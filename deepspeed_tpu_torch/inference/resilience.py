"""Serving resilience primitives: health, watchdog, recovery errors.

Counterpart of ``deepspeed_tpu/inference/resilience.py``. The engine's
failure story is CRASH-ONLY (Candea & Fox, HotOS'03): device state is
disposable, the host-side request records are the only durable truth,
and recovery is always the same move: reset the pool to its initial
values, and replay every in-flight request from its host-side record
(``inference/engine.py``, ``InferenceEngine._recover``). This module
holds the pieces that do not touch the device; all but
``fatal_step_errors`` are copies of the JAX module's:

- ``HealthState``: the ``healthy / degraded / draining / dead`` machine,
  exported as a live telemetry gauge (its numeric index) so a scrape can
  read an engine's fitness without calling into it.
- ``StepWatchdog``: a wall-clock budget around each engine step. A
  device stall presents as a host thread blocked in a synchronizing call
  (the harvest's device-to-host copy); nothing host-side can preempt it,
  so the watchdog's job is DETECTION, not interruption: a timer thread
  fires loudly (warning log + ``step_stalls`` counter + degraded health)
  the moment a step overruns its budget.
- The error taxonomy: ``NumericsError`` (harvest validity check caught
  device garbage), ``EngineDeadError`` (recovery retries exhausted, or
  the device could not be reset: terminal), ``EngineDraining``
  (admissions rejected during drain), and ``fatal_step_errors()``: the
  catch tuple naming every error class the recovery path treats as
  "device state is lost".
"""

import threading

import torch

from deepspeed_tpu_torch.inference.faults import InjectedFault
from deepspeed_tpu_torch.utils.logging import logger

# Order IS the gauge encoding: health_state exports the index, so a
# dashboard threshold "alert when >= 1" reads naturally.
HEALTH_STATES = ("healthy", "degraded", "draining", "dead")


class NumericsError(RuntimeError):
    """The harvest validity check found tokens no sampler can emit
    (negative ids in valid lanes): the device returned garbage, NaN
    logits being the classic cause. Treated exactly like a fatal step
    error: the step's harvest is discarded BEFORE any token reaches a
    request, so replay recovery stays exact."""


class EngineDeadError(RuntimeError):
    """Recovery retries are exhausted, the device could not be reset, or
    step() was called on a dead engine. Terminal: the engine will never
    serve again; callers should fail over, not retry."""


class EngineDraining(RuntimeError):
    """submit() during drain(): admissions are closed while in-flight
    work finishes. Distinct from QueueFull: the right caller response
    is re-route, not back off and retry here."""


def fatal_step_errors():
    """The tuple of error classes after which device state must be
    presumed lost: injected fatal faults, the harvest numerics check, a
    device allocation failure (``torch.cuda.OutOfMemoryError``) and the
    CUDA runtime's error out of a launch, a replay or a copy
    (``torch.AcceleratorError``, feature-detected: older torch builds
    raise a bare RuntimeError there). A bare RuntimeError is never in
    the tuple: a programming error must reach the caller."""
    errs = [InjectedFault, NumericsError, torch.cuda.OutOfMemoryError]
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        errs.append(accel)
    return tuple(errs)


class HealthState(object):
    """The engine's health machine. Transitions the engine performs:

    healthy  -> degraded   a stall tripped the watchdog, or a recovery
                           is in progress
    degraded -> healthy    a clean (fault-free, stall-free) step
    *        -> draining   drain(): admissions close, in-flight work
                           finishes; undrain() reopens (-> healthy)
    *        -> dead       recovery retries exhausted, or the device
                           could not be reset. TERMINAL: every later
                           transition raises.

    The optional registry export is a LIVE gauge (``health_state``,
    value = state index): sampled at scrape time, zero hot-path cost.
    """

    def __init__(self, registry=None):
        self.state = "healthy"
        if registry is not None:
            registry.gauge("health_state").set_fn(
                lambda: float(HEALTH_STATES.index(self.state)))

    @property
    def index(self):
        return HEALTH_STATES.index(self.state)

    def to(self, state):
        if state not in HEALTH_STATES:
            raise ValueError("unknown health state {!r}; valid: {}"
                             .format(state, list(HEALTH_STATES)))
        if self.state == "dead" and state != "dead":
            raise EngineDeadError(
                "engine is dead (recovery retries exhausted); it cannot "
                "transition to {!r} — fail over to another replica"
                .format(state))
        if self.state != state:
            logger.info("inference.health: %s -> %s", self.state, state)
            self.state = state

    @property
    def accepting(self):
        """May submit() admit new work in this state?"""
        return self.state in ("healthy", "degraded")


class StepWatchdog(object):
    """Wall-clock budget around one engine step.

    ``with watchdog:`` arms a one-shot timer thread before the step and
    disarms it after; if the step is still running when the budget
    elapses, the timer fires ``on_trip(budget_s)`` FROM THE TIMER
    THREAD. The step itself may be blocked in a device call and cannot
    be interrupted, so the trip handler must only do host-safe
    signalling (log, count, set health): no CUDA call, which could land
    inside a graph capture. ``tripped`` stays readable after the guard
    exits so the step loop can tell a slow-but-finished step from a
    clean one. Budget ``None`` disables the whole thing (entering
    degenerates to a flag reset)."""

    def __init__(self, budget_s, on_trip):
        if budget_s is not None and budget_s <= 0:
            raise ValueError("step watchdog budget must be > 0 or None, "
                             "got {}".format(budget_s))
        self.budget_s = budget_s
        self._on_trip = on_trip
        self._timer = None
        self.tripped = False
        self.trips = 0

    def _fire(self):
        self.tripped = True
        self.trips += 1
        self._on_trip(self.budget_s)

    def __enter__(self):
        self.tripped = False
        if self.budget_s is not None:
            self._timer = threading.Timer(self.budget_s, self._fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def stop(self):
        """Cancel any armed timer. Idempotent and safe from any thread:
        engine.close() calls it so a watchdog armed around a wedged
        final step can never keep the interpreter alive (the timer is a
        daemon thread regardless, but a cancelled timer also never fires
        a late trip into a torn-down engine)."""
        timer, self._timer = self._timer, None
        if timer is not None:
            timer.cancel()

    def __exit__(self, *exc):
        self.stop()
        return False
