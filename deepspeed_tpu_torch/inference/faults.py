"""Typed, seeded fault injection for the serving engine.

Counterpart of ``deepspeed_tpu/inference/faults.py``, a copy: the module
holds no device code, and the port keeps its own copy because it imports
nothing of the JAX package. A ``FaultPlan`` names WHICH faults fire at
WHICH engine steps, deterministically, so a chaos test is as
reproducible as any other test.

Fault model (each a distinct failure the engine must survive; the
engine's module docstring has the recovery story):

- ``"raise"``            the step dies before its program runs (the
                         stand-in for a CUDA error out of a launch or a
                         replay). Device state must be treated as lost:
                         recovery resets the pool in place.
- ``"nan"``              the device returns garbage (NaN logits sampled
                         into nonsense token ids). Injected by
                         corrupting the HARVESTED tokens (the numpy
                         ``toks`` of ``kv_pool.step_harvest``), which the
                         engine's harvest validity check then catches,
                         the same detection path a real numerics blowup
                         takes, BEFORE any corrupt token reaches a
                         request. The step's program did run.
- ``"stall"``            the step takes ``stall_s`` longer than it
                         should (host-side sleep): the step watchdog's
                         prey. A stall is SLOW, not fatal: no recovery,
                         just detection (counter + degraded health).
- ``"admission_block"``  upstream pressure: ``submit()`` sheds with a
                         structured ``QueueFull`` while the fault is
                         active, exercising caller backoff paths.

Steps are counted from ``engine.inject_faults(plan)`` (arming), so one
plan means the same thing whether armed before the first step or mid-run
by the loadgen chaos mode. Everything is frozen/hashable and validated at
construction: a typo'd kind fails at plan build, not mid-chaos-run.

Zero cost when off: an engine without an armed plan holds
``_injector = None`` and every hook is one ``is not None`` test; arming
at all requires ``inference.fault_injection=True`` (the config switch),
so production configs cannot be chaos'd by accident.
"""

import dataclasses
from typing import Tuple

FAULT_KINDS = ("raise", "stall", "nan", "admission_block")


class InjectedFault(RuntimeError):
    """Raised by a ``"raise"`` fault in place of the step program call:
    the stand-in for a fatal device error. Carries the step index it
    fired at so recovery logs read like a real incident."""

    def __init__(self, step):
        super().__init__(
            "injected fatal step fault at engine step {}".format(step))
        self.step = step


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault: ``kind`` fires at engine step ``step`` (0-based,
    counted from arming) and stays active for ``duration_steps``
    consecutive steps. ``stall_s`` is the per-step extra latency for
    ``kind="stall"`` (must be 0 otherwise — loud beats ignored)."""

    kind: str
    step: int
    duration_steps: int = 1
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError("unknown fault kind {!r}; valid kinds: {}"
                             .format(self.kind, list(FAULT_KINDS)))
        if self.step < 0:
            raise ValueError("fault.step must be >= 0, got {}"
                             .format(self.step))
        if self.duration_steps < 1:
            raise ValueError("fault.duration_steps must be >= 1, got {}"
                             .format(self.duration_steps))
        if self.stall_s < 0:
            raise ValueError("fault.stall_s must be >= 0, got {}"
                             .format(self.stall_s))
        if self.stall_s and self.kind != "stall":
            raise ValueError(
                "fault.stall_s only applies to kind='stall' (got kind={!r})"
                .format(self.kind))

    def active_at(self, step):
        return self.step <= step < self.step + self.duration_steps


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic chaos schedule: which faults, at which steps.
    ``seed`` feeds the nan-fault's corruption values (the only random
    piece) so every chaos run is replayable bit-for-bit."""

    faults: Tuple[Fault, ...]
    seed: int = 0

    def __post_init__(self):
        faults = tuple(self.faults)
        for f in faults:
            if not isinstance(f, Fault):
                raise TypeError(
                    "FaultPlan.faults must be Fault instances, got {!r}"
                    .format(type(f).__name__))
        if not faults:
            raise ValueError("FaultPlan needs at least one Fault")
        object.__setattr__(self, "faults", faults)

    def active(self, step, kind):
        """The plan's faults of ``kind`` active at ``step``."""
        return [f for f in self.faults
                if f.kind == kind and f.active_at(step)]


class FaultInjector(object):
    """The armed form of a plan: tracks the engine's step index and
    answers the engine's hook-point queries. One injector per arming;
    re-arming replaces it (step count restarts)."""

    def __init__(self, plan, registry=None):
        if not isinstance(plan, FaultPlan):
            raise TypeError("inject_faults() wants a FaultPlan, got {!r}"
                            .format(type(plan).__name__))
        self.plan = plan
        self.step_index = 0
        self._counter = (registry.counter("faults_injected")
                         if registry is not None else None)

    def _count(self, n=1):
        if self._counter is not None and n:
            self._counter.inc(n)

    # Hook points, in the order the engine reaches them ------------------

    def admission_blocked(self):
        """submit()-time: True while an admission_block fault is active.
        Counted per SHED (each blocked submit is one injected event)."""
        if self.plan.active(self.step_index, "admission_block"):
            self._count()
            return True
        return False

    def stall_seconds(self):
        """Step-entry: total extra seconds this step must burn."""
        stalls = self.plan.active(self.step_index, "stall")
        self._count(len(stalls))
        return sum(f.stall_s for f in stalls)

    def maybe_raise(self):
        """In place of the step program call: raise when a fatal fault
        is scheduled for this step."""
        if self.plan.active(self.step_index, "raise"):
            self._count()
            raise InjectedFault(self.step_index)

    def corrupt_harvest(self, toks, valid):
        """Garble the harvested tokens the way NaN logits would (the
        sampler's argmax over all-NaN rows is meaningless): valid lanes
        get a seeded negative sentinel no real sampler can produce, so
        the engine's harvest validity check MUST fire. ``toks`` and
        ``valid`` are the harvest's numpy arrays (int64 tokens, bool
        validity, one shape). Returns the (possibly corrupted) array;
        no-op when no nan fault is active."""
        if not self.plan.active(self.step_index, "nan"):
            return toks
        self._count()
        toks = toks.copy()
        toks[valid] = -2 - (self.plan.seed % 1009)
        return toks

    def advance(self):
        """Step-exit (fault or not): the next engine step is the next
        plan step."""
        self.step_index += 1

    def exhausted(self):
        """True when no fault can ever fire again : chaos harnesses use
        this to assert the plan actually ran."""
        return all(f.step + f.duration_steps <= self.step_index
                   for f in self.plan.faults)
