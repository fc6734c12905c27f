"""Routing policy for the serving fleet — breaker + scorer, no I/O.

Counterpart of ``deepspeed_tpu/inference/router.py``, kept verbatim in
behaviour (host code; the seeded tie-break draws the JAX package's
sequence, so a port fleet routes as the JAX fleet does). Split out of
fleet.py so the DECISIONS are testable without engines:
everything here consumes plain numbers (the live ``queue_depth`` /
``slot_occupancy`` / ``health_state`` gauges the engine exports, and
the structured ``QueueFull.retry_after_s`` backpressure hint) and
returns orderings or booleans. The fleet supplies the numbers and acts.

Two pieces:

- ``CircuitBreaker`` — one per replica, classic closed/open/half-open.
  Failures (QueueFull sheds, watchdog stalls, fatal step errors) trip it
  open for an exponentially growing backoff, floored by the replica's
  own ``retry_after_s`` hint when one was offered (the replica knows its
  completion rate better than our doubling schedule does). When the
  backoff elapses, the FIRST ``allow()`` is the half-open probe: exactly
  one request is let through, and its outcome closes the breaker or
  re-trips it at the next backoff step. Clock is injectable
  (``time.monotonic`` default) so tests drive state transitions without
  sleeping.
- ``Router`` — health-weighted least-loaded ordering. Score =
  (slot_occupancy + queue_depth / max_slots) * health weight; degraded
  replicas carry a penalty multiplier so they keep serving (they ARE
  accepting) but only fill after healthier peers at comparable load.
  Exact ties break by a SEEDED rng — two routers built with the same
  seed make the same choice sequence, which is what makes fleet routing
  tests deterministic.

The breaker deliberately does NOT live inside the router: ordering is a
pure ranking over every live replica, and the fleet consults
``breaker.allow()`` only for replicas it actually attempts — a
half-open probe must never be burned on a replica the router ranked
last and the submit never reached.
"""

import random
import time

from deepspeed_tpu_torch.inference.scheduler import RETRY_AFTER_CAP_S

BREAKER_STATES = ("closed", "open", "half_open")

# Degraded replicas (mid-recovery, or recently stalled) score this many
# times worse than healthy ones at equal load: they stay in rotation —
# degraded IS accepting — but new work prefers healthy peers.
DEGRADED_PENALTY = 4.0

# Prefix-affinity weight: a full-length cached-prefix match (affinity
# 1.0) is worth this much LOAD — enough to out-rank a peer holding one
# spare slot on a small replica (1/3 occupancy), not enough to pile
# work onto an already-saturated prefix holder (occupancy >= 1 beats
# it). Affinity can never resurrect a dead replica (its score is inf)
# and never bypasses a breaker (the fleet consults breakers per
# attempted candidate AFTER ordering).
AFFINITY_WEIGHT = 0.5


class CircuitBreaker(object):
    """Per-replica admission breaker.

    closed    — normal; every allow() passes.
    open      — tripped; allow() fails until the backoff elapses.
    half_open — backoff elapsed; exactly ONE probe was granted (the
                allow() that performed the open->half_open transition)
                and its outcome decides: record_success() -> closed,
                record_failure() -> open at the next backoff step.

    Failures only trip the breaker after ``failure_threshold``
    CONSECUTIVE ones while closed (one shed under a burst is load, not
    sickness) — but a half-open probe failure re-trips immediately: the
    replica just proved it is still sick. ``trip()`` force-opens (the
    fleet calls it on fatal step errors and watchdog stalls, which are
    never load)."""

    def __init__(self, failure_threshold=3, backoff_base_s=0.5,
                 backoff_max_s=30.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1, got "
                             "{}".format(failure_threshold))
        if backoff_base_s <= 0 or backoff_max_s < backoff_base_s:
            raise ValueError(
                "need 0 < backoff_base_s <= backoff_max_s, got "
                "base={} max={}".format(backoff_base_s, backoff_max_s))
        self.failure_threshold = failure_threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._clock = clock
        self.state = "closed"
        self.consecutive_failures = 0
        self.backoff_s = 0.0
        self._open_until = 0.0
        self.trips = 0
        self.probes = 0

    def allow(self):
        """May one request be sent to this replica now? The allow()
        that finds an elapsed backoff IS the half-open probe grant —
        callers must follow it with an actual attempt and report the
        outcome, or the breaker sticks half-open (by design: an
        unreported probe means the caller dropped it)."""
        if self.state == "closed":
            return True
        if self.state == "open" and self._clock() >= self._open_until:
            self.state = "half_open"
            self.probes += 1
            return True
        return False

    def record_success(self):
        """An attempt the breaker allowed succeeded — close and reset."""
        self.state = "closed"
        self.consecutive_failures = 0
        self.backoff_s = 0.0

    def record_failure(self, retry_after_s=None):
        """An attempt failed (QueueFull shed, typically). Trips after
        ``failure_threshold`` consecutive failures — or immediately on
        a failed half-open probe. ``retry_after_s`` (the shed's own
        backpressure hint, pre-clamped by the scheduler) floors the
        backoff: never re-probe faster than the replica said it could
        plausibly free a queue position."""
        self.consecutive_failures += 1
        if (self.state == "half_open"
                or self.consecutive_failures >= self.failure_threshold):
            self.trip(retry_after_s)

    def trip(self, retry_after_s=None):
        """Force-open now (fatal step error / watchdog stall — sickness,
        not load; no threshold applies). Backoff doubles per consecutive
        trip, floored by ``retry_after_s``, capped at backoff_max_s."""
        base = self.backoff_s * 2.0 if self.backoff_s > 0 else \
            self.backoff_base_s
        if retry_after_s is not None and retry_after_s > 0:
            base = max(base, min(float(retry_after_s), RETRY_AFTER_CAP_S))
        self.backoff_s = min(base, self.backoff_max_s)
        self.state = "open"
        self._open_until = self._clock() + self.backoff_s
        self.trips += 1

    def retry_after_s(self):
        """Seconds until this breaker would grant again (0.0 when it
        would grant NOW) — the fleet takes the min across breakers for
        the fleet-level QueueFull's retry hint."""
        if self.state != "open":
            return 0.0
        return max(0.0, self._open_until - self._clock())


class Router(object):
    """Health-weighted least-loaded ordering over replica views.

    ``order(views)`` returns the views best-first. Each view must expose
    ``queue_depth``, ``slot_occupancy``, ``max_slots`` and ``health``
    (a HEALTH_STATES string) — the fleet's ``_Replica`` reads them off
    the engine's live gauges. The router RANKS; it does not filter
    (dead/draining exclusion and breaker consultation are the fleet's
    attempt loop) — except that it never needs to see dead replicas, so
    passing them is a caller bug the score makes harmless (they sort
    last)."""

    def __init__(self, seed=0):
        self._rng = random.Random(seed)

    @staticmethod
    def score(view):
        """Lower is better. Occupancy is the primary load axis (a full
        slot set means new work WAITS); queue depth, normalized by slot
        count, extends the axis past saturation so two full replicas
        still rank by backlog. Health multiplies: degraded serves after
        healthy at equal load, dead after everything."""
        load = (float(view.slot_occupancy)
                + float(view.queue_depth) / max(int(view.max_slots), 1))
        health = getattr(view, "health", "healthy")
        if health == "degraded":
            load = (load + 1.0) * DEGRADED_PENALTY
        elif health == "dead":
            load = float("inf")
        return load

    def order(self, views, affinity=None, eligible=None):
        """Views sorted best-first by score; EXACT score ties break by
        the seeded rng (draws happen in input order, so equal inputs +
        equal seed = equal output, run after run).

        ``affinity`` (optional) is a sequence aligned with ``views`` of
        cached-prefix affinities in [0, 1] (matched prefix depth over
        the prefix plane length — the fleet computes it from its prefix
        directory). Each view's effective score is
        ``score - AFFINITY_WEIGHT * affinity``: a replica already
        holding a prompt's prefix wins the route at comparable load,
        but a dead replica stays inf (affinity never resurrects it) and
        one rng draw per view still happens in input order, so the
        seeded tie-break sequence is unchanged from affinity-free
        ordering.

        ``eligible`` (optional) is a sequence of bools aligned with
        ``views`` — role eligibility in a disaggregated fleet (a new
        prompt cannot land on a decode-role replica, a handoff cannot
        land on a prefill-role one). Ineligible views are SKIPPED
        OUTRIGHT: no score computation, no rng draw, absent from the
        result — not scored-then-filtered, which would advance the
        seeded tie-break stream and make an all-``mixed`` fleet route
        differently just because role plumbing exists. With every view
        eligible (or ``eligible=None``) the draw sequence is
        bit-for-bit the historical one."""
        decorated = []
        for i, v in enumerate(views):
            if eligible is not None and not eligible[i]:
                continue
            s = self.score(v)
            if affinity is not None:
                s -= AFFINITY_WEIGHT * float(affinity[i])
            decorated.append((s, self._rng.random(), i, v))
        decorated.sort(key=lambda t: t[:3])
        return [v for _, _, _, v in decorated]
