"""SLO admission math: TTFT prediction from live queue state and
throughput evidence.

Counterpart of ``deepspeed_tpu/inference/frontdoor/admission.py``.

The predictor is deliberately simple and conservative:

    predicted_ttft = work_ahead / completion_rate + service_base

``work_ahead`` is the number of requests that will reach a slot before
the candidate (target queue depth + front-door pending that dispatches
first), ``completion_rate`` an EWMA of the target's completions/s (the
same evidence the ``queue_wait_seconds`` histogram accumulates, read as
a live rate), and ``service_base`` an EWMA of observed admit->first-
token service time (what the ``ttft_seconds`` histogram sees for an
unqueued request). Before two completions of evidence exist the
predictor returns None — admission is OPTIMISTIC cold (shedding on a
guess would reject the first request ever submitted) and the front
door bounds batch depth by slot count instead.

Per-class completion deques feed the class-aware ``retry_after_s``
hints with exactly the scheduler's estimator shape (Scheduler._rate_
hint), so a front-door shed and an engine shed hint on the same
evidence scale.
"""

import collections
import time

from deepspeed_tpu_torch.inference.scheduler import Scheduler


class AdmissionController(object):
    """Throughput/TTFT estimators for one front door. NOT thread-safe
    on its own — the owning FrontDoor serializes every call under its
    lock."""

    # Below this poll spacing the completion-delta rate is mostly
    # noise; updates are folded into the next wide-enough interval.
    MIN_POLL_DT_S = 0.2

    def __init__(self, alpha=0.3, slots=1, clock=time.time):
        self.alpha = float(alpha)
        self.slots = max(1, int(slots))
        self._clock = clock
        self._rate = None          # completions/s EWMA
        self._token_rate = None    # tokens/s EWMA
        self._service_base = None  # admit->first-token seconds EWMA
        self._last_poll = None     # (t, completed_total, tokens_total)
        self._finish_times = collections.deque(maxlen=32)
        self._finish_by_class = {}

    # -------------------------------------------------------- evidence

    def update_slots(self, n):
        """Refresh the effective concurrent-session capacity. Dense
        targets never move it (max_slots is static); a PAGED target's
        capacity is page-budget-bound and floats with the live mix —
        the front door feeds ``pages_available / mean_reservation``
        here each poll so predict_e2e_s's per-session token rate
        tracks the pool that actually exists."""
        self.slots = max(1, int(n))

    def observe_poll(self, completed_total, tokens_total):
        """Feed cumulative target counters; rates come from deltas over
        wall time. Called opportunistically (every dispatch round) —
        sub-MIN_POLL_DT_S intervals are skipped, so the EWMA sees
        stable windows whatever the call cadence."""
        now = self._clock()
        if self._last_poll is None:
            self._last_poll = (now, completed_total, tokens_total)
            return
        t0, c0, k0 = self._last_poll
        dt = now - t0
        if dt < self.MIN_POLL_DT_S:
            return
        self._last_poll = (now, completed_total, tokens_total)
        rate = max(0.0, (completed_total - c0) / dt)
        trate = max(0.0, (tokens_total - k0) / dt)
        a = self.alpha
        self._rate = rate if self._rate is None \
            else (1 - a) * self._rate + a * rate
        self._token_rate = trate if self._token_rate is None \
            else (1 - a) * self._token_rate + a * trate

    def observe_finish(self, priority, service_ttft_s=None):
        """One completion: timestamp it (globally and per class — the
        retry-hint evidence) and fold its admit->first-token service
        time into the prediction base."""
        now = self._clock()
        self._finish_times.append(now)
        if priority is not None:
            self._finish_by_class.setdefault(
                priority, collections.deque(maxlen=32)).append(now)
        if service_ttft_s is not None and service_ttft_s >= 0:
            a = self.alpha
            self._service_base = service_ttft_s \
                if self._service_base is None \
                else (1 - a) * self._service_base + a * service_ttft_s

    # ------------------------------------------------------ prediction

    @property
    def cold(self):
        """True before the estimators hold usable evidence."""
        return self._rate is None or len(self._finish_times) < 2

    def predict_ttft_s(self, ahead):
        """Predicted TTFT for a request with ``ahead`` requests in
        front of it; None while cold (admit optimistically — the batch
        gate's cold slot-count bound carries the early phase)."""
        if self.cold or self._rate <= 1e-9:
            return None
        return ahead / self._rate + (self._service_base or 0.0)

    def predict_e2e_s(self, ahead, max_new_tokens):
        """Predicted completion time: TTFT plus the decode tail at the
        observed per-slot token rate. None while cold."""
        ttft = self.predict_ttft_s(ahead)
        if ttft is None:
            return None
        if not self._token_rate or self._token_rate <= 1e-9:
            return ttft
        per_slot = self._token_rate / self.slots
        return ttft + max(0, int(max_new_tokens)) / max(per_slot, 1e-9)

    def retry_hint_s(self, priority=None):
        """Class-aware backpressure hint on the scheduler's estimator
        shape: that class's own completions rate, global fallback."""
        if priority is not None:
            hint = Scheduler._rate_hint(
                self._finish_by_class.get(priority))
            if hint is not None:
                return hint
        return Scheduler._rate_hint(self._finish_times)
