"""Front-door policy objects: priority classes, tenant policies, the
token bucket, and the FrontDoorConfig that binds them.

Counterpart of ``deepspeed_tpu/inference/frontdoor/classes.py``.

All frozen dataclasses in the InferenceConfig idiom: validated at
construction, ``from_dict`` rejects unknown keys loudly, and the
defaults reproduce the two-class (interactive/batch) front door the
acceptance tests pin. The classes are EXTENSIBLE — any number of
classes, each either a latency class (``ttft_budget_ms`` set: admission
predicts TTFT against the budget) or a throughput class (budget None:
deferred behind latency work, optionally preemptible into the
kv_hierarchy ``swapped`` phase).
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """One priority class.

    ``ttft_budget_ms``: per-class TTFT SLO budget. Set -> latency class:
    admission predicts TTFT (admission.AdmissionController) and
    admits / preempts batch / sheds (reason ``slo``) against it. None ->
    throughput class: never shed on SLO, dispatched only when the batch
    gate says a hypothetical latency arrival would still meet budget.

    ``weight``: weighted-fair-queue share (relative, > 0) among classes
    of the same tier and across tenants within the class.

    ``preemptible``: this class's DECODING requests may be parked into
    the ``swapped`` phase when a latency class would miss its budget
    (requires host_offload on the target; resume is bit-identical).

    ``max_pending``: front-door queue cap per (class, tenant) lane —
    past it, submissions shed with reason ``frontdoor_full``.

    ``shed_on_budget``: latency classes only — when prediction still
    exceeds budget after preemption, shed (True, the SLO-honest
    default) or enqueue anyway (False: callers prefer lateness over
    rejection)."""

    name: str
    ttft_budget_ms: Optional[float] = None
    weight: float = 1.0
    preemptible: bool = False
    max_pending: int = 1024
    shed_on_budget: bool = True

    def __post_init__(self):
        if not self.name:
            raise ValueError("PriorityClass needs a non-empty name")
        if self.ttft_budget_ms is not None and self.ttft_budget_ms <= 0:
            raise ValueError(
                "ttft_budget_ms must be > 0 (or None for a throughput "
                "class), got {!r}".format(self.ttft_budget_ms))
        if self.weight <= 0:
            raise ValueError("weight must be > 0, got "
                             "{!r}".format(self.weight))
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1, got "
                             "{!r}".format(self.max_pending))

    @property
    def is_latency(self):
        return self.ttft_budget_ms is not None

    @property
    def budget_s(self):
        return None if self.ttft_budget_ms is None \
            else self.ttft_budget_ms / 1e3


# The two-class default the paper-scale serving story needs: interactive
# traffic with a real TTFT budget, batch traffic that may saturate the
# fleet but yields (defer + preempt) whenever interactive would miss.
DEFAULT_CLASSES = (
    PriorityClass("interactive", ttft_budget_ms=2000.0, weight=4.0),
    PriorityClass("batch", weight=1.0, preemptible=True),
)


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant knobs: ``weight`` is the fair-queue share among
    tenants in the same class lane; ``rate``/``burst`` the token-bucket
    rate limit in requests/s (rate None: unlimited; burst None: one
    second of rate, floor 1)."""

    name: str
    weight: float = 1.0
    rate: Optional[float] = None
    burst: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("TenantPolicy needs a non-empty name")
        if self.weight <= 0:
            raise ValueError("weight must be > 0, got "
                             "{!r}".format(self.weight))
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be > 0 requests/s (or None for "
                             "unlimited), got {!r}".format(self.rate))
        if self.burst is not None and self.burst < 1:
            raise ValueError("burst must be >= 1, got "
                             "{!r}".format(self.burst))

    @property
    def bucket_burst(self):
        if self.burst is not None:
            return float(self.burst)
        return max(1.0, float(self.rate or 1.0))


class TokenBucket(object):
    """Classic token bucket with an injectable clock: ``take(now)``
    consumes one token if available (refilled at ``rate`` tokens/s up
    to ``burst``); ``retry_after(now)`` is the seconds until the next
    token exists — the structured hint a rate-limit shed carries."""

    __slots__ = ("rate", "burst", "_tokens", "_t_last")

    def __init__(self, rate, burst, now):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t_last = now

    def _refill(self, now):
        dt = max(0.0, now - self._t_last)
        self._t_last = now
        self._tokens = min(self.burst, self._tokens + dt * self.rate)

    def take(self, now):
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def retry_after(self, now):
        self._refill(now)
        if self._tokens >= 1.0:
            return 0.0
        return (1.0 - self._tokens) / self.rate


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Everything the front door needs beyond the target's own config.

    ``batch_headroom``: batch dispatch gate — batch work enters the
    target only while a HYPOTHETICAL latency-class arrival would still
    see predicted TTFT <= headroom * strictest budget, so batch
    saturates the slots without burying the queue. ``cold_depth``:
    before the throughput estimator has evidence, batch in-flight depth
    is bounded by this instead (None: the target's total slot count).
    ``preempt_max``: victims parked per over-budget latency admission.
    ``ewma_alpha``: smoothing for the completion/token-rate estimators.
    ``stream_poll_s``: TokenStream's wait between pump attempts when no
    token is ready."""

    classes: Tuple[PriorityClass, ...] = DEFAULT_CLASSES
    tenants: Tuple[TenantPolicy, ...] = ()
    default_class: str = "interactive"
    default_tenant: str = "default"
    batch_headroom: float = 0.5
    cold_depth: Optional[int] = None
    preempt_max: int = 2
    ewma_alpha: float = 0.3
    stream_poll_s: float = 0.002

    def __post_init__(self):
        classes = tuple(self.classes)
        tenants = tuple(self.tenants)
        object.__setattr__(self, "classes", classes)
        object.__setattr__(self, "tenants", tenants)
        if not classes:
            raise ValueError("FrontDoorConfig needs at least one class")
        names = [c.name for c in classes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate class names: {}".format(names))
        tnames = [t.name for t in tenants]
        if len(set(tnames)) != len(tnames):
            raise ValueError("duplicate tenant names: {}".format(tnames))
        if self.default_class not in names:
            raise ValueError(
                "default_class {!r} is not a configured class "
                "(have {})".format(self.default_class, names))
        if not 0.0 < self.batch_headroom <= 1.0:
            raise ValueError("batch_headroom must be in (0, 1], got "
                             "{!r}".format(self.batch_headroom))
        if self.cold_depth is not None and self.cold_depth < 1:
            raise ValueError("cold_depth must be >= 1 (or None), got "
                             "{!r}".format(self.cold_depth))
        if self.preempt_max < 0:
            raise ValueError("preempt_max must be >= 0, got "
                             "{!r}".format(self.preempt_max))
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1], got "
                             "{!r}".format(self.ewma_alpha))
        if self.stream_poll_s <= 0:
            raise ValueError("stream_poll_s must be > 0, got "
                             "{!r}".format(self.stream_poll_s))

    @classmethod
    def from_dict(cls, d):
        """Build from a plain dict; ``classes``/``tenants`` entries may
        themselves be dicts. Unknown keys raise — a typo must never
        silently configure nothing."""
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                "unknown FrontDoorConfig key(s): {} (known: {})".format(
                    sorted(unknown), sorted(known)))
        if "classes" in d:
            d["classes"] = tuple(
                c if isinstance(c, PriorityClass) else PriorityClass(**c)
                for c in d["classes"])
        if "tenants" in d:
            d["tenants"] = tuple(
                t if isinstance(t, TenantPolicy) else TenantPolicy(**t)
                for t in d["tenants"])
        return cls(**d)
