"""SLO evaluation: budgets, attainment, goodput.

Counterpart of ``deepspeed_tpu/loadgen/slo.py``, unchanged.

Throughput alone rewards the wrong thing — an engine that batches so
aggressively every request waits seconds for its first token posts
GREAT tokens/sec. The serving-quality number that resists that gaming
is GOODPUT: tokens per second per chip counted ONLY from requests that
met their latency budgets. A shed request (QueueFull) met nothing — it
counts against attainment and contributes zero goodput, which is what
makes overload visible in the headline number instead of hidden in a
side tally.

Budgets are per-REQUEST checks (this request's TTFT and mean ITL inside
budget?), aggregated into attainment; the p99 curves in the windowed
report tell you WHEN the misses happened.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLO:
    """Latency budgets, milliseconds. ``None`` disables that check."""

    ttft_p99_ms: float = 1500.0
    itl_p99_ms: float = 150.0

    def meets(self, sample):
        """Does one runner sample row meet every enabled budget? Shed
        and unfinished requests never do; a one-token request has no ITL
        and is judged on TTFT alone."""
        if sample["shed"] or not sample["completed"]:
            return False
        if self.ttft_p99_ms is not None:
            if sample["ttft_s"] is None:
                return False
            if sample["ttft_s"] * 1e3 > self.ttft_p99_ms:
                return False
        if self.itl_p99_ms is not None and sample["itl_s"] is not None:
            if sample["itl_s"] * 1e3 > self.itl_p99_ms:
                return False
        return True

    def to_json(self):
        return dataclasses.asdict(self)


def evaluate(samples, slo, wall_s, chips=1):
    """Fold runner samples + budgets into the SLO section of a report.

    ``goodput_tokens_per_sec``: tokens from SLO-meeting requests over
    the run's wall clock; ``_per_chip`` divides by ``chips`` so numbers
    compare across pod sizes."""
    total = len(samples)
    shed = sum(1 for s in samples if s["shed"])
    met = [s for s in samples if slo.meets(s)]
    good_tokens = sum(s["tokens_out"] for s in met)
    wall = max(float(wall_s), 1e-9)
    return {
        "budgets": slo.to_json(),
        "requests": total,
        "shed": shed,
        "slo_met": len(met),
        "attainment": (len(met) / total) if total else None,
        "goodput_tokens_per_sec": good_tokens / wall,
        "goodput_tokens_per_sec_per_chip":
            good_tokens / wall / max(int(chips), 1),
    }
