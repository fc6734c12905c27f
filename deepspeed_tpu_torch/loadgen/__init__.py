"""deepspeed_tpu_torch.loadgen — sustained-load harness over the serving
engine.

Counterpart of ``deepspeed_tpu/loadgen``, with its names and
signatures:

- ``WorkloadSpec`` (workload.py): seeded, fully deterministic request
  streams — Poisson/burst/ramp arrivals, heavy-tail lognormal/Zipf
  prompt+output length mixes, JSONL trace replay.
- ``SustainedRunner`` (runner.py): open-loop driver — submits on the
  workload's schedule regardless of backlog, records QueueFull sheds as
  signal, ticks a ``TimeseriesCollector`` into per-window curves. Chaos
  mode waits for the resilience slice.
- ``SLO`` / ``evaluate`` (slo.py): TTFT/ITL budgets, attainment, and
  goodput (tokens from SLO-meeting requests per second per chip).
- ``build_report`` / ``saturation_sweep`` / ``regression_gate``
  (report.py): the JSON report, the stepped-rate capacity sweep, and
  the noise-aware A/B gate whose thresholds come from each run's own
  per-window variance.

``chip_smoke.py``'s ``phase_sustained`` drives the whole stack on the
card (README, "PyTorch/H100 port").
"""

from deepspeed_tpu_torch.loadgen.report import (
    GATE_DEFAULT_METRICS,
    SCHEMA_VERSION,
    build_report,
    regression_gate,
    saturation_sweep,
)
from deepspeed_tpu_torch.loadgen.runner import RunResult, SustainedRunner
from deepspeed_tpu_torch.loadgen.slo import SLO, evaluate
from deepspeed_tpu_torch.loadgen.workload import (
    LoadRequest,
    MixedWorkload,
    WorkloadSpec,
    replay_trace,
    save_trace,
)
from deepspeed_tpu_torch.telemetry import TimeseriesCollector

__all__ = [
    "LoadRequest",
    "MixedWorkload",
    "WorkloadSpec",
    "replay_trace",
    "save_trace",
    "SustainedRunner",
    "RunResult",
    "SLO",
    "evaluate",
    "TimeseriesCollector",
    "SCHEMA_VERSION",
    "GATE_DEFAULT_METRICS",
    "build_report",
    "saturation_sweep",
    "regression_gate",
]
