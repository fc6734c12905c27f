"""deepspeed_tpu_torch.telemetry — observability for training and serving.

Counterpart of ``deepspeed_tpu/telemetry``: one dependency-free
subsystem both engines emit into, with the JAX package's names and
signatures.

- ``MetricsRegistry`` (registry.py): counters / gauges /
  bounded-reservoir histograms with windowed snapshots.
- ``SpanRecorder`` (tracing.py): per-request trace spans exported as
  Chrome trace-event JSON (Perfetto-loadable) and a JSONL flight ring.
- ``TimeseriesCollector`` (timeseries.py): periodic windowed registry
  snapshots in a bounded ring, the per-window curves the sustained-load
  harness (``loadgen/``) reports.
- ``RecompileDetector`` / ``annotate`` / ``profile_window``
  (instrumentation.py): program-cache growth after warm-up as a live
  counter, ``record_function`` + NVTX scoping, and the
  ``DS_TPU_PROFILE_DIR``-gated ``torch.profiler`` window.
- ``prometheus_text`` / ``PrometheusEndpoint`` /
  ``TensorBoardScalarWriter`` (exporters.py): the read side. The
  tensorboard extra is imported lazily.
- ``TraceContext`` / ``merged_trace`` / ``validate_trace``
  (distributed.py): propagated trace context, the fleet-wide merge that
  binds cross-replica hops with flow arrows, and the trace schema gate.
- ``build_autopsy`` / ``worst_requests`` (autopsy.py): the structured
  "why was this request slow?" answer assembled from the rings.
- ``AlertRule`` / ``AlertManager`` / ``default_rules`` (alerts.py):
  declarative SLO burn-rate alerting over the collector's windows.

- ``ProgramRegistry`` / ``HBMLedger`` / ``cost_model_gate`` (xray.py):
  the per-program cost and memory observatory (flops and bytes measured
  on each program's eager first run, the graph pool's bytes, roofline
  gauges against ``PLATFORM_PEAKS``), the predicted-vs-live device memory
  ledger, and the regression gate's cost arm.
"""

from deepspeed_tpu_torch.telemetry.alerts import (
    AlertManager,
    AlertRule,
    default_rules,
)
from deepspeed_tpu_torch.telemetry.autopsy import (
    build_autopsy,
    worst_requests,
)

from deepspeed_tpu_torch.telemetry.distributed import (
    TraceContext,
    TraceError,
    merged_trace,
    validate_trace,
    write_merged_trace,
)
from deepspeed_tpu_torch.telemetry.exporters import (
    PrometheusEndpoint,
    TensorBoardScalarWriter,
    prometheus_digest,
    prometheus_text,
)
from deepspeed_tpu_torch.telemetry.instrumentation import (
    PROFILE_DIR_ENV,
    RecompileDetector,
    annotate,
    profile_window,
)
from deepspeed_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MergedRegistry,
    MetricsRegistry,
    NullRegistry,
)
from deepspeed_tpu_torch.telemetry.timeseries import TimeseriesCollector
from deepspeed_tpu_torch.telemetry.tracing import NullRecorder, SpanRecorder
from deepspeed_tpu_torch.telemetry.xray import (PLATFORM_PEAKS, HBMLedger,
                                                ProgramRegistry,
                                                cost_model_gate)

__all__ = [
    "TimeseriesCollector",
    "Counter",
    "Gauge",
    "Histogram",
    "MergedRegistry",
    "MetricsRegistry",
    "NullRegistry",
    "NullRecorder",
    "SpanRecorder",
    "RecompileDetector",
    "annotate",
    "profile_window",
    "PROFILE_DIR_ENV",
    "prometheus_text",
    "prometheus_digest",
    "PrometheusEndpoint",
    "TensorBoardScalarWriter",
    "TraceContext",
    "TraceError",
    "merged_trace",
    "validate_trace",
    "write_merged_trace",
    "build_autopsy",
    "worst_requests",
    "AlertRule",
    "AlertManager",
    "default_rules",
    "PLATFORM_PEAKS",
    "HBMLedger",
    "ProgramRegistry",
    "cost_model_gate",
]
