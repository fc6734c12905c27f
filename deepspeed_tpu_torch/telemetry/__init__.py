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
  (distributed.py): propagated trace context and the trace schema gate.

Alerts, the request autopsy and the perf x-ray of the JAX package are
not ported yet.
"""

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
]
