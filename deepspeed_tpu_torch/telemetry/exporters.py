"""Exporters: Prometheus text exposition, stdlib HTTP endpoint,
TensorBoard scalars.

Counterpart of ``deepspeed_tpu/telemetry/exporters.py``: the same text,
byte for byte, for the same registry.

All of them READ the registry; none of them are required for it to
work. The Prometheus side is dependency-free (text format + the
stdlib's http.server, opt-in). The TensorBoard side lazily imports
``torch.utils.tensorboard`` and degrades to a no-op with ONE clear log
line when the extra is not installed — ``import
deepspeed_tpu_torch.telemetry`` must always succeed on a bare
interpreter.
"""

import hashlib
import math
import threading

from deepspeed_tpu_torch.telemetry.registry import Histogram
from deepspeed_tpu_torch.utils.logging import logger

# Label-value escapes per the Prometheus text exposition format: inside
# a quoted label value exactly backslash, double-quote and line feed are
# escaped (in that conceptual order — a single-pass translate makes the
# order question moot, where chained str.replace calls would double- or
# under-escape depending on sequencing).
_LABEL_ESCAPES = {ord("\\"): "\\\\", ord('"'): '\\"', ord("\n"): "\\n"}


def _escape_label(v):
    return str(v).translate(_LABEL_ESCAPES)


def _fmt_labels(labels, extra=None):
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    return "{{{}}}".format(",".join(
        '{}="{}"'.format(k, _escape_label(v))
        for k, v in sorted(items.items())))


def _fmt_value(v):
    if v is None:
        return "NaN"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        # The exposition format spells infinities '+Inf'/'-Inf';
        # Python's repr ('inf') does not parse on the Prometheus side.
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(registry):
    """Prometheus text-exposition snapshot of ``registry``.

    Counters export as ``<ns>_<name>_total`` (monotonic, since boot —
    window resets do NOT rewind them; Prometheus rates need monotonic
    series), gauges as ``<ns>_<name>``, histograms as summaries:
    ``{quantile="0.5|0.95|0.99"}`` rows from the bounded reservoir plus
    exact ``_sum``/``_count``.

    Series within a family are emitted in sorted-label order, so the
    text (and prometheus_digest) is canonical regardless of the
    registry's internal ordering — in particular a fleet's
    MergedRegistry produces the same digest whatever order its replica
    registries were attached in."""
    ns = registry.namespace
    lines = []
    for name, kind, metrics in registry.collect():
        metrics = sorted(metrics, key=lambda m: sorted(m.labels.items()))
        base = "{}_{}".format(ns, name) if ns else name
        if kind == "counter":
            lines.append("# TYPE {}_total counter".format(base))
            for m in metrics:
                lines.append("{}_total{} {}".format(
                    base, _fmt_labels(m.labels), _fmt_value(m.value)))
        elif kind == "gauge":
            lines.append("# TYPE {} gauge".format(base))
            for m in metrics:
                lines.append("{}{} {}".format(
                    base, _fmt_labels(m.labels), _fmt_value(m.value)))
        elif kind == "histogram":
            lines.append("# TYPE {} summary".format(base))
            for m in metrics:
                q = m.quantiles((50, 95, 99))
                for p in (50, 95, 99):
                    lines.append("{}{} {}".format(
                        base,
                        _fmt_labels(m.labels, {"quantile": p / 100.0}),
                        _fmt_value(q[p])))
                lines.append("{}_sum{} {}".format(
                    base, _fmt_labels(m.labels), _fmt_value(m.sum)))
                lines.append("{}_count{} {}".format(
                    base, _fmt_labels(m.labels), _fmt_value(m.count)))
    return "\n".join(lines) + ("\n" if lines else "")


def prometheus_digest(registry):
    """(sha256-hex, line count) of the snapshot — the cheap fingerprint
    a report stamps into its JSON so a reader can tell two runs exported
    identical metric SHAPES without shipping the whole text."""
    text = prometheus_text(registry)
    return (hashlib.sha256(text.encode()).hexdigest(),
            sum(1 for l in text.splitlines() if l and not
                l.startswith("#")))


class PrometheusEndpoint(object):
    """Opt-in stdlib scrape endpoint: GET /metrics serves
    ``prometheus_text(registry)``. Daemon thread; ``port=0`` picks a
    free port (read it back from ``.port``). Never started implicitly —
    serving engines must not open sockets unasked.

    Scrapes are CONCURRENT (ThreadingHTTPServer, one thread per
    request) and must survive both each other and the serving loop
    creating metrics mid-scrape: the registry's collect() walk is
    structure-locked, and a handler that still fails (or whose client
    hung up) answers 500 / drops the connection without taking the
    endpoint — or the engine — down with it."""

    def __init__(self, registry, host="127.0.0.1", port=0):
        import http.server

        reg = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = prometheus_text(reg).encode()
                except Exception as e:  # noqa: BLE001 — scrape must not
                    # kill the endpoint; the error travels to the scraper.
                    self.send_error(500, "scrape failed: {}".format(e))
                    return
                try:
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # scraper hung up mid-response — its problem

            def log_message(self, *a):  # quiet: no per-scrape stderr spam
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        # Scrape threads must never block interpreter exit (a wedged
        # scraper holding a socket open would otherwise hang shutdown).
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="ds-tpu-metrics",
            daemon=True)
        self._thread.start()
        logger.info("telemetry: Prometheus endpoint on http://%s:%d/metrics",
                    self.host, self.port)

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


class TensorBoardScalarWriter(object):
    """Scalar writer behind the ``tensorboard_*`` config keys.

    Wraps ``torch.utils.tensorboard.SummaryWriter`` when available;
    otherwise every call is a no-op after ONE log line saying exactly
    what is missing — a config that asks for tensorboard on a box
    without it must not crash training (reference behavior: warn once).

    ``add_scalar(tag, value, step)`` is the whole surface the engines
    need; ``publish(registry, step, prefix)`` pushes a registry
    snapshot (counters/gauges as scalars, histograms as their p50/p99/
    mean) for the structured step-log path."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self._writer = None
        self._dead = False

    def _get(self):
        if self._dead or self._writer is not None:
            return self._writer
        try:
            import os

            from torch.utils.tensorboard import SummaryWriter

            os.makedirs(self.log_dir, exist_ok=True)
            self._writer = SummaryWriter(log_dir=self.log_dir)
        except (ImportError, OSError) as e:
            self._dead = True
            logger.warning(
                "telemetry: tensorboard scalars disabled (%s) — install "
                "the tensorboard extra or unset tensorboard.enabled; "
                "training continues without event files", e)
        return self._writer

    @property
    def available(self):
        return self._get() is not None

    def add_scalar(self, tag, value, step):
        w = self._get()
        if w is None or value is None:
            return
        w.add_scalar(tag, float(value), int(step))

    def publish(self, registry, step, prefix="telemetry"):
        w = self._get()
        if w is None:
            return
        for name, kind, metrics in registry.collect():
            for m in metrics:
                tag = "{}/{}".format(prefix, name)
                if isinstance(m, Histogram):
                    s = m.stats()
                    for k in ("p50", "p99", "mean"):
                        if s[k] is not None:
                            w.add_scalar("{}_{}".format(tag, k),
                                         float(s[k]), int(step))
                else:
                    w.add_scalar(tag, float(m.value), int(step))

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None
