"""Metrics registry — counters, gauges, bounded-reservoir histograms.

Counterpart of ``deepspeed_tpu/telemetry/registry.py``, line for line:
the same operations on a port registry and a JAX one give the same
snapshot and the same Prometheus text (the reservoir draws from the same
seeded ``random.Random``, in the same order).

The one telemetry surface the training engine, the serving engine and
``chip_smoke.py`` emit into: every number lands in ONE registry, and the
exporters (Prometheus text, TensorBoard scalars, Chrome traces) read it
back out.

Design constraints, in order:

- DEPENDENCY-FREE: stdlib only. Exporters that need extras (tensorboard)
  degrade to a no-op with one clear log line (exporters.py).
- BOUNDED MEMORY whatever the run length: histograms keep an exact
  count/sum/min/max plus a fixed-size reservoir sample (Vitter's
  algorithm R, seeded — deterministic across runs) that percentiles are
  computed from. A month-long serving run holds the same few KB a test
  does.
- WINDOWED SNAPSHOTS: ``snapshot(reset=True)`` returns the values
  accumulated since the previous reset and opens a new window — the
  per-interval p50/p99 a long-running server reports instead of
  since-boot aggregates. Counters stay monotonic internally (Prometheus
  semantics); only the *window view* resets. Gauges are instantaneous
  and never windowed.
- CHEAP on the hot path: a counter inc is one float add; a histogram
  observe is O(1), both lock-free (single mutations under the GIL). The
  only lock guards the registry's STRUCTURE (metric creation and the
  collect walk): a concurrent Prometheus scrape iterating the metric
  table while the serving loop get-or-creates a new metric must never
  hit "dictionary changed size during iteration".

Metrics are identified by (name, sorted label items). ``MetricsRegistry``
get-or-creates on access, so call sites just say
``reg.counter("tokens_out", engine="inference").inc(n)``.
"""

import random
import threading


def _label_key(labels):
    return tuple(sorted(labels.items()))


class Counter(object):
    """Monotonic counter. ``value`` is since-creation; ``window_value``
    since the last window reset (snapshot(reset=True))."""

    __slots__ = ("name", "labels", "_value", "_window_base")

    def __init__(self, name, labels):
        self.name = name
        self.labels = dict(labels)
        self._value = 0.0
        self._window_base = 0.0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("counter {!r} cannot decrease".format(self.name))
        self._value += n

    @property
    def value(self):
        return self._value

    @property
    def window_value(self):
        return self._value - self._window_base

    def reset_window(self):
        self._window_base = self._value


class Gauge(object):
    """Instantaneous value; ``set_fn`` registers a callable sampled at
    read time (live gauges like compile_count read the jit caches)."""

    __slots__ = ("name", "labels", "_value", "_fn")

    def __init__(self, name, labels):
        self.name = name
        self.labels = dict(labels)
        self._value = 0.0
        self._fn = None

    def set(self, v):
        self._value = float(v)

    def set_fn(self, fn):
        self._fn = fn

    @property
    def value(self):
        if self._fn is not None:
            return float(self._fn())
        return self._value

    def reset_window(self):
        pass  # gauges are instantaneous — windows don't apply


class Histogram(object):
    """Bounded-reservoir histogram: exact count/sum/min/max over the
    window plus a ``reservoir_size`` uniform sample percentiles are read
    from (algorithm R; the RNG is seeded per-instance so runs are
    reproducible). ``snapshot(reset=True)`` truncation applies here too:
    the reservoir and the exact stats restart each window."""

    __slots__ = ("name", "labels", "reservoir_size", "_rng", "_sample",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name, labels, reservoir_size=2048):
        self.name = name
        self.labels = dict(labels)
        self.reservoir_size = reservoir_size
        self._rng = random.Random(0x5EED)
        self._reset()

    def _reset(self):
        self._sample = []
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, v):
        v = float(v)
        self._count += 1
        self._sum += v
        if self._min is None or v < self._min:
            self._min = v
        if self._max is None or v > self._max:
            self._max = v
        if len(self._sample) < self.reservoir_size:
            self._sample.append(v)
        else:
            j = self._rng.randrange(self._count)
            if j < self.reservoir_size:
                self._sample[j] = v

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def percentile(self, p):
        """p in [0, 100]; None when empty. Nearest-rank over the sorted
        reservoir (exact until ``count`` exceeds the reservoir)."""
        if not self._sample:
            return None
        s = sorted(self._sample)
        idx = min(int(len(s) * p / 100.0), len(s) - 1)
        return s[idx]

    def quantiles(self, ps=(50, 95, 99)):
        if not self._sample:
            return {p: None for p in ps}
        s = sorted(self._sample)
        return {p: s[min(int(len(s) * p / 100.0), len(s) - 1)] for p in ps}

    def stats(self):
        q = self.quantiles()
        return {
            "count": self._count,
            "sum": self._sum,
            "min": self._min,
            "max": self._max,
            "mean": self._sum / self._count if self._count else None,
            "p50": q[50],
            "p95": q[95],
            "p99": q[99],
        }

    def reset_window(self):
        self._reset()


class MetricsRegistry(object):
    """Get-or-create registry over (name, labels). ``const_labels`` are
    merged into every metric (engine=..., model=..., pool=... — the
    labeling axes). ``namespace`` prefixes exported
    names (Prometheus convention)."""

    def __init__(self, namespace="ds_tpu", **const_labels):
        self.namespace = namespace
        self.const_labels = dict(const_labels)
        # name -> {label_key: metric}; kind checked on re-access so one
        # name never silently serves two metric types. The lock guards
        # this structure only — reads/writes of an already-created
        # metric stay lock-free (call sites cache the metric object).
        self._metrics = {}
        self._kinds = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, labels, **kw):
        with self._lock:
            kind = self._kinds.setdefault(name, cls)
            if kind is not cls:
                raise TypeError(
                    "metric {!r} already registered as {} (requested {})"
                    .format(name, kind.__name__, cls.__name__))
            merged = dict(self.const_labels, **labels)
            family = self._metrics.setdefault(name, {})
            key = _label_key(merged)
            metric = family.get(key)
            if metric is None:
                metric = cls(name, merged, **kw)
                family[key] = metric
            return metric

    def counter(self, name, **labels):
        return self._get(Counter, name, labels)

    def gauge(self, name, **labels):
        return self._get(Gauge, name, labels)

    def histogram(self, name, reservoir_size=2048, **labels):
        return self._get(Histogram, name, labels,
                         reservoir_size=reservoir_size)

    def collect(self):
        """Yield (name, kind, [metric...]) per family, names sorted —
        the exporter walk order. The family table is materialized under
        the structure lock, so a scrape racing metric creation (the
        threaded PrometheusEndpoint against the serving loop) sees a
        consistent point-in-time metric SET — individual values may
        still move underneath, which is normal scrape semantics."""
        with self._lock:
            families = [(name, self._kinds[name].__name__.lower(),
                         [self._metrics[name][k]
                          for k in sorted(self._metrics[name])])
                        for name in sorted(self._metrics)]
        for item in families:
            yield item

    def snapshot(self, reset=False):
        """Plain-dict view: counters report their WINDOW value (since
        the last reset), gauges their instantaneous value, histograms
        their window stats. ``reset=True`` then opens a new window."""
        out = {}
        for name, kind, metrics in self.collect():
            for m in metrics:
                key = name
                extra = {k: v for k, v in m.labels.items()
                         if k not in self.const_labels}
                if extra:
                    key = "{}{{{}}}".format(name, ",".join(
                        "{}={}".format(k, v) for k, v in sorted(
                            extra.items())))
                if kind == "counter":
                    out[key] = m.window_value
                elif kind == "gauge":
                    out[key] = m.value
                else:
                    out[key] = m.stats()
        if reset:
            self.reset_window()
        return out

    def reset_window(self):
        with self._lock:
            metrics = [m for family in self._metrics.values()
                       for m in family.values()]
        for m in metrics:
            m.reset_window()


class _LabeledMetric(object):
    """Read-only view of a child registry's metric with one label
    injected (``replica="0"``). The metric object itself is SHARED with
    the child — values are always live; only the label dict is copied.
    Injection is setdefault semantics: a child that already carries the
    label (an engine built with ``replica_id``) keeps its own value, so
    the merge never mislabels a replica."""

    __slots__ = ("_metric", "labels")

    def __init__(self, metric, label, value):
        self._metric = metric
        merged = dict(metric.labels)
        merged.setdefault(label, value)
        self.labels = merged

    def __getattr__(self, name):
        return getattr(self._metric, name)


class MergedRegistry(object):
    """Read-only union of child registries under one label axis — the
    fleet's aggregate view (``MergedRegistry({0: eng0.telemetry, 1:
    eng1.telemetry})`` exports every engine series with a ``replica``
    label). Same read surface as MetricsRegistry (collect / snapshot /
    reset_window), so every exporter — prometheus_text, the HTTP
    endpoint, the timeseries collector — works on a fleet unchanged.
    Metric CREATION goes through the children, never through here:
    counter()/gauge()/histogram() raise, because a merged metric has no
    single owner to mutate."""

    def __init__(self, children, label="replica", namespace=None):
        # children: mapping axis value -> registry. Axis values are
        # stringified for labels; iteration order (sorted keys) is the
        # within-family export order.
        self.children = dict(children)
        self.label = label
        regs = list(self.children.values())
        if namespace is None:
            namespace = regs[0].namespace if regs else "ds_tpu"
        self.namespace = namespace
        # Const labels common to EVERY child (same key, same value) —
        # snapshot() elides them from keys exactly as MetricsRegistry
        # elides its own const_labels; per-child labels (replica) stay.
        common = None
        for reg in regs:
            items = set(reg.const_labels.items())
            common = items if common is None else (common & items)
        self.const_labels = dict(common or ())

    def _no_create(self, name):
        raise TypeError(
            "MergedRegistry is read-only: create metric {!r} on a child "
            "registry (it has an owner); the merge only exports".format(name))

    def counter(self, name, **labels):
        self._no_create(name)

    def gauge(self, name, **labels):
        self._no_create(name)

    def histogram(self, name, reservoir_size=2048, **labels):
        self._no_create(name)

    def collect(self):
        """Union of the children's families: (name, kind, [metric...])
        with names sorted and each metric wrapped to carry its child's
        axis label. A name registered as different kinds in different
        children raises — one name, one type, fleet-wide."""
        fams = {}
        kinds = {}
        for key in sorted(self.children, key=str):
            for name, kind, metrics in self.children[key].collect():
                prev = kinds.setdefault(name, kind)
                if prev != kind:
                    raise TypeError(
                        "metric {!r} is a {} in one replica registry and "
                        "a {} in another — one name, one type"
                        .format(name, prev, kind))
                fams.setdefault(name, []).extend(
                    _LabeledMetric(m, self.label, str(key))
                    for m in metrics)
        for name in sorted(fams):
            yield name, kinds[name], fams[name]

    def snapshot(self, reset=False):
        """Plain-dict view across the fleet: keys carry every non-common
        label — ``tokens_out{replica=0}`` — with the same value
        semantics as MetricsRegistry.snapshot. ``reset=True`` opens a
        new window on EVERY child."""
        out = {}
        for name, kind, metrics in self.collect():
            for m in metrics:
                key = name
                extra = {k: v for k, v in m.labels.items()
                         if self.const_labels.get(k) != v}
                if extra:
                    key = "{}{{{}}}".format(name, ",".join(
                        "{}={}".format(k, v) for k, v in sorted(
                            extra.items())))
                if kind == "counter":
                    out[key] = m.window_value
                elif kind == "gauge":
                    out[key] = m.value
                else:
                    out[key] = m.stats()
        if reset:
            self.reset_window()
        return out

    def reset_window(self):
        for reg in self.children.values():
            reg.reset_window()


class _NullMetric(object):
    """Accepts every metric call and does nothing — the telemetry-off
    stand-in (one shared instance per registry; zero allocation on the
    hot path)."""

    name = "null"
    labels = {}
    value = 0.0
    window_value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def set_fn(self, fn):
        pass

    def observe(self, v):
        pass

    def percentile(self, p):
        return None

    def quantiles(self, ps=(50, 95, 99)):
        return {p: None for p in ps}

    def stats(self):
        return {"count": 0, "sum": 0.0, "min": None, "max": None,
                "mean": None, "p50": None, "p95": None, "p99": None}

    def reset_window(self):
        pass


class NullRegistry(object):
    """Registry with the same surface as MetricsRegistry whose metrics
    are all no-ops — what ``telemetry=False`` swaps in."""

    namespace = "ds_tpu"
    const_labels = {}

    def __init__(self, **_):
        self._metric = _NullMetric()

    def counter(self, name, **labels):
        return self._metric

    def gauge(self, name, **labels):
        return self._metric

    def histogram(self, name, reservoir_size=2048, **labels):
        return self._metric

    def collect(self):
        return iter(())

    def snapshot(self, reset=False):
        return {}

    def reset_window(self):
        pass
