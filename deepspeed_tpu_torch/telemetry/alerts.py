"""Declarative SLO alerting over TimeseriesCollector windows.

Counterpart of ``deepspeed_tpu/telemetry/alerts.py`` (host code, kept
near-verbatim).

Dashboards answer "what is the p99 right now?"; an on-call pager needs
the different question "are we burning error budget fast enough that
the SLO will be gone before a human looks?". ``AlertRule`` encodes that
as data and ``AlertManager`` evaluates every rule once per closed
window — no extra sampling thread, no second clock: the collector's
windows (the same records bench and loadgen report) are the only input.

Three rule kinds cover the serving stack's failure shapes:

- ``burn_rate`` — multi-window error-budget burn over a latency
  histogram (TTFT / inter-token attainment). Each window's error rate
  is estimated conservatively from the windowed histogram stats ladder
  (p50 over budget -> at least half the requests missed; p95 over ->
  at least 5%; p99 over -> at least 1%) and divided by the budget
  (1 - objective) to get a burn multiple: burn 1.0 spends the budget
  exactly at the objective's pace, burn 14 is the classic "page now"
  threshold. The rule fires only when BOTH the short and the long
  lookback burn at >= the threshold — the standard two-window guard
  that ignores one bad window but catches a sustained regression fast.
- ``saturation`` — a gauge (queue depth, breaker-open count) at or
  above a threshold for N consecutive windows. One spike is traffic;
  N windows is a trend.
- ``rate`` — a counter's per-second rate (handoff fallbacks, deadline
  sheds) over the last N windows at or above a threshold.

All rules read MergedRegistry snapshots transparently: a series name
matches both its bare form ("queue_depth") and every replica-labelled
form ("queue_depth{replica=0}"), and the WORST series wins — an alert
on "any replica saturated" needs no per-replica rule copies.

``AlertManager`` owns a private ``MetricsRegistry`` (the fleet's
MergedRegistry is read-only) exporting ``alerts_firing`` (live gauge),
``alerts_fired_total`` and per-rule ``alert_active{rule=...}`` gauges
via Prometheus text. ``on_fire`` hooks run OUTSIDE the manager lock on
the rising edge only — the fleet wires the auto-dump there (merged
trace + worst-K autopsies), so a firing rule leaves the evidence on
disk before anyone ssh-es in.
"""

import threading
import time

from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry


def _series_values(metrics, name):
    """Every value of ``name`` in one window's metrics snapshot — the
    bare key plus all labelled variants a MergedRegistry emits
    ("queue_depth", "queue_depth{replica=0}", ...)."""
    prefix = name + "{"
    return [v for k, v in metrics.items()
            if k == name or k.startswith(prefix)]


def _window_error_rate(stats, budget_s):
    """Conservative error-rate estimate for one window from windowed
    histogram stats. Exact per-request attainment is not recoverable
    from a stats dict, so estimate from the percentile ladder: each
    rung is a LOWER bound on the miss fraction, which makes the alert
    err toward firing — the right direction for a pager."""
    if not isinstance(stats, dict) or not stats.get("count"):
        return 0.0

    def _over(p):
        v = stats.get(p)
        return v is not None and v > budget_s

    if _over("p50"):
        return 0.5
    if _over("p95"):
        return 0.05
    if _over("p99"):
        return 0.01
    return 0.0


class AlertRule(object):
    """One declarative rule. ``kind`` selects the evaluator:

    - ``burn_rate``: ``metric`` is a histogram (seconds), ``budget_s``
      the latency budget, ``objective`` the attainment target (0.99 ->
      1% error budget), ``threshold`` the burn multiple, ``short`` /
      ``long`` the two lookbacks in windows.
    - ``saturation``: ``metric`` is a gauge, fires when its max across
      series stays >= ``threshold`` for ``windows`` consecutive
      windows.
    - ``rate``: ``metric`` is a counter, fires when its summed
      per-second rate over the last ``windows`` windows is >=
      ``threshold``.
    """

    KINDS = ("burn_rate", "saturation", "rate")

    def __init__(self, name, kind, metric, threshold, objective=0.99,
                 budget_s=None, short=2, long=12, windows=3):
        if kind not in self.KINDS:
            raise ValueError("unknown alert kind {!r} (one of {})".format(
                kind, self.KINDS))
        if kind == "burn_rate" and budget_s is None:
            raise ValueError("burn_rate rule {!r} needs budget_s".format(
                name))
        if not (0.0 < objective < 1.0):
            raise ValueError("objective must be in (0, 1), got "
                             "{}".format(objective))
        self.name = str(name)
        self.kind = kind
        self.metric = str(metric)
        self.threshold = float(threshold)
        self.objective = float(objective)
        self.budget_s = None if budget_s is None else float(budget_s)
        self.short = max(int(short), 1)
        self.long = max(int(long), 1)
        self.windows = max(int(windows), 1)

    @property
    def lookback(self):
        """Windows of history this rule needs to evaluate."""
        if self.kind == "burn_rate":
            return max(self.short, self.long)
        return self.windows

    # ------------------------------------------------------- evaluation

    def evaluate(self, history):
        """``(firing, evidence)`` over ``history`` (oldest-first window
        records). Evidence is the JSON-safe "why" an autopsy or a dump
        stamps alongside the verdict."""
        if self.kind == "burn_rate":
            return self._eval_burn(history)
        if self.kind == "saturation":
            return self._eval_saturation(history)
        return self._eval_rate(history)

    def _burn_of(self, rec):
        worst = 0.0
        for stats in _series_values(rec["metrics"], self.metric):
            err = _window_error_rate(stats, self.budget_s)
            worst = max(worst, err / (1.0 - self.objective))
        return worst

    def _eval_burn(self, history):
        if len(history) < self.short:
            return False, None
        burns = [self._burn_of(rec) for rec in history]
        short = burns[-self.short:]
        long = burns[-self.long:]
        short_burn = sum(short) / len(short)
        long_burn = sum(long) / len(long)
        firing = (short_burn >= self.threshold and
                  long_burn >= self.threshold)
        return firing, {
            "short_burn": round(short_burn, 4),
            "long_burn": round(long_burn, 4),
            "threshold": self.threshold,
            "budget_s": self.budget_s,
            "objective": self.objective,
        }

    def _eval_saturation(self, history):
        if len(history) < self.windows:
            return False, None
        tail = history[-self.windows:]
        maxima = []
        for rec in tail:
            vals = [v for v in _series_values(rec["metrics"], self.metric)
                    if isinstance(v, (int, float))]
            maxima.append(max(vals) if vals else 0.0)
        firing = all(v >= self.threshold for v in maxima)
        return firing, {
            "maxima": [round(float(v), 4) for v in maxima],
            "threshold": self.threshold,
            "windows": self.windows,
        }

    def _eval_rate(self, history):
        if len(history) < self.windows:
            return False, None
        tail = history[-self.windows:]
        total = 0.0
        span_s = 0.0
        for rec in tail:
            total += sum(v for v in
                         _series_values(rec["metrics"], self.metric)
                         if isinstance(v, (int, float)))
            span_s += rec["duration_s"]
        rate = total / max(span_s, 1e-9)
        return rate >= self.threshold, {
            "rate_per_s": round(rate, 4),
            "total": total,
            "span_s": round(span_s, 4),
            "threshold": self.threshold,
        }

    def to_json(self):
        return {
            "name": self.name, "kind": self.kind, "metric": self.metric,
            "threshold": self.threshold, "objective": self.objective,
            "budget_s": self.budget_s, "short": self.short,
            "long": self.long, "windows": self.windows,
        }


def default_rules(ttft_budget_s=1.0, itl_budget_s=0.25, objective=0.95,
                  burn_threshold=2.0, queue_saturation=32,
                  fallback_rate=1.0, hbm_pressure=0.92):
    """The serving stack's standard rule set — TTFT and inter-token
    burn, queue saturation, breaker-opens, handoff-fallback rate, and
    HBM pressure (the xray ledger's 0..1 fill gauge; it reads 0 when
    capacity is unknown — a CPU round can never fire it). Every knob
    has a keyword so bench and tests can tighten them into firing
    range without inventing rule syntax."""
    return [
        AlertRule("ttft_burn", "burn_rate", "ttft_seconds",
                  burn_threshold, objective=objective,
                  budget_s=ttft_budget_s),
        AlertRule("itl_burn", "burn_rate", "inter_token_seconds",
                  burn_threshold, objective=objective,
                  budget_s=itl_budget_s),
        AlertRule("queue_saturated", "saturation", "queue_depth",
                  queue_saturation, windows=3),
        AlertRule("breaker_open", "saturation", "breaker_open", 1,
                  windows=1),
        AlertRule("handoff_fallbacks", "rate", "handoff_fallbacks",
                  fallback_rate, windows=3),
        AlertRule("hbm_pressure", "saturation", "hbm_pressure",
                  hbm_pressure, windows=3),
    ]


class AlertManager(object):
    """Evaluates a rule set against a TimeseriesCollector, incrementally.

    ``evaluate()`` is cheap and idempotent per window: it processes only
    window records it has not seen (by window index), so the fleet can
    call it from ``_tick()`` on every step without re-scoring history.
    State transitions:

    - not firing -> firing: recorded in ``fired`` (bounded by the
      collector's own ring discipline: one entry per edge, not per
      window), ``alerts_fired_total`` incremented, ``on_fire(rule,
      evidence)`` hooks invoked OUTSIDE the lock.
    - firing -> not firing: the rule leaves ``firing()``; the fired
      record keeps its evidence for the post-mortem.
    """

    def __init__(self, collector, rules, on_fire=None, clock=time.time,
                 history=64):
        self.collector = collector
        self.rules = list(rules)
        self._clock = clock
        self._lock = threading.Lock()
        self._on_fire = list(on_fire or [])
        need = max([r.lookback for r in self.rules] or [1])
        self._history_cap = max(int(history), need)
        self._history = []
        self._last_index = -1
        self._firing = {}
        self._fired = []
        self.telemetry = MetricsRegistry(engine="alerts")
        self.telemetry.gauge("alerts_firing").set_fn(
            lambda: len(self._firing))
        self._fired_total = self.telemetry.counter("alerts_fired_total")
        for rule in self.rules:
            self.telemetry.gauge(
                "alert_active", rule=rule.name).set_fn(
                (lambda name: lambda: 1 if name in self._firing else 0)(
                    rule.name))

    def add_on_fire(self, hook):
        with self._lock:
            self._on_fire.append(hook)

    # ------------------------------------------------------- evaluation

    def evaluate(self):
        """Score every rule against windows closed since the last call.
        Returns the list of (rule, evidence) pairs that FIRED (rising
        edge) this call — normally empty."""
        edges = []
        with self._lock:
            fresh = [rec for rec in self.collector.windows()
                     if rec["index"] > self._last_index]
            if not fresh:
                return []
            for rec in fresh:
                self._last_index = rec["index"]
                self._history.append(rec)
                if len(self._history) > self._history_cap:
                    del self._history[:len(self._history) -
                                      self._history_cap]
                for rule in self.rules:
                    firing, evidence = rule.evaluate(self._history)
                    was = rule.name in self._firing
                    if firing and not was:
                        record = {
                            "rule": rule.name,
                            "kind": rule.kind,
                            "metric": rule.metric,
                            "window_index": rec["index"],
                            "t": rec["t_end"],
                            "evidence": evidence,
                        }
                        self._firing[rule.name] = record
                        self._fired.append(record)
                        self._fired_total.inc()
                        edges.append((rule, record))
                    elif firing and was:
                        self._firing[rule.name]["evidence"] = evidence
                    elif not firing and was:
                        del self._firing[rule.name]
            hooks = list(self._on_fire)
        for rule, record in edges:
            for hook in hooks:
                try:
                    hook(rule, record)
                except Exception:  # noqa: BLE001 - a broken dump hook
                    # must not take down the serving loop it rides.
                    pass
        return edges

    # ----------------------------------------------------------- export

    def firing(self):
        """Currently-asserted alerts: {rule name: latest record}."""
        with self._lock:
            return {name: dict(rec) for name, rec in self._firing.items()}

    def fired(self):
        """Every rising edge seen, oldest first."""
        with self._lock:
            return [dict(rec) for rec in self._fired]

    def to_json(self):
        with self._lock:
            return {
                "rules": [r.to_json() for r in self.rules],
                "firing": sorted(self._firing),
                "fired": [dict(rec) for rec in self._fired],
                "windows_evaluated": self._last_index + 1,
            }
