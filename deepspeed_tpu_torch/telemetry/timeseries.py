"""Windowed time-series over the metrics registry — curves, not scalars.

Counterpart of ``deepspeed_tpu/telemetry/timeseries.py`` (pure Python,
the same records).

The registry's windowed snapshots (registry.py) answer "what happened
since the last reset"; a sustained-load run needs that question answered
REPEATEDLY on a fixed cadence, so TTFT/ITL p50/p99, queue depth and slot
occupancy become per-window curves a human (or the regression gate,
loadgen/report.py) can read saturation and p99 drift out of. The
``TimeseriesCollector`` does exactly that: every ``window_seconds`` it
closes the registry's current window into an interval-tagged record and
opens the next one.

Design constraints, matching the rest of the telemetry package:

- BOUNDED MEMORY whatever the run length: records land in a
  ``deque(maxlen=capacity)`` ring — the newest windows win, and
  ``dropped`` counts evictions exactly (a day-long soak holds the same
  few hundred KB a smoke run does).
- ONE window owner: ``sample()`` calls ``registry.snapshot(reset=True)``,
  so while a collector is attached the registry's window state belongs
  to IT. Interleaving ``engine.metrics(reset=True)`` (which resets the
  same windows) mid-run would split a window across two readers —
  callers scrub warmup with ``metrics(reset=True)`` BEFORE
  ``start()`` and read windows from the collector afterwards.
- A stalled loop closes one LONG window, never fabricates empty ones:
  ``tick()`` compares wall clock against the current window's start, so
  a 5-window-long GC pause shows up as one 5x-duration window with its
  real (degraded) stats — which is the honest shape of a stall.

Export: ``windows()`` / ``to_json()`` for the load report, and
``chrome_counter_events()`` — Chrome trace "C" (counter) events that
load into Perfetto alongside the SpanRecorder's span export, so the
queue-depth curve sits under the request tracks that caused it.
"""

import collections
import time


class TimeseriesCollector(object):
    def __init__(self, registry, window_seconds=1.0, capacity=512,
                 clock=time.time):
        if window_seconds <= 0:
            raise ValueError("window_seconds must be > 0, got "
                             "{}".format(window_seconds))
        if capacity < 1:
            raise ValueError("capacity must be >= 1, got "
                             "{}".format(capacity))
        self.registry = registry
        self.window_seconds = window_seconds
        self.capacity = capacity
        self._clock = clock
        self._ring = collections.deque(maxlen=capacity)
        self._idx = 0
        self._window_start = None
        self.dropped = 0

    @property
    def started(self):
        return self._window_start is not None

    def start(self, now=None):
        """Open the first window. Resets the registry's window state so
        the first record covers exactly [start, first sample] — nothing
        accumulated before attach (warmup) leaks in."""
        self._window_start = self._clock() if now is None else now
        self.registry.reset_window()
        return self._window_start

    def tick(self, now=None):
        """Close the current window IF ``window_seconds`` have elapsed
        (auto-starts on the first call). The cheap per-iteration hook a
        driving loop calls every step; returns the closed record or
        None. A stall longer than one window closes ONE long window —
        real degraded stats, not fabricated empties."""
        now = self._clock() if now is None else now
        if self._window_start is None:
            self.start(now)
            return None
        if now - self._window_start < self.window_seconds:
            return None
        return self.sample(now)

    def sample(self, now=None):
        """Force-close the current window into the ring and open the
        next (drivers call this once after their loop exits so the tail
        lands). Each record: window index, absolute start/end seconds,
        duration, and the registry's windowed snapshot — counters as
        window deltas, gauges as at-sample instants, histograms as
        window stats."""
        if self._window_start is None:
            raise RuntimeError("TimeseriesCollector.sample() before "
                               "start()/tick()")
        now = self._clock() if now is None else now
        rec = {
            "index": self._idx,
            "t_start": self._window_start,
            "t_end": now,
            "duration_s": max(now - self._window_start, 1e-9),
            "metrics": self.registry.snapshot(reset=True),
        }
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(rec)
        self._idx += 1
        self._window_start = now
        return rec

    # ------------------------------------------------------------ export

    def windows(self):
        """The retained window records, oldest first."""
        return list(self._ring)

    def to_json(self):
        return {
            "window_seconds": self.window_seconds,
            "capacity": self.capacity,
            "windows_total": self._idx,
            "dropped": self.dropped,
            "windows": self.windows(),
        }

    def chrome_counter_events(self, pid=0, epoch=None):
        """Chrome trace "C" (counter) events — one per numeric metric
        per window, stamped at the window's END. Histogram stats emit
        their p50/p99 as ``<name>_p50`` / ``<name>_p99`` counters.
        ``epoch`` (absolute seconds) anchors ts=0; pass the owning
        SpanRecorder's ``_t0`` to merge with its span export on one
        Perfetto timeline (default: the first retained window's start).
        """
        wins = self.windows()
        if not wins:
            return []
        if epoch is None:
            epoch = wins[0]["t_start"]
        events = []
        for w in wins:
            ts = (w["t_end"] - epoch) * 1e6
            for name in sorted(w["metrics"]):
                v = w["metrics"][name]
                if isinstance(v, dict):
                    for k in ("p50", "p99"):
                        if v.get(k) is not None:
                            events.append({
                                "name": "{}_{}".format(name, k), "ph": "C",
                                "ts": ts, "pid": pid,
                                "args": {"value": float(v[k])}})
                elif isinstance(v, (int, float)):
                    events.append({"name": name, "ph": "C", "ts": ts,
                                   "pid": pid,
                                   "args": {"value": float(v)}})
        return events
