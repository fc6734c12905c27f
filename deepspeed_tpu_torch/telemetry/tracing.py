"""Per-request trace spans — Chrome trace-event JSON + JSONL flight ring.

Counterpart of ``deepspeed_tpu/telemetry/tracing.py``; the clock is
injectable, so a recorder fed the same clock gives the same JSON as the
JAX package's.

The scheduler's request lifecycle (submit -> queued -> prefilling ->
decoding -> done/cancelled) and the engine's step phases (prefill lane,
decode chunk, harvest) are recorded as SPANS into a bounded ring. Two
export shapes read the same ring:

- ``chrome_trace()`` / ``write_chrome_trace(path)``: the Chrome
  trace-event format (a ``{"traceEvents": [...]}`` object of "X"
  complete events, ts/dur in microseconds, sorted by ts) — loadable
  directly in Perfetto / chrome://tracing. Request lifecycle phases ride
  tid=rid so one request reads as one track; engine step phases ride
  tid=0.
- ``jsonl_lines()`` / ``write_jsonl(path)``: one JSON object per event,
  newest-last — the flight recorder a crash handler or a log shipper
  tails.

The ring is a ``collections.deque(maxlen=capacity)``: memory is bounded
whatever the run length, and the newest events win (a flight recorder
keeps the crash, not the boot). Span counts per name are tracked
EXACTLY (counters, not ring occupancy) so a report can say how many
spans each phase emitted even after the ring wrapped.

``NullRecorder`` is the telemetry-off stand-in: same surface, no work.
"""

import collections
import json
import time


class SpanRecorder(object):
    def __init__(self, capacity=4096, clock=time.time, pid=0):
        if capacity < 1:
            raise ValueError("trace ring capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._pid = pid
        self._ring = collections.deque(maxlen=capacity)
        self._counts = {}
        self._t0 = clock()
        self.dropped = 0

    # ------------------------------------------------------------ record

    def _emit(self, ev):
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(ev)
        name = ev["name"]
        self._counts[name] = self._counts.get(name, 0) + 1

    def span(self, name, start, end=None, tid=0, **args):
        """One complete ("X") span: ``start``/``end`` are wall-clock
        seconds (``end`` defaults to now). Args must be JSON-safe."""
        if end is None:
            end = self._clock()
        self._emit({
            "name": name,
            "ph": "X",
            "ts": (start - self._t0) * 1e6,
            "dur": max(end - start, 0.0) * 1e6,
            "pid": self._pid,
            "tid": tid,
            "args": args,
        })

    def instant(self, name, tid=0, **args):
        self._emit({
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": (self._clock() - self._t0) * 1e6,
            "pid": self._pid,
            "tid": tid,
            "args": args,
        })

    class _Timed(object):
        __slots__ = ("rec", "name", "tid", "args", "_start")

        def __init__(self, rec, name, tid, args):
            self.rec = rec
            self.name = name
            self.tid = tid
            self.args = args
            self._start = None

        def __enter__(self):
            self._start = self.rec._clock()
            return self

        def __exit__(self, *exc):
            self.rec.span(self.name, self._start, tid=self.tid, **self.args)
            return False

    def timed(self, name, tid=0, **args):
        """Context manager: records one span around the body."""
        return self._Timed(self, name, tid, args)

    # ------------------------------------------------------------ export

    @property
    def epoch(self):
        """Wall-clock second this recorder's ts=0 maps to. The fleet
        merge (telemetry/distributed.py) re-anchors every ring to one
        shared epoch with this."""
        return self._t0

    def span_counts(self):
        """Exact per-name event counts since construction (survives ring
        wraparound)."""
        return dict(self._counts)

    def events(self):
        return list(self._ring)

    def chrome_trace(self):
        """Perfetto-loadable trace object: events sorted by ts (the
        ring appends in wall order already, but spans are recorded at
        their END — a long span that finishes after a short one started
        later would otherwise appear out of order)."""
        events = sorted(self._ring, key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")
        return path

    def jsonl_lines(self):
        return [json.dumps(e) for e in self._ring]

    def write_jsonl(self, path):
        with open(path, "w") as f:
            for line in self.jsonl_lines():
                f.write(line)
                f.write("\n")
        return path


class NullRecorder(object):
    """Telemetry-off stand-in: same surface, no allocation, no work."""

    capacity = 0
    dropped = 0
    epoch = 0.0

    class _Null(object):
        __slots__ = ()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    _null = _Null()

    def span(self, name, start, end=None, tid=0, **args):
        pass

    def instant(self, name, tid=0, **args):
        pass

    def timed(self, name, tid=0, **args):
        return self._null

    def span_counts(self):
        return {}

    def events(self):
        return []

    def chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path):
        raise RuntimeError("telemetry is disabled: no trace to write")

    def jsonl_lines(self):
        return []

    def write_jsonl(self, path):
        raise RuntimeError("telemetry is disabled: no trace to write")
