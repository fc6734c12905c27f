"""Distributed request tracing — propagated context + fleet-wide merge.

Counterpart of ``deepspeed_tpu/telemetry/distributed.py``, the whole
module. The port's engine needs ``TraceContext`` (every ``Request``
carries one) and ``validate_trace`` (the schema gate of
``write_trace``'s file); ``merged_trace`` serves the fleet, which the
port does not have yet.

A SpanRecorder gives each engine a private flight ring; a request
that crosses a front door, a router, a prefill replica, a KV-plane
handoff, a decode replica, and possibly a failover leaves fragments in
four rings that share nothing but wall time. This module adds the two
pieces that turn those fragments into one story:

- ``TraceContext`` — the propagated identity. One context is created
  where the request enters the stack (FrontDoor admission, fleet
  submit, or the scheduler's local fallback) and travels BY REFERENCE
  through every hop: engine submit, handoff spec, orphan respec,
  failover re-submit, TokenStream. It carries the Chrome ``tid`` every
  event rides (so one request reads as one track across all process
  rows) and a shared hop counter: each recorded event consumes the next
  sequence number, so the merged timeline has a TOTAL order that does
  not depend on clocks agreeing. ``itertools.count`` makes ``hop()``
  atomic under the GIL — replica threads, pump threads and the stream
  consumer may all stamp hops concurrently.
- ``merged_trace`` / ``write_merged_trace`` — the fleet-level export.
  Every recorder keeps its own epoch (``SpanRecorder.epoch``); the
  merge re-anchors all rings to the earliest epoch, assigns one Chrome
  ``pid`` per recorder (with ``process_name`` metadata so Perfetto
  shows "replica0", "frontdoor", ...), and pairs ``flow_out``/
  ``flow_in`` args stamped by the emitting sites into Chrome flow
  (``s``/``f``) events with shared numeric ids — the arrows binding a
  handoff donor to its acceptor, a dead owner to the survivor that
  replayed its request, and a prefix-adoption donor to the adopter.

Flow keys are plain strings ("handoff/<tid>/<hop>") minted on the
donor side and carried INSIDE the handoff spec / orphan respec, so the
acceptor stamps the byte-identical key without any registry.

``validate_trace`` is the schema gate: the parser-level contract tests
and ``chip_smoke.py`` call it, and ``write_merged_trace`` refuses to
write a file that would not load in Perfetto. Run
``python -m deepspeed_tpu_torch.telemetry.distributed --self-check`` for
the standalone check.

Everything here is host-side bookkeeping — dict appends and integer
increments. Nothing touches the device, so tracing cannot change what
a step program captures.
"""

import itertools
import json

# tid bases keep the three context origins visually separate in
# Perfetto and collision-free against engine-local rids (small ints):
# a bare fleet submission rides 1_000_000 + fid, a front-door admission
# 2_000_000 + hid. Deterministic — no global counter to drift between
# runs of the same seeded workload.
FLEET_TID_BASE = 1_000_000
FRONTDOOR_TID_BASE = 2_000_000

_VALID_PH = ("X", "i", "C", "M", "s", "f")


class TraceContext(object):
    """Propagated per-request trace identity: the Chrome ``tid`` all of
    the request's events ride plus the shared hop counter. Immutable
    after construction (all attributes bind in ``__init__``); the only
    mutation is ``next()`` on the counter, which is GIL-atomic — safe
    to stamp from replica threads, pump threads and the stream consumer
    at once."""

    __slots__ = ("tid", "origin", "_seq")

    def __init__(self, tid, origin="local", start=0):
        self.tid = int(tid)
        self.origin = str(origin)
        self._seq = itertools.count(start)

    def hop(self):
        """Consume and return the next hop sequence number."""
        return next(self._seq)

    def __repr__(self):
        return "TraceContext(tid={}, origin={!r})".format(
            self.tid, self.origin)


class TraceError(ValueError):
    """A trace object violates the Chrome/Perfetto event schema."""


def merged_trace(recorders, extra_events=None):
    """Merge named recorder rings into one Perfetto-loadable object.

    ``recorders`` maps a process label ("frontdoor", "fleet",
    "replica0", ...) to a SpanRecorder (NullRecorders contribute
    nothing). Each recorder becomes one Chrome ``pid`` (enumeration
    order) with a ``process_name`` metadata row; every event ``ts`` is
    re-anchored from its recorder's private epoch to the earliest epoch
    across the set, so spans from different replicas line up on one
    wall clock. ``flow_out``/``flow_in`` args are paired into ``s``/
    ``f`` flow events (shared numeric id, ``bp: "e"`` on the finish so
    the arrow binds to the enclosing slice). ``extra_events`` (e.g. a
    TimeseriesCollector's ``chrome_counter_events``) are appended
    as-is.
    """
    live = [(label, rec) for label, rec in recorders.items()
            if rec.events()]
    epochs = [rec.epoch for _, rec in live]
    epoch = min(epochs) if epochs else 0.0
    meta, events = [], []
    for pid, (label, rec) in enumerate(live):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": str(label)}})
        shift = (rec.epoch - epoch) * 1e6
        for ev in rec.events():
            ev = dict(ev)
            ev["ts"] = ev["ts"] + shift
            ev["pid"] = pid
            events.append(ev)
    events.sort(key=lambda e: e["ts"])
    events.extend(_flow_events(events))
    if extra_events:
        events.extend(extra_events)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _flow_events(events):
    """Pair ``flow_out``/``flow_in`` args into Chrome flow events.

    The start binds to the END of the emitting span (a handoff arrow
    leaves when the capture finishes, not when it started); the finish
    clamps to >= the start so a clock-skewed acceptor cannot produce a
    backwards arrow Perfetto would reject. Unpaired keys (a handoff
    that fell back, an orphan nobody adopted) produce no arrow — the
    lifecycle events themselves still tell that story.
    """
    outs, ins = {}, {}
    for ev in events:
        args = ev.get("args") or {}
        key = args.get("flow_out")
        if key is not None:
            outs.setdefault(key, ev)
        key = args.get("flow_in")
        if key is not None:
            ins.setdefault(key, ev)
    flows = []
    for fid, key in enumerate(sorted(set(outs) & set(ins)), start=1):
        src, dst = outs[key], ins[key]
        name = "flow/" + str(key).split("/", 1)[0]
        ts_s = src["ts"] + src.get("dur", 0.0)
        flows.append({"name": name, "cat": "flow", "ph": "s", "id": fid,
                      "ts": ts_s, "pid": src["pid"], "tid": src["tid"]})
        flows.append({"name": name, "cat": "flow", "ph": "f", "bp": "e",
                      "id": fid, "ts": max(dst["ts"], ts_s),
                      "pid": dst["pid"], "tid": dst["tid"]})
    return flows


def validate_trace(trace):
    """Raise TraceError unless ``trace`` is a well-formed Chrome
    trace-event object: known phases, complete spans with non-negative
    durations, instants with a scope, ts-sorted events, and every flow
    ``s`` paired with exactly one ``f`` of the same id and name at a
    ts no earlier than the start. Returns the event count so callers
    can assert non-emptiness in one breath."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise TraceError("trace must be a dict with a traceEvents list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise TraceError("traceEvents must be a list")
    starts, finishes = {}, {}
    last_ts = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise TraceError("event {} is not an object".format(i))
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            raise TraceError("event {} has unknown phase {!r}".format(
                i, ph))
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise TraceError("event {} has no name".format(i))
        if "pid" not in ev:
            raise TraceError("event {} has no pid".format(i))
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            raise TraceError("event {} ({}) has no numeric ts".format(
                i, ev["name"]))
        if last_ts is not None and ts < last_ts:
            raise TraceError(
                "events not ts-sorted: {} at index {} goes backwards"
                .format(ev["name"], i))
        last_ts = ts
        if ph != "C" and "tid" not in ev:
            # Counter tracks are per-process (pid only) in the Chrome
            # format; every other phase rides a request/thread track.
            raise TraceError("event {} ({}) has no tid".format(
                i, ev["name"]))
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise TraceError(
                    "complete event {} needs a non-negative dur".format(
                        ev["name"]))
        elif ph == "i":
            if "s" not in ev:
                raise TraceError(
                    "instant {} needs a scope ('s')".format(ev["name"]))
        elif ph in ("s", "f"):
            fid = ev.get("id")
            if fid is None:
                raise TraceError(
                    "flow event {} has no id".format(ev["name"]))
            side = starts if ph == "s" else finishes
            if fid in side:
                raise TraceError(
                    "flow id {} has duplicate {!r} events".format(
                        fid, ph))
            side[fid] = ev
    for fid, ev in starts.items():
        other = finishes.get(fid)
        if other is None:
            raise TraceError(
                "flow id {} ({}) has a start but no finish".format(
                    fid, ev["name"]))
        if other["name"] != ev["name"]:
            raise TraceError(
                "flow id {} pairs {!r} with {!r}".format(
                    fid, ev["name"], other["name"]))
        if other["ts"] < ev["ts"]:
            raise TraceError(
                "flow id {} finishes before it starts".format(fid))
    for fid in finishes:
        if fid not in starts:
            raise TraceError(
                "flow id {} has a finish but no start".format(fid))
    return len(events)


def write_merged_trace(path, recorders, extra_events=None):
    """``merged_trace`` -> validate -> write. Refusing to write an
    invalid file is the point: a trace that will not load in Perfetto
    is worse than no trace, because the operator only reaches for it
    mid-incident."""
    trace = merged_trace(recorders, extra_events=extra_events)
    validate_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return path


def _self_check():
    """Deterministic schema round-trip: build a two-recorder trace with
    a handoff flow pair, validate it, and confirm the validator rejects
    a broken variant, so a schema regression fails here, not in an
    incident."""
    from deepspeed_tpu_torch.telemetry.tracing import SpanRecorder

    ticks = itertools.count()

    def clock():
        return next(ticks) * 0.001

    donor = SpanRecorder(capacity=64, clock=clock)
    acceptor = SpanRecorder(capacity=64, clock=clock)
    ctx = TraceContext(FLEET_TID_BASE + 7, origin="selfcheck")
    key = "handoff/{}/{}".format(ctx.tid, 0)
    donor.span("request/prefill", start=clock(), tid=ctx.tid,
               hop=ctx.hop())
    donor.instant("request/handoff", tid=ctx.tid, hop=ctx.hop(),
                  flow_out=key)
    acceptor.instant("request/handoff_in", tid=ctx.tid, hop=ctx.hop(),
                     flow_in=key)
    acceptor.span("request/decode", start=clock(), tid=ctx.tid,
                  hop=ctx.hop())
    trace = merged_trace({"donor": donor, "acceptor": acceptor})
    n = validate_trace(trace)
    phases = [e["ph"] for e in trace["traceEvents"]]
    assert phases.count("s") == 1 and phases.count("f") == 1, \
        "flow pair missing from merged trace"
    broken = {"traceEvents": [dict(e) for e in trace["traceEvents"]]}
    for ev in broken["traceEvents"]:
        if ev["ph"] == "f":
            ev["id"] = 999
    try:
        validate_trace(broken)
    except TraceError:
        pass
    else:
        raise AssertionError("validator accepted an unpaired flow")
    print("trace schema self-check: OK ({} events)".format(n))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_self_check())
