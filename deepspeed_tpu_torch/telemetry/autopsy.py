"""Request autopsy — "why was this request slow?" as a data structure.

Counterpart of ``deepspeed_tpu/telemetry/autopsy.py`` (host code, kept
near-verbatim).

``build_autopsy`` gathers every event a request's TraceContext stamped
across a set of recorders (FrontDoor ring, fleet ring, one ring per
replica), orders them by hop sequence number (the total order the
context minted — immune to clock skew between rings), and folds them
into the structured answer an operator actually asks for:

- ``hops`` — the ordered timeline: one row per event with the process
  it landed in, the re-anchored wall offset, and the span duration
  where there is one.
- ``admission`` — the admission predictor's evidence at decision time
  (completion rate, token rate, service floor, predicted TTFT) copied
  off the ``request/admitted`` / ``request/shed`` event, plus the
  router's per-replica scores off ``request/routed`` — the inputs
  behind the verdict, not a post-hoc reconstruction.
- ``terminal`` — what ended the request: ``done``, ``shed`` (with the
  structured reason), ``expired``, ``cancelled``, or nothing yet
  (``in-flight``). ``lost_then_replayed`` is set when the request was
  replayed by a recovery or re-homed by a failover before finishing —
  the "it finished, but only because resilience caught it" flag.
- ``hop_gaps`` — hop sequence numbers that were consumed but whose
  events are missing from every gathered ring. A non-empty list means
  the autopsy is INCOMPLETE (ring overflow — check the
  ``trace_spans_dropped`` counter), and the failover-chain assertions
  in bench refuse to pass on it.

``FrontDoor.explain(hid)`` / ``fleet.explain(fid)`` /
``engine.explain(rid)`` are thin wrappers: resolve the handle to its
TraceContext, collect the recorder set, call ``build_autopsy``.
"""

_TERMINAL_NAMES = {
    "request/expired": "expired",
    "request/cancelled": "cancelled",
}

# Events that mean "resilience moved this request", not "the request
# progressed": a replay after recovery, or a failover re-home.
_RESCUE_NAMES = ("request/replayed", "request/failover_in")


def gather_events(recorders, tid):
    """All events stamped with ``tid`` across ``recorders`` (a mapping
    label -> recorder), each as ``(label, epoch, event)``. Hop order is
    applied by the caller — gathering is ring order."""
    rows = []
    for label, rec in recorders.items():
        epoch = rec.epoch
        for ev in rec.events():
            if ev.get("tid") == tid:
                rows.append((str(label), epoch, ev))
    return rows


def build_autopsy(recorders, tid):
    """Fold every event of one trace ``tid`` into the structured
    autopsy described in the module docstring. Events without a hop
    stamp (pre-distributed-tracing emitters) sort after stamped ones
    by re-anchored time, so a partially-instrumented path still yields
    a readable timeline."""
    rows = gather_events(recorders, tid)
    epochs = [rec.epoch for rec in recorders.values() if rec.events()]
    epoch = min(epochs) if epochs else 0.0

    def _key(row):
        label, rec_epoch, ev = row
        hop = (ev.get("args") or {}).get("hop")
        ts = ev["ts"] + (rec_epoch - epoch) * 1e6
        return (0, hop, ts) if hop is not None else (1, 0, ts)

    rows.sort(key=_key)
    hops = []
    admission = None
    routing = None
    terminal = {"cause": "in-flight", "reason": None}
    replays = 0
    failovers = 0
    preemptions = 0
    handoffs = 0
    done_span = None
    for label, rec_epoch, ev in rows:
        args = dict(ev.get("args") or {})
        hop = args.pop("hop", None)
        t_ms = (ev["ts"] + (rec_epoch - epoch) * 1e6) / 1e3
        hops.append({
            "hop": hop,
            "site": label,
            "name": ev["name"],
            "t_ms": round(t_ms, 3),
            "dur_ms": (round(ev["dur"] / 1e3, 3)
                       if ev.get("ph") == "X" else None),
            "args": args,
        })
        name = ev["name"]
        if name in ("request/admitted", "request/shed") and \
                admission is None:
            admission = {k: v for k, v in args.items()
                         if k not in ("flow_out", "flow_in")}
        if name == "request/routed" and routing is None:
            routing = {k: v for k, v in args.items()
                       if k not in ("flow_out", "flow_in")}
        if name == "request/shed":
            terminal = {"cause": "shed",
                        "reason": args.get("reason")}
        elif name in _TERMINAL_NAMES:
            terminal = {"cause": _TERMINAL_NAMES[name], "reason": None}
        elif name == "request" and ev.get("ph") == "X":
            done_span = args
            phase = args.get("phase")
            if phase == "done":
                terminal = {"cause": "done", "reason": None}
            elif phase in ("cancelled", "expired"):
                terminal = {"cause": phase, "reason": None}
        elif name == "request/replayed":
            replays += 1
        elif name == "request/failover_in":
            failovers += 1
        elif name == "request/preempted":
            preemptions += 1
        elif name in ("request/handoff", "request/handoff_in"):
            handoffs += 1
    stamped = sorted(h["hop"] for h in hops if h["hop"] is not None)
    gaps = []
    if stamped:
        have = set(stamped)
        gaps = [n for n in range(stamped[0], stamped[-1] + 1)
                if n not in have]
    rescued = (replays + failovers) > 0
    return {
        "tid": tid,
        "hops": hops,
        "admission": admission,
        "routing": routing,
        "terminal": dict(terminal,
                         lost_then_replayed=bool(
                             rescued and terminal["cause"] == "done")),
        "replays": replays,
        "failovers": failovers,
        "preemptions": preemptions,
        "handoff_events": handoffs,
        "lifetime": done_span,
        "hop_gaps": gaps,
        "spans_dropped": {label: rec.dropped
                          for label, rec in recorders.items()
                          if rec.dropped},
    }


def worst_requests(autopsies, k=4):
    """Rank autopsies worst-first for the auto-dump: unterminated and
    rescued requests ahead of clean ones, then by end-to-end span where
    known. ``autopsies`` is an iterable of ``build_autopsy`` results."""
    def _badness(a):
        unfinished = a["terminal"]["cause"] in ("in-flight",)
        shed_like = a["terminal"]["cause"] in ("shed", "expired",
                                               "cancelled")
        rescued = a["replays"] + a["failovers"]
        span_ms = 0.0
        if a["hops"]:
            span_ms = a["hops"][-1]["t_ms"] - a["hops"][0]["t_ms"]
        return (unfinished, shed_like, rescued, len(a["hop_gaps"]),
                span_ms)

    return sorted(autopsies, key=_badness, reverse=True)[:max(int(k), 0)]
