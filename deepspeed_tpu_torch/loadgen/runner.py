"""Open-loop sustained-load driver.

Counterpart of ``deepspeed_tpu/loadgen/runner.py``, driving the port's
``InferenceEngine`` or ``ServingFleet`` through ``submit`` / ``step`` /
``idle``.

OPEN loop means arrivals follow the workload's schedule, not the
engine's pace: ``run()`` calls ``engine.submit()`` the moment each
request's ``arrival_s`` passes, whatever the backlog looks like, and
harvests completions separately. A closed-loop driver (next request
only after the previous answer) self-throttles into exactly the load
the engine can absorb — it can NEVER observe queueing collapse, which
is the one thing a sustained-load harness exists to observe. Under open
loop, saturation shows up honestly: queue depth climbs window over
window, TTFT p99 grows without bound, and past ``max_queue`` the engine
sheds (scheduler.QueueFull) — the runner records each shed as a sample
row rather than dying, because shed traffic IS the signal.

One ``TimeseriesCollector.tick()`` per loop iteration turns the run
into per-window curves; one sample record per request (submitted or
shed) carries the per-request view. ``loadgen/report.py`` folds both
into the SLO report.

CHAOS mode (``chaos_plan``, an ``inference.faults.FaultPlan``): the runner
arms the plan on the engine (``engine.inject_faults``) once
``chaos_after_s`` seconds of the run have passed; the plan's steps count
from there. The engine must be built with ``inference.fault_injection``.
The run then records the engine's recoveries in run-relative seconds
(``recovery``), the faults that fired (``faults_injected``) and
``requests_lost``: accepted requests that reached no terminal phase by
the run's end, which the recovery invariant demands be 0 (reported on
every run). Chaos runs use the real clock: the engine stamps its
recoveries with ``time.time()``. ``chaos_replica`` arms the plan on one
replica of a ``ServingFleet`` (kill a replica mid-run).

ALERTS (``alerts``, a ``telemetry.alerts.AlertManager``): evaluated once
per loop iteration, right after the collector's tick, and at the end;
its rising edges land in ``RunResult.alerts_fired``.
"""

import dataclasses
import time

from deepspeed_tpu_torch.inference.scheduler import QueueFull
from deepspeed_tpu_torch.telemetry import TimeseriesCollector


@dataclasses.dataclass
class RunResult:
    """Everything one sustained run produced: per-request ``samples``
    (dict rows, shed included), the collector's per-window records, and
    the run-level tallies report.py aggregates."""

    samples: list
    windows: list
    collector: object
    wall_s: float
    submitted: int
    completed: int
    shed: int
    tokens_out: int
    # Chaos/recovery facts (empty/zero on fault-free runs): recovery
    # intervals in RUN-RELATIVE seconds (t_start_s/t_end_s/duration_s +
    # error/replayed), and accepted requests that reached NO terminal
    # phase by run end — the recovery invariant demands 0.
    recovery: list = dataclasses.field(default_factory=list)
    requests_lost: int = 0
    faults_injected: int = 0
    # Prefix-cache facts (zero on engines/fleets without one): counter
    # DELTAS across this run — probe hits/misses, bytes the fleet
    # shipped in cross-replica adoptions, and requests whose route was
    # won (or made good) by prefix affinity.
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_bytes_shipped: int = 0
    affinity_routed: int = 0
    # Disaggregated-serving facts (zero on single engines and all-mixed
    # fleets): counter deltas across this run — prompts captured off
    # prefill replicas, re-prefill fallbacks (no decode-capable
    # survivor), and the KV bytes the handoff records shipped.
    handoffs: int = 0
    handoff_fallbacks: int = 0
    handoff_bytes_shipped: int = 0
    # Front-door facts (zero without one): counter deltas across this
    # run — batch sessions parked in the swapped phase to protect a
    # latency budget, and their later bit-identical resumes.
    preemptions: int = 0
    preempt_resumes: int = 0
    # SLO alerting facts (empty without an ``alerts`` manager): every
    # rising-edge record of the run, in firing order (alerts.py's
    # ``fired()`` schema).
    alerts_fired: list = dataclasses.field(default_factory=list)
    # Adapter facts (schema v6, zero/empty on plain GPT-2): which
    # ModelAdapter served the run, per-expert dispatch totals summed
    # across replicas (MoE), the long-context sparse threshold in force
    # (0 = dense), and KV host-offload swap counter deltas — the
    # offloaded-page evidence for long-context capacity runs.
    adapter: str = None
    expert_load: list = dataclasses.field(default_factory=list)
    sparse_decode_threshold: int = 0
    swap_outs: int = 0
    swap_ins: int = 0
    # Paged-KV facts (schema v7; false/zero on dense engines): the page
    # quantum and arena size from ``engine.kv_page_stats()``, the
    # high-water page count across the run, and live-tokens-over-mapped-
    # capacity at that peak (the fragmentation bound).
    paged: bool = False
    kv_page_len: int = 0
    kv_pages_total: int = 0
    kv_pages_peak: int = 0
    kv_page_utilization: float = None


def _sample_row(lr, req, shed_reason=None):
    """One per-request record from the scheduler Request's timestamp
    trail (submit/first-token/finish are stamped by the engine at
    harvest time — the runner only reads them back). ``priority``/
    ``tenant`` come from the workload tags (the request echoes them on
    tagged surfaces; the tags are authoritative for shed rows, which
    never got a request); ``shed_reason`` is the structured QueueFull
    reason for shed rows (None on legacy untagged sheds)."""
    row = {
        "arrival_s": lr.arrival_s,
        "prompt_tokens": int(lr.prompt.size),
        "max_new_tokens": int(lr.max_new_tokens),
        "shed": req is None,
        "shed_reason": shed_reason,
        "rid": None if req is None else req.rid,
        "priority": getattr(lr, "priority", None),
        "tenant": getattr(lr, "tenant", None),
        "ttft_s": None,
        "e2e_s": None,
        "itl_s": None,
        "tokens_out": 0,
        "completed": False,
        "phase": None,
    }
    if req is None:
        return row
    row["phase"] = req.phase
    row["tokens_out"] = len(req.tokens)
    if req.first_token_time is not None:
        row["ttft_s"] = req.first_token_time - req.submit_time
    if req.finish_time is not None:
        # ``completed`` means DONE — a deadline-expired or cancelled
        # request has a finish_time too but never delivered its answer,
        # and must not count toward completion or SLO attainment.
        row["completed"] = req.phase == "done"
        row["e2e_s"] = req.finish_time - req.submit_time
        if req.first_token_time is not None and len(req.tokens) > 1:
            row["itl_s"] = ((req.finish_time - req.first_token_time) /
                            (len(req.tokens) - 1))
    return row


class SustainedRunner(object):
    """Drive ``engine`` with ``spec``'s request stream, open loop.

    The caller owns warmup: compile + ``recompile_detector.mark_warm()``
    + ``engine.metrics(reset=True)`` BEFORE ``run()``, so neither
    compile time nor warmup traffic pollutes the first window (the
    collector owns the registry's window state from ``start()`` on —
    see telemetry/timeseries.py).

    ``clock``/``sleep`` are injectable for tests; ``max_steps`` is a
    hard iteration backstop so a wedged engine fails the harness loudly
    instead of hanging CI.
    """

    def __init__(self, engine, spec, window_seconds=1.0, max_windows=512,
                 collector=None, max_steps=None, clock=time.time,
                 sleep=time.sleep, chaos_plan=None, chaos_after_s=0.0,
                 chaos_replica=None, alerts=None):
        self.engine = engine
        self.spec = spec
        self._clock = clock
        self._sleep = sleep
        self.max_steps = max_steps
        # Alerts and chaos mode (module docstring). Fault steps count from
        # arming; ``chaos_replica`` targets one replica of a fleet.
        self.alerts = alerts
        self.chaos_replica = chaos_replica
        self.chaos_plan = chaos_plan
        self.chaos_after_s = chaos_after_s
        self.collector = collector or TimeseriesCollector(
            engine.telemetry, window_seconds=window_seconds,
            capacity=max_windows, clock=clock)

    def run(self):
        pending = self.spec.requests() if hasattr(self.spec, "requests") \
            else list(self.spec)
        handles = []   # (LoadRequest, Request-or-None, shed_reason) rows
        t0 = self._clock()
        self.collector.start(t0)
        i, steps, shed = 0, 0, 0
        injector = None
        recoveries_at_start = len(getattr(self.engine, "recovery_log", []))
        counters = getattr(self.engine, "counters", None)

        def _counter(name):
            if counters is not None and name in counters:
                return counters[name]
            return 0

        faults_at_start = _counter("faults_injected")
        # Paged-KV poll state: kv_page_stats is the single-engine
        # surface (a fleet aggregates per-replica; its report rows stay
        # at the dense defaults), _live_tokens the utilization numerator.
        page_stats_fn = getattr(self.engine, "kv_page_stats", None)
        live_tokens_fn = getattr(self.engine, "_live_tokens", None)
        pages_peak, page_util = 0, None
        prefix_at_start = {n: _counter(n) for n in (
            "prefix_hits", "prefix_misses", "prefix_bytes_shipped",
            "affinity_routed", "handoffs", "handoff_fallbacks",
            "handoff_bytes_shipped", "preemptions", "preempt_resumes",
            "swap_outs", "swap_ins")}
        while i < len(pending) or not self.engine.idle:
            now = self._clock() - t0
            if (self.chaos_plan is not None and injector is None
                    and now >= self.chaos_after_s):
                if self.chaos_replica is not None:
                    injector = self.engine.inject_faults(
                        self.chaos_plan, replica=self.chaos_replica)
                else:
                    injector = self.engine.inject_faults(self.chaos_plan)
            # Submit everything whose arrival time has passed — open
            # loop: the schedule, not the backlog, decides.
            while i < len(pending) and pending[i].arrival_s <= now:
                lr = pending[i]
                kw = {}
                # Tagged workloads ride the front-door surface; the
                # legacy untagged call shape stays byte-identical.
                if getattr(lr, "priority", None) is not None:
                    kw["priority"] = lr.priority
                if getattr(lr, "tenant", None) is not None:
                    kw["tenant"] = lr.tenant
                try:
                    handles.append((lr, self.engine.submit(
                        lr.prompt, max_new_tokens=lr.max_new_tokens,
                        temperature=lr.temperature, seed=lr.seed,
                        **kw), None))
                except QueueFull as exc:
                    shed += 1
                    handles.append((lr, None,
                                    getattr(exc, "reason", None)))
                i += 1
            if self.engine.idle:
                # Nothing in flight: sleep to the next arrival, but
                # never past the current window's close (the curve must
                # keep its cadence through quiet gaps).
                gap = pending[i].arrival_s - (self._clock() - t0)
                if gap > 0:
                    self._sleep(min(gap, self.collector.window_seconds))
            else:
                self.engine.step()
                steps += 1
                if page_stats_fn is not None:
                    pst = page_stats_fn()
                    if pst is not None and pst["pages_in_use"] > pages_peak:
                        pages_peak = pst["pages_in_use"]
                        if live_tokens_fn is not None:
                            page_util = (live_tokens_fn() /
                                         float(pst["pages_in_use"] *
                                               pst["page_len"]))
                if self.max_steps is not None and steps > self.max_steps:
                    raise RuntimeError(
                        "sustained run exceeded max_steps={} with {} "
                        "requests outstanding — engine wedged?".format(
                            self.max_steps, len(pending) - i +
                            sum(1 for _, r, _ in handles
                                if r is not None and not r.done)))
            self.collector.tick()
            if self.alerts is not None:
                self.alerts.evaluate()
        self.collector.sample()   # flush the tail window
        if self.alerts is not None:
            self.alerts.evaluate()
        wall = self._clock() - t0
        samples = [_sample_row(lr, req, reason)
                   for lr, req, reason in handles]
        # Recovery intervals from this run only, converted to run-
        # relative seconds (the engine stamps time.time(); chaos runs
        # use the real clock — module docstring).
        recovery = [
            {"t_start_s": round(r["t_start"] - t0, 6),
             "t_end_s": round(r["t_end"] - t0, 6),
             "duration_s": r["duration_s"],
             "error": r["error"], "replayed": r["replayed"]}
            for r in getattr(self.engine, "recovery_log",
                             [])[recoveries_at_start:]]
        # The recovery invariant's bottom line: every ACCEPTED request
        # must reach a terminal phase — done, or deliberately shed
        # (expired / cancelled). Anything else was lost by the engine.
        lost = sum(1 for _, r, _ in handles
                   if r is not None and r.phase not in
                   ("done", "expired", "cancelled"))
        # Adapter facts: name + sparse threshold off the (shared)
        # adapter instance; per-expert dispatch gauges summed across
        # replicas out of the registry snapshot (keys look like
        # ``moe_expert_load{expert=2,replica=0}`` on a fleet).
        final_page_stats = (None if page_stats_fn is None
                            else page_stats_fn())
        adapter_obj = getattr(self.engine, "adapter", None)
        expert_load = {}
        reg = getattr(self.engine, "telemetry", None)
        if adapter_obj is not None and reg is not None:
            for key, val in reg.snapshot().items():
                if not key.startswith("moe_expert_load{"):
                    continue
                for part in key[key.index("{") + 1:-1].split(","):
                    k, _, v = part.partition("=")
                    if k == "expert":
                        e = int(v)
                        expert_load[e] = expert_load.get(e, 0.0) + val
        return RunResult(
            samples=samples,
            windows=self.collector.windows(),
            collector=self.collector,
            wall_s=wall,
            submitted=sum(1 for _, r, _ in handles if r is not None),
            completed=sum(1 for s in samples if s["completed"]),
            shed=shed,
            tokens_out=sum(s["tokens_out"] for s in samples),
            recovery=recovery,
            requests_lost=lost,
            alerts_fired=([] if self.alerts is None
                          else self.alerts.fired()),
            faults_injected=(0 if counters is None or
                             "faults_injected" not in counters else
                             counters["faults_injected"] - faults_at_start),
            prefix_hits=_counter("prefix_hits")
            - prefix_at_start["prefix_hits"],
            prefix_misses=_counter("prefix_misses")
            - prefix_at_start["prefix_misses"],
            prefix_bytes_shipped=_counter("prefix_bytes_shipped")
            - prefix_at_start["prefix_bytes_shipped"],
            affinity_routed=_counter("affinity_routed")
            - prefix_at_start["affinity_routed"],
            handoffs=_counter("handoffs")
            - prefix_at_start["handoffs"],
            handoff_fallbacks=_counter("handoff_fallbacks")
            - prefix_at_start["handoff_fallbacks"],
            handoff_bytes_shipped=_counter("handoff_bytes_shipped")
            - prefix_at_start["handoff_bytes_shipped"],
            preemptions=_counter("preemptions")
            - prefix_at_start["preemptions"],
            preempt_resumes=_counter("preempt_resumes")
            - prefix_at_start["preempt_resumes"],
            adapter=(None if adapter_obj is None
                     else getattr(adapter_obj, "name", None)),
            expert_load=[expert_load[e] for e in sorted(expert_load)],
            sparse_decode_threshold=int(
                getattr(adapter_obj, "threshold", 0) or 0),
            swap_outs=_counter("swap_outs")
            - prefix_at_start["swap_outs"],
            swap_ins=_counter("swap_ins")
            - prefix_at_start["swap_ins"],
            paged=final_page_stats is not None,
            kv_page_len=(0 if final_page_stats is None
                         else int(final_page_stats["page_len"])),
            kv_pages_total=(0 if final_page_stats is None
                            else int(final_page_stats["pages_total"])),
            kv_pages_peak=pages_peak,
            kv_page_utilization=page_util)
