"""The front door: the SLO-aware layer callers talk to.

Counterpart of ``deepspeed_tpu/inference/frontdoor/frontdoor.py``.

One FrontDoor wraps ONE target — an InferenceEngine or a ServingFleet —
and exposes the same duck-typed driver surface the loadgen runner
already speaks (submit/step/idle/counters/telemetry/recovery_log/
inject_faults), plus ``stream()``. Everything it adds is HOST-side
policy; no new device code, so compile_count stays exactly what the
target's own contract pins (one captured program per key met, no capture
after warm-up).

Layering:

  submit()  — resolve priority class + tenant, tenant token bucket,
              per-lane cap, deadline feasibility, TTFT-budget admission
              (shed reasons: rate_limit / frontdoor_full / deadline /
              slo — each a structured QueueFull with a CLASS-AWARE
              retry_after_s hint).
  _dispatch — strict priority tiers (latency classes before throughput
              classes) with a weighted fair queue across (class, tenant)
              lanes inside a tier; batch enters the target only while
              the target queue is empty (slots may saturate, the FIFO
              queue in front of interactive prefill may not) or while
              the warm predictor says a hypothetical interactive
              arrival would still meet headroom * budget.
  preempt   — when a latency admission would miss budget, preemptible
              decoding work parks in the kv_hierarchy's ``swapped``
              phase (engine.preempt) and is held there until the
              latency backlog clears; resume is bit-identical by the
              positional-rng contract.

THREADING: One RLock serializes
every mutation AND every target call (engines demand external
serialization; the fleet's own locks nest safely under ours because we
only enter the fleet through its public surface). All instance
attributes are bound once in __init__ and mutated strictly IN PLACE
afterwards — scalar run-state lives inside dicts for exactly that
reason.
"""

import collections
import itertools
import threading
import time

from deepspeed_tpu_torch.inference.frontdoor.admission import AdmissionController
from deepspeed_tpu_torch.inference.frontdoor.classes import (
    FrontDoorConfig,
    TokenBucket,
)
from deepspeed_tpu_torch.inference.frontdoor.stream import TokenStream
from deepspeed_tpu_torch.inference.resilience import EngineDeadError, EngineDraining
from deepspeed_tpu_torch.inference.scheduler import QueueFull, RETRY_AFTER_CAP_S
from deepspeed_tpu_torch.telemetry import MetricsRegistry, prometheus_text
from deepspeed_tpu_torch.telemetry.autopsy import build_autopsy
from deepspeed_tpu_torch.telemetry.distributed import (
    FRONTDOOR_TID_BASE,
    TraceContext,
    write_merged_trace,
)
from deepspeed_tpu_torch.telemetry.tracing import NullRecorder, SpanRecorder


class FrontDoorHandle(object):
    """Caller-side handle for one front-door request.

    Request-compatible read surface (rid/phase/tokens/submit_time/
    first_token_time/finish_time/done) so the loadgen runner and the
    TokenStream read it exactly like an engine Request or FleetRequest.
    ``submit_time`` is the FRONT-DOOR arrival — deferral spent in a
    front-door lane shows up honestly in TTFT, not hidden upstream of
    the measurement."""

    __slots__ = ("hid", "prompt", "max_new_tokens", "kw", "priority",
                 "tenant", "deadline", "submit_time", "dispatch_time",
                 "preempt_count", "trace", "_req", "_local_phase",
                 "_finish_time")

    def __init__(self, hid, prompt, max_new_tokens, kw, priority, tenant,
                 deadline, now, trace=None):
        self.hid = hid
        self.trace = trace if trace is not None else TraceContext(
            FRONTDOOR_TID_BASE + hid, origin="frontdoor")
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.kw = kw                  # sampling params forwarded verbatim
        self.priority = priority
        self.tenant = tenant
        self.deadline = deadline      # absolute wall clock, None = none
        self.submit_time = now
        self.dispatch_time = None     # when the target accepted it
        self.preempt_count = 0
        self._req = None              # engine Request / FleetRequest
        self._local_phase = None      # pre-dispatch verdicts only
        self._finish_time = None

    @property
    def rid(self):
        return self.hid if self._req is None else self._req.rid

    @property
    def phase(self):
        if self._req is not None:
            return self._req.phase
        return self._local_phase or "pending"

    @property
    def tokens(self):
        return [] if self._req is None else self._req.tokens

    @property
    def first_token_time(self):
        return None if self._req is None else self._req.first_token_time

    @property
    def finish_time(self):
        if self._req is not None:
            return self._req.finish_time
        return self._finish_time

    @property
    def done(self):
        if self._req is not None:
            return self._req.done
        return self._local_phase in ("expired", "cancelled", "failed")

    def _settle(self, phase, now):
        """Terminal verdict for a handle the target never saw."""
        self._local_phase = phase
        self._finish_time = now


class FrontDoor(object):
    """Streaming, SLO-aware admission layer over one engine or fleet."""

    # Every attribute is bound in __init__ and mutated in place only;
    # nothing is consumer-owned.
    _THREAD_OWNED = frozenset()

    def __init__(self, target, config=None, clock=time.time,
                 sleep=time.sleep):
        if config is None:
            config = FrontDoorConfig()
        elif not isinstance(config, FrontDoorConfig):
            config = FrontDoorConfig.from_dict(config)
        self.config = config
        self.target = target
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.RLock()
        self._is_fleet = hasattr(target, "replicas")
        self._classes = {c.name: c for c in config.classes}
        self._tenant_policies = {t.name: t for t in config.tenants}
        budgets = [c.budget_s for c in config.classes if c.is_latency]
        self._strictest_budget_s = min(budgets) if budgets else None
        self._slot_total = self._count_slots()
        self._can_preempt = self._offload_enabled()
        # Per-(class, tenant) pending lanes, WFQ virtual service, lazily
        # created tenant buckets. Mutated in place only.
        self._lanes = {}
        self._served = {}
        self._buckets = {}
        self._inflight = []     # dispatched, not yet terminal
        self._preempted = []    # parked in swapped under our hold
        self._finished = []     # terminal handles awaiting harvest()
        self._hids = itertools.count()
        self._admission = AdmissionController(
            alpha=config.ewma_alpha, slots=self._slot_total, clock=clock)
        # Run-state scalars and per-class/per-reason tallies live in
        # dicts so methods never REBIND an attribute outside __init__.
        self._stats = {"admitted": 0, "dispatched": 0, "sheds": 0,
                       "deferrals": 0, "expired": 0, "preemptions": 0,
                       "preempt_releases": 0, "completed": 0}
        self._admissions_by = {}    # (class, tenant) -> count
        self._sheds_by = {}         # (class, tenant, reason) -> count
        self._preempts_by = {}      # class -> count
        # The front door's OWN registry (the target's stays untouched;
        # ``telemetry`` below returns the TARGET registry so the
        # runner's TimeseriesCollector keeps seeing engine histograms).
        self.registry = MetricsRegistry(engine="frontdoor")
        # The front door's OWN ring: admission verdicts (with the
        # predictor's evidence at decision time), dispatches, lane
        # expiries — the first hops of every request's distributed
        # trace. Follows the target's telemetry switch.
        self.tracer = (SpanRecorder(capacity=2048)
                       if getattr(target.config, "telemetry", False)
                       else NullRecorder())

    # ------------------------------------------------------ target probes

    def _count_slots(self):
        if self._is_fleet:
            return sum(rep.engine.config.max_slots
                       for rep in self.target.replicas)
        return self.target.config.max_slots

    def _page_stats(self):
        """Aggregated kv_page_stats() across the target's engines, or
        None when no engine serves a paged pool (dense targets, and
        engines without the hook)."""
        if self._is_fleet:
            engines = [rep.engine for rep in self.target.replicas]
        else:
            engines = [self.target]
        stats = [s for s in (getattr(e, "kv_page_stats", lambda: None)()
                             for e in engines) if s is not None]
        if not stats:
            return None
        return {
            "pages_available": sum(s["pages_available"] for s in stats),
            "mean_reservation_pages": max(
                1.0, sum(s["mean_reservation_pages"] for s in stats)
                / len(stats)),
        }

    def _capacity_bound(self):
        """Concurrent-session capacity the admission predictor and the
        cold batch gate reason against. Dense targets: the static slot
        total. PAGED targets: pages AVAILABLE (free minus outstanding
        reservations) over the mean per-session page reservation — the
        number of admissible sessions the page budget actually carries,
        which under long-context mixes is far below (or above) the slot
        count. Occupied slots with few live pages no longer read as
        exhausted capacity."""
        stats = self._page_stats()
        if stats is None:
            return self._slot_total
        return max(1, int(stats["pages_available"]
                          / stats["mean_reservation_pages"]))

    def _offload_enabled(self):
        if self._is_fleet:
            return any(rep.engine.config.host_offload
                       for rep in self.target.replicas)
        return bool(self.target.config.host_offload)

    def _queue_depth(self):
        """Requests QUEUED at the target (not running) — what a new
        latency arrival would wait behind in the target's FIFO."""
        if self._is_fleet:
            return sum(rep.queue_depth for rep in self.target.replicas
                       if rep.alive)
        return len(self.target._scheduler.queue)

    @property
    def _threaded(self):
        """Started fleets step themselves; we must not hold our lock
        while their step() sleeps."""
        return self._is_fleet and getattr(self.target, "_started", False)

    # -------------------------------------------------------- resolution

    def _resolve_class(self, name):
        if name is None:
            name = self.config.default_class
        cls = self._classes.get(name)
        if cls is None:
            raise ValueError(
                "unknown priority class {!r} (configured: {})".format(
                    name, sorted(self._classes)))
        return cls

    def _resolve_tenant(self, name):
        if name is None:
            name = self.config.default_tenant
        return name, self._tenant_policies.get(name)

    def _tenant_weight(self, tname):
        pol = self._tenant_policies.get(tname)
        return pol.weight if pol is not None else 1.0

    # ----------------------------------------------------------- helpers

    def _pending_total(self):
        return sum(len(lane) for lane in self._lanes.values())

    def _latency_pending(self):
        return sum(len(lane) for (cn, _), lane in self._lanes.items()
                   if self._classes[cn].is_latency)

    def _work_ahead(self, cls):
        """Requests that reach a target slot before a NEW arrival of
        ``cls``: the target's queue plus every pending latency-lane
        handle; a throughput-class arrival also waits behind pending
        batch."""
        depth = self._queue_depth()
        if cls.is_latency:
            return depth + self._latency_pending()
        return depth + self._pending_total()

    def _observe(self):
        counters = getattr(self.target, "counters", None)
        if counters is None:
            return
        self._admission.observe_poll(counters["requests_completed"],
                                     counters["tokens_out"])
        # Paged targets: capacity floats with the page budget — refresh
        # the predictor's session-capacity input each poll (dense
        # targets return the static slot total; a no-op update).
        self._admission.update_slots(self._capacity_bound())

    def _predictor_evidence(self):
        """The admission predictor's state RIGHT NOW — copied onto the
        admitted/shed trace event so an autopsy shows the inputs the
        verdict was computed from, not a later reconstruction."""
        a = self._admission
        return {
            "predictor_cold": a.cold,
            "completion_rate": a._rate,
            "token_rate": a._token_rate,
            "service_base_s": a._service_base,
        }

    def _shed(self, reason, cls, tname, message, retry=None, ctx=None):
        """Structured rejection: count it, label it, and raise a
        QueueFull whose retry_after_s is the CLASS's own hint (never
        another class's backpressure) clamped like the scheduler's."""
        self._stats["sheds"] += 1
        key = (cls.name, tname, reason)
        self._sheds_by[key] = self._sheds_by.get(key, 0) + 1
        self.registry.counter("frontdoor_sheds", priority=cls.name,
                              tenant=tname, reason=reason).inc()
        hint = retry if retry is not None \
            else self._admission.retry_hint_s(cls.name)
        if hint is not None:
            hint = round(min(max(float(hint), 0.0), RETRY_AFTER_CAP_S), 4)
        if ctx is not None:
            self.tracer.instant(
                "request/shed", tid=ctx.tid, hop=ctx.hop(),
                reason=reason, priority=cls.name, tenant=tname,
                retry_after_s=hint, queue_depth=self._pending_total(),
                **self._predictor_evidence())
        raise QueueFull(message,
                        queue_depth=self._pending_total(),
                        retry_after_s=hint, priority=cls.name,
                        tenant=tname, reason=reason)

    # ------------------------------------------------------------ submit

    def submit(self, prompt, max_new_tokens=None, priority=None,
               tenant=None, deadline_ms=None, **kw):
        """Admit one request; returns a FrontDoorHandle. Sheds raise a
        structured scheduler.QueueFull carrying ``reason`` (rate_limit /
        frontdoor_full / deadline / slo), the submitting class/tenant,
        and that class's own retry_after_s hint. ``kw`` (temperature,
        seed, top_k, ...) is forwarded to the target verbatim at
        dispatch time."""
        with self._lock:
            cls = self._resolve_class(priority)
            tname, policy = self._resolve_tenant(tenant)
            now = self._clock()
            # The trace context exists BEFORE the first verdict: a shed
            # is as much a lifecycle event as an admission, and the
            # autopsy of a shed request starts here.
            hid = next(self._hids)
            ctx = TraceContext(FRONTDOOR_TID_BASE + hid,
                               origin="frontdoor")
            self._observe()
            if policy is not None and policy.rate is not None:
                bucket = self._buckets.get(tname)
                if bucket is None:
                    bucket = TokenBucket(policy.rate, policy.bucket_burst,
                                         now)
                    self._buckets[tname] = bucket
                if not bucket.take(now):
                    self._shed(
                        "rate_limit", cls, tname,
                        "tenant {!r} over its {:.3g} req/s rate "
                        "limit".format(tname, policy.rate),
                        retry=bucket.retry_after(now), ctx=ctx)
            lane = self._lanes.setdefault((cls.name, tname),
                                          collections.deque())
            if len(lane) >= cls.max_pending:
                self._shed(
                    "frontdoor_full", cls, tname,
                    "front-door lane {}/{} at max_pending={}".format(
                        cls.name, tname, cls.max_pending), ctx=ctx)
            mnt = max_new_tokens
            if mnt is None:
                mnt = self._default_max_new()
            deadline = None
            eta = None
            pred = None
            if deadline_ms is not None:
                if deadline_ms <= 0:
                    raise ValueError("deadline_ms must be > 0, got "
                                     "{}".format(deadline_ms))
                deadline = now + deadline_ms / 1e3
                eta = self._admission.predict_e2e_s(
                    self._work_ahead(cls), mnt)
                if eta is not None and eta > deadline_ms / 1e3:
                    self._shed(
                        "deadline", cls, tname,
                        "predicted completion {:.3f}s exceeds deadline "
                        "{:.3f}s — shedding at submit beats burning a "
                        "slot on a missed deadline".format(
                            eta, deadline_ms / 1e3), ctx=ctx)
            if cls.is_latency:
                pred = self._admission.predict_ttft_s(
                    self._work_ahead(cls))
                if pred is not None and pred > cls.budget_s:
                    # Budget at risk: park preemptible batch first, then
                    # re-predict — preemption IS the mechanism that buys
                    # the budget back.
                    if self._maybe_preempt(cls):
                        pred = self._admission.predict_ttft_s(
                            self._work_ahead(cls))
                    if pred is not None and pred > cls.budget_s \
                            and cls.shed_on_budget:
                        self._shed(
                            "slo", cls, tname,
                            "predicted TTFT {:.3f}s exceeds the {} "
                            "budget {:.3f}s even after "
                            "preemption".format(pred, cls.name,
                                                cls.budget_s), ctx=ctx)
            h = FrontDoorHandle(hid, prompt, mnt, dict(kw),
                                cls.name, tname, deadline, now, trace=ctx)
            lane.append(h)
            self._stats["admitted"] += 1
            akey = (cls.name, tname)
            self._admissions_by[akey] = self._admissions_by.get(akey,
                                                                0) + 1
            self.registry.counter("frontdoor_admissions",
                                  priority=cls.name, tenant=tname).inc()
            self.tracer.instant(
                "request/admitted", tid=ctx.tid, hop=ctx.hop(),
                hid=hid, priority=cls.name, tenant=tname,
                work_ahead=self._work_ahead(cls),
                predicted_ttft_s=pred, predicted_e2e_s=eta,
                deadline_ms=deadline_ms,
                **self._predictor_evidence())
            self._dispatch()
            return h

    def _default_max_new(self):
        if self._is_fleet:
            for rep in self.target.replicas:
                return rep.engine.config.max_new_tokens
            return 16
        return self.target.config.max_new_tokens

    # ------------------------------------------------------------ stream

    def stream(self, prompt, **kw):
        """Submit + per-token iterator: yields token ids as they
        harvest, bit-identical (order and values) to what a batch
        harvest of the same submission returns — across failover,
        preemption and resume. Close early to cancel."""
        handle = self.submit(prompt, **kw)
        return self.stream_for(handle)

    def stream_for(self, handle):
        """Wrap an existing handle in a TokenStream (one consumer)."""
        return TokenStream(handle, pump=self._pump_stream,
                           poll_s=self.config.stream_poll_s,
                           cancel=lambda: self.cancel(handle),
                           tracer=self.tracer)

    def _pump_stream(self):
        """Make progress for a blocked stream consumer. Returns whether
        this call itself advanced the target (False = someone else is
        stepping; the stream should sleep its poll)."""
        if self._threaded:
            with self._lock:
                self._dispatch()
                self._reap()
            return False
        with self._lock:
            self._dispatch()
            stepped = False
            if not self.target.idle:
                self.target.step()
                stepped = True
            self._reap()
            self._dispatch()
        return stepped

    # ---------------------------------------------------------- dispatch

    def _dispatch(self):
        """Push pending work into the target: latency tiers first,
        weighted-fair across (class, tenant) lanes inside a tier, batch
        gated so it saturates slots without burying the target queue.
        Called under self._lock only."""
        self._observe()
        self._expire_pending()
        gate_open = self._batch_gate_open()
        progressed = True
        while progressed:
            progressed = False
            for lane_key in self._lane_order():
                lane = self._lanes.get(lane_key)
                if not lane:
                    continue
                cls = self._classes[lane_key[0]]
                if not cls.is_latency and not gate_open:
                    continue
                h = lane[0]
                try:
                    self._target_submit(h)
                except QueueFull:
                    if cls.is_latency and self._maybe_preempt(cls):
                        # A parked victim frees capacity on swap
                        # cadence, not instantly — retry next round.
                        pass
                    progressed = False
                    break
                except (EngineDraining, EngineDeadError):
                    # Target-side drain/death: leave work pending; the
                    # fleet reopens after undrain/failover.
                    progressed = False
                    break
                lane.popleft()
                self._inflight.append(h)
                self._stats["dispatched"] += 1
                self._served[lane_key] = self._served.get(lane_key,
                                                          0.0) + 1.0
                self.registry.counter("frontdoor_dispatched",
                                      priority=h.priority,
                                      tenant=h.tenant).inc()
                progressed = True
                gate_open = self._batch_gate_open()
                # ONE dispatch per pass, then re-sort: the weighted
                # fair queue owes each next turn to whichever lane has
                # the lowest virtual service NOW, not to a stale pass
                # order (a plain per-pass sweep degrades to unweighted
                # round-robin).
                break
        if not gate_open and any(
                lane and not self._classes[k[0]].is_latency
                for k, lane in self._lanes.items()):
            self._stats["deferrals"] += 1
            self.registry.counter("frontdoor_deferrals").inc()
        self._maybe_release()

    def _lane_order(self):
        """Dispatch order over nonempty lanes: strict tiers (latency
        before throughput, tighter budget first), then the weighted
        fair queue — lowest virtual service / (class weight * tenant
        weight) goes first, so a heavy tenant gets proportionally more
        turns without ever starving a light one."""
        keys = [k for k, lane in self._lanes.items() if lane]

        def order(key):
            cname, tname = key
            cls = self._classes[cname]
            tier = 0 if cls.is_latency else 1
            budget = cls.budget_s if cls.is_latency else float("inf")
            share = cls.weight * self._tenant_weight(tname)
            fair = self._served.get(key, 0.0) / share
            return (tier, budget, fair, cname, tname)

        return sorted(keys, key=order)

    def _batch_gate_open(self):
        """May throughput-class work enter the target right now?

        Warm predictor: yes while a HYPOTHETICAL latency arrival behind
        the current target queue would still see predicted TTFT within
        headroom * the strictest budget (batch may even queue). Cold —
        or when the predictor says no — batch still flows whenever the
        target QUEUE is empty and batch in-flight is under the depth
        bound: slots saturate, the FIFO in front of interactive prefill
        stays clear, and batch can never starve outright."""
        if self._strictest_budget_s is None:
            return True
        depth = self._queue_depth()
        pred = self._admission.predict_ttft_s(depth + 1)
        if pred is not None and \
                pred <= self.config.batch_headroom * self._strictest_budget_s:
            return True
        bound = self.config.cold_depth or self._capacity_bound()
        batch_inflight = sum(
            1 for h in self._inflight
            if not self._classes[h.priority].is_latency
            and h.phase not in ("done", "cancelled", "expired"))
        return depth == 0 and batch_inflight < bound

    def _target_submit(self, h):
        kw = dict(h.kw)
        if h.deadline is not None:
            remaining_ms = (h.deadline - self._clock()) * 1e3
            kw["deadline_ms"] = max(1.0, remaining_ms)
        req = self.target.submit(h.prompt,
                                 max_new_tokens=h.max_new_tokens,
                                 priority=h.priority, tenant=h.tenant,
                                 trace=h.trace, **kw)
        h._req = req
        h.dispatch_time = self._clock()
        self.tracer.instant(
            "request/dispatched", tid=h.trace.tid, hop=h.trace.hop(),
            hid=h.hid, rid=req.rid,
            lane_wait_ms=round((h.dispatch_time - h.submit_time) * 1e3,
                               3))

    def _expire_pending(self):
        """Deadline lapse while still in a front-door lane: settle the
        handle as ``expired`` (same terminal phase the engine's queue-
        side expiry uses) instead of dispatching dead work."""
        now = self._clock()
        for (cname, tname), lane in self._lanes.items():
            if not lane:
                continue
            dead = [h for h in lane
                    if h.deadline is not None and h.deadline <= now]
            for h in dead:
                lane.remove(h)
                h._settle("expired", now)
                self._finished.append(h)
                self._stats["expired"] += 1
                self.registry.counter("frontdoor_expired",
                                      priority=cname, tenant=tname).inc()
                self.tracer.instant(
                    "request/expired", tid=h.trace.tid,
                    hop=h.trace.hop(), hid=h.hid, where="frontdoor_lane")

    # -------------------------------------------------------- preemption

    def _maybe_preempt(self, for_cls):
        """Park preemptible decoding work in the ``swapped`` phase to
        protect ``for_cls``'s budget. Most-remaining-tokens victims
        first (their slots pay off longest), at most ``preempt_max``
        per call. Returns whether anything was parked."""
        if not self._can_preempt or self.config.preempt_max <= 0:
            return False
        victims = [
            h for h in self._inflight
            if h not in self._preempted
            and self._classes[h.priority].preemptible
            and h.phase == "decoding"]
        victims.sort(key=lambda h: len(h.tokens) - h.max_new_tokens)
        parked = 0
        for h in victims:
            if parked >= self.config.preempt_max:
                break
            if self.target.preempt(h._req):
                parked += 1
                h.preempt_count += 1
                self._preempted.append(h)
                self._stats["preemptions"] += 1
                self._preempts_by[h.priority] = \
                    self._preempts_by.get(h.priority, 0) + 1
                self.registry.counter("frontdoor_preemptions",
                                      priority=h.priority,
                                      tenant=h.tenant).inc()
        return parked > 0

    def _maybe_release(self):
        """Lift preemption holds once the latency pressure is gone (no
        latency work pending AND the target queue is clear) — the
        engine's resume-first swap-in then brings the parked sessions
        back bit-identically. Checked on every dispatch, so idle/drain
        always resolves the holds."""
        if not self._preempted:
            return
        if self._latency_pending() > 0 or self._queue_depth() > 0:
            return
        for h in self._preempted:
            self.target.release_preempted(h._req)
            self._stats["preempt_releases"] += 1
            self.registry.counter("frontdoor_preempt_releases",
                                  priority=h.priority,
                                  tenant=h.tenant).inc()
        self._preempted[:] = []

    # ----------------------------------------------------------- harvest

    def _reap(self):
        """Move terminal handles out of the in-flight set and feed the
        estimator one completion each. Called under self._lock."""
        if self._is_fleet:
            # Done FleetRequests leave the fleet's table (bounded
            # bookkeeping); our handles keep the references.
            self.target.harvest()
        still = []
        for h in self._inflight:
            if not h.done:
                still.append(h)
                continue
            self._finished.append(h)
            if h in self._preempted:
                self._preempted.remove(h)
            if h.phase == "done":
                self._stats["completed"] += 1
                gap = None
                if h.first_token_time is not None \
                        and h.dispatch_time is not None:
                    gap = max(0.0, h.first_token_time - h.dispatch_time)
                self._admission.observe_finish(h.priority, gap)
                self.registry.counter("frontdoor_completed",
                                      priority=h.priority,
                                      tenant=h.tenant).inc()
        self._inflight[:] = still

    def harvest(self):
        """Terminal handles not yet harvested, completion order."""
        with self._lock:
            self._reap()
            out = list(self._finished)
            self._finished[:] = []
        return sorted(out, key=lambda h: h.finish_time or 0.0)

    # ------------------------------------------------------------ driver

    def step(self):
        """One front-door step: dispatch, advance the target, reap.
        Matches the runner's duck-typed step() (returns [])."""
        if self._threaded:
            with self._lock:
                self._dispatch()
            self.target.step()     # sleeps its poll; replica threads work
            with self._lock:
                self._reap()
                self._dispatch()
            return []
        with self._lock:
            self._dispatch()
            if not self.target.idle:
                self.target.step()
            self._reap()
            self._dispatch()
        return []

    @property
    def idle(self):
        """Nothing pending here and nothing live in the target. A
        preempted hold keeps the target non-idle (swapped sessions);
        _maybe_release clears the hold as soon as the pressure is gone,
        so drains terminate."""
        with self._lock:
            if self._pending_total() > 0:
                return False
            return self.target.idle

    def wait_idle(self, timeout_s=None):
        t0 = self._clock()
        while not self.idle:
            self.step()
            if timeout_s is not None and self._clock() - t0 >= timeout_s:
                return False
        return True

    def cancel(self, handle):
        """Cancel wherever the request lives: still in a front-door
        lane (settled locally) or already on the target (delegated).
        Returns False when it had already finished."""
        with self._lock:
            if handle._req is None:
                if handle._local_phase is not None:
                    return False
                lane = self._lanes.get((handle.priority, handle.tenant))
                if lane is not None and handle in lane:
                    lane.remove(handle)
                handle._settle("cancelled", self._clock())
                self._finished.append(handle)
                self.tracer.instant(
                    "request/cancelled", tid=handle.trace.tid,
                    hop=handle.trace.hop(), hid=handle.hid,
                    where="frontdoor_lane")
                return True
            if handle in self._preempted:
                self._preempted.remove(handle)
            return self.target.cancel(handle._req)

    def close(self):
        self.target.close()

    # ------------------------------------------------- passthrough surface

    @property
    def telemetry(self):
        """The TARGET's registry — the runner's TimeseriesCollector
        must keep seeing engine histograms. The front door's own
        counters live in ``self.registry``."""
        return self.target.telemetry

    @property
    def counters(self):
        return self.target.counters

    @property
    def recovery_log(self):
        return getattr(self.target, "recovery_log", [])

    def inject_faults(self, plan, replica=None):
        if replica is not None:
            return self.target.inject_faults(plan, replica=replica)
        return self.target.inject_faults(plan)

    @property
    def compile_count(self):
        if self._is_fleet:
            return sum(self.target.compile_counts.values())
        return self.target.compile_count

    # ------------------------------------------------------------ metrics

    def metrics(self, reset=False):
        """The target's metrics() plus a ``frontdoor`` section: run
        totals, per-class/per-tenant admissions, sheds by reason, and
        preemption tallies — the counters the acceptance criteria pin."""
        with self._lock:
            base = self.target.metrics(reset=reset)
            base["frontdoor"] = {
                "stats": dict(self._stats),
                "pending": {"{}/{}".format(c, t): len(lane)
                            for (c, t), lane in self._lanes.items()
                            if lane},
                "inflight": len(self._inflight),
                "preempted_held": len(self._preempted),
                "admissions": {"{}/{}".format(c, t): n
                               for (c, t), n in
                               sorted(self._admissions_by.items())},
                "sheds": {"{}/{}/{}".format(c, t, r): n
                          for (c, t, r), n in
                          sorted(self._sheds_by.items())},
                "preemptions_by_class": dict(self._preempts_by),
                "predictor": {
                    "cold": self._admission.cold,
                    "completion_rate": self._admission._rate,
                    "token_rate": self._admission._token_rate,
                    "service_base_s": self._admission._service_base,
                },
            }
            return base

    def prometheus(self):
        """Target exposition plus the front door's own ds_tpu_frontdoor_*
        families (labelled priority/tenant/reason)."""
        with self._lock:
            return self.target.prometheus() + prometheus_text(self.registry)

    # ------------------------------------------------------------- tracing

    def trace_recorders(self):
        """Every ring a front-door request may have stamped: ours
        (admission / dispatch / lane verdicts) plus the target's —
        the fleet merges its own plane and each replica's ring; a bare
        engine contributes one."""
        recs = {"frontdoor": self.tracer}
        recs.update(self.target.trace_recorders())
        return recs

    def write_trace(self, path):
        """One merged Perfetto-loadable trace across the front door
        and everything behind it (telemetry/distributed.py)."""
        if isinstance(self.tracer, NullRecorder):
            raise RuntimeError("telemetry is disabled: no trace to write")
        extra = None
        collector = getattr(self.target, "collector", None)
        if collector is not None:
            extra = collector.chrome_counter_events()
        return write_merged_trace(path, self.trace_recorders(),
                                  extra_events=extra)

    def explain(self, handle_or_hid):
        """Structured autopsy of one front-door request — the full
        chain from admission verdict (with the predictor's evidence)
        through routing, dispatch, per-chunk decode, preemption,
        handoff and failover to the terminal cause. Accepts the
        FrontDoorHandle or its hid."""
        if isinstance(self.tracer, NullRecorder):
            raise RuntimeError(
                "telemetry is disabled: no trace to explain")
        if isinstance(handle_or_hid, FrontDoorHandle):
            tid = handle_or_hid.trace.tid
        else:
            tid = FRONTDOOR_TID_BASE + int(handle_or_hid)
        return build_autopsy(self.trace_recorders(), tid)
