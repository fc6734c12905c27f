"""Continuous-batching scheduler: the host-side request lifecycle.

Counterpart of ``deepspeed_tpu/inference/scheduler.py``. The device side is
shape-static; all dynamic serving behaviour lives here: a bounded FIFO
queue, admission of queued requests into free slots at step boundaries, a
``prefilling`` phase that walks a cursor through the prompt
``prefill_chunk`` tokens at a time, and completion bookkeeping.

Phases: ``queued -> prefilling -> decoding -> done``, or ``cancelled``
from any live phase, or ``expired`` from ``queued`` when a request's
deadline passes before admission. Host offload (the KV hierarchy) adds
``decoding -> swapped -> decoding``: a swapped session holds no slot (its
device state is a host record the engine keeps) and resumes ahead of
fresh admissions. Disaggregated serving (``inference/fleet.py``) adds
``decoding -> handoff``: a prefill-role replica captured the slot of a
finished prompt and the stream is migrating to a decode-role peer, whose
scheduler ``adopt``s it straight into ``decoding``; ``finish_handoff``
then drops the donor's record.

Recovery (``inference/engine.py``, ``InferenceEngine._recover``) adds one
move: after a fatal step error the engine calls ``requeue_running()``:
every in-flight request, swapped ones included, returns to the FRONT of
the queue in rid (= admission) order, to be re-admitted and replayed against the reset
pool. The request records here are the durable truth that makes the
device state disposable.

Timestamps are stamped here (submit / admit / finish; the engine stamps
the first token at its harvest). The optional ``tracer``
(telemetry.SpanRecorder) turns them into per-request Chrome trace events
on the request's own track (``tid``, its ``TraceContext``'s): a
``request/submitted`` instant, a ``request/queued`` span (submit ->
admit), a ``request/prefill`` span (admit -> first token sampled), a
``request/decode`` span (first token -> finish) and a whole-lifetime
``request`` span, as the JAX scheduler records them. The optional
``registry`` gets the ``queue_wait_seconds`` histogram (submit -> admit).
"""

import collections
import itertools
import time

from deepspeed_tpu_torch.telemetry.distributed import TraceContext

# Ceiling on the retry_after_s hint (a cold completions window would
# otherwise give an absurd estimate).
RETRY_AFTER_CAP_S = 60.0


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the queue holds ``max_queue`` requests,
    and by the engine for admission-pressure sheds (an injected
    ``admission_block`` fault). STRUCTURED, as the JAX package's: the
    queue depth at rejection, a ``retry_after_s`` hint from the recent
    completions rate (None before two completions), clamped to
    [0, RETRY_AFTER_CAP_S]; the ``replica_id`` of the rejecting engine
    (None outside a fleet); ``swap_eligible`` (False until the KV
    hierarchy's host offload can free a slot); the rejected submission's
    ``priority`` and ``tenant`` (None for untagged traffic); and
    ``reason``, the shed's cause (``queue_full`` here)."""

    def __init__(self, message, queue_depth=None, retry_after_s=None,
                 replica_id=None, swap_eligible=False, priority=None,
                 tenant=None, reason=None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s
        self.replica_id = replica_id
        self.swap_eligible = swap_eligible
        self.priority = priority
        self.tenant = tenant
        self.reason = reason


class Request(object):
    """One generation request and its accumulated output."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "temperature", "top_k",
                 "eos_token_id", "seed", "spec", "tokens", "slot", "phase",
                 "cursor", "submit_time", "admit_time", "first_token_time",
                 "finish_time", "deadline", "replays", "resync", "folded",
                 "last_touch", "priority", "tenant", "trace")

    def __init__(self, rid, prompt, max_new_tokens, temperature, top_k,
                 eos_token_id, seed, spec=False, deadline=None, priority=None,
                 tenant=None, trace=None):
        self.rid = rid
        # The submission's priority class and tenant (None for untagged
        # traffic); carried across failovers and handoffs for the front
        # door, which is not ported yet.
        self.priority = priority
        self.tenant = tenant
        # Propagated trace identity: the Chrome tid every lifecycle event
        # rides and the hop counter (telemetry/distributed.py). A bare
        # engine mints a local one, so tid == rid.
        self.trace = trace if trace is not None \
            else TraceContext(rid, origin="local")
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.seed = seed
        # Speculates in the decode lane: the slot's ``spec`` field, which
        # vetoes draft agreement when False. A decode step may then emit
        # 1..spec_k+1 tokens for the slot.
        self.spec = spec
        self.tokens = []
        self.slot = None
        self.phase = "queued"
        # Prompt tokens consumed so far.
        self.cursor = 0
        self.submit_time = time.time()
        self.admit_time = None
        self.first_token_time = None
        self.finish_time = None
        # Absolute wall-clock expiry (None: no deadline), checked
        # QUEUE-side at each admission round: a request whose deadline
        # passes before it reaches a slot is shed as ``expired``; once
        # admitted, it finishes (mid-stream abandonment is cancel()'s).
        self.deadline = deadline
        # Times recovery re-admitted this request (replay). The emitted
        # stream stays one stream across replays: tokens only grow.
        self.replays = 0
        # Replay bookkeeping (InferenceEngine._replay_requests): the index
        # in ``tokens`` of the next delivered token the device re-derives
        # after a replay (None: in step, new tokens are delivered), and
        # how many delivered tokens were folded into ``prompt``.
        self.resync = None
        self.folded = 0
        # Wall clock of the request's last progress (submit, then each
        # step that emitted it tokens; the engine stamps it at harvest):
        # the swap-victim policy prefers a stale session
        # (kv_hierarchy.offload.pick_swap_victim).
        self.last_touch = self.submit_time

    @property
    def done(self):
        return self.finish_time is not None


class Scheduler(object):
    """FIFO admission over a fixed slot set."""

    def __init__(self, num_slots, max_queue, tracer=None, registry=None,
                 replica_id=None):
        self.num_slots = num_slots
        self.max_queue = max_queue
        # Stamped into every QueueFull this scheduler raises (None for a
        # standalone engine).
        self.replica_id = replica_id
        self.queue = collections.deque()
        self.running = {}           # slot -> Request (prefilling | decoding)
        # rid -> Request in the ``swapped`` phase: mid-decode but holding
        # NO slot (its device state is a host record). Insertion order is
        # swap-out order, so next_swap_in() resumes the longest-waiting
        # session first.
        self.swapped = {}
        # rid -> Request in the ``handoff`` phase: prefill finished, slot
        # captured and freed, stream migrating to another replica. Still
        # this scheduler's (``idle`` counts it) until finish_handoff.
        self.handoff = {}
        self.completed = {}         # rid -> Request
        self._ids = itertools.count()
        # Telemetry is additive (module docstring): without a tracer or a
        # registry the scheduler behaves exactly as before.
        self.tracer = tracer
        self._queue_wait = (registry.histogram("queue_wait_seconds")
                            if registry is not None else None)
        self._deadline_sheds = (registry.counter("deadline_sheds")
                                if registry is not None else None)
        self._finish_times = collections.deque(maxlen=32)
        # The same evidence split by priority class (retry_after_s).
        self._finish_by_class = {}
        # True once any queued request carries a deadline: admissions()
        # skips the expiry scan entirely on deadline-free workloads.
        self._has_deadlines = False

    @staticmethod
    def _rate_hint(times):
        """1/rate over a completion-timestamp deque, clamped to
        [0, RETRY_AFTER_CAP_S]; None below two observations (no rate,
        no guess)."""
        if times is None or len(times) < 2:
            return None
        span = times[-1] - times[0]
        if span <= 0:
            return None
        rate = (len(times) - 1) / span
        return round(min(max(1.0 / rate, 0.0), RETRY_AFTER_CAP_S), 4)

    def retry_after_s(self, priority=None):
        """Seconds until one queue position plausibly frees, from the
        recent completions rate; None below two completions. With
        ``priority`` the estimate comes from that class's own completions
        first (a batch-dominated window must not inflate the interactive
        hint), falling back to every completion until the class has two
        of its own."""
        if priority is not None:
            hint = self._rate_hint(self._finish_by_class.get(priority))
            if hint is not None:
                return hint
        return self._rate_hint(self._finish_times)

    def queue_full_error(self, reason=None, priority=None, tenant=None,
                         cause=None, retry_after_s=None):
        """The structured QueueFull for the CURRENT queue state, also
        built by the engine for admission-pressure sheds, so every shed
        carries the same backpressure fields. ``reason`` is the message
        (default: the queue-full text); ``priority`` and ``tenant`` are
        stamped on the error; ``cause`` overrides the structured
        ``reason`` field (default ``queue_full``) and ``retry_after_s``
        the completions-rate hint."""
        depth = len(self.queue)
        hint = retry_after_s if retry_after_s is not None \
            else self.retry_after_s(priority)
        msg = reason or ("inference queue is full ({} pending); retry "
                         "later or raise inference.max_queue".format(depth))
        if hint is not None:
            msg += " (retry_after_s hint: {})".format(hint)
        return QueueFull(msg, queue_depth=depth, retry_after_s=hint,
                         replica_id=self.replica_id, priority=priority,
                         tenant=tenant, reason=cause or "queue_full")

    def submit(self, prompt, max_new_tokens, temperature, top_k,
               eos_token_id, seed, spec=False, deadline=None, priority=None,
               tenant=None, trace=None):
        """Queue one request; ``trace``: the TraceContext a fleet minted
        (None: a local one, tid == rid)."""
        if len(self.queue) >= self.max_queue:
            raise self.queue_full_error(priority=priority, tenant=tenant)
        req = Request(next(self._ids), prompt, max_new_tokens, temperature,
                      top_k, eos_token_id, seed, spec, deadline=deadline,
                      priority=priority, tenant=tenant, trace=trace)
        if deadline is not None:
            self._has_deadlines = True
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.instant("request/submitted", tid=req.trace.tid,
                                rid=req.rid, hop=req.trace.hop(),
                                queue_depth=len(self.queue))
        return req

    def free_slot_ids(self):
        return [s for s in range(self.num_slots) if s not in self.running]

    def expire_deadlines(self, now=None):
        """QUEUE-side deadline expiry: shed every queued request whose
        deadline has passed (phase ``expired``, counted in
        ``deadline_sheds``). Runs at each admission round: a deadline is
        a promise about WAITING, checked at the only point waiting can
        end. Returns the expired requests. Free on deadline-free
        workloads (one bool test)."""
        if not self._has_deadlines:
            return []
        now = time.time() if now is None else now
        expired = [r for r in self.queue
                   if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self.queue.remove(req)
            req.phase = "expired"
            req.finish_time = now
            self.completed[req.rid] = req
            if self._deadline_sheds is not None:
                self._deadline_sheds.inc()
            if self.tracer is not None:
                self.tracer.instant("request/expired", tid=req.trace.tid,
                                    rid=req.rid, hop=req.trace.hop(),
                                    waited_s=round(now - req.submit_time, 4))
                self.tracer.span("request", req.submit_time, req.finish_time,
                                 tid=req.trace.tid, rid=req.rid,
                                 hop=req.trace.hop(), tokens=0,
                                 phase="expired")
        return expired

    def admissions(self, gate=None):
        """FIFO: pop (request, slot) pairs for every free slot while the
        queue lasts, moving each request into ``prefilling``. Called only
        at step boundaries. Expired-deadline requests are shed first; a
        replayed request (recovery re-admission) keeps its FIRST
        admit_time, so queue wait is observed once per request.

        ``gate``: optional callable(Request) -> bool consulted on the queue
        HEAD before it pops (the paged engine's page reservation). A refused
        head ENDS the round (strict FIFO: younger requests must not jump a
        head that is waiting for pages to free)."""
        self.expire_deadlines()
        pairs = []
        for slot in self.free_slot_ids():
            if not self.queue:
                break
            if gate is not None and not gate(self.queue[0]):
                break
            req = self.queue.popleft()
            first_admission = req.admit_time is None
            req.slot = slot
            req.phase = "prefilling"
            req.cursor = 0
            self.running[slot] = req
            pairs.append((req, slot))
            if not first_admission:
                continue  # replay re-admission: stats already stamped
            req.admit_time = time.time()
            if self._queue_wait is not None:
                self._queue_wait.observe(req.admit_time - req.submit_time)
            if self.tracer is not None:
                self.tracer.span("request/queued", req.submit_time,
                                 req.admit_time, tid=req.trace.tid,
                                 rid=req.rid, hop=req.trace.hop(), slot=slot,
                                 prompt_tokens=int(req.prompt.size))
        return pairs

    def next_prefill(self):
        """The prefilling request whose next prompt chunk rides the coming
        step: FIFO by admission (rid) order; None when none prefills."""
        pf = [r for r in self.running.values() if r.phase == "prefilling"]
        return min(pf, key=lambda r: r.rid) if pf else None

    def advance_prefill(self, req, n):
        """Record ``n`` prompt tokens consumed; True when the prompt is
        exhausted (its first token was sampled this step and it moves to
        ``decoding``)."""
        req.cursor += n
        if req.cursor >= req.prompt.size:
            req.phase = "decoding"
            if self.tracer is not None:
                self.tracer.span("request/prefill", req.admit_time,
                                 tid=req.trace.tid, rid=req.rid,
                                 hop=req.trace.hop(), slot=req.slot,
                                 prompt_tokens=int(req.prompt.size))
            return True
        return False

    def complete(self, slot):
        """Evict ``slot``: its request is finished and the slot is free for
        the next admission round."""
        req = self.running.pop(slot)
        req.finish_time = time.time()
        req.phase = "done"
        req.slot = None
        self.completed[req.rid] = req
        self._finish_times.append(req.finish_time)
        if req.priority is not None:
            self._finish_by_class.setdefault(
                req.priority,
                collections.deque(maxlen=32)).append(req.finish_time)
        if self.tracer is not None:
            if req.first_token_time is not None:
                self.tracer.span("request/decode", req.first_token_time,
                                 req.finish_time, tid=req.trace.tid,
                                 rid=req.rid, hop=req.trace.hop(),
                                 tokens=len(req.tokens))
            self.tracer.span("request", req.submit_time, req.finish_time,
                             tid=req.trace.tid, rid=req.rid,
                             hop=req.trace.hop(),
                             tokens=len(req.tokens), phase="done")
        return req

    def cancel(self, req):
        """Evict ``req`` wherever it lives: queued, mid-prefill or
        decoding. Its slot (if any) frees for the next admission round;
        tokens emitted so far stay on the request. Returns True when the
        request was live (False: already finished). The caller owns any
        device-side deactivation (the engine clears a decoding slot's
        ``active`` flag; a prefilling slot is frozen in the decode lane
        and its frontier is overwritten at re-admission)."""
        if req.done:
            return False
        if req.phase == "queued":
            self.queue.remove(req)
        elif req.phase == "swapped":
            # Slotless; the host record is the engine's to drop.
            self.swapped.pop(req.rid)
        elif req.phase == "handoff":
            # Slotless and off the device already (captured at
            # begin_handoff): host bookkeeping only. pop() tolerates a
            # record the fleet's pump settled meanwhile.
            self.handoff.pop(req.rid, None)
        else:
            self.running.pop(req.slot)
            req.slot = None
        req.phase = "cancelled"
        req.finish_time = time.time()
        self.completed[req.rid] = req
        if self.tracer is not None:
            self.tracer.instant("request/cancelled", tid=req.trace.tid,
                                rid=req.rid, hop=req.trace.hop(),
                                tokens=len(req.tokens))
            self.tracer.span("request", req.submit_time, req.finish_time,
                             tid=req.trace.tid, rid=req.rid,
                             hop=req.trace.hop(),
                             tokens=len(req.tokens), phase="cancelled")
        return True

    def requeue(self, req):
        """Pull one in-flight request out of its slot (or out of the
        swapped phase) and push it onto the FRONT of the queue with
        ``cursor`` 0 and one more ``replays`` (the ``request/replayed``
        instant). The slot frees for the next admission round; the caller
        owns its device side."""
        if req.phase == "swapped":
            self.swapped.pop(req.rid)
        else:
            self.running.pop(req.slot)
        req.slot = None
        req.phase = "queued"
        req.cursor = 0
        req.replays += 1
        self.queue.appendleft(req)
        if self.tracer is not None:
            self.tracer.instant("request/replayed", tid=req.trace.tid,
                                rid=req.rid, hop=req.trace.hop(),
                                replay=req.replays, tokens=len(req.tokens))

    def requeue_running(self):
        """Crash-only recovery: pull EVERY in-flight request out of its
        slot, and every SWAPPED session out of the swapped phase (its host
        record described a pool that was just reset; the engine drops it),
        and push all of them back onto the FRONT of the queue in rid
        (= admission) order, ahead of never-admitted work (``requeue``).
        The engine then marks each for replay
        (``InferenceEngine._replay_requests``): every draw is keyed on
        (seed, absolute position), so the replayed stream continues the
        original one. Returns the requeued requests in rid order."""
        reqs = sorted(list(self.running.values()) +
                      list(self.swapped.values()), key=lambda r: r.rid)
        for req in reversed(reqs):
            self.requeue(req)
        return reqs

    # ------------------------------------------------------ host offload

    def swap_out(self, req):
        """Move a DECODING request out of its slot into the ``swapped``
        phase. The engine owns the device side (capture the slot to the
        host store, then deactivate it); this records only that the
        session is paused and slotless."""
        assert req.phase == "decoding", req.phase
        self.running.pop(req.slot)
        req.slot = None
        req.phase = "swapped"
        self.swapped[req.rid] = req
        if self.tracer is not None:
            self.tracer.instant("request/swapped_out", tid=req.trace.tid,
                                rid=req.rid, hop=req.trace.hop(),
                                tokens=len(req.tokens))

    def next_swap_in(self, skip=()):
        """The longest-swapped session, or None: resume-first fairness (a
        swapped session outranks fresh admissions for the next free slot,
        so swaps time-slice the slot set instead of starving whoever lost
        the first eviction). ``skip``: rids to pass over."""
        for rid, req in self.swapped.items():
            if rid not in skip:
                return req
        return None

    def swap_in(self, req, slot):
        """Resume a swapped request into ``slot`` (need not be the slot it
        was captured from: the record carries every positional fact). The
        engine restores the device state before the next program call."""
        self.swapped.pop(req.rid)
        req.slot = slot
        req.phase = "decoding"
        self.running[slot] = req
        if self.tracer is not None:
            self.tracer.instant("request/swapped_in", tid=req.trace.tid,
                                rid=req.rid, hop=req.trace.hop(), slot=slot,
                                tokens=len(req.tokens))

    # ------------------------------------------- disaggregated handoff

    def begin_handoff(self, req):
        """Move a DECODING request out of its slot into the ``handoff``
        phase: the prompt finished on this prefill-role replica, the
        engine captured the slot to a host record, and the stream is
        migrating to a decode replica. Slotless like ``swapped``, but
        bound for ANOTHER scheduler: the fleet's pump places the record
        or falls back to a replay, and calls finish_handoff either way.
        ``requeue_running`` leaves it alone: its record survives a pool
        reset."""
        assert req.phase == "decoding", req.phase
        self.running.pop(req.slot)
        req.slot = None
        req.phase = "handoff"
        self.handoff[req.rid] = req
        if self.tracer is not None:
            self.tracer.instant("request/handoff", tid=req.trace.tid,
                                rid=req.rid, hop=req.trace.hop(),
                                tokens=len(req.tokens))

    def finish_handoff(self, req):
        """The migration settled (adopted by a peer, or fallen back to a
        replay elsewhere): drop the record from this scheduler's books
        (not ``completed``: the new owner's record is the truth now)."""
        self.handoff.pop(req.rid, None)

    def adopt(self, prompt, max_new_tokens, temperature, top_k,
              eos_token_id, seed, slot, spec=False, deadline=None,
              submit_time=None, admit_time=None, first_token_time=None,
              priority=None, tenant=None, trace=None, flow=None, tokens=(),
              resync=None, folded=0):
        """ACCEPTOR side: install a request migrated from a prefill-role
        peer straight into ``slot`` in the ``decoding`` phase; it never
        queues here and never rides the prefill lane (the restored record
        IS its prefill). The port carries the donor's record whole:
        ``prompt`` and ``max_new_tokens`` as submitted, the ``tokens``
        already delivered, and the replay bookkeeping (``resync``,
        ``folded``), so a later recovery here replays the stream as the
        donor would have. The donor's submit/admit/first-token stamps
        carry over: queue wait and TTFT are observed once, where they
        happened."""
        assert slot not in self.running, slot
        req = Request(next(self._ids), prompt, max_new_tokens, temperature,
                      top_k, eos_token_id, seed, spec, deadline=deadline,
                      priority=priority, tenant=tenant, trace=trace)
        if submit_time is not None:
            req.submit_time = submit_time
            req.last_touch = submit_time
        req.admit_time = admit_time if admit_time is not None \
            else req.submit_time
        req.first_token_time = first_token_time
        req.tokens = list(tokens)
        req.resync = resync
        req.folded = folded
        req.cursor = int(prompt.size)
        req.slot = slot
        req.phase = "decoding"
        self.running[slot] = req
        if self.tracer is not None:
            args = {"rid": req.rid, "slot": slot,
                    "prompt_tokens": int(prompt.size),
                    "hop": req.trace.hop()}
            if flow is not None:
                args["flow_in"] = flow
            self.tracer.instant("request/handoff_in", tid=req.trace.tid,
                                **args)
        return req

    @property
    def idle(self):
        return (not self.queue and not self.running and not self.swapped
                and not self.handoff)

    def occupancy(self):
        return len(self.running) / float(self.num_slots)
