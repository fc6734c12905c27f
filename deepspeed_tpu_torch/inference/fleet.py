"""Replicated serving fleet: N engines, one front door.

Counterpart of ``deepspeed_tpu/inference/fleet.py``. A ``ServingFleet``
owns N ``InferenceEngine`` replicas and extends the engine's crash-only
invariant ACROSS them: when a replica dies, its request records move to
survivors, and every stream (greedy and sampled) completes as a
fault-free run's, because emissions depend only on (prompt, seed,
absolute position), never on the replica, the batch or the chunk
boundaries. Zero requests lost; a survivor captures no graph for it.

Topology: replicas are IN-PROCESS, one stepping thread each. Placement
comes from ``parallel.mesh.replica_devices``: with several cards each
replica gets one (the model is copied there once); on one card (and on
the CPU, the tests) every replica shares the device and the model's
parameter tensors, with no copy: one ``ServingWeights`` serves them all.
Each replica owns its pool, its CUDA stream, its graph pool and its
thread (``inference/engine.py``, ONE STREAM PER ENGINE), so replicas on
one card overlap their steps and never synchronize with one another.
One CUDA context serves them all: a sticky CUDA error ends every
replica, so failover on one card covers the faults recovery cannot
clear in one engine (``recovery_max_retries`` exhausted, an unexpected
exception), not a corrupted context.

Routing (router.py): health-weighted least-loaded over the live
``queue_depth`` / ``slot_occupancy`` / ``health_state`` gauges, one
circuit breaker per replica fed by structured ``QueueFull.retry_after_s``
sheds, watchdog ``step_stalls`` and fatal-step recoveries. The fleet
consults ``breaker.allow()`` only for replicas it actually attempts, so
half-open probes are never burned on untried candidates.

Prefix affinity: when the replicas run the prefix cache, the fleet keeps
a ``PrefixDirectory`` of the prefix rows each replica published,
re-synced after clean steps (gated by the store's ``version``) and
invalidated wholesale on a replica's death or recovery. ``submit()``
folds the directory's longest match into the router score, so template
traffic lands on the replica already holding its prefix; when load wins
the route anyway, the cold winner ADOPTS the holder's row
(``export_prefix`` on the donor, ``adopt_prefix`` on the acceptor; int8
codes ship as stored) before submitting. The directory is derived state
and never authoritative: both ends re-validate against their live store
under their own replica lock, and failover never depends on it
(``prefix_affinity=False`` switches the whole plane off).

Locking discipline (the whole concurrency story, in one place):

- ``rep.lock`` (one per replica) serializes EVERY call into that
  replica's engine: submit, step, cancel, the transports, health
  transitions. An engine is single-threaded by contract; the fleet
  supplies that contract.
- ``self._lock`` (fleet RLock) guards fleet bookkeeping: the request
  table, the orphan list, failover counters.
- ORDER: ``self._lock`` may be taken while holding a ``rep.lock``,
  NEVER the reverse, so a submit registering its request can nest, and a
  failover scanning the table cannot deadlock against it. Two replica
  locks are never held at once.

Failure of a replica (recovery retries exhausted, or any unexpected step
exception: crash-only means we fail over, we do not diagnose) triggers
``_failover``: every live FleetRequest the dead replica owned snapshots
its record and joins the orphan list; ``_pump`` places orphans on
survivors, straight into the scheduler past admission health, because
ACCEPTED IS A PROMISE: a draining survivor still takes failover work,
and a full one is retried until a slot frees (``idle`` stays False while
orphans exist).

A re-homed request REPLAYS BY RE-DERIVATION, as the port's engine
recovers (``InferenceEngine.resubmit``): it goes to the survivor with its
original prompt and budget and the tokens it delivered; the survivor
prefills the prompt again and its decode lane re-derives each delivered
token, checked and not delivered twice, before it delivers a new one. If
a re-derived token disagrees, that request alone takes the JAX package's
replay (prompt + delivered tokens, ``_resync_failed``). The JAX fleet
resubmits prompt + delivered tokens at once: exact on the CPU, but on the
card the prefill lane's GEMMs round the delivered tokens' k/v unlike the
decode lane's, and a stream may part at a near tie.

Disaggregated prefill/decode serving: ``roles=`` types each replica
``prefill`` / ``decode`` / ``mixed`` (default all ``mixed``). The router
sends NEW requests only to prefill-capable replicas (ineligible views
are SKIPPED before scoring: no score, no tie-break draw, so an all-mixed
fleet routes as before); when a prompt's final slice lands on a prefill
replica, its engine captures the finished slot (every plane as stored,
every per-slot field; all of a step's completers in one synchronization)
and the ``HandoffPump`` moves the stream into a decode-capable replica's
slot pool, chosen by the same ordering. The acceptor installs it
straight into the ``decoding`` phase (the restored record IS the
prefill), so decode replicas never run a prefill lane. Cancel reaches a
mid-handoff stream (the pump's commit and the cancel path serialize on
the fleet lock), the donor's death drops the pump item and replays
through the orphan path, and when NO decode-capable replica survives,
the surviving prefill replicas degrade to effective-mixed (capture off)
and the stream replays on a survivor: zero lost, counted as
``handoff_fallbacks``.

Telemetry: the merged registry (every replica's series under a
``replica`` label), a ``TimeseriesCollector`` over it, SLO burn-rate
alerts (``telemetry/alerts.py``) evaluated as windows close, the fleet's
own span ring (routing, failover, prefix shipments), ``write_trace``
(one merged Perfetto trace with flow arrows across replicas) and
``explain`` (``telemetry/autopsy.py``) and ``perf_xray`` (every
replica's program records under its replica label).
"""

import copy
import dataclasses
import itertools
import json
import os
import threading
import time

import numpy as np

from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.engine import InferenceEngine
from deepspeed_tpu_torch.inference.kv_hierarchy import PrefixDirectory
from deepspeed_tpu_torch.inference.resilience import (EngineDeadError,
                                                      EngineDraining)
from deepspeed_tpu_torch.inference.router import CircuitBreaker, Router
from deepspeed_tpu_torch.inference.scheduler import (RETRY_AFTER_CAP_S,
                                                     QueueFull)
from deepspeed_tpu_torch.inference.adapters.gpt2 import ServingWeights
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHeadModel,
                                             params_from_jax)
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.telemetry import (MergedRegistry, NullRecorder,
                                           SpanRecorder, TimeseriesCollector,
                                           prometheus_text)
from deepspeed_tpu_torch.telemetry.alerts import AlertManager, default_rules
from deepspeed_tpu_torch.telemetry.autopsy import (build_autopsy,
                                                   worst_requests)
from deepspeed_tpu_torch.telemetry.distributed import (FLEET_TID_BASE,
                                                       TraceContext,
                                                       write_merged_trace)
from deepspeed_tpu_torch.utils.logging import logger


def _respec(req):
    """What re-homes engine request ``req`` on another replica: the
    request as it stands (prompt and budget as submitted, the delivered
    tokens, the replay bookkeeping, the sampling parameters, the trace by
    reference, the stamps). ``InferenceEngine.resubmit`` and
    ``Scheduler.adopt`` take these fields."""
    return {
        "prompt": req.prompt,
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature,
        "top_k": req.top_k,
        "eos_token_id": req.eos_token_id,
        "seed": req.seed,
        "spec": req.spec,
        "deadline": req.deadline,
        "priority": req.priority,
        "tenant": req.tenant,
        "trace": req.trace,
        "tokens": [int(t) for t in req.tokens],
        "folded": req.folded,
        "first_token_time": req.first_token_time,
    }


class FleetRequest(object):
    """Fleet-side handle for one submitted request: the object a caller
    (or the loadgen runner) holds across failovers. The same read surface
    as a scheduler Request (rid/phase/tokens/submit_time/first_token_time/
    finish_time/done), stitched across replicas: a re-homed engine
    request carries the tokens delivered before it, so ``tokens`` is
    always one continuous stream (``_prior`` holds them only while the
    request waits for a survivor)."""

    __slots__ = ("fid", "replica_id", "failovers", "trace", "_req",
                 "_prior", "_submit_time", "_first_token_time",
                 "_finish_time", "_cancelled", "_respec")

    def __init__(self, fid, replica_id, req):
        self.fid = fid
        self.replica_id = replica_id   # current owner; None mid-failover
        self.failovers = 0
        # The propagated trace identity, shared BY REFERENCE with the
        # engine Request, so it survives re-homing.
        self.trace = req.trace
        self._req = req                # current engine Request record
        self._prior = []               # delivered tokens while orphaned
        self._submit_time = req.submit_time
        self._first_token_time = None  # preserved across failover
        self._finish_time = None       # set only by orphan-cancel
        self._cancelled = False
        self._respec = None

    @property
    def rid(self):
        return self.fid

    @property
    def tokens(self):
        req = self._req
        if req is None:
            return list(self._prior)
        return self._prior + list(req.tokens)

    @property
    def phase(self):
        req = self._req
        if req is not None:
            return req.phase
        return "cancelled" if self._cancelled else "queued"

    @property
    def submit_time(self):
        return self._submit_time

    @property
    def first_token_time(self):
        if self._first_token_time is not None:
            return self._first_token_time
        req = self._req
        return None if req is None else req.first_token_time

    @property
    def finish_time(self):
        if self._finish_time is not None:
            return self._finish_time
        req = self._req
        return None if req is None else req.finish_time

    @property
    def done(self):
        return self.finish_time is not None

    # -- failover internals (called under the fleet lock) ---------------

    def _orphan(self):
        """Snapshot the re-homing spec from the (dead) owner's record and
        detach (module docstring: replay by re-derivation)."""
        req = self._req
        if req.first_token_time is not None and \
                self._first_token_time is None:
            self._first_token_time = req.first_token_time
        self._prior = self.tokens
        self.failovers += 1
        self._respec = _respec(req)
        # ``flow`` keys the failover arrow: the dead owner's
        # failover_out and the survivor's failover_in both stamp it.
        self._respec["flow"] = "failover/{}/{}".format(req.trace.tid,
                                                       self.failovers)
        self._req = None
        self.replica_id = None

    def _rehome(self, req, replica_id):
        """Point at ``req``, which carries every delivered token."""
        self._req = req
        self._prior = []
        self.replica_id = replica_id

    def _mark_cancelled(self, now):
        self._cancelled = True
        self._finish_time = now


class _Replica(object):
    """One engine plus its fleet-side fixtures: the serialization lock,
    the stepping thread's wake/stop events, the circuit breaker, the
    error that failed it (``cause``; None while it serves), and handles
    to the live gauges the router scores from."""

    __slots__ = ("rid", "engine", "device", "breaker", "lock", "wake",
                 "stop", "thread", "failed", "cause", "last_stalls",
                 "last_recoveries", "last_prefix_version", "_g_queue",
                 "_g_occ")

    def __init__(self, rid, engine, device, breaker):
        self.rid = rid
        self.engine = engine
        self.device = device
        self.breaker = breaker
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.stop = threading.Event()
        self.thread = None
        self.failed = False
        self.cause = None
        self.last_stalls = 0
        self.last_recoveries = 0
        # PrefixStore.version at the last directory sync: gates the
        # publish walk to one int compare on an unchanged prefix set.
        self.last_prefix_version = -1
        self._g_queue = engine.telemetry.gauge("queue_depth")
        self._g_occ = engine.telemetry.gauge("slot_occupancy")

    # Router view (router.Router.score reads these).
    @property
    def queue_depth(self):
        return self._g_queue.value

    @property
    def slot_occupancy(self):
        return self._g_occ.value

    @property
    def max_slots(self):
        return self.engine.config.max_slots

    @property
    def health(self):
        return self.engine.health

    @property
    def alive(self):
        return not self.failed and self.engine.health != "dead"


class _FleetCounters(object):
    """Read-only dict-shaped SUM of every replica's counter bank, the
    duck type of ``engine.counters``, so the loadgen runner reads a fleet
    unchanged. Dead replicas keep counting (their totals are history)."""

    __slots__ = ("_replicas",)

    def __init__(self, replicas):
        self._replicas = replicas

    def _banks(self):
        return [r.engine.counters for r in self._replicas]

    def __contains__(self, name):
        return any(name in b for b in self._banks())

    def __getitem__(self, name):
        banks = [b for b in self._banks() if name in b]
        if not banks:
            raise KeyError(name)
        return sum(b[name] for b in banks)

    def __iter__(self):
        seen = set()
        for b in self._banks():
            for n in b:
                if n not in seen:
                    seen.add(n)
                    yield n

    def keys(self):
        return list(self)

    def items(self):
        return [(n, self[n]) for n in self]


class HandoffPump(object):
    """In-flight migrations, donor -> decode replica. One per fleet;
    every replica thread (and the single-threaded ``step()`` driver)
    drains it, so a migration never depends on one thread surviving.
    Items are ``(fr, donor_rep, req, record, t_capture)``: the fleet
    handle, the prefill replica that captured, its slotless engine
    Request (phase ``handoff``), the host record, and the capture time
    the donor's ``handoff_latency_seconds`` observes at commit.

    ``claim()`` atomically empties the list, so concurrent pumps get
    disjoint items and never place one stream twice; ``requeue()`` puts
    unplaceable items back at the FRONT. Every write holds ``lock``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.pending = []

    def put(self, items):
        with self.lock:
            self.pending.extend(items)

    def claim(self):
        with self.lock:
            items, self.pending = self.pending, []
        return items

    def requeue(self, items):
        with self.lock:
            self.pending = list(items) + self.pending

    def __len__(self):
        with self.lock:
            return len(self.pending)


def _replica_models(model, params, devices, adapter=None):
    """device -> (GPT2LMHeadModel on it, its ServingWeights): one model and
    one set of serving weights per distinct device, shared by every
    replica placed there. With ``model=None`` the adapter brings its own
    weights (``adapter.prepare_params``): (None, those weights)."""
    out = {}
    for dev in devices:
        if dev in out:
            continue
        if model is None:
            if adapter is None:
                raise ValueError("model=None needs an adapter that brings "
                                 "its own weights (MoEAdapter)")
            out[dev] = (None, adapter.prepare_params(params, dev))
            continue
        if isinstance(model, GPT2Config):
            if params is None:
                raise ValueError("a GPT2Config needs params (a flax GPT-2 "
                                 "tree of numpy arrays)")
            m = params_from_jax(params, model, dev)
        elif isinstance(model, GPT2LMHeadModel):
            if params is not None:
                raise ValueError("pass params only with a GPT2Config: a "
                                 "GPT2LMHeadModel holds its own weights")
            m = model if not out else copy.deepcopy(model)
            m = m.to(dev)
        else:
            raise TypeError("model must be a GPT2LMHeadModel or GPT2Config, "
                            "got {}".format(type(model).__name__))
        out[dev] = (m, ServingWeights(m))
    return out


class ServingFleet(object):
    """N replicas, one submit()/harvest()/cancel()/drain() surface.

    ``model`` / ``params`` / ``adapter``: as ``InferenceEngine`` takes
    them (every replica serves the same adapter and shares its weights).
    ``device``: None places the replicas on the visible CUDA devices
    (round-robin), ``"cpu"`` on the host. ``start=True`` (default)
    launches one daemon stepping thread per replica; ``start=False``
    leaves the fleet single-threaded: callers drive ``step()`` themselves,
    which is what the deterministic routing tests do.

    ``breaker_factory`` builds one CircuitBreaker per replica (tests
    inject fake-clock breakers); ``seed`` fixes the router's tie-break
    draws. The fleet owns a TimeseriesCollector over the merged registry:
    its windows are the evidence ``rolling_drain`` checks before taking a
    replica out of rotation, and what the alert rules score."""

    def __init__(self, model, params=None, n_replicas=2, config=None, seed=0,
                 window_seconds=1.0, window_capacity=512, start=True,
                 breaker_factory=None, idle_wait_s=0.01, poll_s=0.002,
                 prefix_affinity=None, roles=None,
                 latency_classes=("interactive",), alert_rules=None,
                 dump_dir=None, device=None, adapter=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1, got "
                             "{}".format(n_replicas))
        if isinstance(config, dict):
            config = InferenceConfig.from_dict(config)
        config = config or InferenceConfig()
        self.config = config
        # One role per replica; by default every replica takes
        # config.role (itself "mixed"). Per-role validation runs in
        # InferenceConfig via the per-replica replace().
        if roles is None:
            roles = [config.role] * n_replicas
        roles = [str(r) for r in roles]
        if len(roles) != n_replicas:
            raise ValueError(
                "roles must name one role per replica: got {} for "
                "{} replicas".format(len(roles), n_replicas))
        if "prefill" in roles and \
                not any(r in ("decode", "mixed") for r in roles):
            raise ValueError(
                "a prefill-role replica needs at least one decode or "
                "mixed replica to hand finished prompts to; got "
                "roles={}".format(roles))
        self.roles = tuple(roles)
        self._disagg = any(r != "mixed" for r in roles)
        if breaker_factory is None:
            breaker_factory = CircuitBreaker
        devices = mesh_lib.replica_devices(n_replicas, device=device)
        models = _replica_models(model, params, devices, adapter)
        self.replicas = []
        for i in range(n_replicas):
            cfg = dataclasses.replace(config, replica_id=i, role=roles[i])
            m, weights = models[devices[i]]
            eng = InferenceEngine(m, config=cfg, device=devices[i],
                                  weights=weights, adapter=adapter)
            self.replicas.append(
                _Replica(i, eng, devices[i], breaker_factory()))
        self.adapter = self.replicas[0].engine.adapter
        self.router = Router(seed=seed)
        # The fleet prefix directory: on whenever the replicas run a
        # prefix cache; prefix_affinity=False forces it off for an
        # affinity-free A/B on the same config.
        if prefix_affinity is None:
            prefix_affinity = bool(config.prefix_cache)
        self.prefix_affinity = bool(prefix_affinity)
        self._directory = PrefixDirectory() if self.prefix_affinity \
            else None
        # Class-aware placement: submissions tagged with one of these
        # priority classes go only to the SHALLOWEST live queues. Untagged
        # traffic keeps the router order (eligibility is a skip, so the
        # seeded tie-break sequence is preserved).
        self._latency_classes = frozenset(latency_classes or ())
        self.telemetry = MergedRegistry(
            {r.rid: r.engine.telemetry for r in self.replicas})
        self.collector = TimeseriesCollector(
            self.telemetry, window_seconds=window_seconds,
            capacity=window_capacity)
        self.collector.start()
        self.counters = _FleetCounters(self.replicas)
        # Fleet-window base: metrics(reset=True) snapshots the cumulative
        # sums here, so the aggregate windows like a lone engine's metrics
        # without touching the counter windows the collector owns.
        self._agg_base = {}
        # The fleet plane's ring: routing decisions, failover arrows,
        # prefix shipments (what belongs to no engine's ring).
        self.tracer = (SpanRecorder(capacity=2048)
                       if config.telemetry else NullRecorder())
        # SLO burn-rate alerting over the collector's windows, evaluated
        # from _tick() as windows close; ``dump_dir`` arms the auto-dump
        # (merged trace + worst-K autopsies) on a firing rule or a
        # replica death.
        self._dump_dir = dump_dir
        self.dumps = []
        self.alerts = AlertManager(
            self.collector,
            default_rules() if alert_rules is None else alert_rules,
            on_fire=[lambda rule, rec:
                     self._auto_dump("alert:" + rule.name)])
        self._lock = threading.RLock()
        self._tick_lock = threading.Lock()
        self._fids = itertools.count()
        self._flow_ids = itertools.count(1)  # prefix-ship flow keys
        self._requests = {}     # fid -> FleetRequest (until harvested)
        self._orphans = []      # FleetRequests awaiting a survivor
        self._handoffs = HandoffPump()
        self.failovers = 0      # requests moved off dead replicas
        self._idle_wait_s = idle_wait_s
        self._poll_s = poll_s
        self._started = False
        self._closed = False
        if start:
            self.start()

    # ------------------------------------------------------------ threads

    def start(self):
        """Launch the per-replica stepping threads (idempotent)."""
        with self._lock:
            if self._started or self._closed:
                return
            self._started = True
        for rep in self.replicas:
            rep.thread = threading.Thread(
                target=self._replica_loop, args=(rep,),
                name="ds-fleet-replica-{}".format(rep.rid), daemon=True)
            rep.thread.start()

    def _replica_loop(self, rep):
        while not rep.stop.is_set():
            if self._orphans:
                self._pump()
            if self._handoffs.pending:
                self._pump_handoffs()
            progressed = self._step_replica(rep)
            if rep.failed:
                return  # dead is terminal; the thread's work is done
            self._tick()
            if not progressed:
                rep.wake.wait(self._idle_wait_s)
                rep.wake.clear()

    def _step_replica(self, rep):
        """One guarded engine step; True when work was done. ANY escape
        from step() (EngineDeadError, or an unexpected exception:
        crash-only) fails the replica and fails its live requests over."""
        dead = None
        with rep.lock:
            if rep.failed or rep.engine.health == "dead":
                return False
            if rep.engine.idle:
                return False
            try:
                rep.engine.step()
            except EngineDeadError as e:
                dead = e
            except Exception as e:  # noqa: BLE001 — crash-only failover
                logger.exception(
                    "fleet: replica %d step raised unexpectedly — "
                    "failing it over", rep.rid)
                dead = e
                try:
                    rep.engine._health.to("dead")
                except Exception:  # noqa: BLE001 — already dead is fine
                    pass
            else:
                self._observe_resilience(rep)
                self._sync_prefixes(rep)
                self._collect_handoffs(rep)
        if dead is not None:
            self._failover(rep, dead)
            return False
        return True

    def _observe_resilience(self, rep):
        """Feed the breaker from the engine's resilience counters (under
        rep.lock, right after a step): a watchdog stall or a recovery is
        sickness, not load, so trip at once. A recovery reset the pool:
        drop the replica's directory entries."""
        c = rep.engine.counters
        stalls = c["step_stalls"]
        recoveries = c["recoveries"]
        if stalls > rep.last_stalls or recoveries > rep.last_recoveries:
            rep.breaker.trip()
        if recoveries > rep.last_recoveries and \
                self._directory is not None:
            self._directory.invalidate(rep.rid)
        rep.last_stalls = stalls
        rep.last_recoveries = recoveries

    def _sync_prefixes(self, rep):
        """Publish this replica's live prefix rows into the directory
        (under rep.lock, after a clean step), gated by the store's
        ``version``."""
        if self._directory is None:
            return
        hier = rep.engine._hier
        if hier is None or hier.store is None:
            return
        version = hier.store.version
        if version == rep.last_prefix_version:
            return
        self._directory.sync(rep.rid, hier.store.tokens.values())
        rep.last_prefix_version = version

    # ----------------------------------------------- disaggregated handoff

    def _collect_handoffs(self, rep):
        """Move a prefill replica's fresh captures from its outbox onto the
        pump (under rep.lock, after a clean step). A capture whose fleet
        handle is gone (cancelled and harvested meanwhile) settles on the
        donor at once."""
        if not rep.engine._handoff_outbox:
            return
        items = []
        with self._lock:
            for req, record, t0 in rep.engine.take_handoffs():
                fr = next((f for f in self._requests.values()
                           if f._req is req), None)
                if fr is None:
                    rep.engine.finish_handoff(req)
                    continue
                items.append((fr, rep, req, record, t0))
        if items:
            self._handoffs.put(items)

    def _pump_handoffs(self):
        """Place each claimed migration on a decode-capable replica (or
        settle it: cancelled, donor failed over, or fallen back); what
        cannot place now (every acceptor full) requeues."""
        items = self._handoffs.claim()
        if not items:
            return
        remaining = [item for item in items
                     if not self._place_handoff(*item)]
        if remaining:
            self._handoffs.requeue(remaining)

    def _place_handoff(self, fr, donor, req, record, t0):
        """One migration attempt. True when the item SETTLED (adopted,
        dropped, or fallen back), False to retry on a later pass."""
        with self._lock:
            if fr._cancelled or fr.done or fr._req is not req \
                    or req.phase != "handoff":
                # The stream moved on without us: cancel reached it, or
                # the donor died and _failover orphaned it.
                self._settle_handoff(donor, req, t0, "dropped")
                return True
            spec = dict(_respec(req), submit_time=req.submit_time,
                        admit_time=req.admit_time, resync=req.resync)
        # Donor-side anchor of the migration arrow: the acceptor's
        # handoff_in (scheduler.adopt) closes the same flow key.
        hop = req.trace.hop()
        spec["flow"] = "handoff/{}/{}".format(req.trace.tid, hop)
        donor.engine.tracer.instant(
            "request/handoff_out", tid=req.trace.tid, rid=req.rid,
            hop=hop, flow_out=spec["flow"], fid=fr.fid,
            tokens_emitted=len(req.tokens))
        acceptors = self._ordered(include_draining=True, role="decode")
        if not acceptors:
            return self._handoff_fallback(fr, donor, req, t0)
        return any(self._try_acceptor(acc, donor, fr, req, record, spec, t0)
                   for acc in acceptors)

    def _try_acceptor(self, acc, donor, fr, req, record, spec, t0):
        """Try ONE decode-capable acceptor; True when settled on it (or
        found cancelled at commit), False when it cannot take the stream
        now (dead, full).

        Adopt and commit both run under acc.lock, with the fleet lock
        nested for the commit (the rep.lock -> self._lock order): the
        acceptor cannot fail between adoption and the handle pointing at
        it, and the phase re-check serializes against cancel()'s handoff
        branch, so a cancel lands either before (the adopted copy is
        cancelled) or after (it retries against the new owner)."""
        with acc.lock:
            if acc.failed:
                return False
            if not acc.engine._scheduler.free_slot_ids():
                return False
            new_req = acc.engine.adopt_handoff(spec, record)
            if new_req is None:
                return False
            with self._lock:
                committed = not (fr._cancelled or fr._req is not req
                                 or req.phase != "handoff")
                if committed:
                    if req.first_token_time is not None and \
                            fr._first_token_time is None:
                        fr._first_token_time = req.first_token_time
                    fr._rehome(new_req, acc.rid)
                else:
                    acc.engine.cancel(new_req)
        self._settle_handoff(donor, req, t0,
                             "adopted" if committed else "dropped")
        if committed:
            acc.wake.set()
        return True

    def _settle_handoff(self, donor, req, t0, outcome):
        """Donor-side epilogue of a settled migration: forget the record
        and unpin its prefix row; an adoption observes capture -> adopt on
        the DONOR's histogram, a fallback counts on its bank. Host-side
        only, so safe on a failed donor."""
        with donor.lock:
            donor.engine.finish_handoff(req)
            if outcome == "adopted":
                donor.engine._handoff_latency_hist.observe(
                    time.time() - t0)
            elif outcome == "fallback":
                donor.engine.counters["handoff_fallbacks"] += 1

    def _handoff_fallback(self, fr, donor, req, t0):
        """No decode-capable replica is alive: degrade every surviving
        prefill replica to effective-mixed (capture OFF, so a replayed
        stream completes there instead of bouncing back into the pump) and
        replay this stream through the orphan path on any survivor."""
        for rep in self.replicas:
            if rep.alive and rep.engine.role == "prefill":
                with rep.lock:
                    rep.engine._handoff_enabled = False
        with self._lock:
            live = not (fr._cancelled or fr.done) and fr._req is req \
                and req.phase == "handoff"
            if live:
                fr._orphan()
                self._orphans.append(fr)
        if live:
            # Open the arrow the survivor's failover_in closes.
            donor.engine.tracer.instant(
                "request/handoff_fallback", tid=fr.trace.tid,
                fid=fr.fid, hop=fr.trace.hop(),
                flow_out=fr._respec["flow"])
        self._settle_handoff(donor, req, t0,
                             "fallback" if live else "dropped")
        self._pump()
        return True

    def _tick(self):
        # Non-blocking: whichever thread reaches the window boundary first
        # closes it; the others skip.
        closed = None
        if self._tick_lock.acquire(False):
            try:
                closed = self.collector.tick()
            finally:
                self._tick_lock.release()
        if closed is not None:
            # Outside the tick lock: evaluate() serializes on its own lock
            # and fires dump hooks, which must not block ticking.
            self.alerts.evaluate()

    # ------------------------------------------------------------- submit

    def _ordered(self, include_draining=False, match=None, role=None,
                 shallow=False):
        views = [rep for rep in self.replicas
                 if rep.alive and (rep.engine.health in
                                   ("healthy", "degraded")
                                   or include_draining)]
        # Role eligibility: a view qualifies for ``role`` work if it
        # holds that role or is mixed. The router SKIPS ineligible views
        # (no score, no draw).
        eligible = None
        if role is not None:
            eligible = [rep.engine.role in (role, "mixed")
                        for rep in views]
        # Latency-class placement: only the minimum queue depth among the
        # views still eligible, by the same skip.
        if shallow and views:
            depths = [rep.queue_depth for rep in views]
            base = eligible if eligible is not None \
                else [True] * len(views)
            pool = [d for d, e in zip(depths, base) if e]
            if pool:
                dmin = min(pool)
                eligible = [e and d <= dmin
                            for d, e in zip(depths, base)]
        if not match:
            return self.router.order(views, eligible=eligible)
        # Prefix affinity: matched depth over the prefix row length, zero
        # below min_prefix_len (the acceptor's probe would miss anyway).
        plen = float(max(self.config.prefix_len, 1))
        minp = self.config.min_prefix_len
        affinity = []
        for rep in views:
            d = match.get(rep.rid, 0)
            affinity.append(min(d, plen) / plen if d >= minp else 0.0)
        return self.router.order(views, affinity, eligible=eligible)

    def _match_prefix(self, prompt):
        """Directory longest match for one prompt: {replica_id: depth}, or
        {} when affinity is off or the prompt is malformed (engine.submit
        is the authority on that)."""
        if self._directory is None:
            return {}
        try:
            toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        except (TypeError, ValueError):
            return {}
        if not toks:
            return {}
        return self._directory.match(toks)

    def _maybe_adopt(self, rep, prompt, match):
        """Cross-replica adoption: ``rep`` was routed a prompt whose best
        published prefix another replica holds, so ship that row instead
        of prefilling it again. True when ``rep`` now holds a usable
        prefix. The donor's and the acceptor's locks are taken in turn,
        never nested; both re-validate against their live store."""
        minp = self.config.min_prefix_len
        own = match.get(rep.rid, 0)
        best, donors = 0, []
        for rid, d in match.items():
            if rid == rep.rid:
                continue
            peer = self.replicas[rid]
            if not peer.alive:
                continue
            if d > best:
                best, donors = d, [peer]
            elif d == best and d > 0:
                donors.append(peer)
        if best < minp or best <= own:
            return own >= minp
        toks = [int(t) for t in np.asarray(prompt).reshape(-1)]
        exported = None
        for donor in sorted(donors, key=lambda r: r.rid):
            with donor.lock:
                if donor.failed:
                    continue
                exported = donor.engine.export_prefix(toks[:best])
            if exported is not None:
                break
        if exported is None:
            return own >= minp
        matched, record = exported
        with rep.lock:
            if rep.failed:
                return False
            ok = rep.engine.adopt_prefix(matched, record)
        if ok:
            key = "prefix/{}".format(next(self._flow_ids))
            donor.engine.tracer.instant(
                "prefix/ship_out", flow_out=key, tokens=len(matched),
                to_replica=rep.rid)
            rep.engine.tracer.instant(
                "prefix/ship_in", flow_in=key, tokens=len(matched),
                from_replica=donor.rid)
            self._directory.add(rep.rid, matched)
        return ok or own >= minp

    def submit(self, prompt, **kw):
        """Route one request to the best live replica; returns a
        FleetRequest. Tries replicas in router order (prefix affinity
        folded in when the fleet runs a directory), consulting each
        breaker only at its attempt. A winner that lacks the prompt's best
        published prefix adopts the holder's row first (_maybe_adopt).
        Raises the fleet-level analogue of the engine's admission errors:
        QueueFull (summed queue_depth, MIN retry_after across shed hints
        and open breakers, replica_id=None) when every candidate
        rejected; EngineDraining when every live replica has admissions
        closed; EngineDeadError when the whole fleet is dead."""
        if self._closed:
            raise RuntimeError("submit() on a closed fleet")
        if self._orphans:
            self._pump()
        # fid and trace context before placement, so the routing decision
        # lands on the request's track.
        fid = next(self._fids)
        ctx = kw.pop("trace", None)
        if ctx is None:
            ctx = TraceContext(FLEET_TID_BASE + fid, origin="fleet")
        kw["trace"] = ctx
        match = self._match_prefix(prompt)
        role = "prefill" if self._disagg else None
        shallow = kw.get("priority") in self._latency_classes
        candidates = self._ordered(match=match, role=role, shallow=shallow)
        if not candidates and role is not None:
            # Every prefill-capable replica is gone: any survivor (a
            # decode-role one completes the stream locally).
            candidates = self._ordered(match=match)
        if not candidates:
            if any(rep.alive for rep in self.replicas):
                raise EngineDraining(
                    "fleet: every live replica is draining — admissions "
                    "reopen after undrain_all()/rolling_drain()")
            raise EngineDeadError("fleet: every replica is dead")
        depth = 0
        hints = []
        for rep in candidates:
            if not rep.breaker.allow():
                hints.append(rep.breaker.retry_after_s())
                continue
            affine = bool(match) and self._maybe_adopt(rep, prompt, match)
            with rep.lock:
                if rep.failed:
                    continue
                try:
                    req = rep.engine.submit(prompt, **kw)
                except QueueFull as e:
                    rep.breaker.record_failure(e.retry_after_s)
                    depth += e.queue_depth or 0
                    if e.retry_after_s is not None:
                        hints.append(e.retry_after_s)
                    continue
                except (EngineDraining, EngineDeadError):
                    continue
                rep.breaker.record_success()
                if affine:
                    rep.engine.counters["affinity_routed"] += 1
                with self._lock:
                    fr = FleetRequest(fid, rep.rid, req)
                    self._requests[fr.fid] = fr
            # Routing evidence on the fleet plane, with the winner's
            # decision-time gauges.
            self.tracer.instant(
                "request/routed", tid=ctx.tid, hop=ctx.hop(),
                fid=fid, replica=rep.rid,
                queue_depth=int(rep.queue_depth),
                slot_occupancy=round(float(rep.slot_occupancy), 4),
                affinity=bool(affine), shallow=bool(shallow),
                role=role or "any")
            rep.wake.set()
            return fr
        retry = min(hints) if hints else None
        if retry is not None:
            retry = round(min(max(retry, 0.0), RETRY_AFTER_CAP_S), 4)
        raise QueueFull(
            "fleet: all {} candidate replica(s) rejected the request "
            "(open breaker or full queue){}".format(
                len(candidates),
                "" if retry is None else
                " (retry_after_s hint: {})".format(retry)),
            queue_depth=depth, retry_after_s=retry, replica_id=None,
            priority=kw.get("priority"), tenant=kw.get("tenant"),
            reason="queue_full")

    # --------------------------------------------------------- preemption

    def preempt(self, fr):
        """Park ``fr`` on its owning replica (engine.preempt). False when
        it is not parkable now (mid-failover, wrong phase, owner dead, no
        swap room); retries if a failover moves it meanwhile."""
        while True:
            rep_id = fr.replica_id
            if rep_id is None:
                return False
            rep = self.replicas[rep_id]
            with rep.lock:
                if fr.replica_id != rep_id or fr._req is None:
                    continue  # failover moved it — retry
                if not rep.alive:
                    return False
                return rep.engine.preempt(fr._req)

    def release_preempted(self, fr):
        """Lift the preemption hold on ``fr``. False when it is
        mid-failover or its owner died (the hold died with the engine's
        ledgers; the replay requeues the stream)."""
        while True:
            rep_id = fr.replica_id
            if rep_id is None:
                return False
            rep = self.replicas[rep_id]
            with rep.lock:
                if fr.replica_id != rep_id or fr._req is None:
                    continue
                if not rep.alive:
                    return False
                rep.engine.release_preempted(fr._req)
            rep.wake.set()
            return True

    # ------------------------------------------------------------ harvest

    def harvest(self):
        """Completed FleetRequests not yet harvested, in completion order.
        Harvested handles leave the fleet's table; unfinished ones stay
        tracked for failover."""
        with self._lock:
            done = [fr for fr in self._requests.values() if fr.done]
            for fr in done:
                del self._requests[fr.fid]
        return sorted(done, key=lambda fr: fr.finish_time or 0.0)

    # ------------------------------------------------------------- cancel

    def cancel(self, fr):
        """Cancel wherever the request lives NOW: on its owning replica
        (engine.cancel), on a DEAD replica's scheduler (host-side only: the
        dead pool is not touched), or in the orphan list mid-failover.
        False when it had already finished. Retries if a failover moves
        the request between the ownership read and the replica lock."""
        while True:
            rep_id = fr.replica_id
            if rep_id is None:
                with self._lock:
                    if fr.done:
                        return False
                    if fr.replica_id is not None:
                        continue  # re-homed between read and lock
                    if fr in self._orphans:
                        self._orphans.remove(fr)
                    fr._mark_cancelled(time.time())
                    return True
            rep = self.replicas[rep_id]
            with rep.lock:
                if fr.replica_id != rep_id or fr._req is None:
                    continue  # failover moved it — retry
                if rep.alive:
                    if fr._req.phase == "handoff":
                        # Mid-migration: serialize with the pump's commit
                        # (self._lock under rep.lock, the allowed order).
                        with self._lock:
                            if fr.replica_id != rep_id:
                                continue  # the pump won — retry there
                            return rep.engine.cancel(fr._req)
                    return rep.engine.cancel(fr._req)
                # Dead owner, failover not yet run: host-side only.
                return rep.engine._scheduler.cancel(fr._req)

    # ----------------------------------------------------------- failover

    def _failover(self, rep, exc):
        """Move every live request off a failed replica: each snapshots
        its re-homing spec and joins the orphan list; then one pump pass
        tries to place them."""
        with rep.lock:
            with self._lock:
                if rep.failed:
                    return
                rep.failed = True
                rep.cause = exc
                moved = [fr for fr in self._requests.values()
                         if fr.replica_id == rep.rid and not fr.done]
                for fr in moved:
                    fr._orphan()
                    # The dead owner's last word on this stream, on ITS
                    # ring (host-side; the ring outlives the pool).
                    rep.engine.tracer.instant(
                        "request/failover_out", tid=fr.trace.tid,
                        fid=fr.fid, hop=fr.trace.hop(),
                        flow_out=fr._respec["flow"],
                        tokens_emitted=len(fr._prior),
                        error=type(exc).__name__)
                self._orphans.extend(moved)
                self.failovers += len(moved)
                if self._directory is not None:
                    self._directory.invalidate(rep.rid)
        logger.warning(
            "fleet: replica %d is dead (%s: %s) — failing over %d live "
            "request(s) to survivors", rep.rid, type(exc).__name__, exc,
            len(moved))
        self._auto_dump("replica_death:{}".format(rep.rid))
        self._pump()

    def _pump(self):
        """Place orphans on survivors: claim the list atomically (so
        concurrent pumps never place one request twice), try each against
        the router-ordered survivors, requeue what does not fit."""
        with self._lock:
            orphans, self._orphans = self._orphans, []
        if not orphans:
            return
        remaining = []
        for fr in orphans:
            if fr._cancelled or not self._place_orphan(fr):
                if not fr._cancelled:
                    remaining.append(fr)
        if remaining:
            with self._lock:
                self._orphans.extend(remaining)

    def _place_orphan(self, fr):
        """One placement attempt across router-ordered survivors, DRAINING
        ones included (accepted is a promise), straight into the
        survivor's queue (``InferenceEngine.resubmit``: the replay by
        re-derivation). Breakers are not consulted: the queue's QueueFull
        says what an open breaker would."""
        spec = fr._respec
        for rep in self._ordered(include_draining=True):
            with rep.lock:
                if rep.failed:
                    continue
                try:
                    req = rep.engine.resubmit(spec)
                except QueueFull:
                    continue
                # Close the failover arrow on the survivor's ring.
                rep.engine.tracer.instant(
                    "request/failover_in", tid=req.trace.tid,
                    fid=fr.fid, hop=req.trace.hop(),
                    flow_in=spec.get("flow"), replica=rep.rid,
                    tokens_delivered=len(spec["tokens"]))
                with self._lock:
                    fr._rehome(req, rep.rid)
            rep.wake.set()
            logger.info("fleet: request %d failed over to replica %d "
                        "(%d tokens delivered, re-derived there)", fr.fid,
                        rep.rid, len(spec["tokens"]))
            return True
        return False

    # ------------------------------------------------------------ driving

    def step(self):
        """One fleet 'step' for single-threaded drivers (the loadgen
        runner, start=False tests): pump orphans and handoffs, then
        either yield to the stepping threads (started fleets) or step each
        replica inline, round-robin. Returns [] (completions are read
        through the handles / harvest())."""
        if self._orphans:
            self._pump()
        if self._handoffs.pending:
            self._pump_handoffs()
        if self._started:
            time.sleep(self._poll_s)
            self._tick()
            return []
        for rep in self.replicas:
            self._step_replica(rep)
        self._tick()
        return []

    @property
    def idle(self):
        """True when nothing is queued, running, orphaned or mid-handoff
        anywhere; dead replicas excluded (their live work was failed
        over)."""
        if self._orphans or self._handoffs.pending:
            return False
        return all(rep.failed or rep.engine.idle for rep in self.replicas)

    def _wait(self, pred, timeout_s):
        t0 = time.time()
        while not pred():
            if self._started:
                if self._orphans:
                    self._pump()
                if self._handoffs.pending:
                    self._pump_handoffs()
                time.sleep(self._poll_s)
            else:
                self.step()
            if timeout_s is not None and time.time() - t0 >= timeout_s:
                return False
        return True

    def wait_idle(self, timeout_s=None):
        """Block until the fleet is idle (or the timeout; returns whether
        it settled). A pure wait with stepping threads; on a start=False
        fleet it drives step() itself."""
        return self._wait(lambda: self.idle, timeout_s)

    # -------------------------------------------------------------- drain

    def drain(self, timeout_s=None):
        """Fleet-wide graceful drain: close admissions on every live
        replica (the threads finish in-flight work, orphans included),
        settle idle, return harvest(). Admissions STAY closed;
        ``undrain_all()`` reopens."""
        for rep in self.replicas:
            if rep.alive:
                with rep.lock:
                    if rep.engine.health in ("healthy", "degraded"):
                        rep.engine.close_admissions()
        self._wait(lambda: self.idle, timeout_s)
        return self.harvest()

    def undrain_all(self):
        """Reopen admissions on every drained (live) replica."""
        for rep in self.replicas:
            if rep.alive:
                with rep.lock:
                    if rep.engine.health == "draining":
                        rep.engine.undrain()

    def drain_headroom(self, rep):
        """Can the OTHERS absorb ``rep``'s load? Both must hold: live spare
        capacity (survivors' free slots and queue positions against
        ``rep``'s in-flight count) and the timeseries window (survivors'
        queue depth at the last window close below half their combined
        queue capacity)."""
        others = [r for r in self.replicas
                  if r is not rep and r.alive
                  and r.engine.health in ("healthy", "degraded")]
        spare = sum(
            (r.engine.config.max_slots
             - len(r.engine._scheduler.running))
            + (r.engine.config.max_queue - len(r.engine._scheduler.queue))
            for r in others)
        inflight = (len(rep.engine._scheduler.running)
                    + len(rep.engine._scheduler.queue))
        queue_cap = sum(r.engine.config.max_queue for r in others)
        # Close the current window now, so the check reads the present.
        with self._tick_lock:
            windowed = self.collector.sample()["metrics"]
        window_queue = sum(
            v for k, v in windowed.items()
            if k.startswith("queue_depth{")
            and "replica={}".format(rep.rid) not in k
            and isinstance(v, (int, float)))
        ok = (bool(others) and spare >= inflight
              and window_queue <= queue_cap / 2.0)
        return ok, {
            "survivors": [r.rid for r in others],
            "spare_capacity": spare,
            "in_flight": inflight,
            "windowed_survivor_queue": window_queue,
            "survivor_queue_cap": queue_cap,
        }

    def rolling_drain(self, timeout_s=30.0, require_headroom=True):
        """Rolling restart: one replica at a time, verify headroom
        (drain_headroom), close its admissions, let its thread finish the
        in-flight work, reopen, move on. A replica without headroom is
        SKIPPED unless ``require_headroom=False``; dead replicas are
        skipped. Returns one report dict per replica."""
        report = []
        for rep in self.replicas:
            if not rep.alive:
                report.append({"replica": rep.rid, "drained": False,
                               "skipped": "dead"})
                continue
            ok, detail = self.drain_headroom(rep)
            if require_headroom and not ok:
                report.append({"replica": rep.rid, "drained": False,
                               "skipped": "no_headroom",
                               "headroom": detail})
                continue
            with rep.lock:
                rep.engine.close_admissions()
            drained = self._wait(
                lambda: rep.failed or rep.engine.idle, timeout_s)
            with rep.lock:
                if rep.alive and rep.engine.health == "draining":
                    rep.engine.undrain()
            report.append({"replica": rep.rid,
                           "drained": drained and rep.alive,
                           "headroom": detail})
        return report

    # -------------------------------------------------------------- chaos

    def inject_faults(self, plan, replica=0):
        """Arm a FaultPlan on ONE replica (chaos: kill replica ``replica``
        mid-run while the fleet keeps serving). Needs
        ``fault_injection=True`` in the shared config."""
        rep = self.replicas[replica]
        with rep.lock:
            return rep.engine.inject_faults(plan)

    @property
    def recovery_log(self):
        """Every replica's recovery records in time order, each stamped
        with its replica id (the loadgen chaos windows read it as a lone
        engine's)."""
        out = []
        for rep in self.replicas:
            for rec in rep.engine.recovery_log:
                d = dict(rec)
                d["replica"] = rep.rid
                out.append(d)
        out.sort(key=lambda d: d["t_start"])
        return out

    # ------------------------------------------------------------ metrics

    @property
    def health(self):
        """The best any replica offers: one healthy replica makes a healthy
        fleet; degraded-only -> degraded; live-but-closed -> draining;
        nobody left -> dead."""
        states = [rep.engine.health if not rep.failed else "dead"
                  for rep in self.replicas]
        for s in ("healthy", "degraded", "draining"):
            if s in states:
                return s
        return "dead"

    def metrics(self, reset=False):
        """Aggregated fleet view + per-replica engine metrics.
        ``reset=True`` forwards to every engine (the windows the collector
        also reads). The aggregate counters window against the FLEET's own
        base (cumulative minus the snapshot at the last reset), so two
        metrics(reset=True) calls bracket exactly the work between them;
        without a reset they count since construction, dead replicas'
        history included."""
        per_replica = {rep.rid: rep.engine.metrics(reset=reset)
                       for rep in self.replicas}
        agg = {}
        for name in ("tokens_out", "requests_completed", "recoveries",
                     "requests_replayed", "deadline_sheds", "step_stalls",
                     "faults_injected", "prefix_hits", "prefix_misses",
                     "prefix_adoptions", "prefix_bytes_shipped",
                     "affinity_routed", "handoffs", "handoffs_in",
                     "handoff_fallbacks", "handoff_bytes_shipped",
                     "preemptions", "preempt_resumes"):
            if name in self.counters:
                total = self.counters[name]
                agg[name] = total - self._agg_base.get(name, 0)
                if reset:
                    self._agg_base[name] = total
        agg.update({
            "n_replicas": len(self.replicas),
            "alive": sum(1 for rep in self.replicas if rep.alive),
            "health": self.health,
            "failovers": self.failovers,
            "orphans": len(self._orphans),
            "roles": {rep.rid: rep.engine.role for rep in self.replicas},
            "pending_handoffs": len(self._handoffs.pending),
            "breaker_states": {rep.rid: rep.breaker.state
                               for rep in self.replicas},
        })
        if self._directory is not None:
            agg["prefix_directory"] = self._directory.snapshot()
            agg["prefix_hit_rate"] = self.prefix_hit_rate()
        agg["alerts_firing"] = sorted(self.alerts.firing())
        agg["alerts_fired"] = len(self.alerts.fired())
        return {"fleet": agg, "replicas": per_replica}

    def perf_xray(self):
        """Every replica's ``perf_xray`` section (``InferenceEngine
        .perf_xray``) under its replica label, the rid: the artifact the
        regression gate reads. A replica with the x-ray off, or dead,
        contributes None. The roofline and HBM gauges already flow
        through the merged registry with ``replica`` labels."""
        return {rep.rid: (rep.engine.perf_xray() if rep.alive else None)
                for rep in self.replicas}

    def prefix_hit_rate(self):
        """Fleet-wide prefix hit rate (hits / probes; 0.0 with no
        probes)."""
        c = self.counters
        hits = c["prefix_hits"] if "prefix_hits" in c else 0
        misses = c["prefix_misses"] if "prefix_misses" in c else 0
        total = hits + misses
        return hits / total if total else 0.0

    def prometheus(self):
        """One exposition of the WHOLE fleet: every replica's series with
        its ``replica`` label, plus the alert manager's registry."""
        return (prometheus_text(self.telemetry)
                + prometheus_text(self.alerts.telemetry))

    # ------------------------------------------------------------- tracing

    def trace_recorders(self):
        """Every ring a fleet request may have stamped, labelled: ``fleet``
        plus each replica's."""
        recs = {"fleet": self.tracer}
        for rep in self.replicas:
            recs.update(rep.engine.trace_recorders())
        return recs

    def write_trace(self, path):
        """Merge every ring into ONE Perfetto-loadable trace: a process row
        per ring, flow arrows across replicas (handoff, failover, prefix
        ship), the collector's windows as counter tracks."""
        if isinstance(self.tracer, NullRecorder):
            raise RuntimeError("telemetry is disabled: no trace to write")
        return write_merged_trace(
            path, self.trace_recorders(),
            extra_events=self.collector.chrome_counter_events())

    def _resolve_tid(self, fr_or_fid):
        with self._lock:
            if isinstance(fr_or_fid, FleetRequest):
                return fr_or_fid.trace.tid
            fr = self._requests.get(fr_or_fid)
        if fr is None:
            raise KeyError("unknown fleet request: {!r}".format(fr_or_fid))
        return fr.trace.tid

    def explain(self, fr_or_fid):
        """Structured autopsy of one request (telemetry/autopsy.py), from
        the handle or its fid."""
        if isinstance(self.tracer, NullRecorder):
            raise RuntimeError(
                "telemetry is disabled: no trace to explain")
        return build_autopsy(self.trace_recorders(),
                             self._resolve_tid(fr_or_fid))

    def _auto_dump(self, cause):
        """On a firing alert or a replica death: write the merged trace and
        the worst-K request autopsies into ``dump_dir``, record the dump
        in ``self.dumps``. No-op without a dump_dir or with telemetry off;
        never raises."""
        if self._dump_dir is None or isinstance(self.tracer, NullRecorder):
            return None
        try:
            n = len(self.dumps)
            stem = "dump{:03d}_{}".format(
                n, "".join(ch if ch.isalnum() else "_"
                           for ch in str(cause)))
            trace_path = os.path.join(self._dump_dir, stem + ".trace.json")
            self.write_trace(trace_path)
            with self._lock:
                frs = list(self._requests.values())
            recs = self.trace_recorders()
            autopsies = [build_autopsy(recs, fr.trace.tid) for fr in frs]
            worst = worst_requests(autopsies, k=4)
            autopsy_path = os.path.join(
                self._dump_dir, stem + ".autopsies.json")
            with open(autopsy_path, "w") as f:
                json.dump({"cause": str(cause),
                           "firing": self.alerts.firing(),
                           "worst_requests": worst}, f, indent=1)
            record = {"cause": str(cause), "trace": trace_path,
                      "autopsies": autopsy_path, "requests": len(worst)}
            self.dumps.append(record)
            logger.warning("fleet: auto-dump (%s) -> %s", cause,
                           trace_path)
            return record
        except Exception:  # noqa: BLE001 — the black box must never
            # take down the serving loop that feeds it.
            logger.exception("fleet: auto-dump failed (%s)", cause)
            return None

    @property
    def compile_counts(self):
        """Per-replica program counts (``InferenceEngine.compile_count``):
        killing one replica must leave every other entry unchanged."""
        return {rep.rid: rep.engine.compile_count
                for rep in self.replicas}

    # ------------------------------------------------------------ teardown

    def close(self, timeout_s=5.0):
        """Stop and JOIN every replica thread, stop every watchdog.
        Idempotent; a closed fleet still reads (metrics, harvest) but never
        steps or submits again."""
        # The flag flips under the lock; the joins run OUTSIDE it (replica
        # threads take self._lock in _pump).
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for rep in self.replicas:
            rep.stop.set()
            rep.wake.set()
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=timeout_s)
        for rep in self.replicas:
            rep.engine.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
