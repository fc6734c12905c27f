"""InferenceEngine: continuous-batching serving over the slotted KV pool.

Counterpart of ``deepspeed_tpu/inference/engine.py``: chunked prefill into a
dense or paged pool of fp or int8 planes, with or without speculative
decoding. Every step is the JAX package's mixed step,
``_mixed_step_program``, in which every per-request fact is a tensor:

- PREFILL LANE: when a slot is mid-prompt, append one ``prefill_chunk``
  slice of the oldest prefilling request at its cursor (the adapter's
  ``prefill_append``, k/v written in place at the frontier). When the slice
  is the prompt's last (``done``), sample the request's first token and
  install its decode state on the device; it starts decoding in this
  step's decode lane. The slot, frontier, slice length and the request's
  budget, EOS and sampling parameters are read from the step's input
  buffer, never from Python values.
- DECODE LANE: advance every slot ``chunk_size`` tokens with the adapter's
  ``decode_step``. Inactive slots flow through frozen: their frontier is
  pinned and their emissions masked, so occupancy never changes a shape.

SPECULATIVE DECODING (``inference.spec_decode``; prompt-lookup drafting,
no draft model) swaps the decode lane's body for a draft/verify step
(``_spec_decode_chunk_program``): each slot drafts ``spec_k`` tokens by
``spec_ngram``-gram lookup over its own token ring (``kv_pool``), one
``verify_forward`` scores its frontier token and the drafts (``spec_k + 1``
query rows through K3-K6) without moving the frontier, and the longest
draft prefix that agrees with the model's own choices is accepted with the
choice after it: 1..spec_k+1 tokens per slot per step. Rollback is not
moving the frontier: rejected positions hold k/v and ring entries past it,
masked or overwritten before it gets there. Every choice is drawn at its
own (seed, position), so greedy and sampled streams are those of the plain
decode lane. Speculation is an engine-lifetime fact, like the JAX static
argument: it sizes the plane slack (``max(prefill_chunk, spec_k + 1)``),
the ring and the harvest, and it is not part of the program key. A request
that opts out (``submit(spec_decode=False)``) rides the same program: its
slot's ``spec`` field vetoes agreement, so it emits one token per step.

ONE PROGRAM PER KEY, CAPTURED ON THE CARD. The JAX engine jits the step
once (``compile_count`` 1 whatever the prompt mix); its ``lax.cond``
branches are data. The port's program branches on three host facts, its
KEY: whether the prefill lane runs, whether any row that can emit samples,
and whether any filters top-k (``ops.sampling.sample_rows`` skips the
[R, V] sort and draw when none does). The pool's layout is fixed per
engine, so an engine has at most 8 programs. On a CUDA device the first
step that meets a key runs the program eagerly (that step's work, and the
warm-up: cuBLAS, the kernel library), and the engine then captures the
program as a ``torch.cuda.CUDAGraph``; every later step with that key
replays the graph. All graphs share one memory pool, since replays run one
after another on one stream. On the CPU (tests) the same program runs
eagerly at every step and the keys are recorded alike. ``compile_count``
is the number of programs (graphs captured, on the card), cumulative;
``graph_replays`` counts the steps a program met before served. There is
no switch: a capture or replay that fails raises.

Static addresses: the pool's tensors are updated in place and never
rebound; the step's inputs (the slice, the lane's facts, the frontiers of
slots admitted this step) are packed on the host into one pinned buffer
and copied to one static device buffer per step (``kv_pool.step_inputs``);
the program writes what the host reads into one static harvest buffer
(``kv_pool.step_harvest``), copied back in ONE device-to-host transfer
after the step. A paged engine's block table is copied in place from a
pinned snapshot before the step when the host table changed. There is no
``.item()`` or ``.tolist()`` on a device tensor inside the program.

Sampling draws from the counter-based generator of ``ops.sampling``, keyed
on (request seed, absolute position): a sampled stream does not depend on
slot placement or neighbours. Greedy streams equal ``generate``'s.

PAGED pool (``inference.paged_kv``): a host-side ``PageAllocator`` owns
page lifetime. Admission is page-aware (the queue head reserves the pages
its deepest frontier needs, or the round ends); before every step the pager
maps each page the step can write. int8 KV (``inference.int8_kv``)
quantizes at the frontier write and attends through the int8 kernels.
The prefill lane reaches its slot through a one-row block table in both
layouts (``kv_pool.slot_cache_view``), so on the card it runs the paged
kernels: K5 over a dense pool, K6 over a dense int8 pool; the decode lane
runs K3/K4 over dense planes and K5/K6 over paged ones.

TELEMETRY, as in the JAX engine. The counters, gauges and latency
histograms live in one ``MetricsRegistry`` (``self.telemetry``), always
on: ``metrics(reset=True)`` reads them as a window and opens the next
(the accept statistics and the wall clock too), and ``prometheus()`` and
``telemetry_snapshot()`` read the same registry. ``inference.telemetry``
(default on) adds a ``SpanRecorder`` ring of ``trace_ring`` events and
the profiler scopes (``telemetry.annotate``): the scheduler's request
lifecycle, and per step a ``step/mixed`` span around the program
(``captured=True`` on a step that captures its key's graph: the capture
lies inside the span), a ``step/harvest`` span around the one D2H read,
``request/chunk`` instants per emitting slot and ``spec/verify``
instants on a speculating engine; ``write_trace`` dumps the ring.
``step/mixed`` measures the LAUNCH of a replayed graph, not its device
work: that lands in ``step/harvest``, which waits for the D2H copy (the
JAX spans split the same way: dispatch is asynchronous there too). The
``inference/decode`` timer spans the step from the H2D upload to the
harvest, synchronizing outside every capture. Every gauge reads host
state only, so a scrape from another thread (``PrometheusEndpoint``)
makes no CUDA call that could disturb a capture.

The ``RecompileDetector`` watches the program cache: after
``recompile_detector.mark_warm()``, a key met for the first time counts
in ``recompiles``, and the warning names the key. Warm-up is the
caller's, as on the JAX legacy path: the engine does not mark itself
warm after its first step (the JAX mixed step does: it has one program),
so the caller meets every key its traffic will meet before
``mark_warm()``.

CRASH-ONLY RESILIENCE, as in the JAX engine (``inference/resilience.py``,
``inference/faults.py``). Device state is disposable; the scheduler's
request records are the only truth. ``step()`` runs inside a watchdog
(``step_budget_s``: a timer thread that counts ``step_stalls`` and marks
the engine ``degraded``, touching neither the device nor the engine) and
catches ``fatal_step_errors()``: an injected fault, the harvest's
numerics check (``NumericsError``: a negative token in a valid lane,
caught before any token reaches a request), a CUDA error or a device
allocation failure. Recovery (``_recover``) drains the stream, resets
the pool IN PLACE to ``init_pool``'s values (``kv_pool.reset_pool``;
the page allocator and the step's host inputs too), requeues every
in-flight request at the queue's front and replays it: its prompt is
prefilled again and its decode lane re-derives the tokens it delivered
(checked, not delivered twice) before it emits new ones. Every draw is
keyed on (seed, position) and a row's arithmetic does not depend on its
slot or neighbours, so the replayed stream is the original one, bit for
bit (``_replay_requests``).
The captured graphs hold the pool's, the inputs' and the harvest's
addresses, and none of them moves, so recovery captures no graph:
``compile_count`` does not change. ``recovery_max_retries`` consecutive
failures, or a fatal error while the device is being drained or reset
(a sticky CUDA error: one process cannot clear it), end in ``dead``
(``EngineDeadError``). ``cancel``, ``drain`` / ``undrain`` /
``close_admissions``, queue-side deadlines (``submit(deadline_ms=)``),
``run(timeout_s=)``, ``health`` and ``inject_faults`` follow the JAX
engine.

THE KV HIERARCHY (``inference/kv_hierarchy``), as in the JAX engine: the
shared-prefix cache (``prefix_cache``) and host offload
(``host_offload``) beside int8 planes, on dense and paged pools, with or
without speculation. Every hierarchy operation is an eager in-place write
on the step's stream between steps, outside every captured graph: it adds
no program key and captures nothing. A step resumes swapped sessions into
free slots first (``_swap_in_ready``), then admits (``_admit``, with the
hierarchy's ``on_admit`` per admitted request: a trie hit copies the
stored prefix span into the slot's plane on a dense pool, or shares its
pages on a paged one, and starts the prefill past it), then, under slot
pressure, swaps one decoding victim out to host memory and admits again
(``_maybe_swap_out``). A finished prompt publishes a missed prefix
(``on_prefill_done``); completion and cancel unpin (``on_release``);
recovery drops all of it (``reset``), and swapped sessions replay like
running ones. A full queue sheds with ``QueueFull`` triaged as the JAX
engine does (``_augment_queue_full``: ``reason == "pages"`` with the
page-release hint when a paged queue head waits for pages;
``swap_eligible`` with an armed swap when offload can free a slot).

ONE STREAM PER ENGINE. Every device operation of an engine, eager or
replayed, runs on the engine's own CUDA stream: ``step`` (the hierarchy
hooks and recovery inside it), ``cancel``, ``preempt`` and the fleet's
transports enter it themselves, so a lone engine runs on its own stream
too and several engines on one card (``inference/fleet.py``) never
queue behind, or synchronize with, one another: every wait is a wait on
the engine's stream, never on the device. A capture names the stream,
runs with ``capture_error_mode="thread_local"`` (another thread's
allocation cannot invalidate it) and holds the process-wide
``_CAPTURE_LOCK``, as does the eager first run of a key before it
(first launches, workspace allocations). Each engine counts the decode
kernels it runs in its own ``launches`` (``decode_attention
.counting_into``): exact while other replicas step on other threads.
One CUDA context serves every engine of the process, so a sticky CUDA
error (an illegal address) ends them all: a replica's failure is its
own only for the faults recovery can clear.

THE FLEET'S ENGINE SIDE (``inference/fleet.py``), as in the JAX
engine: ``replica_id`` labels the engine's metrics; a ``prefill``-role
engine captures every request still decoding after a step's harvest in
one synchronization (``_capture_handoffs``) into its outbox
(``take_handoffs``), and a decode-capable peer installs one straight
into the ``decoding`` phase (``adopt_handoff``); ``export_prefix`` /
``adopt_prefix`` ship a shared-prefix row between replicas;
``preempt`` / ``release_preempted`` park a decoding session in the
``swapped`` phase and hold it there. Every write is eager, in place and
outside the graphs: no new key and no capture. A request re-homed on
another engine (a failover, a handoff's fallback) arrives with its
original prompt and budget and the tokens it delivered, and replays as
after a recovery (``_take``).

THE PERF X-RAY (``inference.perf_xray``; ``telemetry/xray.py``): each
program key's EAGER FIRST RUN (never the capture) runs under the x-ray's
cost modes and leaves a record under the label ``mixed_step``: the key
and the pool's shapes as its signature and fingerprint, the flops
(``FlopCounterMode``, plus the decode kernels' formula: they are ctypes
launches torch cannot see), the bytes, and the graph pool's bytes after
its capture. A key met for the first time after ``mark_warm()`` is a
recompile event the detector's warning names by the x-ray's identity.
Every step stashes its key (a signature compare) and notes its tokens; 1
in ``xray_sample_every`` replayed steps waits for the engine's stream to
time the step (the MFU/MBU denominator). ``perf_xray()`` returns the
section with the HBM ledger (weights, KV pool and graph pool against the
caching allocator's live bytes); None with the x-ray off. An MoE or
long-context adapter (``adapter=``) serves through the same programs.

SERVING OVER A MESH (``mesh=``, ``parallel/mesh.build_mesh``): the JAX
engine is one controller over its devices; the port runs one engine per
rank, SPMD. Every rank of the mesh makes the same ``submit`` / ``step`` /
``run`` calls in the same order, and the host scheduler decides only from
what every rank holds alike: the replicated logits, hence the tokens and
the harvests (a sampled draw is keyed on (seed, position), the same on
every rank). The adapter of this rank (``bind(config, mesh)``) holds its
shard of the weights over the 'model' axis and the pool its heads
(``kv_pool.init_pool(tp=)``); the 'data' axis replicates, as in the JAX
programs. ``run()`` (and ``generate``) gathers a digest of the queued
requests before it steps and one of the completed requests' tokens after
it, over every rank of the mesh, and raises ``MeshDivergence`` on a
difference: a rank whose requests differ fails loudly, before any step,
rather than hanging at a collective. What would decide from a host clock
(the step watchdog, queue deadlines, ``run(timeout_s=)``, fault injection
and recovery replay, the KV hierarchy's swap timing) is refused under a
mesh, as are the mesh's 'pipe' and 'seq' axes (ROADMAP Queue 1 item 19).

Under a model group a step program is a CHAIN OF CAPTURED SEGMENTS split
at the group's collectives (``_StepGraph``): the forward's row-parallel
partials (``tensor_parallel.serving_reduce``) end a segment inside the
capture, and each replay runs the all-reduce of that partial, in place on
its static address, between the segments' replays on the engine's stream
(gloo stages it through the host, which no capture can hold). One code
path for every backend: a program of one segment is the one-card graph.
``graph_segments`` counts the segments captured (cumulative, like
``compile_count``).
"""

import contextlib
import hashlib
import itertools
import threading
import time

import numpy as np
import torch

from deepspeed_tpu_torch.analysis.annotations import hot_path
from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.adapters import GPT2Adapter
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.kv_hierarchy import (
    KVHierarchy, capture_prefix_pages, capture_prefix_row, capture_slot,
    capture_slot_paged, capture_slots, capture_slots_paged, pick_swap_victim,
    record_nbytes, restore_prefix_pages, restore_prefix_row, restore_slot,
    restore_slot_paged, spec_from_config)
from deepspeed_tpu_torch.inference.faults import FaultInjector
from deepspeed_tpu_torch.inference.kv_pool import (
    cache_view, clear_step_inputs, harvest_names, init_pool,
    max_active_frontier, paged_plane_len, plane_len_for, pool_nbytes,
    reset_pool, slot_cache_view, step_harvest, step_inputs)
from deepspeed_tpu_torch.inference.paging import PageAllocator
from deepspeed_tpu_torch.inference.resilience import (EngineDeadError,
                                                      EngineDraining,
                                                      HealthState,
                                                      NumericsError,
                                                      StepWatchdog,
                                                      fatal_step_errors)
from deepspeed_tpu_torch.inference.scheduler import QueueFull, Scheduler
from deepspeed_tpu_torch.inference.adapters.gpt2 import ServingWeights
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHeadModel,
                                             params_from_jax)
from deepspeed_tpu_torch.ops.sampling import sample_rows as _sample_rows
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention
from deepspeed_tpu_torch.parallel import comm, tensor_parallel
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.telemetry import (HBMLedger, MetricsRegistry,
                                           NullRecorder, ProgramRegistry,
                                           RecompileDetector, SpanRecorder,
                                           annotate, build_autopsy,
                                           prometheus_digest,
                                           prometheus_text)
from deepspeed_tpu_torch.telemetry.registry import Counter
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer

# The telemetry-off profiler scope, and a CPU engine's stream: free.
_NULL_CTX = contextlib.nullcontext()

# Serializes CUDA graph captures (and the eager first run of a key before
# one) across every engine of the process (module docstring).
_CAPTURE_LOCK = threading.Lock()

_MESH_ITEM = "ROADMAP Queue 1 item 19"


class MeshDivergence(RuntimeError):
    """The ranks of a serving mesh were given, or produced, different
    requests or tokens (module docstring)."""


def _check_mesh(mesh, config):
    """Refuse what a serving mesh cannot hold (module docstring)."""
    if mesh is None or mesh.size <= 1:
        return
    for axis in (mesh_lib.PIPE_AXIS, mesh_lib.SEQ_AXIS):
        if mesh.shape[axis] > 1:
            raise ValueError(
                "serving over a mesh whose '{}' axis is {} wide is not "
                "ported: the serving mesh takes 'model' and 'data' axes "
                "({})".format(axis, mesh.shape[axis], _MESH_ITEM))
    refused = [name for name, on in (
        ("step_budget_s", config.step_budget_s is not None),
        ("fault_injection", config.fault_injection),
        ("prefix_cache", config.prefix_cache),
        ("host_offload", config.host_offload)) if on]
    if refused:
        raise ValueError(
            "inference.{} over a serving mesh: the ranks would decide "
            "apart (a host clock, recovery replay, the KV hierarchy); not "
            "ported ({})".format(", ".join(refused), _MESH_ITEM))
    if mesh_lib.mp_size(mesh) > 1 and mesh.mp_group is None:
        raise ValueError("a 'model' axis of size {} needs a process group "
                         "(torch.distributed)".format(
                             mesh_lib.mp_size(mesh)))


# The JAX engine's counters that the port's features drive.
_COUNTERS = ("tokens_out", "chunks", "prefills", "prefill_tokens",
             "requests_completed", "occupied_slot_steps", "slot_steps",
             "faults_injected", "recoveries", "requests_replayed",
             "deadline_sheds", "step_stalls",
             # The KV hierarchy's: zero forever on an engine without it.
             "prefix_hits", "prefix_misses", "prefix_inserts",
             "prefix_evictions", "swap_outs", "swap_ins",
             # Preemption, prefix adoption and disaggregated handoff: zero
             # forever outside a fleet (the fleet counts affinity_routed).
             "preemptions", "preempt_resumes", "prefix_adoptions",
             "prefix_bytes_shipped", "affinity_routed", "handoffs",
             "handoffs_in", "handoff_fallbacks", "handoff_bytes_shipped")


class _CounterBank(object):
    """Dict-shaped view over registry counters: ``bank["tokens_out"] +=
    n`` while the values live in the telemetry registry, ONE source of
    truth for metrics() and Prometheus. Reads return ints; monotonicity
    is enforced by the underlying Counter. (The JAX engine's class.)"""

    __slots__ = ("_c",)

    def __init__(self, registry, names):
        self._c = {n: registry.counter(n) for n in names}

    def __getitem__(self, name):
        return int(self._c[name].value)

    def __setitem__(self, name, value):
        c = self._c[name]
        c.inc(value - c.value)

    def __contains__(self, name):
        return name in self._c

    def __iter__(self):
        return iter(self._c)

    def keys(self):
        return self._c.keys()

    def items(self):
        return [(n, int(c.value)) for n, c in self._c.items()]

    def window(self, name):
        """Value accumulated since the last metrics(reset=True)."""
        return int(self._c[name].window_value)


class _ProgramCache(dict):
    """Program key -> ``_StepGraph`` on the card, None on the CPU: one
    program per key met. ``_cache_size`` is what the RecompileDetector
    reads; ``describe`` names the key added last in its warning."""

    newest = None

    def __setitem__(self, key, program):
        self.newest = key
        super().__setitem__(key, program)

    def _cache_size(self):
        return len(self)

    def describe(self, label):
        return "key (prefill lane, any row samples, any row top-k) = " \
            "{}".format(self.newest)


def _no_sync():
    """A CPU engine's timer edge: there is no queue to wait for."""


def _tensor_bytes(obj, seen=None):
    """Bytes of the distinct tensors reachable from ``obj`` (weights held
    in namespaces, lists, dicts, modules), each storage counted once."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.untyped_storage().data_ptr(), obj.device)
        if key in seen:
            return 0
        seen.add(key)
        return obj.untyped_storage().nbytes()
    if isinstance(obj, torch.nn.Module):
        return sum(_tensor_bytes(t, seen) for t in
                   list(obj.parameters()) + list(obj.buffers()))
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if hasattr(obj, "__dict__"):
        return sum(_tensor_bytes(v, seen) for v in vars(obj).values())
    return 0


def _live_tokens(scheduler):
    """Tokens resident across running requests: the numerator of the
    page-fragmentation gauge."""
    total = 0
    for r in list(scheduler.running.values()):
        if r.phase == "prefilling":
            total += int(r.cursor)
        else:
            total += int(r.prompt.size) + len(r.tokens)
    return total


def _on_stall(counters, health, scheduler):
    """The watchdog's trip handler (JAX ``InferenceEngine._on_stall``). It
    runs on the TIMER THREAD while the step may still be executing, even
    inside a graph capture, so it signals only: a counter, a log line and
    the health state, and no CUDA call. It closes over the counter bank,
    the health machine and the scheduler, never the engine, so an engine
    dropped is freed at once (the watchdog would otherwise hold a bound
    method of the engine)."""
    def trip(budget_s):
        counters["step_stalls"] += 1
        logger.warning(
            "inference.watchdog: step still running past its %.3fs budget "
            "— device stall? (%d running, %d queued; health -> degraded)",
            budget_s, len(scheduler.running), len(scheduler.queue))
        if health.state == "healthy":
            health.to("degraded")
    return trip


@hot_path
def _decode_chunk_program(params, adapter, chunk, pool, harvest, any_sample,
                          any_top_k):
    """Advance every ACTIVE slot ``chunk`` tokens, in place. Writes
    ``harvest['toks'][t]`` [slots, 1] (slot s's token at step t, -1 where
    frozen) and ``harvest['valid'][t]`` (slot s active at step t). Frozen
    slots still run ``decode_step``; their frontier is pinned, so their
    writes land at their own frozen frontier, where a later admission
    overwrites them before any mask can see them."""
    for t in range(chunk):
        # ``active`` and ``pos`` alias the pool's fields: every value below
        # is computed from them before the in-place updates at the end.
        active, pos = pool["active"], pool["pos"]
        logits, cache = adapter.decode_step(params, pool["last_tok"],
                                            cache_view(pool))
        nxt = _sample_rows(logits, pool["temp"], pool["top_k"], pool["seed"],
                           cache["pos"], any_sample, any_top_k)
        nxt = torch.where(active, nxt, pool["last_tok"])
        hit_eos = (pool["eos"] >= 0) & (nxt == pool["eos"])
        remaining = torch.where(active, pool["remaining"] - 1,
                                pool["remaining"])
        new_pos = torch.where(active, cache["pos"], pos)
        new_active = active & ~hit_eos & (remaining > 0)
        harvest["toks"][t].copy_(torch.where(active, nxt, -1)[:, None])
        harvest["valid"][t].copy_(active[:, None])
        pos.copy_(new_pos)
        pool["last_tok"].copy_(nxt)
        pool["remaining"].copy_(remaining)
        active.copy_(new_active)


@hot_path
def _spec_decode_chunk_program(params, adapter, chunk, spec_k, spec_ngram,
                               pool, harvest, any_sample, any_top_k):
    """The decode lane with speculation (module docstring): ``chunk``
    draft/verify steps, in place. Per slot and step: draft ``spec_k``
    tokens from the ring, score ``[last_tok, draft]`` in one
    ``verify_forward`` at the frontier, draw the model's choice at every
    position ``pos + 1 + i`` with the sampler the plain lane uses, accept
    the agreeing draft prefix plus one (vetoed where ``spec`` is False),
    clamp to the budget, cut after an EOS inside the accepted prefix, and
    advance the frontier by the accepted count. All ``spec_k + 1`` choices
    land in the ring at ``pos + 1`` (frozen rows too; entries past the new
    frontier are stale-rule garbage). Writes ``harvest['toks'][t]`` [slots,
    spec_k + 1] (-1 where not emitted) and ``harvest['valid'][t]``."""
    kp1 = spec_k + 1
    ring = pool["toks"]
    dev = ring.device
    lanes = torch.arange(kp1, device=dev)[None]
    rows = torch.arange(ring.shape[0], device=dev)[:, None]
    for t in range(chunk):
        # ``active`` and ``pos`` alias the pool's fields: every value below
        # is computed from them before the in-place updates at the end.
        active, pos = pool["active"], pool["pos"]
        draft = adapter.ngram_draft(ring, pos, spec_ngram, spec_k)
        ids = torch.cat([pool["last_tok"][:, None], draft], dim=1)
        logits, _ = adapter.verify_forward(params, ids, cache_view(pool))
        R = ids.shape[0]
        # choices[:, i]: the model's pick for position pos + 1 + i, each
        # row's sampling parameters repeated over its lanes.
        at = pos.to(torch.int64)[:, None] + 1 + lanes

        def per_lane(x):
            return x[:, None].expand(R, kp1).reshape(-1)

        choices = _sample_rows(
            logits.reshape(R * kp1, -1), per_lane(pool["temp"]),
            per_lane(pool["top_k"]), per_lane(pool["seed"]), at.reshape(-1),
            any_sample, any_top_k).reshape(R, kp1)
        n_acc = adapter.accept_counts(draft, choices,
                                      ok=pool["spec"][:, None])
        # The budget clamp first (at least 1, so a frozen row's gather
        # stays in range), then EOS truncation inside the accepted prefix:
        # emit the EOS, then stop, as the plain lane does.
        n_acc = torch.minimum(n_acc, pool["remaining"].clamp(min=1).long())
        eos = pool["eos"][:, None]
        is_eos = (eos >= 0) & (choices == eos) & (lanes < n_acc[:, None])
        hit_eos = is_eos.any(dim=1)
        n_acc = torch.where(hit_eos, is_eos.to(torch.int32).argmax(dim=1) + 1,
                            n_acc)
        last = choices.gather(1, (n_acc - 1)[:, None])[:, 0]
        remaining = torch.where(active, pool["remaining"] - n_acc,
                                pool["remaining"])
        new_pos = torch.where(active, pos + n_acc, pos)
        new_last = torch.where(active, last, pool["last_tok"])
        new_active = active & ~hit_eos & (remaining > 0)
        ok = active[:, None] & (lanes < n_acc[:, None])
        harvest["toks"][t].copy_(torch.where(ok, choices, -1))
        harvest["valid"][t].copy_(ok)
        # No clamp: an entry past the ring raises (the slack covers it).
        ring[rows, at] = choices
        pos.copy_(new_pos)
        pool["last_tok"].copy_(new_last)
        pool["remaining"].copy_(remaining)
        active.copy_(new_active)


@hot_path
def _prefill_lane(params, adapter, pool, inp, any_sample, any_top_k):
    """The JAX lane: append ``inp['ids']`` [1, C] (``inp['n_valid']``
    leading columns real) into slot ``inp['slot']`` at ``inp['frontier']``
    and advance its frontier. On the prompt's final slice (``inp['done']``)
    install the first token, sampled at position ``frontier + n_valid``,
    and the request's decode state; otherwise every field but ``pos``
    keeps its value (``torch.where`` on the slot's row). On a speculating
    engine the lane keeps the slot's token ring: the slice at the frontier
    (pad columns land past the advanced frontier, stale-rule garbage) and,
    when ``done``, the first token at the new frontier. Every fact is a
    tensor of ``inp`` (``kv_pool.step_inputs``); returns the first token
    [1] (-1 unless ``done``)."""
    ids, slot, done = inp["ids"], inp["slot"], inp["done"]
    frontier, n_valid = inp["frontier"], inp["n_valid"]
    C = ids.shape[1]
    cache = slot_cache_view(pool, slot, frontier)
    logits, cache = adapter.prefill_append(params, ids, cache,
                                           n_valid=n_valid)
    # The prompt's true last row (pad rows sit past it).
    last = logits[0].index_select(0, (n_valid.long() - 1).clamp(0, C - 1))
    first = _sample_rows(last, inp["temp"], inp["top_k"], inp["seed"],
                         frontier + n_valid, any_sample, any_top_k)
    # The first token counts against the budget: a request can finish at
    # admission (max_new == 1, or its first token IS its EOS).
    finished = (inp["max_new"] <= 1) | ((inp["eos"] >= 0) &
                                        (first == inp["eos"]))
    for name, val in (("last_tok", first), ("active", done & ~finished),
                      ("remaining", inp["max_new"] - 1), ("eos", inp["eos"]),
                      ("temp", inp["temp"]), ("top_k", inp["top_k"]),
                      ("seed", inp["seed"]), ("spec", inp["spec"])):
        field = pool[name]
        field.index_copy_(0, slot, torch.where(
            done, val.to(field.dtype), field.index_select(0, slot)))
    pool["pos"].index_copy_(0, slot, cache["pos"])
    if "toks" in pool:
        ring = pool["toks"]
        ring[slot, frontier.long() + torch.arange(C, device=ids.device)] = \
            ids[0]
        at = (frontier + n_valid).long()
        ring[slot, at] = torch.where(done, first, ring[slot, at])
    return torch.where(done, first, -1)


@hot_path
def _mixed_step_program(params, adapter, chunk, spec, pool, inp, harvest,
                        lane, any_sample, any_top_k, pin=False):
    """One serving step on the pool in place: pin the frontiers of slots
    admitted this step (when ``pin``), the prefill lane when ``lane``,
    then the decode lane, speculative when ``spec``
    (the engine-lifetime ``(spec_k, spec_ngram)``, or None); fill
    ``harvest`` (``kv_pool.step_harvest``'s device views). ``inp`` are
    ``kv_pool.step_inputs``' device views. ``lane``, ``any_sample`` and
    ``any_top_k`` are the program's key; ``pin`` is an engine-lifetime
    fact (paged pools and pools with the prefix tier pin) and every other
    fact is a tensor."""
    if pin:
        pool["pos"].copy_(torch.where(inp["pin"] >= 0, inp["pin"],
                                      pool["pos"]))
    if lane:
        harvest["first"].copy_(_prefill_lane(params, adapter, pool, inp,
                                             any_sample, any_top_k))
    else:
        harvest["first"].fill_(-1)
    if spec is None:
        _decode_chunk_program(params, adapter, chunk, pool, harvest,
                              any_sample, any_top_k)
    else:
        _spec_decode_chunk_program(params, adapter, chunk, spec[0], spec[1],
                                   pool, harvest, any_sample, any_top_k)
    for name in harvest_names(pool):
        harvest[name].copy_(pool[name])


class _StepGraph(object):
    """One step program captured on ``stream`` (the engine's) as a chain of
    CUDA graphs, one segment per stretch between the model group's
    collectives (module docstring; one segment without a model group),
    with the decode-kernel launches it holds. The capture records launches
    without running them (``decode_attention.recording``: they land in
    this program's tally, not in any count), and every replay adds the
    tally: the counts are kernels run. The caller holds
    ``_CAPTURE_LOCK``.

    Each capture is begun and ended by hand rather than through
    ``torch.cuda.graph``, whose entry synchronizes the whole device and
    empties the caching allocator: with other engines stepping on the
    card, the wait before the capture is on ``stream`` alone. All segments
    share ``pool`` and replay in capture order. A reduce inside the
    capture ends the segment (``_cut``); its partial stays referenced
    here, so its address is the next segment's input. On an error inside
    the capture, the open segment's ``capture_end`` still runs (and raises
    the CUDA error in turn when the capture was invalidated); the stream
    context restores the caller's stream either way, the half-built
    program is dropped with this object, and the engine's key stays out
    of its programs, so the key's next step captures it again."""

    def __init__(self, program, pool, stream):
        self.graphs, self.cuts = [], []
        self._pool = pool
        stream.synchronize()
        with decode_attention.recording() as tally, \
                torch.cuda.stream(stream), \
                tensor_parallel.segmented(self._cut):
            self._begin()
            try:
                program()
            finally:
                self.graphs[-1].capture_end()
        self.launches = dict(tally)

    def _begin(self):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool,
                            capture_error_mode="thread_local")
        self.graphs.append(graph)

    def _cut(self, t, tp):
        self.graphs[-1].capture_end()
        self.cuts.append((t, tp))
        self._begin()
        return t

    def replay(self):
        for graph, cut in itertools.zip_longest(self.graphs, self.cuts):
            graph.replay()
            if cut is not None:
                tensor_parallel.serving_reduce(*cut)
        decode_attention.add_launches(self.launches)


class InferenceEngine(object):
    """Continuous-batching serving engine (see module docstring).

    ``model`` is the port's ``GPT2LMHeadModel`` (its weights are used and
    the module is moved to ``device``), or a ``GPT2Config`` with ``params``,
    a flax GPT-2 parameter tree of numpy arrays. ``config`` is an
    ``InferenceConfig``, a dict, or None. ``device`` defaults to ``cuda``;
    without a GPU the engine raises unless ``device="cpu"`` is passed.
    ``weights``: the ``ServingWeights`` of ``model`` to serve from (the
    fleet's replicas on one card share one; None builds them).
    ``adapter``: the ``ModelAdapter`` to serve (None: ``GPT2Adapter`` over
    ``model``). A GPT-2-weight adapter (``LongContextAdapter``) serves
    ``model`` as above; with ``model=None`` the adapter's own parameter
    tree is ``params`` (``MoEAdapter``: the JAX layout of numpy arrays,
    or its ``init_params``), read through ``adapter.prepare_params``.
    ``mesh``: this rank's ``parallel.mesh.Mesh`` to serve over (module
    docstring); the weights given are full, and the engine keeps this
    rank's shard."""

    # graftlint THREADRACE manifest (as the JAX engine's). The engine is
    # single-threaded by contract: every entry into it is serialized from
    # outside (the fleet wraps each engine call in the replica's lock;
    # standalone use is one caller thread), so its mutable serving state
    # is owned by whichever thread holds that outer lock. A new attribute
    # written outside construction joins this set, with the same
    # argument, or takes a lock.
    _THREAD_OWNED = frozenset({
        "_last_snap",       # last harvest snapshot, the stepper's
        "_injector",        # fault plan, swapped between steps
        "_recovery_streak", "_last_swap_out_s",
        "_accept_hist", "_accept_base", "_window_t0",
        "graph_replays",    # the stepper's replay count
        # The disaggregated handoff's outbox the fleet pump drains, under
        # the same outer serialization as step().
        "_handoff_outbox",
    })

    def __init__(self, model, params=None, config=None, device=None,
                 weights=None, adapter=None, mesh=None):
        if config is None:
            config = InferenceConfig()
        elif isinstance(config, dict):
            config = InferenceConfig.from_dict(config)
        _check_mesh(mesh, config)
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = resolve_device(device)
        # The engine's own stream (module docstring), None on the CPU. It
        # waits once for the caller's stream, where the weights were made;
        # everything below is allocated and filled on it.
        self._stream = None
        if self.device.type == "cuda":
            # The LM head is an fp32 [B, C] x [C, V] product; it must not
            # drop to TF32 (this is PyTorch's default; set so it holds).
            torch.backends.cuda.matmul.allow_tf32 = False
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            self._build(model, params, config, weights, adapter)

    def _build(self, model, params, config, weights, adapter):
        """The rest of construction, on the engine's stream."""
        if model is None:
            if adapter is None:
                raise ValueError("model=None needs an adapter that brings "
                                 "its own weights (MoEAdapter)")
            self._adapter = adapter.bind(config, self.mesh)
            self._params = weights if weights is not None \
                else self._adapter.prepare_params(params, self.device)
            self._build_serving(config)
            return
        if isinstance(model, GPT2LMHeadModel):
            if params is not None:
                raise ValueError("pass params only with a GPT2Config: a "
                                 "GPT2LMHeadModel holds its own weights")
            model = model.to(self.device)
        elif isinstance(model, GPT2Config):
            if params is None:
                raise ValueError("a GPT2Config needs params (a flax GPT-2 "
                                 "tree of numpy arrays)")
            model = params_from_jax(params, model, self.device)
        else:
            raise TypeError("model must be a GPT2LMHeadModel or GPT2Config, "
                            "got {}".format(type(model).__name__))
        self._adapter = (adapter if adapter is not None
                         else GPT2Adapter.from_model(model)).bind(
                             config, self.mesh)
        # The dense weights cast to the serving dtype once, here (this
        # rank's shard over a mesh).
        self._params = weights if weights is not None \
            else ServingWeights(model, getattr(self._adapter, "tp", None))
        self._build_serving(config)

    def _build_serving(self, config):
        """Everything past the weights and the adapter."""
        self._gcfg = self._adapter.cache_spec()
        # This rank's model-group context (None: every head on the rank).
        self._tp = getattr(self._adapter, "tp", None)
        config.validate_against_model(self._gcfg.n_positions)
        # Telemetry (module docstring): the registry is always real, the
        # spans and profiler scopes follow ``config.telemetry``.
        labels = {"engine": "inference"}
        if config.replica_id is not None:
            labels["replica"] = str(config.replica_id)
        self.telemetry = MetricsRegistry(**labels)
        self.tracer = (SpanRecorder(capacity=config.trace_ring)
                       if config.telemetry else NullRecorder())
        self._scheduler = Scheduler(
            config.max_slots, config.max_queue,
            tracer=self.tracer if config.telemetry else None,
            registry=self.telemetry, replica_id=config.replica_id)
        # Engine-lifetime speculation: (spec_k, spec_ngram), or None.
        self._spec = ((config.spec_k, config.spec_ngram)
                      if config.resolved_spec_decode() else None)
        # An append of prefill_chunk positions, and a verify's spec_k + 1
        # k/v writes and ring writes one past them, from any admissible
        # frontier must stay inside the plane (kv_pool docstring).
        self._slack = config.prefill_chunk
        if self._spec is not None:
            self._slack = max(self._slack, config.spec_k + 1)
        # Paged pool: the allocator owns page lifetime (module docstring);
        # None keeps the dense slotted pool.
        self._pager = None
        if config.paged_kv:
            plane_len = paged_plane_len(config.max_len, self._slack,
                                        config.kv_page_len)
            n_lp = plane_len // config.kv_page_len
            self._pager = PageAllocator(
                config.max_slots, n_lp, config.kv_pages or
                config.max_slots * n_lp, config.kv_page_len)
        else:
            plane_len = plane_len_for(config.max_len, self._slack)
        # The KV hierarchy (inference/kv_hierarchy): None when every tier
        # is off. Its hooks run between steps as eager in-place writes.
        hspec = spec_from_config(config)
        self._hier = KVHierarchy(
            hspec, self._gcfg, plane_len, config.max_slots,
            config.hbm_budget_bytes, pager=self._pager) \
            if hspec.enabled else None
        # Admitted slots' frontiers are pinned to their cursors by the step
        # program (``_admit``): a paged slot's frozen write goes through
        # its new table row, and a prefix hit's copied span must stay
        # clear of it. An engine-lifetime fact, not part of the key.
        self._pin = self._pager is not None or hspec.prefix
        self._last_swap_out_s = None
        # Records restored this step: their host buffers must outlive the
        # copies issued from them, which the step's harvest read waits for.
        self._restored = []
        self._pool = init_pool(
            self._gcfg, config.max_slots, config.max_len, slack=self._slack,
            device=self.device, hier=hspec if hspec.enabled else None,
            page_len=config.kv_page_len if self._pager else 0,
            num_pages=self._pager.total_pages if self._pager else None,
            ring=self._spec is not None, aux=self._adapter.aux_state(),
            tp=self._tp)
        self._inputs = step_inputs(config.max_slots, config.prefill_chunk,
                                   self.device)
        lanes = config.spec_k + 1 if self._spec is not None else 1
        self._harvest = step_harvest(config.max_slots, config.chunk_size,
                                     self.device, lanes=lanes,
                                     aux=self._adapter.aux_state())
        # The pinned host snapshot the device block table is copied from.
        self._table = None
        if self._pager is not None:
            self._table = torch.zeros(
                tuple(self._pool["block_tbl"].shape), dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        # Program cache (module docstring). graph_replays, capture time
        # and the graph pool's bytes are cumulative, like compile_count.
        self._programs = _ProgramCache()
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self.graph_replays = 0
        self.graph_segments = 0
        self._capture_s = 0.0
        self._graph_pool_bytes = 0
        # The last step's harvest (host arrays): gauges and metrics()
        # read it rather than the device.
        self._last_snap = None
        # The perf x-ray (module docstring): None when off.
        self._xray = None
        self._ledger = None
        if config.perf_xray:
            self._xray = ProgramRegistry(
                self.telemetry, platform=self.device.type,
                sample_every=config.xray_sample_every)
            # The pool's layout, part of every record's signature.
            self._xray_spec = tuple(
                (name, tuple(t.shape), str(t.dtype))
                for name, t in self._pool.items())
            self._ledger = HBMLedger(
                self.telemetry, capacity_bytes=config.hbm_budget_bytes,
                device=self.device)
            self._ledger.set_component("weights",
                                       _tensor_bytes(self._params))
            self._ledger.set_component("kv_arena", pool_nbytes(self._pool))
            self._ledger.set_component("graph_pool",
                                       self._xray.max_temp_bytes)
        self.recompile_detector = RecompileDetector(
            self.telemetry,
            describe=(self._xray.identity if self._xray is not None
                      else self._programs.describe))
        self.recompile_detector.watch("mixed_step", self._programs)
        # The timers' edges wait on this engine's stream alone.
        self.timers = SynchronizedWallClockTimer(
            registry=self.telemetry,
            sync=(self._stream.synchronize if self._stream is not None
                  else _no_sync))
        self.counters = _CounterBank(self.telemetry, _COUNTERS)
        # The decode kernels this engine ran (module docstring).
        self.launches = dict.fromkeys(decode_attention.launches, 0)
        if self._hier is not None:
            # The hierarchy counts its hits, misses, inserts and evictions
            # into the same registry counters.
            self._hier.counters = self.counters
        # Steps that carried a prefill lane: the port's own count (the
        # JAX engine keeps none), windowed with the registry, not
        # exported.
        self._lane_steps = Counter("prefill_lanes", {})
        self._register_gauges()
        # Resilience (module docstring): the health machine (its live
        # ``health_state`` gauge), the step watchdog, the recovery
        # bookkeeping. The fault injector stays None until
        # inject_faults() arms one: every hook is one ``is not None``
        # test when off.
        self._health = HealthState(self.telemetry)
        self._watchdog = StepWatchdog(
            config.step_budget_s,
            _on_stall(self.counters, self._health, self._scheduler))
        self._injector = None
        self._fatal = fatal_step_errors()
        self._recovery_streak = 0
        self._recovery_seconds = self.telemetry.histogram("recovery_seconds")
        # One record per recovery (absolute t_start/t_end, duration,
        # error, requests replayed, attempt): the chaos loadgen's
        # SLO-impact windows.
        self.recovery_log = []
        self._ttft_hist = self.telemetry.histogram("ttft_seconds")
        self._itl_hist = self.telemetry.histogram("inter_token_seconds")
        self._qwait_hist = self.telemetry.histogram("queue_wait_seconds")
        # Tokens emitted per occupied slot-step (index 1..lanes; index 0
        # stays empty: an occupied step emits at least one token), the
        # source of a speculating engine's accept statistics in metrics();
        # ``_accept_base`` is the window floor metrics(reset=True) moves.
        self._accept_hist = np.zeros(lanes + 1, np.int64)
        self._accept_base = np.zeros_like(self._accept_hist)
        self._window_t0 = time.time()
        # Disaggregated serving (inference/fleet.py): the role is a
        # routing and capture contract, not a program variant. The outbox
        # holds (request, record, capture time) between a prefill-role
        # step's capture and the fleet's pump; the donor's histogram
        # observes capture -> adoption.
        self.role = config.role
        self._handoff_enabled = config.role == "prefill"
        self._handoff_outbox = []
        self._handoff_latency_hist = self.telemetry.histogram(
            "handoff_latency_seconds")
        # Preemption: rids held in the swapped phase (resume-first swap-in
        # skips them until released), and rids whose swap-in counts as a
        # preempt_resume.
        self._preempt_hold = set()
        self._preempted_rids = set()

    def _register_gauges(self):
        """The live gauges, sampled at read (scrape) time. Each reads host
        state only (module docstring); the pool's bytes are fixed at
        construction (its tensors are never rebound). No gauge refers to
        the engine itself, so an engine dropped is freed at once, pool
        and graphs with it, without waiting for the cycle collector."""
        reg, sched, tracer = self.telemetry, self._scheduler, self.tracer
        reg.gauge("queue_depth").set_fn(lambda: len(sched.queue))
        reg.gauge("slots_running").set_fn(lambda: len(sched.running))
        reg.gauge("slots_prefilling").set_fn(
            lambda: sum(1 for r in list(sched.running.values())
                        if r.phase == "prefilling"))
        reg.gauge("slot_occupancy").set_fn(sched.occupancy)
        nbytes = pool_nbytes(self._pool)
        reg.gauge("kv_pool_bytes").set(nbytes)
        reg.gauge("kv_hbm_bytes").set(nbytes)
        if self._pager is not None:
            pg = self._pager
            reg.gauge("kv_pages_in_use").set_fn(pg.pages_in_use)
            reg.gauge("kv_pages_free").set_fn(pg.pages_free)
            reg.gauge("kv_page_fragmentation").set_fn(
                lambda: pg.fragmentation(_live_tokens(sched)))
        reg.gauge("trace_spans_dropped").set_fn(lambda: tracer.dropped)
        if self._hier is not None:
            h = self._hier
            reg.gauge("prefix_hit_rate").set_fn(h.hit_rate)
            reg.gauge("kv_bytes_aliased").set_fn(h.bytes_aliased_live)
            reg.gauge("kv_bytes_per_slot").set_fn(h.bytes_per_slot)
            reg.gauge("effective_slots").set_fn(h.effective_slots)
            reg.gauge("slots_swapped").set_fn(lambda: len(sched.swapped))
            self._swap_out_hist = reg.histogram("swap_out_seconds")
            self._swap_in_hist = reg.histogram("swap_in_seconds")

    def _on_stream(self):
        """This engine's stream as the current one (module docstring); free
        on the CPU."""
        if self._stream is None:
            return _NULL_CTX
        return torch.cuda.stream(self._stream)

    def _sync(self):
        """Wait for the work queued on this engine's stream (never for the
        whole device)."""
        if self._stream is not None:
            self._stream.synchronize()

    def _annotate(self, name):
        """A profiler scope, or a free no-op with telemetry off."""
        if not self.config.telemetry:
            return _NULL_CTX
        return annotate(name)

    def _live_tokens(self):
        return _live_tokens(self._scheduler)

    @property
    def adapter(self):
        return self._adapter

    @property
    def idle(self):
        """True when no request is queued or in a slot."""
        return self._scheduler.idle

    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               top_k=None, eos_token_id=None, seed=0, spec_decode=None,
               deadline_ms=None, priority=None, tenant=None, trace=None):
        """Queue one request; returns its Request handle. Raises
        scheduler.QueueFull past ``max_queue`` pending requests (or while
        an injected ``admission_block`` fault is active),
        resilience.EngineDraining during drain() (re-route, not retry),
        resilience.EngineDeadError on a dead engine, and ValueError when
        the request cannot fit the pool (or, paged, when the page arena
        could never hold it). ``spec_decode``: None inherits the engine's
        setting, False opts the request out (it rides the same program
        and emits one token per step), True demands a speculating engine.
        ``deadline_ms``: queue-side expiry budget; a request still QUEUED
        deadline_ms after submit is shed as ``expired`` (counted in
        ``deadline_sheds``); once admitted, it always finishes.
        ``priority`` / ``tenant``: the submission's class and tenant
        (carried on the request and its QueueFull); ``trace``: the
        TraceContext a fleet minted (None: a local one)."""
        if not self._health.accepting:
            if self._health.state == "dead":
                raise EngineDeadError(
                    "submit() on a dead engine (recovery retries "
                    "exhausted) — fail over to another replica")
            raise EngineDraining(
                "submit() while draining: admissions are closed while "
                "in-flight work finishes; re-route this request "
                "(undrain() reopens)")
        if self._injector is not None and self._injector.admission_blocked():
            raise self._scheduler.queue_full_error(
                "admission blocked by injected fault (admission_block)",
                priority=priority, tenant=tenant)
        if spec_decode and self._spec is None:
            raise ValueError(
                "submit(spec_decode=True) on an engine without speculation; "
                "enable inference.spec_decode (or DS_TPU_SPEC_DECODE) at "
                "engine construction: it sizes the plane slack, the token "
                "ring and the step program")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        vocab = self._params.config.vocab_size
        if prompt.min() < 0 or prompt.max() >= vocab:
            raise ValueError("prompt token ids must lie in [0, {})".format(
                vocab))
        if max_new_tokens is None:
            max_new_tokens = self.config.max_new_tokens
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if prompt.size + max_new_tokens > self.config.max_len:
            raise ValueError(
                "prompt ({} tokens) + max_new_tokens ({}) exceeds "
                "inference.max_len={}".format(prompt.size, max_new_tokens,
                                              self.config.max_len))
        if self._pager is not None:
            need = self._pages_required(prompt.size, max_new_tokens)
            if need > self._pager.total_pages:
                raise ValueError(
                    "request needs {} KV pages (prompt {} + max_new {} + "
                    "slack {} tokens at kv_page_len={}) but the page arena "
                    "holds only {}; raise inference.kv_pages".format(
                        need, prompt.size, max_new_tokens, self._slack,
                        self.config.kv_page_len, self._pager.total_pages))
        if eos_token_id is None:
            eos_token_id = self.config.eos_token_id
        deadline = None
        if deadline_ms is not None and self.mesh is not None:
            raise ValueError(
                "submit(deadline_ms=) over a serving mesh: a host clock "
                "would shed a request on one rank only; not ported "
                "({})".format(_MESH_ITEM))
        if deadline_ms is not None:
            if deadline_ms <= 0:
                raise ValueError("deadline_ms must be > 0, got "
                                 "{}".format(deadline_ms))
            deadline = time.time() + deadline_ms / 1e3
        try:
            return self._scheduler.submit(
                prompt, int(max_new_tokens), float(temperature),
                int(top_k or 0),
                -1 if eos_token_id is None else int(eos_token_id), int(seed),
                spec=self._spec is not None and spec_decode is not False,
                deadline=deadline, priority=priority, tenant=tenant,
                trace=trace)
        except QueueFull as exc:
            raise self._augment_queue_full(exc) from None

    def _augment_queue_full(self, exc):
        """Backpressure triage (the JAX engine's). On a paged engine whose
        queue HEAD is blocked on page capacity, not merely on slots, the
        shed is a ``pages`` shed, and its ``retry_after_s`` is the
        page-release-rate hint, the cadence capacity will appear on. With
        host offload, when a decoding session could be swapped out and the
        swap store has room, the shed is ``swap_eligible`` and the swap is
        ARMED (the next step evicts a victim), so the caller should retry
        here rather than fail over; with a swap already in flight,
        ``retry_after_s`` is the expected swap-out time instead."""
        sched = self._scheduler
        if self._pager is not None and sched.queue:
            head = sched.queue[0]
            need = self._pages_required(head.prompt.size,
                                        head.max_new_tokens)
            if not self._pager.can_reserve(need):
                exc.reason = "pages"
                exc.retry_after_s = round(self._pager.retry_after_s(
                    need - self._pager.available()), 4)
        hier = self._hier
        if hier is None or not hier.spec.offload:
            return exc
        victims = any(r.phase == "decoding" for r in sched.running.values())
        if not victims or not hier.swap_capacity_left():
            return exc
        in_flight = hier.swap_requested or bool(sched.swapped)
        hier.swap_requested = True
        exc.swap_eligible = True
        if in_flight:
            exc.retry_after_s = self._expected_swap_out_s()
        return exc

    def _expected_swap_out_s(self):
        return self._last_swap_out_s if self._last_swap_out_s else 0.05

    def cancel(self, req):
        """Evict ``req`` wherever it lives: queued, mid-prefill or
        decoding. Frees its slot for the next admission round (on a paged
        engine its pages and its reservation too); tokens emitted so far
        stay on the request. Returns False when it had already finished.
        A decoding slot is frozen on the device by clearing its
        ``active`` flag in place, an eager write on the step's stream at
        the address the captured graphs read (the JAX engine rebinds
        the pool instead, which a graph would not see)."""
        was_decoding = req.phase == "decoding" and req.slot is not None
        had_slot = req.slot is not None and \
            req.phase in ("prefilling", "decoding")
        slot = req.slot
        if not self._scheduler.cancel(req):
            return False
        if self._pager is not None:
            if had_slot:
                self._pager.free_slot(slot)
            self._pager.release_reservation(req.rid)
        if self._hier is not None:
            # Unpin any prefix row and drop a swapped session's host
            # record (a swapped cancel has no slot to deactivate).
            self._hier.on_release(req)
        # A cancelled session cannot stay in the preemption ledgers.
        self._preempt_hold.discard(req.rid)
        self._preempted_rids.discard(req.rid)
        if was_decoding:
            with self._on_stream():
                self._pool["active"][slot] = False
        return True

    # ------------------------------------------------------ paged KV pool

    def _pages_required(self, prompt_len, max_new_tokens):
        """Pages covering the deepest frontier a request can reach: prompt
        + budget + the plane slack, clamped to the per-row table width. The
        admission gate reserves exactly this, so ``ensure_mapped`` cannot
        fail mid-stream."""
        return min(self._pager.pages_for(int(prompt_len)
                                         + int(max_new_tokens) + self._slack),
                   self._pager.pages_per_slot)

    def _ensure_paged_mappings(self, pf, n_valid, p_done):
        """Step-boundary page mapping: back every position the coming step
        can WRITE and a later read can see, then, when the host table
        changed, copy it into the pool's device block table in place, on
        the step's stream, from a pinned snapshot the host does not write
        again until the step's harvest. Writes past what is mapped land in
        the trash page (unmapped entries are 0). The decode lane advances
        each active slot at most ``chunk_size`` positions (``chunk_size *
        (spec_k + 1)`` when speculating), the prefill lane ``n_valid`` at
        the cursor. No request reads a position at or past its own bound
        (prompt + budget; the slack above it is what its reservation
        covers), so the mapping stops there: it never draws past the
        reservation."""
        pager = self._pager
        lookahead = self.config.chunk_size
        if self._spec is not None:
            lookahead *= self._spec[0] + 1

        def bound(req):
            return int(req.prompt.size) + int(req.max_new_tokens) + \
                self._slack

        if pf is not None:
            upto = int(pf.cursor) + int(n_valid)
            if p_done:
                # The slot joins this step's decode lane right after its
                # final slice: map its decode writes too.
                upto += lookahead
            pager.ensure_mapped(pf.slot, min(upto, bound(pf)))
        for slot, req in self._scheduler.running.items():
            if req.phase != "decoding":
                continue
            pos = int(req.prompt.size) + len(req.tokens)
            pager.ensure_mapped(slot, min(pos + lookahead, bound(req)))
        if pager.dirty:
            self._table.numpy()[...] = pager.table
            self._pool["block_tbl"].copy_(self._table, non_blocking=True)
            pager.dirty = False

    def kv_page_stats(self):
        """Paged-capacity snapshot (None on a dense engine): total, free and
        in-use pages, the page length, pages unpromised (free minus
        outstanding reservations: the only number safe to admit against),
        and the mean per-request reservation."""
        pg = self._pager
        if pg is None:
            return None
        reqs = list(self._scheduler.running.values())
        if reqs:
            mean_res = (sum(self._pages_required(r.prompt.size,
                                                 r.max_new_tokens)
                            for r in reqs) / float(len(reqs)))
        else:
            mean_res = float(pg.pages_per_slot)
        return {"pages_total": pg.total_pages,
                "pages_free": pg.pages_free(),
                "pages_in_use": pg.pages_in_use(),
                "pages_available": pg.available(),
                "page_len": pg.page_len,
                "mean_reservation_pages": mean_res}

    def _admit(self):
        """One FIFO admission round into free slots, with the hierarchy's
        admission hook per admitted pair (the prefix-trie probe: a hit
        copies or shares the stored span and advances the cursor past it).
        On a paged engine admission is PAGE-AWARE: the queue head must
        reserve its full frontier bound in pages or the round stops
        (strict FIFO), and every admitted slot's mappings draw down its
        request's reservation. On a paged pool, and on any pool with the
        prefix tier, each admitted slot's device frontier is pinned to its
        cursor, AFTER the hook moved it, by the step program (the ``pin``
        input): until its first prefill slice the slot is frozen in the
        decode lane but still writes at its frontier, so a stale frontier
        of the previous occupant must not steer that write into its new
        table row (paged) or into the prefix span copied into its plane
        (dense)."""
        pager = self._pager
        gate = None
        if pager is not None:
            def gate(req):
                need = self._pages_required(req.prompt.size,
                                            req.max_new_tokens)
                if not pager.can_reserve(need):
                    return False
                pager.reserve(req.rid, need)
                return True

        pairs = self._scheduler.admissions(gate=gate)
        for req, slot in pairs:
            if pager is not None:
                pager.bind_slot(slot, req.rid)
            if self._hier is not None:
                self._hier.on_admit(self._pool, req, slot)
            if self._pin:
                self._inputs.host["pin"][slot] = req.cursor
        return pairs

    # ---------------------------------------------------------- offload

    def _capture_slot_record(self, slot):
        """A slot's host record: its live pages on a paged pool, its plane
        slices on a dense one (``kv_hierarchy.offload``)."""
        if self._pager is not None:
            return capture_slot_paged(self._pool, slot,
                                      self._pager.row_pages(slot))
        return capture_slot(self._pool, slot)

    def _restore_slot_record(self, slot, req, record):
        """Restore a record into ``slot`` in place. Paged: claim fresh
        pages for the record's stack plus a reservation for the request's
        residual growth, point the row at them and write them; False when
        the arena cannot cover both now (the caller defers: capacity
        appears on page-release cadence). The record is held until the
        step's harvest, past the copies issued from it."""
        self._restored.append(record)
        if self._pager is None:
            restore_slot(self._pool, slot, record)
            return True
        pager = self._pager
        n_pages = int(record["k"].shape[1])
        extra = max(0, self._pages_required(req.prompt.size,
                                            req.max_new_tokens) - n_pages)
        if pager.available() < n_pages + extra:
            return False
        pages = pager.alloc_pages(n_pages)
        pager.install_row(slot, pages)
        if extra:
            pager.reserve(req.rid, extra)
        pager.bind_slot(slot, req.rid)
        restore_slot_paged(self._pool, slot, record, pages)
        return True

    def _swap_in_ready(self):
        """RESUME-FIRST: pour free slots into the oldest swapped sessions
        before fresh admissions see them. Returns the resumed rids (this
        round's swap-out exclusions)."""
        sched, resumed = self._scheduler, []
        while True:
            req = sched.next_swap_in(skip=self._preempt_hold)
            free = sched.free_slot_ids()
            if req is None or not free:
                break
            t0 = time.time()
            slot = free[0]
            record = self._hier.swap_store.pop(req.rid)
            if not self._restore_slot_record(slot, req, record):
                # The arena cannot back the record and its residual
                # reservation yet: put it back and wait for pages.
                self._hier.swap_store.put(req.rid, record)
                break
            sched.swap_in(req, slot)
            self.counters["swap_ins"] += 1
            if req.rid in self._preempted_rids:
                self._preempted_rids.discard(req.rid)
                self.counters["preempt_resumes"] += 1
            self._swap_in_hist.observe(time.time() - t0)
            resumed.append(req.rid)
        return resumed

    def _pick_swap_victim(self, exclude):
        """The decoding session that can best afford to wait
        (``kv_hierarchy.offload.pick_swap_victim``), sessions resumed this
        round excluded (no same-step thrash). A paged pool scores by the
        live pages a victim frees, not its residual budget."""
        cands = [r for r in self._scheduler.running.values()
                 if r.phase == "decoding" and r.rid not in exclude]
        if self._pager is not None:
            live = {r.rid: len(self._pager.row_pages(r.slot)) for r in cands}
            return pick_swap_victim(cands, live_pages=live,
                                    page_len=self._pager.page_len)
        return pick_swap_victim(cands)

    def _maybe_swap_out(self, resumed):
        """Swap-out policy: under slot pressure (queued work, no free slot)
        or an armed request from ``submit``, capture ONE victim to host
        memory, free its slot and admit again, so the queue head lands in
        it THIS step. One swap per step bounds the transfer a step
        absorbs. The capture is the step's one blocking read besides the
        harvest; it happens BEFORE the slot is deactivated (the record
        restores ``active``), and then ``active[slot]`` is cleared in place
        on the stream. A paged victim's pages and reservation are freed
        before the second admission, so the table uploads once for
        both."""
        hier, sched = self._hier, self._scheduler
        pressure = bool(sched.queue) and not sched.free_slot_ids()
        if not (pressure or hier.swap_requested):
            return
        hier.swap_requested = False
        if not hier.swap_capacity_left():
            return
        victim = self._pick_swap_victim(set(resumed))
        if victim is None:
            return
        t0 = time.time()
        slot = victim.slot
        hier.swap_store.put(victim.rid, self._capture_slot_record(slot))
        self._pool["active"][slot] = False
        if self._pager is not None:
            # The record IS the session now: its pages free (shared prefix
            # pages live on under their other references) and its
            # reservation drops; swap-in reserves the residual again.
            self._pager.free_slot(slot)
            self._pager.release_reservation(victim.rid)
        sched.swap_out(victim)
        self.counters["swap_outs"] += 1
        self._last_swap_out_s = time.time() - t0
        self._swap_out_hist.observe(self._last_swap_out_s)
        if sched.queue:
            self._admit()

    def step(self):
        """One step boundary: admit, run the step's program (the prefill
        lane and the decode lane), harvest in one transfer, evict finished
        slots. Returns the requests completed during this step.

        The RESILIENCE envelope (module docstring) wraps the boundary: the
        watchdog times it, an injected stall burns its time inside the
        guard so the watchdog sees it, and a fatal step error lands in
        ``_recover()`` instead of the caller's lap. A clean step resets
        the recovery streak and returns ``degraded`` to ``healthy``."""
        if self._health.state == "dead":
            raise EngineDeadError(
                "step() on a dead engine (recovery retries exhausted)")
        inj = self._injector
        stall = inj.stall_seconds() if inj is not None else 0.0
        # The engine's stream and launch counts (module docstring) cover
        # the step and its recovery.
        with self._on_stream(), decode_attention.counting_into(self.launches):
            try:
                with torch.no_grad(), self._watchdog:
                    if stall > 0:
                        time.sleep(stall)
                    done = self._step_chunked()
            except self._fatal as exc:
                done = self._recover(exc)
            else:
                self._recovery_streak = 0
                if (self._health.state == "degraded" and stall == 0
                        and not self._watchdog.tripped):
                    self._health.to("healthy")
            finally:
                if inj is not None:
                    inj.advance()
        return done

    # --------------------------------------------------------- resilience

    @property
    def health(self):
        """Current health state (``healthy/degraded/draining/dead``); the
        ``health_state`` gauge exports its index live."""
        return self._health.state

    def inject_faults(self, plan):
        """Arm a faults.FaultPlan; steps count from here, so a plan armed
        mid-run (the loadgen chaos mode) fires relative to the arming
        point. Requires ``inference.fault_injection=True`` and replaces
        any previous injector. Returns the armed FaultInjector."""
        if not self.config.fault_injection:
            raise ValueError(
                "inject_faults() requires inference.fault_injection=True "
                "at engine construction — chaos must be switched on "
                "explicitly, never ambient")
        self._injector = FaultInjector(plan, registry=self.telemetry)
        return self._injector

    def _check_harvest(self, toks, valid):
        """Harvest validity: every VALID lane must hold a real token id
        (>= 0; no draw over finite logits gives a negative). A violation
        means the device returned garbage and raises NumericsError BEFORE
        any token reaches a request: the whole step's harvest is
        discarded and recovery replays it."""
        if valid.any() and int(toks[valid].min()) < 0:
            raise NumericsError(
                "harvest validity check failed: negative token id in a "
                "valid lane — device returned garbage (NaN logits?); "
                "discarding this step's harvest and recovering")

    def _replay_requests(self, reqs):
        """Mark requeued requests for replay. A request that had
        delivered tokens re-prefills its prompt (the same slices as
        before, so the same k/v) and its decode lane re-derives the
        delivered tokens, each checked against the delivered one and not
        delivered again (``_take``), before it emits new ones: every draw
        is keyed on (seed, position) and a row's arithmetic does not
        depend on its slot or its neighbours, so the replayed stream is
        the original one, bit for bit, on the card too. (The JAX engine
        re-prefills prompt + delivered tokens with the budget less those:
        exact on the CPU, but on the card the prefill lane's GEMMs round
        the delivered tokens' k/v differently from the decode lane's, so
        the stream may part at a near tie. A request whose re-derivation
        disagrees takes that replay instead, ``_resync_failed``.) Prompt
        and budget are unchanged, so the max_len bound, the plane slack
        and a paged request's reservation are too. Mid-prefill requests
        replay their prompt."""
        for req in reqs:
            req.resync = req.folded if len(req.tokens) > req.folded \
                else None

    def _take(self, req, emitted):
        """The tokens among ``emitted`` (one step's, in order) to deliver
        to ``req``: while a replayed request re-derives its delivered
        tokens (``resync``), each emission must equal the delivered token
        at its index, and is not delivered again. None on a mismatch."""
        at = req.resync
        if at is None:
            return emitted
        n = min(len(emitted), len(req.tokens) - at)
        if emitted[:n] != req.tokens[at:at + n]:
            return None
        at += n
        req.resync = at if at < len(req.tokens) else None
        return emitted[n:]

    def _resync_failed(self, req):
        """A replayed request's device stream disagreed with the tokens it
        had delivered: the device did not reproduce its own arithmetic.
        That request alone takes the JAX engine's replay: out of its slot
        (frozen in place, its pages returned) to the queue's front, to
        re-prefill prompt + every delivered token with the budget less
        those, so what it emits next follows what the client holds."""
        slot = req.slot
        logger.warning(
            "inference.replay: request %d re-derived a token that differs "
            "from the one it delivered; replaying it from prompt + its %d "
            "delivered tokens", req.rid, len(req.tokens))
        self._scheduler.requeue(req)
        if self._pager is not None:
            self._pager.free_slot(slot)
            self._pager.release_reservation(req.rid)
        if self._hier is not None:
            # Its next admission probes the trie for the longer prompt.
            self._hier.on_release(req)
        self._pool["active"][slot] = False
        new = req.tokens[req.folded:]
        req.prompt = np.concatenate([req.prompt, np.asarray(new, np.int64)])
        req.max_new_tokens -= len(new)
        req.folded = len(req.tokens)
        req.resync = None
        self.counters["requests_replayed"] += 1

    def _reset_device_state(self):
        """The in-place rebuild. First drain the stream: a step that
        faulted never reached its blocking harvest read, and its
        non-blocking copies (the pinned block-table snapshot, the packed
        inputs) may still be in flight from host buffers the next step
        writes. Then reset the pool to init_pool's values in place, the
        page allocator to zero knowledge (its ``dirty`` flag uploads the
        zeroed table before the next step) and the step's host inputs to
        the idle lane. ``self._programs`` is untouched: every address a
        graph holds is unchanged. The drain waits on this engine's stream
        alone: other engines on the card keep running."""
        self._sync()
        with torch.no_grad():
            reset_pool(self._pool, self._hier.spec if self._hier else None)
        if self._pager is not None:
            self._pager.reset()
        if self._hier is not None:
            # The trie, row pins and swap records described the pool just
            # reset (requeue_running pulls swapped sessions back into the
            # queue too); replay re-earns every hit and insert.
            self._hier.reset()
        clear_step_inputs(self._inputs)
        self._restored.clear()  # the drain above ran their copies
        self._last_snap = None  # it described the pool just reset

    def _recover(self, exc):
        """Crash-only recovery from a fatal step error (JAX
        ``InferenceEngine._recover``): device state is presumed LOST, so
        reset it in place (``_reset_device_state``; no graph is captured
        again), requeue every in-flight request ahead of the queue and
        mark each for replay (``_replay_requests``). Never runs inside a
        capture: an error raised while a key is captured leaves
        ``_StepGraph`` first, which ends the capture, restores the
        caller's stream and the launch counts and drops the half-captured
        graph; the key stays out of ``_programs``, so its next step
        captures it again. Bounded: ``recovery_max_retries`` CONSECUTIVE failures (a
        clean step resets the streak) end in ``dead`` with
        EngineDeadError; so does a fatal error while the device is
        drained or reset, since a CUDA error that outlives the drain is
        sticky to the process and no reset can clear it."""
        t0 = time.time()
        self._recovery_streak += 1
        in_flight = len(self._scheduler.running) + \
            len(self._scheduler.swapped)
        if self._recovery_streak > self.config.recovery_max_retries:
            self._health.to("dead")
            raise EngineDeadError(
                "inference engine dead: {} consecutive step failures "
                "exceeded recovery_max_retries={} ({} requests were in "
                "flight); last error: {}: {}".format(
                    self._recovery_streak,
                    self.config.recovery_max_retries, in_flight,
                    type(exc).__name__, exc)) from exc
        if self._health.state == "healthy":
            self._health.to("degraded")
        logger.warning(
            "inference.recover: fatal step error (%s: %s) — resetting "
            "device state in place, replaying %d in-flight request(s) "
            "(attempt %d/%d)", type(exc).__name__, exc, in_flight,
            self._recovery_streak, self.config.recovery_max_retries)
        if self.config.recovery_backoff_s:
            time.sleep(self.config.recovery_backoff_s *
                       self._recovery_streak)
        try:
            self._reset_device_state()
        except self._fatal as err:
            self._health.to("dead")
            raise EngineDeadError(
                "inference engine dead: the device could not be reset "
                "after {}: {} ({}: {}); a CUDA error that outlives the "
                "stream's drain is sticky to the process — fail over to "
                "another replica".format(type(exc).__name__, exc,
                                         type(err).__name__, err)) from err
        replayed = self._scheduler.requeue_running()
        self._replay_requests(replayed)
        # The preemption ledgers described swapped sessions now queued:
        # they replay through admission, not through a swap-in.
        self._preempt_hold.clear()
        self._preempted_rids.clear()
        self.counters["recoveries"] += 1
        self.counters["requests_replayed"] += len(replayed)
        t1 = time.time()
        self._recovery_seconds.observe(t1 - t0)
        self.recovery_log.append({
            "t_start": t0, "t_end": t1,
            "duration_s": round(t1 - t0, 6),
            "error": "{}: {}".format(type(exc).__name__, exc),
            "replayed": len(replayed),
            "attempt": self._recovery_streak,
        })
        self.tracer.span("engine/recovery", t0, t1,
                         replayed=len(replayed),
                         error=type(exc).__name__)
        return []

    @property
    def compile_count(self):
        """Programs this engine has built, one per key met (module
        docstring): CUDA graphs captured on the card, keys recorded on the
        CPU. At most 8, cumulative; a step with a key met before adds
        nothing."""
        return len(self._programs)

    def _program(self, lane, any_sample, any_top_k):
        _mixed_step_program(self._params, self._adapter,
                            self.config.chunk_size, self._spec, self._pool,
                            self._inputs.dev, self._harvest.dev, lane,
                            any_sample, any_top_k, pin=self._pin)

    def _run_program(self, key):
        """Run the step's program for ``key``: replay its graph (on the CPU,
        run it) when the key was met before; else run it eagerly and, on
        the card, capture it on the engine's stream for the steps to come,
        both under ``_CAPTURE_LOCK`` (module docstring)."""
        if key in self._programs:
            graph = self._programs[key]
            if graph is None:
                self._program(*key)
            else:
                graph.replay()
            self.graph_replays += 1
            return
        if self.device.type != "cuda":
            self._first_run(key)
            self._programs[key] = None
            return
        with _CAPTURE_LOCK:
            self._first_run(key)
            t0 = time.perf_counter()
            graph = _StepGraph(lambda: self._program(*key), self._graph_pool,
                               self._stream)
            self.graph_segments += len(graph.graphs)
            self._sync()
            self._capture_s += time.perf_counter() - t0
            # The pool grows only at a capture (replays allocate nothing).
            self._graph_pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == tuple(self._graph_pool))
            if self._xray is not None:
                self._xray.set_pool_bytes("mixed_step",
                                          self._graph_pool_bytes)
        self._programs[key] = graph

    def _first_run(self, key):
        """A key's eager first run: under the x-ray's cost modes when it
        is on (its record; module docstring), else plain."""
        if self._xray is None:
            self._program(*key)
        else:
            self._xray.measure("mixed_step", lambda: self._program(*key))

    def _step_chunked(self):
        done = []
        # The JAX step order: resume swapped sessions first, then admit,
        # then (under slot pressure) swap one victim out and admit again.
        offload = self._hier is not None and self._hier.spec.offload
        resumed = self._swap_in_ready() if offload else []
        self._admit()
        if offload:
            self._maybe_swap_out(resumed)
        sched = self._scheduler
        pf = sched.next_prefill()
        inp = self._inputs.host
        p_done, n = False, 0
        if pf is not None:
            C = self.config.prefill_chunk
            cur = pf.cursor
            n = int(min(C, pf.prompt.size - cur))
            p_done = cur + n >= pf.prompt.size
            inp["ids"][0, :n] = pf.prompt[cur:cur + n]
            inp["slot"][0], inp["frontier"][0] = pf.slot, cur
            inp["n_valid"][0], inp["done"][0] = n, p_done
            inp["max_new"][0], inp["eos"][0] = (pf.max_new_tokens,
                                                pf.eos_token_id)
            inp["temp"][0], inp["top_k"][0] = pf.temperature, pf.top_k
            inp["seed"][0], inp["spec"][0] = pf.seed, pf.spec
        if self._pager is not None:
            self._ensure_paged_mappings(pf, n, p_done)
        if self._injector is not None:
            # A "raise" fault fires HERE, in place of the program: device
            # state is presumed lost, as after a CUDA error out of it.
            self._injector.maybe_raise()
        # Host facts for the sampler: only slots that can be active in the
        # decode lane (decoding, or finishing their prompt now) matter.
        live = [r for r in sched.running.values()
                if r.phase == "decoding" or (r is pf and p_done)]
        key = (pf is not None, any(r.temperature > 0 for r in live),
               any(r.top_k > 0 for r in live))
        # The timer synchronizes at both edges, outside the capture.
        decode_timer = self.timers("inference/decode")
        decode_timer.start()
        self._inputs.upload()
        first = key not in self._programs
        captures = first and self.device.type == "cuda"
        xray = self._xray
        if xray is not None:
            xray.stash("mixed_step", self._program, key, self._xray_spec,
                       track_change=self.recompile_detector.warm)
            tokens0 = self.counters["tokens_out"]
        t_dispatch0 = time.perf_counter()
        with self.tracer.timed("step/mixed", prefill_tokens=n,
                               captured=captures), \
                self._annotate("inference/mixed_step"):
            self._run_program(key)
        if xray is not None and xray.due() and not first:
            # The sanctioned sync (telemetry/xray.py): 1 in N steps.
            xray.sample_step("mixed_step", self._sync,
                             time.perf_counter() - t_dispatch0)
        with self.tracer.timed("step/harvest"), \
                self._annotate("inference/harvest"):
            snap = self._harvest.read()  # the one D2H copy
        self._adapter.observe(snap, self.telemetry)
        decode_timer.stop()
        clear_step_inputs(self._inputs)
        # The read waited for the stream: every copy issued from a
        # restored record has run.
        self._restored.clear()
        self._last_snap = snap
        toks, valid, active = snap["toks"], snap["valid"], snap["active"]
        if self._injector is not None:
            toks = self._injector.corrupt_harvest(toks, valid)
        # Numerics gate: after the device sync, before any token reaches
        # a request (a garbage harvest is discarded whole).
        self._check_harvest(toks, valid)
        self.counters["chunks"] += 1
        per_step = valid.sum(axis=2)
        occupied = per_step > 0
        n_occ = int(occupied.sum())
        self.counters["occupied_slot_steps"] += n_occ
        self.counters["slot_steps"] += occupied.size
        self._accept_hist += np.bincount(per_step[occupied],
                                         minlength=self._accept_hist.size)
        if self._spec is not None and n_occ:
            # This step's verifies (one per occupied slot-step), the
            # tokens they drafted and the emissions they produced.
            self.tracer.instant("spec/verify", verifies=n_occ,
                                drafted=n_occ * self.config.spec_k,
                                accepted=int(valid.sum()))
        if pf is not None:
            self._lane_steps.inc()
            self.counters["prefill_tokens"] += n
            if sched.advance_prefill(pf, n):
                self.counters["prefills"] += 1
                if self._hier is not None:
                    # The slot's plane now holds the whole prompt's k/v:
                    # publish a missed prefix into the store.
                    self._hier.on_prefill_done(self._pool, pf)
                self._harvest_first(pf, int(snap["first"][0]), done)
        harvest_t = time.time()
        for slot, req in list(sched.running.items()):
            if req.phase != "decoding":
                continue
            # A boolean mask flattens row-major: (step, lane) order is
            # emission order.
            emitted = self._take(req, toks[:, slot][valid[:, slot]].tolist())
            if emitted is None:
                self._resync_failed(req)
                continue
            req.tokens.extend(emitted)
            self.counters["tokens_out"] += len(emitted)
            if emitted:
                # The progress stamp the swap-victim policy reads: a
                # session that stops emitting goes stale.
                req.last_touch = harvest_t
                self.tracer.instant(
                    "request/chunk", tid=req.trace.tid, rid=req.rid,
                    hop=req.trace.hop(), emitted=len(emitted),
                    tokens=len(req.tokens))
            if not active[slot]:
                self._complete(req, done)
        if self._handoff_enabled:
            # Prefill role: every request still decoding after this step's
            # harvest (its prompt just finished; the tokens it emitted this
            # step are part of its stream) leaves for the handoff outbox.
            self._capture_handoffs()
        if xray is not None:
            xray.note("mixed_step",
                      tokens=self.counters["tokens_out"] - tokens0)
        self.recompile_detector.observe()
        return done

    def _harvest_first(self, req, first, done):
        """Record a request's first token; TTFT is stamped here, after the
        step's device sync, once: a request replayed after a fallback
        (``_resync_failed``) takes its "first" token m + 1 here, appended
        like any emission, while TTFT stays the original first token's."""
        new = self._take(req, [first])
        if new is None:
            self._resync_failed(req)
            return
        if not new:
            return  # a replay re-derived the first token it delivered
        req.tokens.append(first)
        if req.first_token_time is None:
            req.first_token_time = time.time()
            self._ttft_hist.observe(req.first_token_time - req.submit_time)
        self.counters["tokens_out"] += 1
        if req.max_new_tokens <= 1 or \
                (req.eos_token_id >= 0 and first == req.eos_token_id):
            self._complete(req, done)

    def _complete(self, req, done):
        """Evict ``req``'s slot and observe its mean inter-token gap
        ((finish - first) / (tokens - 1)) into ``inter_token_seconds``."""
        slot = req.slot
        self._scheduler.complete(slot)
        if self._pager is not None:
            # The host row points at trash now; the device row is stale
            # until the next step's rebind, which precedes any write.
            self._pager.free_slot(slot)
            self._pager.release_reservation(req.rid)
        if self._hier is not None:
            self._hier.on_release(req)
        self.counters["requests_completed"] += 1
        if req.first_token_time is not None and len(req.tokens) > 1:
            self._itl_hist.observe((req.finish_time - req.first_token_time)
                                   / (len(req.tokens) - 1))
        done.append(req)

    def run(self, max_steps=None, timeout_s=None):
        """Step until queue and slots drain; returns the completed
        requests in completion order. ``max_steps`` bounds iterations,
        ``timeout_s`` wall clock (checked after each step: a stalled
        device makes "N more steps" a meaningless promise). Either limit
        logs the in-flight count and returns what completed; it never
        raises, but over a mesh the ranks' digests (module docstring) must
        agree, or it raises ``MeshDivergence``."""
        if timeout_s is not None and self.mesh is not None:
            raise ValueError(
                "run(timeout_s=) over a serving mesh: a host clock would "
                "stop one rank only; not ported ({})".format(_MESH_ITEM))
        self._lockstep("queued", [
            (r.rid, r.prompt.tobytes(), r.max_new_tokens, r.temperature,
             r.top_k, r.eos_token_id, r.seed, r.spec)
            for r in self._scheduler.queue])
        out, steps = [], 0
        t0 = time.time()
        while not self._scheduler.idle:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                logger.warning("inference.run: stopping after %d steps with "
                               "%d requests still in flight", steps,
                               len(self._scheduler.running) +
                               len(self._scheduler.queue))
                break
            if timeout_s is not None and time.time() - t0 >= timeout_s:
                logger.warning("inference.run: timeout after %.3fs "
                               "(%d steps) with %d requests still in "
                               "flight", time.time() - t0, steps,
                               len(self._scheduler.running) +
                               len(self._scheduler.queue))
                break
        self._lockstep("completed", [(r.rid, r.tokens) for r in out])
        return out

    def _lockstep(self, what, facts):
        """Over a mesh: gather a digest of ``facts`` from every rank and
        raise ``MeshDivergence`` where any differs (module docstring)."""
        if self.mesh is None:
            return
        digest = hashlib.blake2b(repr(facts).encode(),
                                 digest_size=16).hexdigest()
        seen = comm.all_gather_object(digest, None)
        if len(set(seen)) != 1:
            raise MeshDivergence(
                "serving mesh ranks disagree on their {} requests (digest "
                "by rank: {}): every rank must make the same submit/step/"
                "run calls in the same order".format(what, seen))

    def drain(self, max_steps=None, timeout_s=None):
        """Graceful drain: CLOSE admissions (submit() raises
        EngineDraining; health -> ``draining``), finish every accepted
        request, queued ones included, and settle to ``idle``. Returns
        the requests completed during the drain. Admissions stay closed
        until ``undrain()``. The bounds pass through to run()."""
        if self._health.state == "dead":
            raise EngineDeadError("drain() on a dead engine")
        self._health.to("draining")
        return self.run(max_steps=max_steps, timeout_s=timeout_s)

    def undrain(self):
        """Reopen admissions after a drain (health -> ``healthy``).
        Raises EngineDeadError if the engine died in the meantime."""
        self._health.to("healthy")

    def close_admissions(self):
        """Close admissions WITHOUT stepping (health -> ``draining``;
        submit() raises EngineDraining); ``undrain()`` reopens."""
        if self._health.state == "dead":
            raise EngineDeadError("close_admissions() on a dead engine")
        self._health.to("draining")

    def close(self):
        """Release host-side resources: stop any armed watchdog timer.
        Idempotent; the engine stays readable (metrics, completed
        requests) but must not step again. Device memory is freed when
        the engine is dropped."""
        self._watchdog.stop()

    # ------------------------------------------------------- preemption

    def preempt(self, req):
        """Park a DECODING request in the ``swapped`` phase (the capacity
        policy's swap-out, so it resumes where it paused) and HOLD it
        there: resume-first swap-in skips it until
        ``release_preempted()``. Needs host offload and room in the swap
        store; False when the request is not parkable now (wrong phase, no
        offload, store full). A held session replays like any swapped one
        after a recovery, which clears the holds. (The JAX engine's; the
        front door, ``inference/frontdoor``, calls it.)"""
        hier = self._hier
        if hier is None or not hier.spec.offload:
            return False
        if req.phase != "decoding" or req.slot is None:
            return False
        if not hier.swap_capacity_left():
            return False
        t0 = time.time()
        slot = req.slot
        with self._on_stream():
            hier.swap_store.put(req.rid, self._capture_slot_record(slot))
            self._pool["active"][slot] = False
        if self._pager is not None:
            self._pager.free_slot(slot)
            self._pager.release_reservation(req.rid)
        self._scheduler.swap_out(req)
        self.counters["swap_outs"] += 1
        self.counters["preemptions"] += 1
        self._preempt_hold.add(req.rid)
        self._preempted_rids.add(req.rid)
        self._last_swap_out_s = time.time() - t0
        self._swap_out_hist.observe(self._last_swap_out_s)
        self.tracer.instant("request/preempted", tid=req.trace.tid,
                            rid=req.rid, hop=req.trace.hop(),
                            tokens=len(req.tokens))
        return True

    def release_preempted(self, req=None):
        """Lift the hold on ``req`` (None: on every held session): the next
        swap-in round may resume it, counted as a ``preempt_resumes``.
        Idempotent."""
        if req is None:
            self._preempt_hold.clear()
        elif req.rid in self._preempt_hold:
            self._preempt_hold.discard(req.rid)
            self.tracer.instant("request/preempt_released",
                                tid=req.trace.tid, rid=req.rid,
                                hop=req.trace.hop())

    def preempted_held(self):
        """rids parked by preempt() and not yet released."""
        return frozenset(self._preempt_hold)

    # ------------------------------------------ cross-replica adoption

    def _capture_prefix_pages(self, row, depth):
        """DONOR half, paged: the pages of store row ``row`` as a record in
        the dense row layout (``kv_hierarchy.capture_prefix_pages``), so
        the transport and a dense acceptor never see the layout. Returns
        (span, record), or None when the row has no page payload."""
        payload = self._hier.store.payload.get(row)
        if payload is None:
            return None
        pages, span = payload
        span = min(int(span), int(depth))
        if span <= 0:
            return None
        n = -(-span // self._pager.page_len)
        return span, capture_prefix_pages(self._pool, pages[:n], span)

    def _restore_prefix_pages(self, row, record):
        """ACCEPTOR half, paged: claim fresh pages for a shipped record,
        write it into them and hang them on store row ``row`` as its
        payload (the store's pin), so the next admission shares them like
        pages prefilled here. False when the arena cannot spare them
        without eating promised capacity (the row then stays payload-less
        and probes miss it)."""
        span = int(record["pk"].shape[2])
        pages = self._pager.alloc_pages(self._pager.pages_for(span))
        if pages is None:
            return False
        restore_prefix_pages(self._pool, pages, record)
        self._hier.store.payload[row] = (tuple(pages), span)
        return True

    def export_prefix(self, tokens):
        """The DONOR half of cross-replica prefix adoption: this engine's
        stored planes for ``tokens`` (or its longest stored prefix of
        them), captured to host memory on its stream. Returns
        ``(matched_tokens, record)``, or None when the store holds no
        usable span. int8 codes and scales ship as stored. The caller
        serializes calls into this engine (the fleet's replica lock)."""
        if self._hier is None or self._hier.store is None:
            return None
        toks = [int(t) for t in tokens]
        row, depth = self._hier.store.lookup(toks)
        if row is None or depth < self._hier.spec.min_prefix_len:
            return None
        with self._on_stream():
            if self._pager is not None:
                out = self._capture_prefix_pages(row, depth)
                if out is None or out[0] < self._hier.spec.min_prefix_len:
                    return None
                span, record = out
                return tuple(toks[:span]), record
            return tuple(toks[:depth]), capture_prefix_row(self._pool, row,
                                                           depth)

    def adopt_prefix(self, tokens, record):
        """The ACCEPTOR half: write a peer's prefix record into a local
        store row, in place on this engine's stream, and index it: the
        next admission's probe hits as if this engine had prefilled
        ``tokens``. The record is held until the next step's harvest,
        past the copies. True on adoption; False when the store already
        covers the span, every row is pinned, or (paged) the arena has no
        pages to spare."""
        if self._hier is None or self._hier.store is None:
            return False
        store = self._hier.store
        toks = tuple(int(t) for t in tokens)
        _, depth = store.lookup(list(toks))
        if depth >= len(toks):
            return False
        before = store.evictions
        row = store.insert(toks)
        self.counters["prefix_evictions"] += store.evictions - before
        if row is None:
            return False
        self._restored.append(record)
        with self._on_stream():
            if self._pager is not None:
                if not self._restore_prefix_pages(row, record):
                    return False
            else:
                restore_prefix_row(self._pool, row, record)
        self.counters["prefix_adoptions"] += 1
        self.counters["prefix_bytes_shipped"] += record_nbytes(record)
        return True

    # -------------------------------------------- disaggregated handoff

    def _capture_handoffs(self):
        """Prefill-role step epilogue: every request whose prompt just
        finished (still decoding) leaves the slot pool for the handoff
        outbox, ALL of them in one synchronization of the engine's stream
        (``capture_slots``). A record is the slot's whole device state:
        its planes as stored (a copied prefix span included; int8 codes
        with their scales) and every per-slot field, ``pos`` and the ring
        too, so the acceptor continues the stream where it stands. The
        slots deactivate in place and free for the next prompts."""
        pending = [r for r in self._scheduler.running.values()
                   if r.phase == "decoding"]
        if not pending:
            return
        slots = [r.slot for r in pending]
        t0 = time.time()
        if self._pager is not None:
            records = capture_slots_paged(
                self._pool, slots, [self._pager.row_pages(s) for s in slots])
        else:
            records = capture_slots(self._pool, slots)
        for slot in slots:
            self._pool["active"][slot] = False
        for req, slot, record in zip(pending, slots, records):
            if self._pager is not None:
                # The record IS the session now: its pages free (shared
                # prefix pages live on under their other references).
                self._pager.free_slot(slot)
                self._pager.release_reservation(req.rid)
            self._scheduler.begin_handoff(req)
            self._handoff_outbox.append((req, record, t0))
            self.counters["handoff_bytes_shipped"] += record_nbytes(record)
        self.counters["handoffs"] += len(pending)

    def take_handoffs(self):
        """Drain the handoff outbox: (Request, record, capture time)
        triples for the fleet's pump. The caller serializes calls into
        this engine."""
        out, self._handoff_outbox = self._handoff_outbox, []
        return out

    def finish_handoff(self, req):
        """Donor-side epilogue once a migration settled (adopted, or
        fallen back to a replay elsewhere): forget the scheduler record
        and unpin any prefix row the request held here. Idempotent
        against a concurrent cancel."""
        self._scheduler.finish_handoff(req)
        if self._hier is not None:
            self._hier.on_release(req)

    def adopt_handoff(self, spec, record):
        """The ACCEPTOR half of a handoff: install a request captured on a
        prefill-role peer straight into a free slot in the ``decoding``
        phase (no queue, no prefill lane: the restored record IS the
        prefill), in place on this engine's stream. ``spec`` carries the
        donor's request (``scheduler.Scheduler.adopt``'s arguments: the
        prompt and budget as submitted, the delivered tokens, the replay
        bookkeeping, the sampling parameters, the stamps); ``record`` the
        captured slot. Returns the new Request, or None when this engine
        cannot take it now (dead, no free slot, a record of the other
        layout, or, paged, too few pages for it and its residual
        reservation). The record carries any aliased prefix span by value,
        so no prefix row is needed here (``kv_hierarchy`` docstring)."""
        if self._health.state == "dead":
            return None
        free = self._scheduler.free_slot_ids()
        if not free:
            return None
        if record["k"].dim() != (5 if self._pager is not None else 4):
            return None
        if self._pager is not None:
            n_pages = int(record["k"].shape[1])
            extra = max(0, self._pages_required(
                len(spec["prompt"]), spec["max_new_tokens"]) - n_pages)
            if self._pager.available() < n_pages + extra:
                return None
        slot = free[0]
        req = self._scheduler.adopt(slot=slot, **spec)
        with self._on_stream():
            # Pre-checked above on a paged pool, so this cannot refuse.
            self._restore_slot_record(slot, req, record)
        self.counters["handoffs_in"] += 1
        return req

    def resubmit(self, spec):
        """Queue a request re-homed from another engine (a failover, a
        handoff's fallback) straight into this scheduler's queue, past
        admission health and shape checks (it passed them where it was
        first submitted; accepted is a promise).
        ``spec`` is the request as it stood there: prompt and budget as
        submitted, the ``tokens`` it delivered, ``folded``, the sampling
        parameters, the trace and the first-token stamp. Its prompt is
        prefilled again and its decode lane re-derives the delivered
        tokens (checked, not delivered twice, ``_take``) before it emits
        new ones, as after a recovery. Raises QueueFull when the queue is
        full."""
        req = self._scheduler.submit(
            spec["prompt"], spec["max_new_tokens"], spec["temperature"],
            spec["top_k"], spec["eos_token_id"], spec["seed"],
            spec=spec["spec"], deadline=spec["deadline"],
            priority=spec.get("priority"), tenant=spec.get("tenant"),
            trace=spec.get("trace"))
        req.tokens = list(spec["tokens"])
        req.folded = spec["folded"]
        req.first_token_time = spec.get("first_token_time")
        self._replay_requests([req])
        return req

    def generate(self, prompts, **kw):
        """Submit every prompt, run to completion, return token lists in
        submission order."""
        reqs = [self.submit(p, **kw) for p in prompts]
        self.run()
        return [r.tokens for r in reqs]


    def _latency_percentiles(self):
        """TTFT / inter-token / queue-wait percentiles (milliseconds; None
        before the first observation) from the registry's histograms,
        windowed like everything else in metrics(), and the series
        Prometheus exports as summary quantiles. TTFT is submit -> first
        harvested token; queue wait submit -> admit; inter-token the mean
        gap per completed request."""
        def pct(h, p):
            v = h.percentile(p)
            return round(v * 1e3, 3) if v is not None else None

        return {
            "ttft_p50_ms": pct(self._ttft_hist, 50),
            "ttft_p99_ms": pct(self._ttft_hist, 99),
            "inter_token_p50_ms": pct(self._itl_hist, 50),
            "inter_token_p99_ms": pct(self._itl_hist, 99),
            "queue_wait_p50_ms": pct(self._qwait_hist, 50),
            "queue_wait_p99_ms": pct(self._qwait_hist, 99),
        }

    def metrics(self, reset=False):
        """Serving metrics over the current window: since construction,
        or since the last ``metrics(reset=True)``, which opens a new
        window after reading (counters, latency and phase histograms,
        accept statistics and the wall clock all restart), as the JAX
        engine's. The keys are the JAX engine's that the port's features
        have, plus the port's own: ``prefill_lanes`` and ``decode_steps``
        (windowed), and the step programs' cumulative facts
        (``compile_count``, ``recompiles``, ``graph_replays``,
        ``capture_ms`` and ``graph_pool_bytes``, 0 on the CPU). The pool's
        layout and bytes; with the KV hierarchy its tier switches, its
        counters (hits, misses, inserts, evictions, swaps), the hit rate,
        the byte accounting, ``effective_slots`` and ``slots_swapped``, as
        the JAX engine's; on a paged engine its page gauges; on a
        speculating engine the accept statistics over the window's
        occupied slot-steps: tokens accepted per step (mean, p50, p99) and
        the accepted share of the drafted tokens (the first token of each
        step is not drafted). ``prefill_seconds`` is 0, as on the JAX
        chunked path: the prefill lane rides the mixed step, which
        ``decode_seconds`` times."""
        now = time.time()
        wall = max(now - self._window_t0, 1e-9)
        c = self.counters
        gauge = self.telemetry.gauge
        nbytes = pool_nbytes(self._pool)
        m = {
            "tokens_out": c.window("tokens_out"),
            "requests_completed": c.window("requests_completed"),
            "prefills": c.window("prefills"),
            "prefill_tokens": c.window("prefill_tokens"),
            "chunks": c.window("chunks"),
            "prefill_lanes": int(self._lane_steps.window_value),
            "decode_steps": c.window("chunks") * self.config.chunk_size,
            "tokens_per_sec": c.window("tokens_out") / wall,
            "slot_occupancy": (c.window("occupied_slot_steps") /
                               max(c.window("slot_steps"), 1)),
            "slot_occupancy_now": gauge("slot_occupancy").value,
            "queue_depth": int(gauge("queue_depth").value),
            "running": len(self._scheduler.running),
            "slots_prefilling": int(gauge("slots_prefilling").value),
            "compile_count": self.compile_count,
            "recompiles": int(self.recompile_detector.recompiles.value),
            "graph_replays": self.graph_replays,
            "graph_segments": self.graph_segments,
            "capture_ms": self._capture_s * 1e3,
            "graph_pool_bytes": self._graph_pool_bytes,
            "prefill_seconds": self.timers(
                "inference/prefill").elapsed(reset=reset),
            "decode_seconds": self.timers(
                "inference/decode").elapsed(reset=reset),
            "adapter": self._adapter.name,
            "chunked_prefill": True,
            "prefill_chunk": self.config.prefill_chunk,
            "max_active_frontier": (max_active_frontier(self._last_snap)
                                    if self._last_snap is not None else 0),
            "spec_decode": self._spec is not None,
            "paged_kv": self._pager is not None,
            "int8_kv": self._hier is not None and self._hier.spec.int8,
            "kv_pool_bytes": nbytes,
            "kv_hbm_bytes": nbytes,
            # Resilience: health is a state fact (never windowed); the
            # counters window like everything else.
            "health": self._health.state,
            "faults_injected": c.window("faults_injected"),
            "recoveries": c.window("recoveries"),
            "requests_replayed": c.window("requests_replayed"),
            "deadline_sheds": c.window("deadline_sheds"),
            "step_stalls": c.window("step_stalls"),
            # Preemption and disaggregated serving (inference/fleet.py):
            # zero on a standalone or all-mixed engine.
            "preemptions": c.window("preemptions"),
            "preempt_resumes": c.window("preempt_resumes"),
            "role": self.role,
            "handoffs": c.window("handoffs"),
            "handoffs_in": c.window("handoffs_in"),
            "handoff_fallbacks": c.window("handoff_fallbacks"),
            "handoff_bytes_shipped": c.window("handoff_bytes_shipped"),
        }
        if self._hier is not None:
            h = self._hier
            # The tier switches and the capacity story: what a slot costs,
            # what aliasing saves, how many sessions the budget carries.
            m.update(
                prefix_cache=h.spec.prefix, host_offload=h.spec.offload,
                prefix_hits=c.window("prefix_hits"),
                prefix_misses=c.window("prefix_misses"),
                prefix_inserts=c.window("prefix_inserts"),
                prefix_evictions=c.window("prefix_evictions"),
                prefix_hit_rate=round(h.hit_rate(), 4),
                kv_bytes_per_slot=h.bytes_per_slot(),
                kv_bytes_per_slot_flat=h.flat_bytes_per_slot(),
                kv_bytes_aliased=h.bytes_aliased_live(),
                prefix_bytes_aliased_total=h.bytes_aliased_total(),
                prefix_store_bytes=h.prefix_store_bytes(),
                effective_slots=h.effective_slots(),
                swap_outs=c.window("swap_outs"),
                swap_ins=c.window("swap_ins"),
                slots_swapped=len(self._scheduler.swapped),
                # Fleet prefix traffic (zero outside a fleet).
                prefix_adoptions=c.window("prefix_adoptions"),
                prefix_bytes_shipped=c.window("prefix_bytes_shipped"),
                affinity_routed=c.window("affinity_routed"))
        if self._pager is not None:
            pg = self._pager
            m.update(kv_page_len=pg.page_len, kv_pages_total=pg.total_pages,
                     kv_pages_in_use=pg.pages_in_use(),
                     kv_pages_free=pg.pages_free(),
                     kv_page_fragmentation=round(
                         pg.fragmentation(_live_tokens(self._scheduler)), 4))
        if self._spec is not None:
            hist = self._accept_hist - self._accept_base
            n = int(hist.sum())
            acc = np.repeat(np.arange(hist.size), hist)
            k = self.config.spec_k
            m.update(
                spec_k=k, spec_ngram=self.config.spec_ngram,
                accepted_per_step_mean=(round(float(acc.mean()), 4)
                                        if n else None),
                accepted_per_step_p50=(float(np.percentile(acc, 50))
                                       if n else None),
                accepted_per_step_p99=(float(np.percentile(acc, 99))
                                       if n else None),
                draft_accept_rate=(round(float((acc - 1).sum()) / (k * n), 4)
                                   if n else None))
        m.update(self._latency_percentiles())
        if reset:
            self.telemetry.reset_window()
            self._lane_steps.reset_window()
            self._accept_base = self._accept_hist.copy()
            self._window_t0 = now
        return m

    # ---------------------------------------------------------- telemetry

    def prometheus(self):
        """Prometheus text exposition of this engine's registry. Serve it
        with ``telemetry.PrometheusEndpoint(engine.telemetry)``; the
        engine never opens a socket itself."""
        return prometheus_text(self.telemetry)

    def telemetry_snapshot(self):
        """The compact observability fingerprint: the Prometheus text's
        sha256 and sample-line count, exact span counts per name (they
        survive the ring's wraparound), and the cumulative compile and
        recompile facts. ``xray_programs``: the x-ray's program records,
        one per key met (0 with the x-ray off)."""
        sha, lines = prometheus_digest(self.telemetry)
        return {
            "prometheus_sha256": sha,
            "prometheus_lines": lines,
            "span_counts": self.tracer.span_counts(),
            "spans_dropped": self.tracer.dropped,
            "compile_count": self.compile_count,
            "recompiles": int(self.recompile_detector.recompiles.value),
            "xray_programs": (self._xray.record_count()
                              if self._xray is not None else 0),
        }

    def perf_xray(self):
        """The schema-versioned ``perf_xray`` section
        (``telemetry/xray.py``): one record per program key met (its
        fingerprint and shapes, flops, bytes, graph-pool bytes, calls,
        tokens, sampled step time and, on the card, MFU and MBU against
        the H100 row), the totals per token, post-warm recompile events,
        the step decomposition and the HBM ledger. None when
        ``inference.perf_xray`` is off. Reads host state only."""
        if self._xray is None:
            return None
        out = self._xray.to_json()
        out["hbm"] = self._ledger.to_json()
        return out

    def write_trace(self, path):
        """Dump the span ring as a Chrome trace-event JSON file (Perfetto
        / chrome://tracing). Raises with telemetry off: an empty file
        would read as 'nothing happened'."""
        return self.tracer.write_chrome_trace(path)

    def trace_recorders(self):
        """This engine's span recorders as the label -> recorder map
        ``telemetry.merged_trace`` takes: one ring, ``replica<id>`` in a
        fleet."""
        label = "engine" if self.config.replica_id is None \
            else "replica{}".format(self.config.replica_id)
        return {label: self.tracer}

    def find_request(self, rid):
        """The Request for ``rid`` wherever it lives (queued, running,
        swapped, mid-handoff or completed); None when unknown."""
        s = self._scheduler
        req = s.completed.get(rid) or s.handoff.get(rid)
        if req is not None:
            return req
        for r in (list(s.running.values()) + list(s.swapped.values()) +
                  list(s.queue)):
            if r.rid == rid:
                return r
        return None

    def explain(self, rid):
        """Structured autopsy of one request (``telemetry/autopsy.py``):
        its hop-ordered timeline, admission evidence and terminal cause,
        with the x-ray's post-warm recompile events by the identity the
        detector's warning used. Raises KeyError for an unknown rid and
        RuntimeError with telemetry off."""
        if not self.config.telemetry:
            raise RuntimeError("telemetry is disabled: no trace to explain")
        req = self.find_request(rid)
        if req is None:
            raise KeyError("unknown rid {}".format(rid))
        out = build_autopsy(self.trace_recorders(), req.trace.tid)
        if self._xray is not None and self._xray.recompile_events:
            out["recompiled_programs"] = self._xray.recompile_dicts()
        return out
