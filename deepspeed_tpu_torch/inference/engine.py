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

Telemetry, perf x-ray, resilience and fault injection, the prefix and
offload tiers of the KV hierarchy and tensor parallelism are later slices.
The accept statistics of ``metrics()`` are cumulative (the port has no
telemetry window yet).
"""

import time

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.adapters import GPT2Adapter
from deepspeed_tpu_torch.inference.config import InferenceConfig
from deepspeed_tpu_torch.inference.kv_hierarchy import (KVHierarchy,
                                                        spec_from_config)
from deepspeed_tpu_torch.inference.kv_pool import (
    HARVEST_FIELDS, cache_view, clear_step_inputs, init_pool,
    max_active_frontier, paged_plane_len, plane_len_for, pool_nbytes,
    slot_cache_view, step_harvest, step_inputs)
from deepspeed_tpu_torch.inference.paging import PageAllocator
from deepspeed_tpu_torch.inference.scheduler import Scheduler
from deepspeed_tpu_torch.models.generation import ServingWeights
from deepspeed_tpu_torch.models.gpt2 import (GPT2Config, GPT2LMHeadModel,
                                             params_from_jax)
from deepspeed_tpu_torch.ops.sampling import sample_rows as _sample_rows
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention


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


def _mixed_step_program(params, adapter, chunk, spec, pool, inp, harvest,
                        lane, any_sample, any_top_k):
    """One serving step on the pool in place: pin the frontiers of slots
    admitted this step (paged pools), the prefill lane when ``lane``, then
    the decode lane, speculative when ``spec`` (the engine-lifetime
    ``(spec_k, spec_ngram)``, or None); fill ``harvest``
    (``kv_pool.step_harvest``'s device views). ``inp`` are
    ``kv_pool.step_inputs``' device views. ``lane``, ``any_sample`` and
    ``any_top_k`` are the program's key; every other fact is a tensor."""
    if "block_tbl" in pool:
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
    for name in HARVEST_FIELDS:
        harvest[name].copy_(pool[name])


class _StepGraph(object):
    """One step program captured as a CUDA graph, with the decode-kernel
    launches it holds. Capture records launches without running them, so
    the counts the wrappers took while it was recorded are handed back, and
    every replay adds them: ``decode_attention.launches`` counts kernels
    run, not kernels recorded."""

    def __init__(self, program, pool):
        before = dict(decode_attention.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            program()
        self.launches = {kind: decode_attention.launches[kind] - n
                         for kind, n in before.items()}
        decode_attention.launches.update(before)

    def replay(self):
        self.graph.replay()
        for kind, n in self.launches.items():
            decode_attention.launches[kind] += n


class InferenceEngine(object):
    """Continuous-batching serving engine (see module docstring).

    ``model`` is the port's ``GPT2LMHeadModel`` (its weights are used and
    the module is moved to ``device``), or a ``GPT2Config`` with ``params``,
    a flax GPT-2 parameter tree of numpy arrays. ``config`` is an
    ``InferenceConfig``, a dict, or None. ``device`` defaults to ``cuda``;
    without a GPU the engine raises unless ``device="cpu"`` is passed."""

    def __init__(self, model, params=None, config=None, device=None):
        if config is None:
            config = InferenceConfig()
        elif isinstance(config, dict):
            config = InferenceConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The LM head is an fp32 [B, C] x [C, V] product; it must not
            # drop to TF32 (this is PyTorch's default; set so it holds).
            torch.backends.cuda.matmul.allow_tf32 = False
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
        # The dense weights cast to the serving dtype once, here.
        self._params = ServingWeights(model)
        self._adapter = GPT2Adapter.from_model(model).bind(config)
        self._gcfg = self._adapter.cache_spec()
        config.validate_against_model(self._gcfg.n_positions)
        self._scheduler = Scheduler(config.max_slots, config.max_queue)
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
        hspec = spec_from_config(config)
        self._hier = KVHierarchy(hspec, self._gcfg, plane_len) \
            if hspec.enabled else None
        self._pool = init_pool(
            self._gcfg, config.max_slots, config.max_len, slack=self._slack,
            device=self.device, hier=hspec if hspec.enabled else None,
            page_len=config.kv_page_len if self._pager else 0,
            num_pages=self._pager.total_pages if self._pager else None,
            ring=self._spec is not None)
        self._inputs = step_inputs(config.max_slots, config.prefill_chunk,
                                   self.device)
        lanes = config.spec_k + 1 if self._spec is not None else 1
        self._harvest = step_harvest(config.max_slots, config.chunk_size,
                                     self.device, lanes=lanes)
        # The pinned host snapshot the device block table is copied from.
        self._table = None
        if self._pager is not None:
            self._table = torch.zeros(
                tuple(self._pool["block_tbl"].shape), dtype=torch.int32,
                pin_memory=self.device.type == "cuda")
        # Program cache (module docstring): key -> _StepGraph on the card,
        # None on the CPU.
        self._programs = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        self.graph_replays = 0
        self._capture_s = 0.0
        self._graph_pool_bytes = 0
        self._last_snap = None
        self.counters = dict.fromkeys(
            ("tokens_out", "prefill_tokens", "prefills", "prefill_lanes",
             "chunks", "requests_completed"), 0)
        self._ttft = []
        # Tokens emitted per occupied slot-step (index 1..lanes; index 0
        # stays empty: an occupied step emits at least one token), the
        # source of a speculating engine's accept statistics in metrics().
        self._accept_hist = np.zeros(lanes + 1, np.int64)
        self._t0 = time.time()

    @property
    def adapter(self):
        return self._adapter

    @property
    def idle(self):
        """True when no request is queued or in a slot."""
        return self._scheduler.idle

    def submit(self, prompt, max_new_tokens=None, temperature=0.0,
               top_k=None, eos_token_id=None, seed=0, spec_decode=None):
        """Queue one request; returns its Request handle. Raises
        scheduler.QueueFull past ``max_queue`` pending requests and
        ValueError when the request cannot fit the pool (or, paged, when
        the page arena could never hold it). ``spec_decode``: None inherits
        the engine's setting, False opts the request out (it rides the same
        program and emits one token per step), True demands a speculating
        engine."""
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
        return self._scheduler.submit(
            prompt, int(max_new_tokens), float(temperature), int(top_k or 0),
            -1 if eos_token_id is None else int(eos_token_id), int(seed),
            spec=self._spec is not None and spec_decode is not False)

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
        """One FIFO admission round into free slots. On a paged engine
        admission is PAGE-AWARE: the queue head must reserve its full
        frontier bound in pages or the round stops (strict FIFO), every
        admitted slot's mappings draw down its request's reservation, and
        each admitted slot's device frontier is pinned to its cursor (0) by
        the step program (the ``pin`` input): until its first prefill
        slice the slot is frozen in the decode lane but still writes at its
        frontier, through its NEW table row, so a stale frontier of the
        previous occupant must not steer that write."""
        pager = self._pager
        if pager is None:
            return self._scheduler.admissions()

        def gate(req):
            need = self._pages_required(req.prompt.size, req.max_new_tokens)
            if not pager.can_reserve(need):
                return False
            pager.reserve(req.rid, need)
            return True

        pairs = self._scheduler.admissions(gate=gate)
        for req, slot in pairs:
            pager.bind_slot(slot, req.rid)
            self._inputs.host["pin"][slot] = req.cursor
        return pairs

    def step(self):
        """One step boundary: admit, run the step's program (the prefill
        lane and the decode lane), harvest in one transfer, evict finished
        slots. Returns the requests completed during this step."""
        with torch.no_grad():
            return self._step_chunked()

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
                            any_sample, any_top_k)

    def _run_program(self, key):
        """Run the step's program for ``key``: replay its graph (on the CPU,
        run it) when the key was met before; else run it eagerly and, on
        the card, capture it for the steps to come."""
        if key in self._programs:
            graph = self._programs[key]
            if graph is None:
                self._program(*key)
            else:
                graph.replay()
            self.graph_replays += 1
            return
        self._program(*key)
        graph = None
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            graph = _StepGraph(lambda: self._program(*key), self._graph_pool)
            torch.cuda.synchronize(self.device)
            self._capture_s += time.perf_counter() - t0
            # The pool grows only at a capture (replays allocate nothing).
            self._graph_pool_bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) == tuple(self._graph_pool))
        self._programs[key] = graph

    def _step_chunked(self):
        done = []
        self._admit()
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
        # Host facts for the sampler: only slots that can be active in the
        # decode lane (decoding, or finishing their prompt now) matter.
        live = [r for r in sched.running.values()
                if r.phase == "decoding" or (r is pf and p_done)]
        key = (pf is not None, any(r.temperature > 0 for r in live),
               any(r.top_k > 0 for r in live))
        self._inputs.upload()
        self._run_program(key)
        snap = self._harvest.read()  # the one D2H copy
        clear_step_inputs(self._inputs)
        self._last_snap = snap
        self.counters["chunks"] += 1
        if pf is not None:
            self.counters["prefill_lanes"] += 1
            self.counters["prefill_tokens"] += n
            if sched.advance_prefill(pf, n):
                self.counters["prefills"] += 1
                self._harvest_first(pf, int(snap["first"][0]), done)
        toks, valid, active = snap["toks"], snap["valid"], snap["active"]
        per_step = valid.sum(axis=2)
        self._accept_hist += np.bincount(per_step[per_step > 0],
                                         minlength=self._accept_hist.size)
        for slot, req in list(sched.running.items()):
            if req.phase != "decoding":
                continue
            # A boolean mask flattens row-major: (step, lane) order is
            # emission order.
            emitted = toks[:, slot][valid[:, slot]].tolist()
            req.tokens.extend(emitted)
            self.counters["tokens_out"] += len(emitted)
            if not active[slot]:
                self._complete(req, done)
        return done

    def _harvest_first(self, req, first, done):
        """Record a request's first token; TTFT is stamped here, after the
        step's device sync."""
        req.tokens.append(first)
        req.first_token_time = time.time()
        self._ttft.append(req.first_token_time - req.submit_time)
        self.counters["tokens_out"] += 1
        if req.max_new_tokens <= 1 or \
                (req.eos_token_id >= 0 and first == req.eos_token_id):
            self._complete(req, done)

    def _complete(self, req, done):
        slot = req.slot
        self._scheduler.complete(slot)
        if self._pager is not None:
            # The host row points at trash now; the device row is stale
            # until the next step's rebind, which precedes any write.
            self._pager.free_slot(slot)
            self._pager.release_reservation(req.rid)
        self.counters["requests_completed"] += 1
        done.append(req)

    def run(self, max_steps=None):
        """Step until queue and slots drain (or ``max_steps``); returns the
        completed requests in completion order."""
        out, steps = [], 0
        while not self._scheduler.idle:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    def generate(self, prompts, **kw):
        """Submit every prompt, run to completion, return token lists in
        submission order."""
        reqs = [self.submit(p, **kw) for p in prompts]
        self.run()
        return [r.tokens for r in reqs]

    def metrics(self):
        """Serving counters since construction, with TTFT percentiles in
        milliseconds (None before the first token), the pool's layout and
        bytes, the step programs (``compile_count``, ``graph_replays``, the
        time spent capturing graphs and the bytes of their memory pool, 0
        on the CPU), on a paged engine its page gauges, and on a
        speculating engine its accept statistics over every occupied
        slot-step since construction: tokens accepted per step (mean, p50,
        p99) and the accepted share of the drafted tokens (the first token
        of each step is not drafted)."""
        c = dict(self.counters)
        wall = max(time.time() - self._t0, 1e-9)
        ttft = np.asarray(self._ttft) * 1e3
        c.update(
            decode_steps=c["chunks"] * self.config.chunk_size,
            tokens_per_sec=c["tokens_out"] / wall,
            ttft_p50_ms=float(np.percentile(ttft, 50)) if ttft.size else None,
            ttft_p99_ms=float(np.percentile(ttft, 99)) if ttft.size else None,
            running=len(self._scheduler.running),
            queue_depth=len(self._scheduler.queue),
            max_active_frontier=(max_active_frontier(self._last_snap)
                                 if self._last_snap is not None else 0),
            kv_pool_bytes=pool_nbytes(self._pool),
            kv_hbm_bytes=pool_nbytes(self._pool),
            paged_kv=self._pager is not None,
            int8_kv=self._hier is not None and self._hier.spec.int8,
            compile_count=self.compile_count,
            graph_replays=self.graph_replays,
            capture_ms=self._capture_s * 1e3,
            graph_pool_bytes=self._graph_pool_bytes,
            spec_decode=self._spec is not None)
        if self._hier is not None:
            c.update(kv_bytes_per_slot=self._hier.bytes_per_slot(),
                     kv_bytes_per_slot_flat=self._hier.flat_bytes_per_slot())
        if self._pager is not None:
            pg = self._pager
            c.update(kv_page_len=pg.page_len, kv_pages_total=pg.total_pages,
                     kv_pages_in_use=pg.pages_in_use(),
                     kv_pages_free=pg.pages_free())
        if self._spec is not None:
            hist = self._accept_hist
            n = int(hist.sum())
            acc = np.repeat(np.arange(hist.size), hist)
            k = self.config.spec_k
            c.update(
                spec_k=k, spec_ngram=self.config.spec_ngram,
                accepted_per_step_mean=(round(float(acc.mean()), 4)
                                        if n else None),
                accepted_per_step_p50=(float(np.percentile(acc, 50))
                                       if n else None),
                accepted_per_step_p99=(float(np.percentile(acc, 99))
                                       if n else None),
                draft_accept_rate=(round(float((acc - 1).sum()) / (k * n), 4)
                                   if n else None))
        return c
