"""Autoregressive generation for GPT-2: KV-cache prefill, append and decode.

Counterpart of ``deepspeed_tpu/models/generation.py``. One forward
(``_forward``) serves every caller: ``generate``'s prefill and decode loop,
and the serving engine's prefill lane (``append_forward``), decode lane
(``decode_step``) and speculative verify (``verify_forward``), which is
what keeps single-shot and continuous-batching outputs token-identical.

The cache is a dict: ``k``/``v`` planes ``[layers, B, heads, T, head_dim]``
and a per-row frontier ``pos`` [B] int32. Two variants, dispatched on the
cache's keys as the JAX package does (``inference/kv_pool.py``):

- int8: ``k``/``v`` hold int8 codes and ``k_scale``/``v_scale`` [layers,
  .., T] fp32 scales; the frontier write quantizes (``quantize_kv``) and
  writes codes and scales;
- paged: ``k``/``v`` (and the scales) are page arenas ``[layers, P, heads,
  page_len, ...]`` and ``block_tbl`` [B, n_lp] int32 names each row's
  pages; the frontier write scatters at (page, offset) through the table.
  The serving engine's prefill lane passes a dense pool in this form too
  (its planes as an arena of one page per slot, the table ``[[slot]]``:
  ``inference/kv_pool.slot_cache_view``), so the lane's slot is a tensor.

Contracts kept from the JAX package:

- ``pos`` is the PRE-write frontier: the k/v of positions
  ``pos .. pos+S-1`` are written into the planes BEFORE attention, and key
  ``t`` is visible to query row ``i`` iff ``t <= pos[b] + i``;
- no host value steers a forward: ``pos``, ``n_valid`` and the block
  table are tensors, so one captured program serves every frontier, slice
  length and slot;
- the frontier write is one indexed assignment on the device, with no host
  sync, and it never clamps: an index past the plane (or, paged, past the
  block table, where the JAX package clamps the page index) raises, as an
  IndexError on the CPU and a device-side assert on the card (the pool's
  ``prefill_chunk`` slack keeps every admissible write in bounds);
- attention is one of the four flash-decode kernels, by layout (K3 dense,
  K4 int8, K5 paged, K6 paged int8): the hand-written kernel on a CUDA
  tensor, its plain version on a CPU tensor. Only an adapter that asks
  for it (``attn``, an ``EinsumAttention``: the long-context adapter)
  takes the JAX package's einsum path instead: the planes gathered through
  the table and dequantized where they are paged or int8, a masked fp32
  softmax between two einsums, and, with ``threshold > 0``, the fixed
  block-sparse layout (``FixedSparsityConfig``, unidirectional) for query
  positions at or past the threshold. No kernel runs on that path;
- GELU is tanh-approximate; the LM head is an fp32 product against
  ``wte``.

Tensor parallelism (serving over a mesh's 'model' axis): a block whose
``attn.tp`` / ``mlp.tp`` is a ``TPContext`` computes Megatron's split, as
the training forward does (``models/gpt2.py``). ``c_attn`` holds the
rank's heads of q, k and v (``qkv_order``), so the rank writes and attends
its H/mp heads of the planes (``parallel/mesh.kv_heads``); ``mlp/c_fc``
holds its column block. Both ``c_proj`` products are row-parallel: the
partial is summed over the model group (``tensor_parallel
.serving_reduce``), then the bias is added once. ``wte``, ``wpe`` and the
LayerNorms are replicated, so every rank computes the same fp32 logits.
Heads that mp does not divide stay whole on every rank (the attention
then runs replicated, as the JAX planes are).

In torch the planes are updated IN PLACE (JAX threads a new array through);
the returned cache holds the same plane tensors and an advanced ``pos``.

Speculation's other two primitives, ``ngram_draft`` and ``accept_counts``,
are plain tensor code on the device with no host sync, so a captured step
program holds them. The shared-prefix cache layout waits for a later slice.
"""

import collections
import functools
import types

import numpy as np

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.analysis.annotations import hot_path
from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.gpt2 import dense, layer_norm, qkv_order
from deepspeed_tpu_torch.ops.sampling import sample_rows
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
    FixedSparsityConfig
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention
from deepspeed_tpu_torch.parallel.tensor_parallel import (serving_reduce,
                                                          shard_of)

# Shape/dtype view of a GPT2Config: what the cache and the pool are sized
# from (and what an adapter's ``cache_spec`` returns). ``kv_page_len`` > 0
# names the page length of a paged pool (the adapter stamps it from the
# engine's config); 0 is the dense pool. ``use_flash_decode`` False names
# the einsum attention path (the long-context adapter's), and the sparse_*
# tail its block-sparse mask (``sparse_threshold`` 0: a dense causal mask).
_GenCfg = collections.namedtuple(
    "_GenCfg",
    "n_layer n_head n_embd n_positions dtype layer_norm_epsilon kv_page_len "
    "use_flash_decode sparse_block sparse_num_local sparse_num_global "
    "sparse_threshold", defaults=(0, True, 0, 0, 0, 0))

# The einsum attention path's geometry (``_forward``'s ``attn``): the
# FixedSparsityConfig block side, local and global blocks, and the query
# position from which the sparse mask applies (0: never, a dense mask).
EinsumAttention = collections.namedtuple(
    "EinsumAttention", "block num_local num_global threshold")


def einsum_attention_of(cfg):
    """``_forward``'s ``attn`` for a ``_GenCfg``: None (the kernels) unless
    ``use_flash_decode`` is False."""
    if cfg.use_flash_decode:
        return None
    return EinsumAttention(cfg.sparse_block, cfg.sparse_num_local,
                           cfg.sparse_num_global, cfg.sparse_threshold)


@functools.lru_cache(maxsize=None)
def _sparse_layout(block, num_local, num_global, num_blocks, device):
    """[num_blocks, num_blocks] bool block visibility of the fixed
    (local + stride) unidirectional layout on ``device`` (the JAX
    ``generation._sparse_layout``): built once per geometry and device, on
    a program's eager first run, so a CUDA graph capture finds it and
    copies nothing."""
    layout = FixedSparsityConfig(
        num_heads=1, block=block, num_local_blocks=num_local,
        num_global_blocks=num_global,
        attention="unidirectional").make_layout(num_blocks * block)
    return torch.from_numpy(np.asarray(layout[0], dtype=bool)).to(device)


def einsum_attention(q, k, v, q_pos, attn, dtype):
    """The JAX einsum path: q [B, H, S, D] against logical planes k, v [B,
    H, T, D] in ``dtype``; key t is visible to query position p iff t <= p
    and, past ``attn.threshold``, the sparse layout shows t's block to p's
    block. Scores (from q and k in fp32, as the decode kernels' plain
    versions take them: the JAX einsum rounds bf16 scores to bf16, which
    parts greedy streams from K3's) and softmax in fp32, probabilities
    cast to ``dtype`` for the value product."""
    T = k.shape[2]
    k_pos = torch.arange(T, device=q.device)
    mask = k_pos[None, None, :] <= q_pos[:, :, None]          # [B, S, T]
    if attn.threshold:
        blk = attn.block
        nb = -(-T // blk)
        layout = _sparse_layout(blk, attn.num_local, attn.num_global, nb,
                                q.device)
        q_blk = torch.clamp(q_pos // blk, max=nb - 1)
        visible = layout[q_blk[:, :, None], (k_pos // blk)[None, None, :]]
        mask = mask & ((q_pos < attn.threshold)[:, :, None] | visible)
    att = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / \
        float(q.shape[3]) ** 0.5
    att = torch.where(mask[:, None], att, torch.finfo(torch.float32).min)
    att = torch.softmax(att, dim=-1).to(dtype)
    return torch.einsum("bhqk,bhkd->bhqd", att, v)


def as_gencfg(cfg):
    """``_GenCfg`` view of a GPT2Config (or anything with the same
    attributes)."""
    if isinstance(cfg, _GenCfg):
        return cfg
    return _GenCfg(cfg.n_layer, cfg.n_head, cfg.n_embd, cfg.n_positions,
                   cfg.dtype, getattr(cfg, "layer_norm_epsilon", 1e-5))


def init_cache(cfg, batch, max_len, dtype=None, device=None):
    """Zeroed ``[layers, B, heads, max_len, head_dim]`` k/v planes plus a
    per-row frontier ``pos`` [B] int32, on ``device`` (default ``cuda``;
    without a GPU it raises unless ``device="cpu"`` is passed)."""
    dtype = dtype or cfg.dtype
    device = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.n_embd // cfg.n_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros(batch, dtype=torch.int32, device=device)}


def serving_rule(cfg, mp):
    """Where a serving rank over ``mp`` model ranks cuts a GPT-2-shaped
    parameter: ``rule(path, shape)`` (path: the flax names) gives (dim,
    order) or None (replicated). The JAX ``DEFAULT_TP_RULES`` with
    ``c_attn`` cut by heads (``qkv_order``) where mp divides the heads,
    ``mlp/c_fc`` by columns, both ``c_proj`` kernels by rows, and the
    expert stacks (``experts``, the MoE adapter's) on their first dim."""
    heads = cfg.n_head % mp == 0

    def rule(path, shape):
        tail = path[-3:]
        if "experts" in path:
            return (0, None) if shape[0] % mp == 0 else None
        if tail[:2] == ("attn", "c_attn") and heads:
            return (len(shape) - 1, qkv_order(cfg.n_embd))
        if tail == ("attn", "c_proj", "kernel") and heads:
            return (0, None)
        if tail[:2] == ("mlp", "c_fc") and shape[-1] % mp == 0:
            return (len(shape) - 1, None)
        if tail == ("mlp", "c_proj", "kernel") and shape[0] % mp == 0:
            return (0, None)
        return None
    return rule


class ServingWeights:
    """A GPT-2 model's weights as the serving path reads them: the dense
    kernels and biases cast to ``config.dtype`` once (the model holds them
    in fp32 and would cast them at every call), ``wte``, ``wpe`` and the
    LayerNorm parameters shared with the model. ``_forward`` reads this and
    a ``GPT2LMHeadModel`` alike, with the same numbers.

    ``tp`` (a ``TPContext``): keep this model rank's shard of a full
    model's weights (``serving_rule``; module docstring). A model already
    cut by ``tensor_parallel.apply_rules`` keeps its own shards and
    contexts."""

    def __init__(self, model, tp=None):
        self.config = model.config
        self.wte, self.wpe, self.ln_f = model.wte, model.wpe, model.ln_f
        dt = model.config.dtype
        if any(getattr(blk.attn, "tp", None) is not None
               for blk in model.blocks()):
            tp = None
        rule = serving_rule(model.config, tp.size) if tp is not None \
            else None

        def cast(path, p):
            leaves = {}
            for leaf in ("kernel", "bias"):
                t = getattr(p, leaf).detach()
                cut = rule(path + (leaf,), tuple(t.shape)) if rule else None
                if cut is not None:
                    t = shard_of(t, cut[0], tp, cut[1])
                leaves[leaf] = t.to(dt).contiguous()
            return types.SimpleNamespace(**leaves)

        # Each half of a block computes split where the rule cuts it.
        C = model.config.n_embd
        attn_tp, mlp_tp = (
            tp if rule is not None and rule(path, shape) is not None
            else None for path, shape in (
                (("attn", "c_proj", "kernel"), (C, C)),
                (("mlp", "c_proj", "kernel"), (4 * C, C))))
        self._blocks = []
        for i, blk in enumerate(model.blocks()):
            h = ("h_{}".format(i),)
            self._blocks.append(types.SimpleNamespace(
                ln_1=blk.ln_1, ln_2=blk.ln_2,
                attn=types.SimpleNamespace(
                    c_attn=cast(h + ("attn", "c_attn"), blk.attn.c_attn),
                    c_proj=cast(h + ("attn", "c_proj"), blk.attn.c_proj),
                    tp=attn_tp if rule is not None else blk.attn.tp),
                mlp=types.SimpleNamespace(
                    c_fc=cast(h + ("mlp", "c_fc"), blk.mlp.c_fc),
                    c_proj=cast(h + ("mlp", "c_proj"), blk.mlp.c_proj),
                    tp=mlp_tp if rule is not None else blk.mlp.tp)))

    def blocks(self):
        return self._blocks


def row_parallel(y, p, tp):
    """``y @ kernel + bias`` of a row-parallel layer (``tp`` a
    ``TPContext``): the local product summed over the model group, then
    the replicated bias; ``dense`` when ``tp`` is None."""
    if tp is None:
        return dense(y, p)
    part = torch.matmul(y, p.kernel.to(y.dtype))
    return serving_reduce(part, tp) + p.bias.to(y.dtype)


@hot_path
def _forward(model, ids, cache, last_only=False, attn=None):
    """ids [B, S], row b starting at ``cache['pos'][b]``; returns (fp32
    logits [B, S, V], cache with the planes written and ``pos + S``).
    ``last_only`` evaluates the LM head on the final position only.
    ``attn``: None for the decode kernels, an ``EinsumAttention`` for the
    einsum path (module docstring)."""
    extra = set(cache) - {"k", "v", "pos", "k_scale", "v_scale", "block_tbl"}
    if extra:
        raise NotImplementedError(
            "the forward reads only the k/v planes, their scales and a block "
            "table: a shared prefix reaches it copied into the slot's own "
            "plane or shared through the table (cache keys {})".format(
                sorted(extra)))
    int8 = cache["k"].dtype == torch.int8
    paged = "block_tbl" in cache
    cfg = model.config
    B, S = ids.shape
    hd = cfg.n_embd // cfg.n_head
    dev = ids.device
    pos = cache["pos"]
    q_pos = pos.to(torch.int64)[:, None] + torch.arange(S, device=dev)
    # Rows past the last real position (chunk pad columns, frozen slots at
    # a finished frontier) may reach n_positions; their outputs are never
    # read, and the clamp keeps their gather in bounds, as the JAX gather
    # does. Admission keeps every real row below n_positions.
    pe = model.wpe[q_pos.clamp(max=cfg.n_positions - 1)]
    x = model.wte[ids.to(torch.int64)].to(cfg.dtype) + pe.to(cfg.dtype)
    rows = torch.arange(B, device=dev)[:, None]
    if paged:
        # Position p of row b lives at (page tbl[b, p // page_len], offset
        # p % page_len). No clamp on the page index: a position past the
        # table raises, as one past a dense plane does.
        tbl = cache["block_tbl"]
        page_len = cache["k"].shape[3]
        at = (tbl[rows, q_pos // page_len], slice(None), q_pos % page_len)
    else:
        at = (rows, slice(None), q_pos)
    scale = 1.0 / float(hd) ** 0.5
    k_cache, v_cache = cache["k"], cache["v"]
    ks_cache, vs_cache = cache.get("k_scale"), cache.get("v_scale")
    for i, blk in enumerate(model.blocks()):
        attn_tp = getattr(blk.attn, "tp", None)
        nh = cfg.n_head // (attn_tp.size if attn_tp is not None else 1)
        h = layer_norm(x, blk.ln_1, cfg.layer_norm_epsilon)
        q, k, v = dense(h, blk.attn.c_attn).split(nh * hd, dim=-1)
        q = q.reshape(B, S, nh, hd).transpose(1, 2).contiguous()
        k, v = k.reshape(B, S, nh, hd), v.reshape(B, S, nh, hd)
        # Frontier write: plane[b, :, pos[b] + s, :] = new[b, s] (through
        # the table when paged). Frozen rows of freed slots may write the
        # same trash-page entry; nothing reads it unmasked.
        if int8:
            # One quantization of k and v together (per-row scales, so the
            # same codes as two): half the eager launches.
            codes, scales = decode_attention.quantize_kv(torch.stack((k, v)))
            k_cache[i][at], v_cache[i][at] = codes[0], codes[1]
            ks_cache[i][at], vs_cache[i][at] = scales[0], scales[1]
        else:
            k_cache[i][at] = k
            v_cache[i][at] = v
        if attn is not None:
            k_eff, v_eff = k_cache[i], v_cache[i]
            ks_eff, vs_eff = (ks_cache[i], vs_cache[i]) if int8 \
                else (None, None)
            if paged:
                k_eff = decode_attention.gather_pages(k_eff, tbl)
                v_eff = decode_attention.gather_pages(v_eff, tbl)
                if int8:
                    ks_eff = decode_attention.gather_pages(ks_eff, tbl)
                    vs_eff = decode_attention.gather_pages(vs_eff, tbl)
            if int8:
                k_eff = decode_attention.dequantize_kv(k_eff, ks_eff,
                                                       cfg.dtype)
                v_eff = decode_attention.dequantize_kv(v_eff, vs_eff,
                                                       cfg.dtype)
            y = einsum_attention(q, k_eff, v_eff, q_pos, attn, cfg.dtype)
        elif paged and int8:
            y = decode_attention.flash_decode_attention_paged_q8(
                q, k_cache[i], v_cache[i], ks_cache[i], vs_cache[i], tbl,
                pos, scale=scale)
        elif paged:
            y = decode_attention.flash_decode_attention_paged(
                q, k_cache[i], v_cache[i], tbl, pos, scale=scale)
        elif int8:
            y = decode_attention.flash_decode_attention_q8(
                q, k_cache[i], v_cache[i], ks_cache[i], vs_cache[i], pos,
                scale=scale)
        else:
            y = decode_attention.flash_decode_attention(
                q, k_cache[i], v_cache[i], pos, scale=scale)
        y = y.transpose(1, 2).reshape(B, S, nh * hd)
        x = x + row_parallel(y, blk.attn.c_proj, attn_tp)
        h = layer_norm(x, blk.ln_2, cfg.layer_norm_epsilon)
        h = F.gelu(dense(h, blk.mlp.c_fc), approximate="tanh")
        x = x + row_parallel(h, blk.mlp.c_proj, getattr(blk.mlp, "tp", None))
    if last_only:
        x = x[:, -1:]
    x = layer_norm(x, model.ln_f, cfg.layer_norm_epsilon)
    logits = torch.matmul(x.float(), model.wte.t())
    return logits, dict(cache, pos=pos + S)


def prefill_forward(model, ids, cache):
    """Whole-prompt prefill of ``ids`` [B, Tp] at the cache's frontiers,
    in slices of at most ``decode_attention.MAX_QUERY_ROWS`` positions
    (the kernel's query-row limit). Each slice attends causally to the
    cache, earlier slices included, so the result is the one-pass
    prefill's. Returns (fp32 logits [B, 1, V] of the last position,
    advanced cache)."""
    step = decode_attention.MAX_QUERY_ROWS
    for s in range(0, ids.shape[1], step):
        logits, cache = _forward(model, ids[:, s:s + step], cache,
                                 last_only=True)
    return logits, cache


@hot_path
def append_forward(model, ids, cache, n_valid=None, attn=None):
    """Append ``ids`` [B, S] at each row's frontier: the chunked-prefill
    primitive. ``n_valid`` [B] marks how many leading columns per row are
    real; the frontier advances by ``n_valid`` (default S). Pad columns
    write k/v past the advanced frontier, where the mask hides them until a
    later write lands on top; their logits are garbage. Returns (fp32
    logits [B, S, V], advanced cache)."""
    pos0 = cache["pos"]
    logits, cache = _forward(model, ids, cache, attn=attn)
    if n_valid is not None:
        cache = dict(cache, pos=pos0 + n_valid.to(pos0.dtype))
    return logits, cache


@hot_path
def decode_step(model, tok, cache, attn=None):
    """Feed ``tok`` [B] (the token at each row's frontier), write its k/v
    there, and return (fp32 logits [B, V] for the next position, advanced
    cache)."""
    logits, cache = _forward(model, tok[:, None], cache, attn=attn)
    return logits[:, 0], cache


@hot_path
def verify_forward(model, ids, cache, attn=None):
    """Score ``ids`` [B, S] at each row's frontier WITHOUT advancing it:
    the speculative verify. Row b's ids are [last_tok, draft_0 ..
    draft_{S-2}], so ``logits[b, i]`` is the model's distribution for
    position ``pos[b] + i + 1``, what ``decode_step`` would give after the
    first i drafts. The k/v of all S positions are written (an accepted
    draft's k/v depend only on its token and position, fixed at draft
    time); ``pos`` is returned unchanged, and the caller advances it by the
    accepted count only: rejected positions sit past the frontier, masked
    or overwritten before it reaches them. The plane needs S - 1 positions
    of slack past the last admissible frontier (the write never clamps)."""
    pos0 = cache["pos"]
    logits, cache = _forward(model, ids, cache, attn=attn)
    return logits, dict(cache, pos=pos0)


@hot_path
def ngram_draft(toks, pos, n, k):
    """Prompt-lookup drafting: for each row, the ``k`` tokens that followed
    the MOST RECENT earlier occurrence of the row's trailing ``n``-gram in
    its own context ``toks[b, :pos[b] + 1]`` (the frontier token sits at
    ``pos[b]``). ``toks`` [B, T] is the token ring (entries past a row's
    frontier are garbage: candidates end strictly below the frontier, so
    they are never matched), ``pos`` [B] the frontiers; ``n`` and ``k`` are
    host ints. A row with no match drafts its frontier token ``k`` times;
    the continuation gather is clipped to ``[0, pos[b]]``, so a match just
    below the frontier drafts from the valid suffix it overlaps. Returns
    int64 [B, k]. Device work only: ``n`` shifted compares over the ring
    (``torch.roll``, whose wraparound only reaches j < n - 1, which the
    window excludes)."""
    T = toks.shape[1]
    dev = toks.device
    p = pos.to(torch.int64)[:, None]
    idx = torch.arange(T, device=dev)[None]
    last = toks.gather(1, p.clamp(0, T - 1))
    match = (idx >= n - 1) & (idx < p)
    for i in range(n):
        match = match & (torch.roll(toks, i, dims=1)
                         == toks.gather(1, (p - i).clamp(0, T - 1)))
    j = torch.where(match, idx, -1).amax(dim=1, keepdim=True)
    cont = torch.minimum((j + 1 + torch.arange(k, device=dev)[None])
                         .clamp(min=0), p.clamp(min=0))
    return torch.where(j >= 0, toks.gather(1, cont), last).to(torch.int64)


@hot_path
def accept_counts(draft, choices, ok=None):
    """The speculative accept rule: drafts [B, K] against the model's own
    choices [B, K+1] from a verify (``choices[:, i]`` is its pick at
    position ``pos + i + 1``). Returns int64 [B] in ``1..K+1``: the
    always-correct first choice plus the length of the longest prefix on
    which draft and choice agree. ``ok`` [B, 1] or [B, K] (optional) vetoes
    agreement (False forces 1: the slots that do not speculate)."""
    agree = draft == choices[:, :draft.shape[1]]
    if ok is not None:
        agree = agree & ok
    return 1 + torch.cumprod(agree.to(torch.int64), dim=1).sum(dim=1)


@torch.no_grad()
def generate(model, prompt_ids, max_new_tokens, temperature=1.0, top_k=None,
             seed=0, eos_token_id=None):
    """Continue ``prompt_ids`` [B, Tp] by ``max_new_tokens`` tokens on the
    model's device. ``temperature=0`` is greedy; otherwise tokens are drawn
    from the positional generator (``ops.sampling``) keyed on ``seed`` and
    each token's absolute position, with an optional ``top_k`` filter. Rows
    that emit ``eos_token_id`` keep repeating it. Returns [B,
    max_new_tokens] int64."""
    cfg = model.config
    dev = model.wte.device
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    prompt = torch.as_tensor(prompt_ids, dtype=torch.int64).to(dev)
    B, Tp = prompt.shape
    if Tp + max_new_tokens > cfg.n_positions:
        raise ValueError("prompt + new tokens exceed n_positions={}".format(
            cfg.n_positions))
    sampling = temperature > 0
    temp = torch.full((B,), float(temperature), device=dev)
    top = torch.full((B,), int(top_k or 0), dtype=torch.int32, device=dev)
    seeds = torch.full((B,), int(seed), dtype=torch.int64, device=dev)

    def sample(logits, position):
        return sample_rows(logits, temp, top, seeds,
                           torch.full((B,), position, device=dev),
                           any_sample=sampling, any_top_k=bool(top_k))

    cache = init_cache(as_gencfg(cfg), B, Tp + max_new_tokens, device=dev)
    logits, cache = prefill_forward(model, prompt, cache)
    tok = sample(logits[:, -1], Tp)
    out = [tok]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(1, max_new_tokens):
        logits, cache = decode_step(model, tok, cache)
        nxt = sample(logits, Tp + t)
        if eos_token_id is not None:
            done = done | (tok == eos_token_id)
            nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1)
