"""MoEAdapter: a mixture-of-experts transformer behind the adapter protocol.

Counterpart of ``deepspeed_tpu/inference/adapters/moe.py``. A self-contained
MoE decode forward (the GPT-2 cache mechanics: write at the frontier, a
global-position causal mask, the stale-cache rule) whose MLP is a
Switch-style top-1 MoE routed through ``moe/sharded_moe.top1gating``.
Attention is the JAX module's masked einsum (``models/generation
.einsum_attention`` with a dense mask) and the expert FFN its four einsums
over a [tokens, experts, capacity] dispatch: ordinary torch, no kernel of
the port runs (K3-K6 launch 0 times in an MoE run).

FAILOVER INVARIANT (per-row independence): capacity-based dropping couples
rows through the cumsum position race, which would break the bit-faithful
crash replay (a replayed request lands next to other neighbours). The
serving default therefore pins capacity to the FULL token count
(``capacity_factor=0`` means "factor = n_experts", so ``cap == tokens``
and nothing drops): each row's output depends only on its own token.
Routing is deterministic (no noise), so the (seed, position) sampler
survives expert routing unchanged. A nonzero ``capacity_factor``
re-enables dropping for load studies but voids the replay invariant.

Everything is capturable: capacity is a host int from shapes, and the
gating is fixed-shape arithmetic with no host sync.

Telemetry rides the pool's ``aux_`` state (``inference/kv_pool.py``):
per-expert dispatch counts and the routed and dropped token totals
accumulate on the device in ``aux_moe_*`` tensors, updated in place by
every forward, read back in the step's one harvest copy, and ``observe``
publishes them as ``moe_expert_load{expert=i}``, ``moe_tokens_routed``,
``moe_tokens_dropped``, ``moe_drop_rate``, ``moe_capacity_factor`` and
``moe_expert_load_imbalance``. Counts include every slot the program
touches (idle slots decode garbage by design), so they read as program
load, not per-request token counts.

Plain fp KV planes only: int8 planes, the prefix tier and the paged pool
are refused, as in the JAX package.

EXPERT PARALLELISM over a mesh's 'model' axis (``bind(config, mesh)``):
with ``expert_parallel`` (the default) model rank r holds experts ``[r
E/mp, (r + 1) E/mp)`` (the first of ``DEFAULT_TP_RULES``); without it
every rank holds every expert. The attention follows the GPT-2 rules
either way (its heads split, ``c_proj`` row-parallel). The JAX layer lets
GSPMD place the token all-to-alls; here the tokens are replicated over
the model ranks, so none is needed: the router runs on every rank on the
same fp32 logits (the same routing, counts and drops everywhere), a rank
dispatches to and runs only its own experts, and their combined partial
output is summed over the model group (``serving_reduce``). The
``aux_moe_*`` counters stay whole-model counts on every rank.
"""

import collections
import dataclasses
import types
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.analysis.annotations import hot_path
from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference.adapters.protocol import (mesh_tp,
                                                             shard_tree)
from deepspeed_tpu_torch.inference.adapters.gpt2 import (EinsumAttention,
                                                         GPT2Adapter,
                                                         einsum_attention,
                                                         row_parallel,
                                                         serving_rule)
from deepspeed_tpu_torch.models.gpt2 import dense, layer_norm
from deepspeed_tpu_torch.parallel.tensor_parallel import (serving_reduce,
                                                          shard_of)
from deepspeed_tpu_torch.moe import sharded_moe
from deepspeed_tpu_torch.ops.transformer.kernels.decode_attention import \
    gather_pages

# The leading fields mirror _GenCfg (the KV pool sizes from them).
MoECfg = collections.namedtuple(
    "MoECfg",
    "n_layer n_head n_embd n_positions dtype layer_norm_epsilon "
    "use_flash_decode vocab_size n_experts d_ff capacity_factor kv_page_len",
    defaults=(0,))

_DENSE_MASK = EinsumAttention(0, 0, 0, 0)
_AUX = ("aux_moe_load", "aux_moe_routed", "aux_moe_dropped")


def _moe_mlp(blk, h, cfg):
    """Top-1 routed expert MLP over ``h`` [B, S, C]. Returns (out [B, S,
    C], per-expert dispatch counts [E] fp32, dropped tokens fp32 [])."""
    B, S, C = h.shape
    tok = h.reshape(B * S, C)
    router = blk.router
    logits = tok.float() @ router.kernel.float() + router.bias.float()
    factor = cfg.capacity_factor or float(cfg.n_experts)
    # No noise: routing is deterministic (module docstring).
    _, combine, dispatch, exp_counts = sharded_moe.top1gating(
        logits, capacity_factor=factor, min_capacity=1, noise_rng=None)
    exp = blk.experts
    dt = h.dtype
    if exp.tp is not None:
        # This rank's experts only; the partial summed over the group.
        per = cfg.n_experts // exp.tp.size
        dispatch = dispatch[:, exp.tp.rank * per:(exp.tp.rank + 1) * per]
        combine = combine[:, exp.tp.rank * per:(exp.tp.rank + 1) * per]
    disp = torch.einsum("tec,tm->ecm", dispatch.to(dt), tok)
    hh = torch.einsum("ecm,emf->ecf", disp, exp.w1.to(dt))
    hh = F.gelu(hh + exp.b1[:, None, :].to(dt), approximate="tanh")
    eo = torch.einsum("ecf,efm->ecm", hh, exp.w2.to(dt))
    eo = eo + exp.b2[:, None, :].to(dt)
    out = torch.einsum("tec,ecm->tm", combine.to(dt), eo)
    if exp.tp is not None:
        out = serving_reduce(out.contiguous(), exp.tp)
    counts = exp_counts.float()
    dropped = float(B * S) - counts.sum()
    return out.reshape(B, S, C), counts, dropped


@hot_path
def _moe_forward(params, cfg, ids, cache, last_only=False):
    """ids [B, S], row b starting at ``cache['pos'][b]``; returns (fp32
    logits [B, S, V], cache with the planes written, the ``aux_moe_*``
    counters advanced in place and ``pos + S``). A ``block_tbl`` (the
    engine's prefill lane: the planes seen as an arena of one page per
    slot) routes the write and the read through the table."""
    if cache["k"].dtype == torch.int8 or "pk" in cache:
        raise ValueError(
            "MoEAdapter supports plain fp KV planes only (no int8 / "
            "prefix hierarchy tiers)")
    B, S = ids.shape
    hd = cfg.n_embd // cfg.n_head
    dev = ids.device
    pos = cache["pos"]
    eps = cfg.layer_norm_epsilon
    q_pos = pos.to(torch.int64)[:, None] + torch.arange(S, device=dev)
    pe = params.wpe[q_pos.clamp(max=cfg.n_positions - 1)]
    x = params.wte[ids.to(torch.int64)].to(cfg.dtype) + pe.to(cfg.dtype)
    rows = torch.arange(B, device=dev)[:, None]
    tbl = cache.get("block_tbl")
    if tbl is not None:
        page_len = cache["k"].shape[3]
        at = (tbl[rows, q_pos // page_len], slice(None), q_pos % page_len)
    else:
        at = (rows, slice(None), q_pos)
    k_cache, v_cache = cache["k"], cache["v"]
    load, routed = cache["aux_moe_load"], cache["aux_moe_routed"]
    dropped_total = cache["aux_moe_dropped"]
    for blk in params.blocks:
        attn_tp = blk.attn.tp
        nh = cfg.n_head // (attn_tp.size if attn_tp is not None else 1)
        h = layer_norm(x, blk.ln_1, eps)
        q, k, v = dense(h, blk.attn.c_attn).split(nh * hd, dim=-1)
        q = q.reshape(B, S, nh, hd).transpose(1, 2).contiguous()
        k, v = k.reshape(B, S, nh, hd), v.reshape(B, S, nh, hd)
        i = blk.index
        k_cache[i][at] = k
        v_cache[i][at] = v
        k_eff, v_eff = k_cache[i], v_cache[i]
        if tbl is not None:
            k_eff, v_eff = gather_pages(k_eff, tbl), gather_pages(v_eff, tbl)
        y = einsum_attention(q, k_eff, v_eff, q_pos, _DENSE_MASK, cfg.dtype)
        y = y.transpose(1, 2).reshape(B, S, nh * hd)
        x = x + row_parallel(y, blk.attn.c_proj, attn_tp)
        h = layer_norm(x, blk.ln_2, eps)
        m, counts, dropped = _moe_mlp(blk, h, cfg)
        x = x + m
        load.add_(counts)
        routed.add_(float(B * S))
        dropped_total.add_(dropped)
    if last_only:
        x = x[:, -1:]
    x = layer_norm(x, params.ln_f, eps)
    logits = torch.matmul(x.float(), params.wte.t())
    return logits, dict(cache, pos=pos + S)


def _ns(**kw):
    return types.SimpleNamespace(**kw)


def _weights(tensor, cfg, tp=None, expert_parallel=True):
    """The MoE weights as the forward reads them from ``tensor(path,
    shape, kind)`` (kind: 'dense' for a GEMM operand cast to the serving
    dtype once, 'fp32' otherwise): wte/wpe/LayerNorms/router in fp32, the
    attention kernels and the expert stacks in ``cfg.dtype``. ``tp``: this
    model rank's shard (``serving_rule``; the experts only under
    ``expert_parallel``), each block carrying the contexts its attention
    and experts compute under."""
    if tp is not None:
        rule = serving_rule(cfg, tp.size)
        whole = tensor

        def tensor(path, kind):
            t = whole(path, kind)
            cut = rule(path, tuple(t.shape))
            if cut is None or ("experts" in path and not expert_parallel):
                return t
            return shard_of(t, cut[0], tp, cut[1]).contiguous()
    heads_tp = tp if tp is not None and cfg.n_head % tp.size == 0 else None
    ep_tp = tp if tp is not None and expert_parallel and \
        cfg.n_experts % tp.size == 0 else None

    def ln(path):
        return _ns(scale=tensor(path + ("scale",), "fp32"),
                   bias=tensor(path + ("bias",), "fp32"))

    def lin(path):
        return _ns(kernel=tensor(path + ("kernel",), "dense"),
                   bias=tensor(path + ("bias",), "dense"))

    blocks = []
    for i in range(cfg.n_layer):
        h = ("h_{}".format(i),)
        blocks.append(_ns(
            index=i, ln_1=ln(h + ("ln_1",)), ln_2=ln(h + ("ln_2",)),
            attn=_ns(c_attn=lin(h + ("attn", "c_attn")),
                     c_proj=lin(h + ("attn", "c_proj")), tp=heads_tp),
            router=_ns(kernel=tensor(h + ("router", "kernel"), "fp32"),
                       bias=tensor(h + ("router", "bias"), "fp32")),
            experts=_ns(tp=ep_tp, **{n: tensor(h + ("experts", n), "dense")
                                     for n in ("w1", "b1", "w2", "b2")})))
    return _ns(wte=tensor(("wte",), "fp32"), wpe=tensor(("wpe",), "fp32"),
               ln_f=ln(("ln_f",)), blocks=blocks, config=cfg)


def params_from_jax(tree, cfg, device=None, tp=None, expert_parallel=True):
    """The JAX MoE parameter tree (``init_params``' layout: flax names,
    ``[in, out]`` kernels, expert stacks ``[E, ...]``, any array type
    numpy can read) as the weights ``_moe_forward`` reads, on ``device``
    (default ``cuda``; without a GPU it raises unless ``device="cpu"``);
    this model rank's shard under ``tp`` (``_weights``)."""
    device = resolve_device(device)

    def tensor(path, kind):
        node = tree
        for key in path:
            node = node[key]
        t = torch.from_numpy(np.array(node, dtype=np.float32)).to(device)
        return t.to(cfg.dtype) if kind == "dense" else t

    return _weights(tensor, cfg, tp, expert_parallel)


def shard_weights(weights, tp, expert_parallel=True):
    """This model rank's shard of full MoE weights (``init_params`` or
    ``params_from_jax`` without ``tp``)."""
    def tensor(path, kind):
        node = weights
        for key in path:
            node = node.blocks[int(key[2:])] if key.startswith("h_") else \
                getattr(node, key)
        return node

    return _weights(tensor, weights.config, tp, expert_parallel)


def init_params(cfg, seed=0, device=None, init_scale=0.02):
    """Random servable weights for an ``MoECfg``, made on ``device`` from
    ``seed`` (the JAX ``init_params`` layout and scales: normal(0,
    ``init_scale``) kernels, embeddings and router, zero biases, unit
    LayerNorm scales). The draws are torch's, not JAX's."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    C, Fd, E = cfg.n_embd, cfg.d_ff, cfg.n_experts
    shapes = {"wte": (cfg.vocab_size, C), "wpe": (cfg.n_positions, C),
              "c_attn": (C, 3 * C), "c_proj": (C, C), "router": (C, E),
              "w1": (E, C, Fd), "w2": (E, Fd, C)}
    bias_shapes = {"c_attn": (3 * C,), "c_proj": (C,), "router": (E,),
                   "b1": (E, Fd), "b2": (E, C)}

    def tensor(path, kind):
        name = path[-1] if path[-1] not in ("kernel", "bias") else path[-2]
        dt = cfg.dtype if kind == "dense" else torch.float32
        if path[-1] == "scale":
            return torch.ones((C,), dtype=dt, device=device)
        if path[-1] == "bias" and path[-2] in ("ln_1", "ln_2", "ln_f"):
            return torch.zeros((C,), dtype=dt, device=device)
        if path[-1] == "bias" or name in ("b1", "b2"):
            return torch.zeros(bias_shapes[name], dtype=dt, device=device)
        t = torch.randn(shapes[name], generator=gen, device=device)
        return (t * init_scale).to(dt)

    return _weights(tensor, cfg)


@dataclasses.dataclass(frozen=True)
class MoEAdapter(GPT2Adapter):
    """MoE decode. Subclasses GPT2Adapter only for the model-agnostic
    drafting pair (``ngram_draft`` / ``accept_counts``) and ``cache_spec``;
    every forward is the MoE program above."""

    expert_parallel: bool = True
    name: ClassVar[str] = "moe"

    @classmethod
    def from_config(cls, vocab_size=256, n_layer=2, n_head=2, n_embd=32,
                    n_positions=512, n_experts=4, d_ff=None,
                    capacity_factor=0.0, dtype=torch.float32,
                    layer_norm_epsilon=1e-5):
        """``capacity_factor=0`` pins capacity to the full token count
        (no drops: the serving and failover default)."""
        return cls(MoECfg(int(n_layer), int(n_head), int(n_embd),
                          int(n_positions), dtype, float(layer_norm_epsilon),
                          False, int(vocab_size), int(n_experts),
                          int(d_ff or 4 * n_embd), float(capacity_factor)))

    def init_params(self, seed=0, device=None, init_scale=0.02):
        return init_params(self.gcfg, seed, device, init_scale)

    def prepare_params(self, params, device):
        """A JAX-layout tree (numpy) is carried across; weights already
        built (``init_params``) are taken as they are; under ``tp`` this
        rank's shard of either."""
        if isinstance(params, types.SimpleNamespace):
            if self.tp is None:
                return params
            return shard_weights(params, self.tp, self.expert_parallel)
        return params_from_jax(params, self.gcfg, device, self.tp,
                               self.expert_parallel)

    def param_shardings(self, mesh, params):
        """This rank's shard of the JAX tree: the GPT-2 attention rules,
        and the experts' rule only under ``expert_parallel`` (JAX
        ``MoEAdapter.param_shardings``)."""
        tp = mesh_tp(mesh)
        if tp is None:
            return None
        rule = serving_rule(self.gcfg, tp.size)

        def moe_rule(path, shape):
            if "experts" in path and not self.expert_parallel:
                return None
            return rule(path, shape)
        return shard_tree(params, moe_rule, tp)

    def bind(self, config, mesh=None):
        adapter = self
        tp = mesh_tp(mesh)
        if tp is not None:
            adapter = dataclasses.replace(adapter, tp=tp)
        if config is not None:
            if getattr(config, "paged_kv", False):
                raise ValueError(
                    "inference.paged_kv is not supported by the MoE adapter "
                    "(its forward has no block-table path); serve MoE with "
                    "the dense KV pool")
            if getattr(config, "int8_kv", False) or \
                    getattr(config, "prefix_cache", False):
                raise ValueError(
                    "MoEAdapter supports plain fp KV planes only (no int8 / "
                    "prefix hierarchy tiers)")
            ep = bool(getattr(config, "expert_parallel", True))
            if ep != adapter.expert_parallel:
                return dataclasses.replace(adapter, expert_parallel=ep)
        return adapter

    def init_cache(self, batch, max_len, dtype=None, device=None):
        cfg = self.gcfg
        device = resolve_device(device)
        shape = (cfg.n_layer, batch, cfg.n_head, max_len,
                 cfg.n_embd // cfg.n_head)
        cache = {"k": torch.zeros(shape, dtype=dtype or cfg.dtype,
                                  device=device),
                 "v": torch.zeros(shape, dtype=dtype or cfg.dtype,
                                  device=device),
                 "pos": torch.zeros(batch, dtype=torch.int32, device=device)}
        for name, (shp, dt) in self.aux_state().items():
            cache[name] = torch.zeros(shp, dtype=dt, device=device)
        return cache

    def aux_state(self):
        return {"aux_moe_load": ((self.gcfg.n_experts,), torch.float32),
                "aux_moe_routed": ((), torch.float32),
                "aux_moe_dropped": ((), torch.float32)}

    @hot_path
    def prefill_append(self, params, ids, cache, n_valid=None):
        pos0 = cache["pos"]
        logits, cache = _moe_forward(params, self.gcfg, ids, cache)
        if n_valid is not None:
            cache = dict(cache, pos=pos0 + n_valid.to(pos0.dtype))
        return logits, cache

    @hot_path
    def decode_step(self, params, tok, cache):
        logits, cache = _moe_forward(params, self.gcfg, tok[:, None], cache)
        return logits[:, 0], cache

    @hot_path
    def verify_forward(self, params, ids, cache):
        pos0 = cache["pos"]
        logits, cache = _moe_forward(params, self.gcfg, ids, cache)
        return logits, dict(cache, pos=pos0)

    def observe(self, snap, registry):
        load = snap.get("aux_moe_load")
        if load is None:
            return
        load = [float(v) for v in load]
        for i, v in enumerate(load):
            registry.gauge("moe_expert_load", expert=str(i)).set(v)
        total = sum(load)
        routed = float(snap.get("aux_moe_routed", 0.0))
        dropped = float(snap.get("aux_moe_dropped", 0.0))
        registry.gauge("moe_tokens_routed").set(routed)
        registry.gauge("moe_tokens_dropped").set(dropped)
        registry.gauge("moe_drop_rate").set(
            dropped / routed if routed else 0.0)
        registry.gauge("moe_capacity_factor").set(
            self.gcfg.capacity_factor or float(self.gcfg.n_experts))
        if total:
            # max/mean dispatch ratio: 1.0 balanced, n_experts collapsed.
            registry.gauge("moe_expert_load_imbalance").set(
                max(load) * len(load) / total)
