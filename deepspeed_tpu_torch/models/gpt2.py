"""GPT-2 family in PyTorch: the config, the parameters and the training
forward.

Counterpart of ``deepspeed_tpu/models/gpt2.py``. Parameters keep the flax
names and layouts, so the weight bridge is mechanical: ``wte``, ``wpe``,
``h_{i}.ln_1 / attn.c_attn / attn.c_proj / ln_2 / mlp.c_fc / mlp.c_proj`` and
``ln_f``. A dense layer keeps flax's ``kernel [in, out]`` (used as
``x @ kernel + bias``, no transpose); a LayerNorm keeps ``scale`` and
``bias``.

Precision, as in flax: every parameter is held in fp32, and each call casts
a dense layer's kernel and bias to ``config.dtype`` (flax's ``dtype=``).
LayerNorm computes in fp32 and casts its output; the embedding is gathered
and cast; the tied LM head's logits are fp32. The serving engine casts the
dense weights once instead (``generation.ServingWeights``).

Parameters are built with ``requires_grad=False``, as weights are data in
flax; the training engine switches gradients on for what it trains.

``forward`` is the training forward (no cache): pre-LN blocks whose
attention is ``flash_attention`` (kernels K1/K2 on the card) or, with
``use_flash_attention=False``, the dense einsum path. Serving goes through
``models.generation``.

Tensor parallelism (``parallel/tensor_parallel.py``): under the JAX
package's ``DEFAULT_TP_RULES`` a block computes Megatron's split. The
attention's ``c_attn`` is column-parallel by heads (rank r holds heads
r H/mp ... of q, k and v, so ``flash_attention`` runs on its H/mp local
heads) and its ``c_proj`` row-parallel (the output all-reduced, the
replicated bias added after the reduction); the MLP's ``c_fc`` is
column-parallel (GELU on the local columns) and its ``c_proj``
row-parallel. Two all-reduces a block forward, two backward; the
embeddings, LayerNorms and the tied head stay replicated.

Sequence parallelism (``GPT2Config(sequence_parallel_axis="seq")``): once
the engine hands the model its seq line (``set_sequence_parallel``, a
``parallel/sequence_parallel.SeqContext``), each rank holds a shard of
T/N tokens: positions start at ``rank * T/N``, attention is
``get_sp_attention(sequence_parallel_mode)`` (the ring or Ulysses over
K1/K2), and the next-token loss takes the next shard's first label by one
ring shift and is the global mean (``_sequence_parallel_xent``). Without a
context the model runs serially, as the JAX model does outside
``shard_map``.

The pipeline variant (``gpt2_pipeline``, JAX ``models/gpt2.py``): an
embedding layer, one layer per block, the final LayerNorm and the tied
head (a ``TiedLayerSpec`` reusing the embedding) or an untied head, with
``gpt2_lm_loss`` (the chunked tied-decoder loss) on the last stage.
"""

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.heads import chunked_tied_softmax_xent
from deepspeed_tpu_torch.ops.transformer.kernels.attention import (
    flash_attention)
from deepspeed_tpu_torch.ops.transformer.ring_attention import (
    get_sp_attention)
from deepspeed_tpu_torch.parallel import sequence_parallel
from deepspeed_tpu_torch.parallel.tensor_parallel import (apply_rules,
                                                          copy_to_model,
                                                          reduce_from_model)
from deepspeed_tpu_torch.runtime.utils import load_flax_tree


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # torch.utils.checkpoint around each block (flax's nn.remat).
    remat: bool = False
    # flash_attention (kernels K1/K2) or the dense einsum path.
    use_flash_attention: bool = True
    # Sequence parallelism: "seq" makes the model sequence-shardable (module
    # docstring); "ring" or "ulysses" picks its attention.
    sequence_parallel_axis: Any = None
    sequence_parallel_mode: str = "ring"

    @classmethod
    def gpt2_small(cls, **kw):
        return cls(n_embd=768, n_layer=12, n_head=12, **kw)

    @classmethod
    def gpt2_medium(cls, **kw):
        return cls(n_embd=1024, n_layer=24, n_head=16, **kw)

    @classmethod
    def gpt2_large(cls, **kw):
        return cls(n_embd=1280, n_layer=36, n_head=20, **kw)

    @classmethod
    def gpt2_xl(cls, **kw):
        return cls(n_embd=1600, n_layer=48, n_head=25, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("n_positions", 128)
        kw.setdefault("dropout", 0.0)
        return cls(n_embd=64, n_layer=2, n_head=4, **kw)

    def num_params(self):
        wpe = self.n_positions * self.n_embd
        wte = self.vocab_size * self.n_embd
        per_block = 12 * self.n_embd * self.n_embd + 13 * self.n_embd
        return wte + wpe + self.n_layer * per_block + 2 * self.n_embd


def _param(*shape, device, fill=None):
    t = torch.empty(*shape, device=device) if fill is None else \
        torch.full(shape, fill, dtype=torch.float32, device=device)
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """flax ``nn.Dense`` layout: ``kernel [in, out]``, ``y = x @ kernel +
    bias``; fp32 parameters."""

    def __init__(self, n_in, n_out, device):
        super().__init__()
        self.kernel = _param(n_in, n_out, device=device)
        self.bias = _param(n_out, device=device, fill=0.0)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` parameters, fp32."""

    def __init__(self, n, device):
        super().__init__()
        self.scale = _param(n, device=device, fill=1.0)
        self.bias = _param(n, device=device, fill=0.0)


def dense(x, p):
    """``x @ kernel + bias`` in x's dtype, the weights cast to it (a no-op
    when they already are), as one GEMM with the bias in its epilogue."""
    y = torch.addmm(p.bias.to(x.dtype), x.reshape(-1, x.shape[-1]),
                    p.kernel.to(x.dtype))
    return y.view(*x.shape[:-1], y.shape[-1])


def layer_norm(x, p, eps):
    """LayerNorm with fp32 statistics and affine part, cast back to x's
    dtype (flax's LayerNorm with ``dtype=``)."""
    return F.layer_norm(x.float(), p.scale.shape, p.scale.float(),
                        p.bias.float(), eps).to(x.dtype)


def dropout(x, rate, generator):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept
    values by 1 / (1 - rate). ``generator`` None means no dropout."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        1.0 - rate, generator=generator).bool()
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _row_parallel(x, p, tp):
    """A row-parallel dense layer: the local product all-reduced over the
    model group, then the replicated bias."""
    y = torch.matmul(x, p.kernel.to(x.dtype))
    return reduce_from_model(y, tp) + p.bias.to(x.dtype)


def qkv_order(n_embd):
    """(rank, mp) -> the ``c_attn`` columns rank holds: its heads' columns
    of q, then of k, then of v."""
    def order(rank, mp):
        per = n_embd // mp
        return torch.cat([torch.arange(part * n_embd + rank * per,
                                       part * n_embd + (rank + 1) * per)
                          for part in range(3)])
    return order


class _Attention(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        C = cfg.n_embd
        self.n_head = cfg.n_head
        self.c_attn = Dense(C, 3 * C, device)
        self.c_proj = Dense(C, C, device)
        self.tp = None
        self.sp = None

    def tensor_parallel_leaves(self, mp):
        """The leaves the attention computes split over ``mp`` ranks (the
        tensor-parallel protocol, ``parallel/tensor_parallel.py``)."""
        if self.n_head % mp:
            raise ValueError(
                "tensor parallelism over {} ranks splits the attention by "
                "heads: n_head={} is not divisible by {}".format(
                    mp, self.n_head, mp))
        order = qkv_order(self.c_proj.kernel.shape[0])
        return {"c_attn.kernel": (1, order), "c_attn.bias": (0, order),
                "c_proj.kernel": (0, None)}

    def set_tensor_parallel(self, tp):
        self.tp = tp

    def forward(self, x, cfg, gen):
        B, T, _ = x.shape
        tp = self.tp
        nh = cfg.n_head // tp.size if tp is not None else cfg.n_head
        hd = cfg.n_embd // cfg.n_head
        C = nh * hd
        if tp is not None:
            x = copy_to_model(x, tp)
        q, k, v = dense(x, self.c_attn).split(C, dim=-1)
        q, k, v = (t.reshape(B, T, nh, hd).transpose(1, 2).contiguous()
                   for t in (q, k, v))
        if self.sp is not None:
            # This shard's queries against every shard's keys (the ring or
            # Ulysses); the probabilities' dropout on the context output.
            y = dropout(get_sp_attention(cfg.sequence_parallel_mode)(
                q, k, v, self.sp, causal=True), cfg.dropout, gen)
        elif cfg.use_flash_attention:
            # Attention-probability dropout moves to the context output:
            # flash never materialises the probabilities.
            y = dropout(flash_attention(q, k, v, causal=True), cfg.dropout,
                        gen)
        else:
            att = torch.matmul(q, k.transpose(-1, -2)) / torch.tensor(
                hd ** 0.5, dtype=x.dtype)
            causal = torch.ones(T, T, dtype=torch.bool,
                                device=x.device).tril()
            att = torch.where(causal, att, torch.finfo(x.dtype).min)
            att = torch.softmax(att.float(), dim=-1).to(x.dtype)
            y = torch.matmul(dropout(att, cfg.dropout, gen), v)
        y = y.transpose(1, 2).reshape(B, T, C)
        out = _row_parallel(y, self.c_proj, tp) if tp is not None else \
            dense(y, self.c_proj)
        return dropout(out, cfg.dropout, gen)


class _MLP(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        C = cfg.n_embd
        self.c_fc = Dense(C, 4 * C, device)
        self.c_proj = Dense(4 * C, C, device)
        self.tp = None

    def tensor_parallel_leaves(self, mp):
        return {"c_fc.kernel": (1, None), "c_fc.bias": (0, None),
                "c_proj.kernel": (0, None)}

    def set_tensor_parallel(self, tp):
        self.tp = tp

    def forward(self, x, cfg, gen):
        tp = self.tp
        if tp is not None:
            x = copy_to_model(x, tp)
        h = F.gelu(dense(x, self.c_fc), approximate="tanh")
        out = _row_parallel(h, self.c_proj, tp) if tp is not None else \
            dense(h, self.c_proj)
        return dropout(out, cfg.dropout, gen)


class Block(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, device)
        self.attn = _Attention(cfg, device)
        self.ln_2 = LayerNorm(cfg.n_embd, device)
        self.mlp = _MLP(cfg, device)

    def kernels(self):
        return (self.attn.c_attn.kernel, self.attn.c_proj.kernel,
                self.mlp.c_fc.kernel, self.mlp.c_proj.kernel)

    def forward(self, x, cfg, seed):
        """Pre-LN block. ``seed`` (an int, or None for no dropout) seeds
        this block's dropout generator, so a checkpointed block redraws the
        same masks when it is recomputed. It may also be the generator
        itself, seeded by the caller (a CUDA graph cannot seed one inside
        its capture)."""
        gen = seed if isinstance(seed, torch.Generator) else None
        if seed is not None and gen is None:
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed)
        eps = cfg.layer_norm_epsilon
        x = x + self.attn(layer_norm(x, self.ln_1, eps), cfg, gen)
        return x + self.mlp(layer_norm(x, self.ln_2, eps), cfg, gen)


class GPT2LMHeadModel(nn.Module):
    """GPT-2 causal LM under the flax names (module docstring).

    ``GPT2LMHeadModel(config, device=None, seed=0)`` fills the weights from
    a ``torch.Generator`` seeded with ``seed``: N(0, 0.02) for ``wte`` and
    every dense kernel, N(0, 0.01) for ``wpe``, zero biases, unit LayerNorm
    scales, all fp32 on ``device``. ``seed=None`` leaves the dense weights
    uninitialised (``params_from_jax`` fills them). ``device`` defaults to
    ``cuda`` and raises without a GPU unless ``device="cpu"`` is passed
    (``device.resolve_device``)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        self.wte = _param(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = _param(cfg.n_positions, cfg.n_embd, device=device)
        for i in range(cfg.n_layer):
            self.add_module("h_{}".format(i), Block(cfg, device))
        self.ln_f = LayerNorm(cfg.n_embd, device)
        self.sp = None
        if seed is not None:
            self._init_weights(seed)

    def set_sequence_parallel(self, sp):
        """Run token-sharded over ``sp`` (a ``SeqContext``), or serially
        with None (module docstring)."""
        if sp is not None and self.config.sequence_parallel_axis is None:
            raise ValueError("set_sequence_parallel needs "
                             "GPT2Config(sequence_parallel_axis='seq')")
        get_sp_attention(self.config.sequence_parallel_mode)  # its check
        self.sp = sp
        for blk in self.blocks():
            blk.attn.sp = sp

    def blocks(self):
        return [getattr(self, "h_{}".format(i))
                for i in range(self.config.n_layer)]

    @torch.no_grad()
    def _init_weights(self, seed):
        g = torch.Generator(device=self.wte.device)
        g.manual_seed(seed)
        for p, std in [(self.wte, 0.02), (self.wpe, 0.01)] + \
                [(blk_p, 0.02) for blk in self.blocks()
                 for blk_p in blk.kernels()]:
            p.normal_(0.0, std, generator=g)

    def forward(self, input_ids, labels=None, deterministic=True,
                generator=None):
        """``input_ids`` [B, T] -> fp32 logits [B, T, V], or with ``labels``
        the mean next-token loss (position t predicts ``labels[:, t+1]``,
        the chunked tied-decoder head). Dropout runs when ``deterministic``
        is False, its masks drawn from seeds taken from ``generator`` (a
        CPU ``torch.Generator``; the engine passes its own)."""
        cfg = self.config
        sp = self.sp
        B, T = input_ids.shape
        n, pos0 = (1, 0) if sp is None else (sp.size, sp.rank * T)
        if n * T > cfg.n_positions:
            raise ValueError("sequence length {} exceeds n_positions={}"
                             .format(n * T, cfg.n_positions))
        train = not deterministic and cfg.dropout > 0.0
        n_seeds = cfg.n_layer + 1
        seeds = torch.randint(0, 2 ** 62, (n_seeds,), generator=generator
                              ).tolist() if train else [None] * n_seeds
        ids = input_ids.to(self.wte.device, torch.int64)
        x = self.wte[ids].to(cfg.dtype) + \
            self.wpe[pos0:pos0 + T].to(cfg.dtype)[None]
        if train:
            g = torch.Generator(device=x.device)
            g.manual_seed(seeds[-1])
            x = dropout(x, cfg.dropout, g)
        for blk, seed in zip(self.blocks(), seeds):
            if cfg.remat:
                x = checkpoint(blk, x, cfg, seed, use_reentrant=False)
            else:
                x = blk(x, cfg, seed)
        x = layer_norm(x, self.ln_f, cfg.layer_norm_epsilon)
        if labels is None:
            return torch.matmul(x.float(), self.wte.float().t())
        labels = labels.to(ids.device, torch.int64)
        if sp is not None:
            return _sequence_parallel_xent(x, self.wte, labels, cfg, sp)
        return chunked_tied_softmax_xent(x[:, :-1], self.wte, labels[:, 1:],
                                         cfg.dtype)


def _sequence_parallel_xent(x, wte, labels, cfg, sp):
    """The next-token loss of token shards (JAX ``_sequence_parallel_xent``):
    a shard's last position predicts the next shard's first label, which
    one ring shift of a ``[B, 1]`` slice brings (the global last token,
    whose delivery wraps around, is ignored); the mean is the summed loss
    over the summed count of the line, so shards with fewer supervised
    tokens weigh less."""
    nxt = sequence_parallel.shift(labels[:, :1], sp, -1)
    if sp.rank == sp.size - 1:
        nxt = torch.full_like(nxt, -1)
    shifted = torch.cat([labels[:, 1:], nxt], dim=1)
    total, count = chunked_tied_softmax_xent(
        x, wte, shifted, cfg.dtype, ignore_index=-1, reduction="sum_count")
    both = sequence_parallel.psum(torch.stack(
        [total.float(), count.detach().float()]), sp)
    return both[0] / torch.clamp(both[1], min=1.0)


def params_from_jax(tree, config, device=None, tp=None):
    """The port's ``GPT2LMHeadModel`` from a flax GPT-2 parameter tree whose
    leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``).

    Names and layouts carry over unchanged (flax ``Dense`` kernels stay
    ``[in, out]``); every parameter is fp32 on ``device`` (default ``cuda``,
    as for ``GPT2LMHeadModel``). Raises KeyError for a missing or unexpected
    parameter and ValueError for a shape that disagrees. ``tp`` (a
    ``TPContext``): the model keeps this model rank's shards of the full
    tree and computes the split (``tensor_parallel.apply_rules``).

    Given the JAX ``PipelineEngine``'s ``layer_params`` list instead (one
    tree or None per layer of ``gpt2_pipeline``), returns the list as fp32
    numpy trees, each checked against its layer's names and shapes: the
    ``model_parameters`` of ``initialize`` with the port's
    ``gpt2_pipeline`` (tied or untied, as the list is)."""
    if isinstance(tree, (list, tuple)):
        return _layer_params_from_jax(list(tree), config)
    model = GPT2LMHeadModel(config, device=device, seed=None)
    load_flax_tree(model, tree)
    if tp is not None:
        apply_rules(model, tp)
    return model


def _layer_params_from_jax(layers, config):
    tied = layers[-1] is not None and "wte" in layers[-1]
    if len(layers) != config.n_layer + (3 if tied else 2):
        raise ValueError("{} layer trees for a GPT-2 pipeline of {} blocks"
                         .format(len(layers), config.n_layer))
    specs = gpt2_pipeline(config, num_stages=1, tied=tied).layer_specs
    out = []
    for spec, t in zip(specs, layers):
        if t is None:
            out.append(None)
            continue
        t = _numpy_tree(t)
        load_flax_tree(spec.build(device="cpu", seed=None), t)
        out.append(t)
    return out


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else
            np.asarray(v, dtype=np.float32) for k, v in tree.items()}


# ------------------------------------------------------- pipeline variant


def _init_block(blk, seed, device):
    if seed is None:
        return
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    with torch.no_grad():
        for p in blk.kernels():
            p.normal_(0.0, 0.02, generator=g)


def _train_gen(seed, device):
    if seed is None:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


class GPT2PipeEmbed(nn.Module):
    """Pipeline layer 0: token and position embedding (``wte``, ``wpe``),
    the embeddings' dropout while training (``seed`` given). A
    ``TiedLayerSpec`` reuses its ``wte`` as the LM head."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        self.wte = _param(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = _param(cfg.n_positions, cfg.n_embd, device=device)
        if seed is not None:
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            with torch.no_grad():
                self.wte.normal_(0.0, 0.02, generator=g)
                self.wpe.normal_(0.0, 0.01, generator=g)

    def forward(self, input_ids, seed=None):
        cfg = self.config
        T = input_ids.shape[1]
        ids = input_ids.to(self.wte.device, torch.int64)
        x = self.wte[ids].to(cfg.dtype) + self.wpe[:T].to(cfg.dtype)[None]
        return dropout(x, cfg.dropout, _train_gen(seed, x.device))


class GPT2PipeBlock(nn.Module):
    """One transformer block as a pipeline layer (``Block_0``, as flax
    names the block inside the JAX layer)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        device = resolve_device(device)
        self.Block_0 = Block(config, device)
        _init_block(self.Block_0, seed, device)

    def forward(self, x, seed=None):
        return self.Block_0(x, self.config, seed)


class GPT2PipeLN(nn.Module):
    """The final LayerNorm as a pipeline layer (``ln_f``)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = config
        self.ln_f = LayerNorm(config.n_embd, resolve_device(device))

    def forward(self, x):
        return layer_norm(x, self.ln_f, self.config.layer_norm_epsilon)


class GPT2PipeFinal(nn.Module):
    """The final LayerNorm and an untied LM head (``lm_head [V, C]``):
    returns (hidden, head) for ``gpt2_lm_loss``."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        cfg = self.config = config
        device = resolve_device(device)
        self.ln_f = LayerNorm(cfg.n_embd, device)
        self.lm_head = _param(cfg.vocab_size, cfg.n_embd, device=device)
        if seed is not None:
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            with torch.no_grad():
                self.lm_head.normal_(0.0, 0.02, generator=g)

    def forward(self, x):
        x = layer_norm(x, self.ln_f, self.config.layer_norm_epsilon)
        return x, self.lm_head


def _gpt2_tied_head(layer, x):
    """``TiedLayerSpec.forward_fn`` of the tied head: the final LayerNorm
    ran in the layer before; hand the embedding's ``wte`` to the loss."""
    return x, layer.wte


def gpt2_lm_loss(out, labels):
    """The pipeline's loss: the shifted chunked tied-decoder loss of the
    last stage's (hidden, head), or the shifted softmax cross-entropy of
    plain logits."""
    labels = labels.to(torch.int64)
    if isinstance(out, (tuple, list)):
        x, head = out
        return chunked_tied_softmax_xent(x[:, :-1], head,
                                         labels.to(x.device)[:, 1:], x.dtype)
    v = out.shape[-1]
    lg = out[:, :-1].reshape(-1, v).float()
    return F.cross_entropy(lg, labels.to(out.device)[:, 1:].reshape(-1))


def gpt2_pipeline(config=None, num_stages=2, tied=None, compiled=False,
                  partition_method="uniform", topology=None, **kw):
    """GPT-2 as a ``PipelineModule``: the embedding, ``n_layer`` blocks,
    then the final LayerNorm and the tied head (``tied``, the default)
    or the untied ``GPT2PipeFinal``; ``gpt2_lm_loss`` on the last stage,
    layers seeded by index. ``compiled=True`` (the compiled engine, whose
    stages share no layer) defaults to the untied head and refuses the
    tied one, as the JAX function does."""
    from deepspeed_tpu_torch.runtime.pipe.module import (LayerSpec,
                                                         PipelineModule,
                                                         TiedLayerSpec)
    cfg = config or GPT2Config(**kw)
    if tied is None:
        tied = not compiled
    if compiled and tied:
        raise ValueError("compiled GPT-2 pipeline requires tied=False")
    blocks = [LayerSpec(GPT2PipeBlock, cfg) for _ in range(cfg.n_layer)]
    if tied:
        layers = ([TiedLayerSpec("embed", GPT2PipeEmbed, cfg)] + blocks +
                  [LayerSpec(GPT2PipeLN, cfg),
                   TiedLayerSpec("embed", GPT2PipeEmbed, cfg,
                                 forward_fn=_gpt2_tied_head)])
    else:
        layers = ([LayerSpec(GPT2PipeEmbed, cfg)] + blocks +
                  [LayerSpec(GPT2PipeFinal, cfg)])
    return PipelineModule(layers=layers, num_stages=num_stages,
                          topology=topology, loss_fn=gpt2_lm_loss,
                          seed_layers=True, partition_method=partition_method,
                          compiled=compiled)


def gpt2_layer_params(tree, config):
    """The tied ``gpt2_pipeline``'s layer trees (its head reuses ``wte``)
    from a flat GPT-2 flax tree, to train the same weights as a
    pipeline."""
    embed = {"wte": tree["wte"], "wpe": tree["wpe"]}
    blocks = [{"Block_0": tree["h_{}".format(i)]}
              for i in range(config.n_layer)]
    return [embed] + blocks + [{"ln_f": tree["ln_f"]}, dict(embed)]
