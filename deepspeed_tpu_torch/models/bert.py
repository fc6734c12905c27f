"""BERT in PyTorch: the encoder on the fused DeepSpeedTransformerLayer and
the MLM + NSP pretraining heads.

Counterpart of ``deepspeed_tpu/models/bert.py``. Parameters keep the flax
names and layouts, so ``params_from_jax`` and the checkpoints carry over
unchanged: ``bert.embeddings.{word,position,token_type}_embeddings`` and
``LayerNorm``, ``bert.layer_{i}`` (the fused layer's 12 tensors, or the
plain layer's ``query/key/value/attn_out/intermediate/output`` dense layers
and two LayerNorms), ``bert.pooler``, ``transform``,
``transform_LayerNorm``, ``mlm_bias`` and ``seq_relationship``. A dense
layer keeps flax's ``kernel [in, out]``; the fused layer keeps the
reference's ``[out, in]``.

Precision, as in flax: parameters are fp32; the encoder computes in
``config.dtype``; the MLM transform's LayerNorm and the NSP head compute in
fp32; the tied decoder's GEMMs run in ``config.dtype`` with fp32 results
(``models.heads``).

Dropout: every site runs kernels K10a/K10b (``kernels.dropout``): the
fused layers' sites, and the embeddings' and the plain layer's, where the
JAX package uses flax's ``nn.Dropout``. The mask is a function of the seed,
so a run on the card and one on the CPU draw the same masks. Every seed
comes from the caller's ``torch.Generator``.

Sparse BERT: with ``sparse_attention_config`` (and ``use_fused_layer=False``)
the plain layer's attention is ``sparse_self_attention`` (kernels K7a/K7b on
the card) with the padding mask as an additive key-padding mask; the
probabilities never exist, so the attention dropout moves to the context
output, as in the JAX package.

Sequence parallelism (``sequence_parallel_axis="seq"``, the plain layer
only; the fused layer and sparse attention refuse it, as in JAX): with a
seq line set (``set_sequence_parallel``) each rank holds T/N tokens, the
positions start at ``rank * T/N``, the plain layer's attention is the ring
(or Ulysses) over K1/K2 with the padding mask beside its block (the
probabilities' dropout on the context), [CLS] (global token 0, on shard 0)
reaches every shard's pooler by a ``psum``, the MLM mean is the line's
summed loss over its summed count and the NSP loss is ``psum(nsp / N)``.
"""

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.gpt2 import Dense, LayerNorm, dense, layer_norm
from deepspeed_tpu_torch.models.heads import chunked_tied_softmax_xent
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention)
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)
from deepspeed_tpu_torch.ops.transformer.kernels.dropout import dropout
from deepspeed_tpu_torch.ops.transformer.ring_attention import (
    get_sp_attention)
from deepspeed_tpu_torch.parallel import sequence_parallel
from deepspeed_tpu_torch.runtime.utils import load_flax_tree


@dataclasses.dataclass
class BertConfig:
    """The JAX package's (HF-compatible) BERT config."""
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    dtype: torch.dtype = torch.bfloat16
    pre_layer_norm: bool = False
    use_fused_layer: bool = True
    # Only None is ported for sequence parallelism (forward raises otherwise).
    sequence_parallel_axis: Any = None
    sequence_parallel_mode: str = "ring"
    sparse_attention_config: Any = None

    @classmethod
    def bert_base(cls, **kw):
        return cls(**kw)

    @classmethod
    def bert_large(cls, **kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_hidden_layers", 24)
        kw.setdefault("num_attention_heads", 16)
        kw.setdefault("intermediate_size", 4096)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 1024)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position_embeddings", 128)
        return cls(**kw)

    def num_params(self):
        h, inter = self.hidden_size, self.intermediate_size
        emb = (self.vocab_size + self.max_position_embeddings +
               self.type_vocab_size) * h + 2 * h
        per_layer = 4 * h * h + 2 * h * inter + 9 * h + inter
        pooler = h * h + h
        return emb + self.num_hidden_layers * per_layer + pooler

    def ds_layer_config(self):
        """The fused layers' config (one object, shared by every layer)."""
        return DeepSpeedTransformerConfig(
            batch_size=-1, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_attention_heads,
            attn_dropout_ratio=self.attention_probs_dropout_prob,
            hidden_dropout_ratio=self.hidden_dropout_prob,
            num_hidden_layers=self.num_hidden_layers,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layer_norm_eps,
            pre_layer_norm=self.pre_layer_norm, dtype=self.dtype)


def _table(rows, cols, device):
    return nn.Parameter(torch.zeros(rows, cols, device=device),
                        requires_grad=False)


def _seed(generator):
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


class BertEmbeddings(nn.Module):
    def __init__(self, config, device):
        super().__init__()
        self.config = cfg = config
        h = cfg.hidden_size
        self.word_embeddings = _table(cfg.vocab_size, h, device)
        self.position_embeddings = _table(cfg.max_position_embeddings, h,
                                          device)
        self.token_type_embeddings = _table(cfg.type_vocab_size, h, device)
        self.LayerNorm = LayerNorm(h, device)
        self.sp = None

    def forward(self, input_ids, token_type_ids=None, seed=None):
        """(embeddings in ``config.dtype``, the word table for the tied
        decoder); ``seed`` None means no dropout."""
        cfg = self.config
        T = input_ids.shape[1]
        n, pos0 = (1, 0) if self.sp is None else \
            (self.sp.size, self.sp.rank * T)
        if n * T > cfg.max_position_embeddings:
            raise ValueError("sequence length {} exceeds "
                             "max_position_embeddings={}".format(
                                 n * T, cfg.max_position_embeddings))
        wte = self.word_embeddings
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = wte[input_ids] + self.position_embeddings[pos0:pos0 + T][None] + \
            self.token_type_embeddings[token_type_ids]
        x = layer_norm(x, self.LayerNorm, cfg.layer_norm_eps)
        x = dropout(x, cfg.hidden_dropout_prob, seed, seed is None)
        return x.to(cfg.dtype), wte


class PlainBertLayer(nn.Module):
    """The stock post-LN BERT layer in plain torch (erf GELU, dense
    attention, or block-sparse with ``sparse_attention_config``): the
    ``use_fused_layer=False`` opt-out. ``attention_module`` is the layer's
    attention choice: None (dense, or the ring under sequence parallelism)
    or a ``SparseSelfAttention`` (``module_inject.replace_attn_with_sparse``
    swaps it in place)."""

    def __init__(self, config, device):
        super().__init__()
        self.config = cfg = config
        h, inter = cfg.hidden_size, cfg.intermediate_size
        for name in ("query", "key", "value", "attn_out"):
            self.add_module(name, Dense(h, h, device))
        self.attn_LayerNorm = LayerNorm(h, device)
        self.intermediate = Dense(h, inter, device)
        self.output = Dense(inter, h, device)
        self.out_LayerNorm = LayerNorm(h, device)
        self.attention_module = None
        if cfg.sparse_attention_config is not None:
            self.attention_module = SparseSelfAttention(
                cfg.sparse_attention_config)
        self.sp = None

    def forward(self, x, add_mask=None, deterministic=True, generator=None):
        cfg = self.config
        dt = cfg.dtype
        B, T, H = x.shape
        nh = cfg.num_attention_heads
        hd = H // nh
        seed = None if deterministic else _seed(generator)
        seeds = [None] * 3 if seed is None else [seed + i for i in range(3)]

        def heads(z):
            return z.reshape(B, T, nh, hd).transpose(1, 2)

        q, k, v = (heads(dense(x, getattr(self, n)))
                   for n in ("query", "key", "value"))
        if self.attention_module is not None:
            ctx = self.attention_module(q, k, v, key_padding_mask=add_mask)
            ctx = dropout(ctx, cfg.attention_probs_dropout_prob, seeds[0],
                          deterministic)
        elif self.sp is not None:
            ctx = get_sp_attention(cfg.sequence_parallel_mode)(
                q.contiguous(), k.contiguous(), v.contiguous(), self.sp,
                mask=add_mask)
            ctx = dropout(ctx, cfg.attention_probs_dropout_prob, seeds[0],
                          deterministic)
        else:
            s = torch.matmul(q, k.transpose(-1, -2)) / float(hd) ** 0.5
            if add_mask is not None:
                s = s + add_mask[:, None, None, :].to(s.dtype)
            p = torch.softmax(s.float(), dim=-1).to(dt)
            p = dropout(p, cfg.attention_probs_dropout_prob, seeds[0],
                        deterministic)
            ctx = torch.matmul(p, v)
        ctx = ctx.transpose(1, 2).reshape(B, T, H)
        a = dropout(dense(ctx, self.attn_out), cfg.hidden_dropout_prob,
                    seeds[1], deterministic)
        eps = cfg.layer_norm_eps
        x = layer_norm((x + a).float(), self.attn_LayerNorm, eps).to(dt)
        f = F.gelu(dense(x, self.intermediate))
        f = dropout(dense(f, self.output), cfg.hidden_dropout_prob,
                    seeds[2], deterministic)
        return layer_norm((x + f).float(), self.out_LayerNorm, eps).to(dt)


class BertModel(nn.Module):
    """Embeddings -> encoder stack -> pooled [CLS].

    ``BertModel(config, device=None, seed=0)`` fills the weights from a
    ``torch.Generator`` seeded with ``seed`` (``init_weights``); ``seed=None``
    leaves them for the caller. ``device`` defaults to ``cuda``
    (``device.resolve_device``)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        self.embeddings = BertEmbeddings(cfg, device)
        self.layer_config = cfg.ds_layer_config()
        for i in range(cfg.num_hidden_layers):
            layer = DeepSpeedTransformerLayer(self.layer_config, device,
                                              seed=None) \
                if cfg.use_fused_layer else PlainBertLayer(cfg, device)
            self.add_module("layer_{}".format(i), layer)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size, device)
        self.sp = None
        if seed is not None:
            self.init_weights(torch.Generator(device=device).manual_seed(seed))

    def set_sequence_parallel(self, sp):
        """Run token-sharded over ``sp`` (a ``SeqContext``), or serially
        with None (module docstring)."""
        if sp is not None and self.config.sequence_parallel_axis is None:
            raise ValueError("set_sequence_parallel needs "
                             "BertConfig(sequence_parallel_axis='seq')")
        self.sp = self.embeddings.sp = sp
        for layer in self.layers():
            if isinstance(layer, PlainBertLayer):
                layer.sp = sp

    def layers(self):
        return [getattr(self, "layer_{}".format(i))
                for i in range(self.config.num_hidden_layers)]

    @torch.no_grad()
    def init_weights(self, generator):
        """N(0, ``initializer_range``) for the embedding tables and every
        dense kernel, the fused layers as ``DeepSpeedTransformerLayer``
        initialises them; biases stay 0 and LayerNorm scales 1."""
        std = self.config.initializer_range
        emb = self.embeddings
        for t in (emb.word_embeddings, emb.position_embeddings,
                  emb.token_type_embeddings):
            t.normal_(0.0, std, generator=generator)
        dense_layers = []
        for layer in self.layers():
            if isinstance(layer, DeepSpeedTransformerLayer):
                layer.init_weights(generator)
            else:
                dense_layers += [layer.query, layer.key, layer.value,
                                 layer.attn_out, layer.intermediate,
                                 layer.output]
        for d in dense_layers + [self.pooler]:
            d.kernel.normal_(0.0, std, generator=generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic=True, generator=None):
        """(sequence output ``[B, T, H]``, pooled ``[B, H]``, the word
        table). ``attention_mask``: 1 keep / 0 pad, ``[B, T]``."""
        cfg = self.config
        sp = cfg.sequence_parallel_axis
        sparse = cfg.sparse_attention_config is not None
        if sp is not None and cfg.use_fused_layer:
            raise ValueError(
                "sequence_parallel BERT requires use_fused_layer=False "
                "(the plain encoder path carries the ring attention)")
        if sparse and cfg.use_fused_layer:
            raise ValueError(
                "sparse_attention_config requires use_fused_layer=False "
                "(the plain encoder path carries the block-sparse kernel)")
        if sparse and sp is not None:
            raise ValueError(
                "sparse attention x sequence parallelism is not supported "
                "(the block-sparse layout is over the full sequence)")
        if not deterministic and generator is None:
            generator = torch.default_generator
        x, wte = self.embeddings(
            input_ids, token_type_ids,
            seed=None if deterministic else _seed(generator))
        add_mask = None
        if attention_mask is not None:
            # 1/0 mask -> the kernels' additive convention (0 keep, -1e9
            # drop), [B, T] fp32.
            add_mask = (1.0 - attention_mask.float()) * -1e9
        gen = None if deterministic else generator
        for layer in self.layers():
            if cfg.use_fused_layer:
                x = layer(x, attention_mask=add_mask,
                          deterministic=deterministic, generator=gen)
            else:
                x = layer(x, add_mask, deterministic=deterministic,
                          generator=gen)
        cls = x[:, 0]
        if self.sp is not None:
            # [CLS] is global token 0, on shard 0: every shard's pooler
            # takes it from there.
            cls = sequence_parallel.psum(
                cls.float() * float(self.sp.rank == 0), self.sp).to(x.dtype)
        pooled = torch.tanh(dense(cls, self.pooler))
        return x, pooled, wte


class BertForPreTraining(nn.Module):
    """MLM + NSP pretraining heads. With labels the forward returns the
    summed loss (the DeepSpeed convention: the model's output is the loss),
    else (prediction logits ``[B, T, V]`` fp32, NSP logits ``[B, 2]``).

    ``BertForPreTraining(config, device=None, seed=0)`` fills the weights
    from a ``torch.Generator`` seeded with ``seed``: the encoder as
    ``BertModel.init_weights`` does, then N(0, ``initializer_range``) for
    the two head kernels; zero biases, unit LayerNorm scales, all fp32 on
    ``device`` (default ``cuda``, ``device.resolve_device``). ``seed=None``
    leaves them for a loader (``params_from_jax``)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        h = cfg.hidden_size
        self.bert = BertModel(cfg, device, seed=None)
        self.transform = Dense(h, h, device)
        self.transform_LayerNorm = LayerNorm(h, device)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size,
                                                 device=device),
                                     requires_grad=False)
        self.seq_relationship = Dense(h, 2, device)
        if seed is not None:
            g = torch.Generator(device=device).manual_seed(seed)
            with torch.no_grad():
                self.bert.init_weights(g)
                for d in (self.transform, self.seq_relationship):
                    d.kernel.normal_(0.0, cfg.initializer_range, generator=g)

    def set_sequence_parallel(self, sp):
        """The encoder's ``set_sequence_parallel``."""
        self.bert.set_sequence_parallel(sp)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                masked_lm_labels=None, next_sentence_label=None,
                deterministic=True, generator=None):
        """Labels: ``masked_lm_labels`` ``[B, T]`` (-1 where not predicted),
        ``next_sentence_label`` ``[B]``. Dropout runs when ``deterministic``
        is False, its seeds drawn from ``generator`` (the engine passes its
        own)."""
        cfg = self.config
        seq_out, pooled, wte = self.bert(
            input_ids, attention_mask, token_type_ids,
            deterministic=deterministic, generator=generator)
        h = F.gelu(dense(seq_out, self.transform))
        h = layer_norm(h.float(), self.transform_LayerNorm, cfg.layer_norm_eps)
        seq_relationship = dense(pooled.float(), self.seq_relationship)
        if masked_lm_labels is None and next_sentence_label is None:
            logits = torch.matmul(h, wte.float().t()) + self.mlm_bias.float()
            return logits, seq_relationship
        sp = self.bert.sp
        total = 0.0
        if masked_lm_labels is not None and sp is not None:
            # Shards hold different numbers of masked positions: the line's
            # summed loss over its summed count.
            mlm, count = chunked_tied_softmax_xent(
                h, wte, masked_lm_labels, cfg.dtype, bias=self.mlm_bias,
                ignore_index=-1, reduction="sum_count")
            both = sequence_parallel.psum(torch.stack(
                [mlm.float(), count.detach().float()]), sp)
            total = total + both[0] / torch.clamp(both[1], min=1.0)
        elif masked_lm_labels is not None:
            total = total + chunked_tied_softmax_xent(
                h, wte, masked_lm_labels, cfg.dtype, bias=self.mlm_bias,
                ignore_index=-1)
        if next_sentence_label is not None:
            logp = F.log_softmax(seq_relationship, dim=-1)
            nll = -logp.gather(-1, next_sentence_label.long()[:, None])[:, 0]
            nsp = nll.mean()
            if sp is not None:
                # Every shard computes the same NSP loss from the summed
                # [CLS]: psum(nsp / N) counts it once.
                nsp = sequence_parallel.psum((nsp / sp.size).reshape(1),
                                             sp)[0]
            total = total + nsp
        return total


def params_from_jax(tree, config, device=None):
    """The port's ``BertForPreTraining`` from a flax BERT pretraining
    parameter tree whose leaves are numpy arrays (``jax.tree_util.tree_map(
    np.asarray, params)``). Names and layouts carry over unchanged; every
    parameter is fp32 on ``device`` (default ``cuda``). Raises KeyError for
    a missing or unexpected parameter and ValueError for a shape that
    disagrees."""
    model = BertForPreTraining(config, device=device, seed=None)
    load_flax_tree(model, tree)
    return model
