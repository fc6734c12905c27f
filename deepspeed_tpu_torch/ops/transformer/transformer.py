"""DeepSpeedTransformerLayer: the fused BERT-style encoder layer.

Counterpart of ``deepspeed_tpu/ops/transformer/transformer.py``: the same
config surface and the same 12 parameters (names, ``[out, in]`` layout and
init), and the same composition::

  qkv GEMM -> flash attention (K1; K2 backward) -> attention dropout on the
  context (K10a; K10b backward) -> attn-out GEMM -> bias + dropout +
  residual (K10a) -> LayerNorm (K8) -> FF1 GEMM -> bias + GELU (K11) -> FF2
  GEMM -> bias + dropout + residual (K10a) -> LayerNorm (K8)

post-LN shown; pre-LN normalises before each sub-block instead. At dropout
0 (or deterministic) the post-LN epilogue is the one-kernel bias + residual
LayerNorm (K8). The GEMMs are plain products (``torch.addmm``/``mm``), as
the JAX package leaves them to XLA.

Parameters are fp32 and built with ``requires_grad=False`` (weights are
data, as in flax); each call casts them to ``config.dtype``. Dropout sites
use the seeds ``seed + i`` (i = 0: attention context, 1: attention output,
2: FF output), ``seed`` drawn per call from the caller's generator, or the
config's seed (42 when unset) without one, as in the JAX package.

The memory flags become ``torch.utils.checkpoint`` (non-reentrant) around
sub-computations whose parameters are passed in explicitly, so a recompute
uses the same (possibly cast) tensors and, the masks being functions of
their seeds, redraws the same masks:
``attn_dropout_checkpoint`` the attention and its dropout,
``gelu_checkpoint`` the feed-forward block with its epilogue, and
``normalize_invertible`` each LayerNorm epilogue (with its bias + dropout +
residual in post-LN), whose input is then recomputed rather than kept.
"""

import dataclasses
import json

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.ops.transformer.kernels.attention import (
    flash_attention, mha_reference)
from deepspeed_tpu_torch.ops.transformer.kernels.dropout import (
    dropout, fused_bias_dropout_residual)
from deepspeed_tpu_torch.ops.transformer.kernels.gelu import (
    bias_gelu_reference, fused_bias_gelu)
from deepspeed_tpu_torch.ops.transformer.kernels.layer_norm import (
    fused_bias_residual_layer_norm, fused_layer_norm, layer_norm_reference)

PARAM_NAMES = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw",
               "attn_nb", "inter_w", "inter_b", "output_w", "output_b",
               "norm_w", "norm_b")


@dataclasses.dataclass
class DeepSpeedTransformerConfig:
    """The reference's config surface. ``local_rank`` is accepted and
    unused; ``stochastic_mode`` runs an fp32 layer's training attention in
    bf16; ``dtype`` is the compute dtype."""

    batch_size: int = -1
    max_seq_length: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = -1
    hidden_dropout_ratio: float = -1
    num_hidden_layers: int = -1
    initializer_range: float = -1
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    huggingface: bool = False
    training: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.intermediate_size in (-1, None) and self.hidden_size > 0:
            self.intermediate_size = 4 * self.hidden_size

    @classmethod
    def from_dict(cls, json_object):
        """Known keys set, unknown keys ignored (the reference's rule)."""
        config = cls()
        for key, value in json_object.items():
            if hasattr(config, key):
                setattr(config, key, value)
        config.__post_init__()
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def _attend(q, k, v, mask, rate, seed, lowp_dtype):
    """Flash attention, then dropout on the context (flash never
    materialises the probabilities). ``lowp_dtype``: cast the context back
    to it (stochastic mode)."""
    ctx = flash_attention(q, k, v, mask=mask, causal=False)
    if lowp_dtype is not None:
        ctx = ctx.to(lowp_dtype)
    return dropout(ctx, rate, seed) if rate > 0 else ctx


def _post_ln(y, residual, bias, nw, nb, rate, seed, deterministic, eps):
    """LN(dropout(y + bias) + residual); at rate 0 the one-kernel bias +
    residual LayerNorm."""
    if rate > 0 and not deterministic:
        z = fused_bias_dropout_residual(y, bias, residual, rate, seed)
        return fused_layer_norm(z, nw, nb, eps)
    return fused_bias_residual_layer_norm(y, residual, nw, nb, bias=bias,
                                          eps=eps)


def _maybe_checkpoint(flag, fn, *args):
    if flag:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class DeepSpeedTransformerLayer(nn.Module):
    """The fused transformer layer (module docstring).

    ``DeepSpeedTransformerLayer(config, device=None, seed=0)`` fills the
    weights from a ``torch.Generator`` seeded with ``seed`` as the JAX
    package initialises them: N(0, std) for ``attn_qkvw`` and ``inter_w``,
    N(0, std / sqrt(2 L)) for ``attn_ow`` and ``output_w`` (with
    ``adjust_init_range``), zero biases, unit LayerNorm scales. ``seed=None``
    leaves the weights unset (a loader fills them). ``device`` defaults to
    ``cuda`` (``device.resolve_device``)."""

    def __init__(self, config, device=None, seed=0):
        super().__init__()
        self.config = cfg = config
        device = resolve_device(device)
        h, inter = cfg.hidden_size, cfg.intermediate_size
        shapes = {"attn_qkvw": (3 * h, h), "attn_qkvb": (3 * h,),
                  "attn_ow": (h, h), "attn_ob": (h,), "attn_nw": (h,),
                  "attn_nb": (h,), "inter_w": (inter, h), "inter_b": (inter,),
                  "output_w": (h, inter), "output_b": (h,), "norm_w": (h,),
                  "norm_b": (h,)}
        for name in PARAM_NAMES:
            fill = 1.0 if name in ("attn_nw", "norm_w") else 0.0
            self.register_parameter(name, nn.Parameter(torch.full(
                shapes[name], fill, dtype=torch.float32, device=device),
                requires_grad=False))
        if seed is not None:
            g = torch.Generator(device=device)
            g.manual_seed(seed)
            self.init_weights(g)

    @torch.no_grad()
    def init_weights(self, generator):
        """Draw the four weight matrices from ``generator`` (in the order
        qkv, attention output, FF1, FF2)."""
        cfg = self.config
        std = cfg.initializer_range if cfg.initializer_range > 0 else 0.02
        out_std = std
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_std = std / (2.0 * cfg.num_hidden_layers) ** 0.5
        for p, s in ((self.attn_qkvw, std), (self.attn_ow, out_std),
                     (self.inter_w, std), (self.output_w, out_std)):
            p.normal_(0.0, s, generator=generator)

    def _attention(self, x, mask, seed, deterministic):
        cfg = self.config
        B, T, H = x.shape
        nh = cfg.heads
        dt = cfg.dtype
        qkv = torch.addmm(self.attn_qkvb.to(dt), x.reshape(-1, H),
                          self.attn_qkvw.to(dt).t())
        q, k, v = (t.reshape(B, T, nh, H // nh).transpose(1, 2).contiguous()
                   for t in qkv.view(B, T, 3 * H).split(H, dim=-1))
        # stochastic_mode: an fp32 layer trains its attention in bf16 (the
        # JAX package's precision-for-speed reading of the reference's
        # faster, non-reproducible training kernels); eval is unaffected.
        lowp = cfg.stochastic_mode and dt == torch.float32 and \
            not deterministic
        if lowp:
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        rate = 0.0 if deterministic else cfg.attn_dropout_ratio
        ctx = _maybe_checkpoint(cfg.attn_dropout_checkpoint, _attend, q, k, v,
                                mask, max(rate, 0.0), seed,
                                dt if lowp else None)
        ctx = ctx.transpose(1, 2).reshape(B * T, H)
        return torch.mm(ctx, self.attn_ow.to(dt).t()).view(B, T, H)

    def forward(self, hidden_states, attention_mask=None, deterministic=None,
                generator=None):
        """hidden_states ``[B, T, H]``; attention_mask an additive ``[B, T]``
        padding mask (0 keep, large negative drop). ``deterministic``
        defaults to ``not config.training``; dropout seeds come from
        ``generator`` (a ``torch.Generator``) when one is given."""
        cfg = self.config
        if deterministic is None:
            deterministic = not cfg.training
        dt = cfg.dtype
        eps = cfg.layer_norm_eps
        x = hidden_states.to(dt)
        if not deterministic and generator is not None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        else:
            seed = cfg.seed if cfg.seed > 0 else 42
        seeds = [seed + i for i in range(3)]
        rate = max(cfg.hidden_dropout_ratio, 0.0)
        p = {name: getattr(self, name) for name in PARAM_NAMES}
        if cfg.pre_layer_norm:
            h = _maybe_checkpoint(cfg.normalize_invertible, fused_layer_norm,
                                  x, p["attn_nw"], p["attn_nb"], eps)
            attn_out = self._attention(h, attention_mask, seeds[0],
                                       deterministic)
            x = fused_bias_dropout_residual(attn_out, p["attn_ob"], x, rate,
                                            seeds[1], deterministic)
            h = _maybe_checkpoint(cfg.normalize_invertible, fused_layer_norm,
                                  x, p["norm_w"], p["norm_b"], eps)
        else:
            attn_out = self._attention(x, attention_mask, seeds[0],
                                       deterministic)
            x = _maybe_checkpoint(
                cfg.normalize_invertible, _post_ln, attn_out, x, p["attn_ob"],
                p["attn_nw"], p["attn_nb"], rate, seeds[1], deterministic, eps)
            h = x

        def ff(h_in, res, inter_w, inter_b, output_w, output_b, nw, nb):
            n = h_in.shape[0] * h_in.shape[1]
            ff1 = torch.mm(h_in.reshape(n, -1), inter_w.to(dt).t())
            act = fused_bias_gelu(ff1, inter_b)
            ff2 = torch.mm(act, output_w.to(dt).t()).view(res.shape)
            if cfg.pre_layer_norm:
                return fused_bias_dropout_residual(ff2, output_b, res, rate,
                                                   seeds[2], deterministic)
            return _maybe_checkpoint(cfg.normalize_invertible, _post_ln, ff2,
                                     res, output_b, nw, nb, rate, seeds[2],
                                     deterministic, eps)

        return _maybe_checkpoint(cfg.gelu_checkpoint, ff, h, x, p["inter_w"],
                                 p["inter_b"], p["output_w"], p["output_b"],
                                 p["norm_w"], p["norm_b"])


def transformer_layer_reference(params, x, attention_mask, config):
    """The layer in plain torch, without dropout: a dict of the 12
    parameters, x ``[B, T, H]``, an additive ``[B, T]`` mask or None."""
    cfg = config
    dt = cfg.dtype
    B, T, H = x.shape
    nh = cfg.heads
    p = {k: v.to(dt) for k, v in params.items()}
    x = x.to(dt)
    eps = cfg.layer_norm_eps

    def attention(h):
        qkv = h @ p["attn_qkvw"].t() + p["attn_qkvb"]
        q, k, v = (t.reshape(B, T, nh, H // nh).transpose(1, 2)
                   for t in qkv.split(H, dim=-1))
        ctx = mha_reference(q, k, v, mask=attention_mask)
        return ctx.transpose(1, 2).reshape(B, T, H) @ p["attn_ow"].t()

    if cfg.pre_layer_norm:
        h = layer_norm_reference(x, p["attn_nw"], p["attn_nb"], eps)
        x = x + attention(h) + p["attn_ob"]
        h = layer_norm_reference(x, p["norm_w"], p["norm_b"], eps)
        ff = bias_gelu_reference(h @ p["inter_w"].t(), p["inter_b"])
        return x + ff @ p["output_w"].t() + p["output_b"]
    x = layer_norm_reference(attention(x) + p["attn_ob"] + x, p["attn_nw"],
                             p["attn_nb"], eps)
    ff = bias_gelu_reference(x @ p["inter_w"].t(), p["inter_b"])
    return layer_norm_reference(ff @ p["output_w"].t() + p["output_b"] + x,
                                p["norm_w"], p["norm_b"], eps)
