"""SparseSelfAttention: layout-driven sparse attention.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
``[B, H, T, D]`` q/k/v plus an optional rpe, key-padding mask and 2D
attention mask with 'add'/'mul' combine modes, steered by a
``SparsityConfig``. The rpe and the attention mask fold into one score bias
for ``kernels.block_sparse_attention`` (kernels K7a/K7b on the card); a row
with no visible key gives zeros.
"""

import weakref

import torch
from torch import nn

from deepspeed_tpu_torch.ops.sparse_attention.kernels import (
    NEG_INF, block_sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    SparsityConfig)


def sparse_self_attention(query, key, value, sparsity_config, rpe=None,
                          key_padding_mask=None, attn_mask=None,
                          key_padding_mask_mode="add", attn_mask_mode="mul",
                          causal=None):
    """Functional sparse self attention.

    query/key/value: ``[B, H, T, D]`` (self-attention: identical shapes).
    rpe: optional relative-position score bias, ``[T, T]``, ``[H, T, T]`` or
    ``[B, H, T, T]``. key_padding_mask: optional ``[B, T]``, combined per
    key_padding_mask_mode. attn_mask: optional ``[T, T]``, combined per
    attn_mask_mode. causal: elementwise causal masking; by default on iff
    the sparsity config is unidirectional. The scale is ``D ** -0.5``.
    """
    if query.shape != key.shape or key.shape != value.shape:
        raise NotImplementedError("only self-attention is supported for now")
    b, h, t, d = query.shape
    layout = _layout_for(sparsity_config, t)
    if causal is None:
        causal = getattr(sparsity_config, "attention", None) == \
            "unidirectional"

    bias = None
    bias_mode = "add"
    if rpe is not None:
        bias = _broadcast_bias(torch.as_tensor(rpe, device=query.device),
                               b, h, t)
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=query.device)
        if am.dim() != 2:
            raise NotImplementedError(
                "currently only 2D attn_mask is supported")
        am = _broadcast_bias(am, b, h, t)
        if bias is None:
            bias = am
            bias_mode = attn_mask_mode
        elif attn_mask_mode == "mul":
            # rpe is additive; a mul-mask folds in by sending masked scores
            # far negative instead (the same result after the softmax).
            bias = torch.where(am != 0, bias, NEG_INF)
        else:
            bias = bias + am

    return block_sparse_attention(
        query, key, value, layout, sparsity_config.block,
        scale=float(d) ** -0.5, causal=causal,
        key_padding_mask=key_padding_mask,
        key_padding_mask_mode=key_padding_mask_mode,
        attn_bias=bias, attn_bias_mode=bias_mode)


# Keyed by a weak reference to the config object, so a collected config can
# never alias a new one's slot (id() reuse), and entries die with their
# config.
_LAYOUT_CACHE = weakref.WeakKeyDictionary()


def _layout_for(config, seq_len):
    per_config = _LAYOUT_CACHE.setdefault(config, {})
    if seq_len not in per_config:
        per_config[seq_len] = config.make_layout(seq_len)
    return per_config[seq_len]


def _broadcast_bias(x, b, h, t):
    if x.dim() == 2:
        x = x[None, None]
    elif x.dim() == 3:
        x = x[None]
    return x.expand(b, h, t, t)


class SparseSelfAttention(nn.Module):
    """Module form of ``sparse_self_attention``; it has no parameters.
    ``max_seq_length`` is accepted for the reference's signature: layouts
    are built per sequence length as they are met."""

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048):
        super().__init__()
        self.sparsity_config = (sparsity_config if sparsity_config is not None
                                else SparsityConfig(num_heads=4))
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length

    def forward(self, query, key, value, rpe=None, key_padding_mask=None,
                attn_mask=None):
        return sparse_self_attention(
            query, key, value, self.sparsity_config, rpe=rpe,
            key_padding_mask=key_padding_mask, attn_mask=attn_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask_mode=self.attn_mask_mode)
