"""BertSparseSelfAttention: a BERT attention block on the sparse core.

Counterpart of
``deepspeed_tpu/ops/sparse_attention/bert_sparse_self_attention.py``: the
``query``/``key``/``value`` dense layers keep flax's names and ``kernel [in,
out]`` layout (``params_from_jax``-style trees load as they are), then
``SparseSelfAttention`` and the head merge.
"""

import torch
from torch import nn

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.models.gpt2 import Dense, dense
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    FixedSparsityConfig)


class BertSparseSelfAttention(nn.Module):
    """Q/K/V projections + ``SparseSelfAttention`` + head merge.

    ``config`` needs ``.hidden_size`` and ``.num_attention_heads`` (duck
    typed, as the reference). ``sparsity_config`` defaults to
    ``FixedSparsityConfig(num_heads)``. The weights are fp32 on ``device``
    (default ``cuda``), filled from a ``torch.Generator`` seeded with
    ``seed`` (kernels N(0, 1 / hidden_size), flax's lecun-normal scale;
    biases 0), or left for a loader with ``seed=None``. As flax's ``Dense``
    without a ``dtype``, the projections compute in the promoted type of the
    input and the fp32 weights."""

    def __init__(self, config, sparsity_config=None, device=None, seed=0):
        super().__init__()
        if config.hidden_size % config.num_attention_heads != 0:
            raise ValueError(
                "The hidden size (%d) is not a multiple of the number of "
                "attention heads (%d)" % (config.hidden_size,
                                          config.num_attention_heads))
        device = resolve_device(device)
        self.num_attention_heads = config.num_attention_heads
        self.attention_head_size = \
            config.hidden_size // config.num_attention_heads
        self.all_head_size = self.num_attention_heads * \
            self.attention_head_size
        for name in ("query", "key", "value"):
            self.add_module(name, Dense(config.hidden_size,
                                        self.all_head_size, device))
        self.sparse_self_attention = SparseSelfAttention(
            sparsity_config if sparsity_config is not None else
            FixedSparsityConfig(num_heads=config.num_attention_heads))
        if seed is not None:
            g = torch.Generator(device=device).manual_seed(seed)
            with torch.no_grad():
                for d in (self.query, self.key, self.value):
                    d.kernel.normal_(0.0, config.hidden_size ** -0.5,
                                     generator=g)

    def _transpose_for_scores(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_attention_heads,
                         self.attention_head_size).transpose(1, 2)

    def forward(self, hidden_states, attention_mask=None):
        x = hidden_states.to(torch.promote_types(hidden_states.dtype,
                                                 torch.float32))
        q, k, v = (self._transpose_for_scores(dense(x, getattr(self, n)))
                   for n in ("query", "key", "value"))
        ctx = self.sparse_self_attention(q, k, v,
                                         key_padding_mask=attention_mask)
        b, h, t, d = ctx.shape
        return ctx.transpose(1, 2).reshape(b, t, self.all_head_size)
