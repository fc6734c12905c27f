"""Fused scale + mask + softmax over attention scores: kernel K9.

Counterpart of ``deepspeed_tpu/ops/transformer/kernels/softmax.py``: a
standalone op (the JAX package's models use their own softmax, and the
port's attention runs through the flash kernels, which subsume it).

- ``attn_softmax_reference``: K9's plain version, ``softmax(scores * scale
  + mask)`` over the last axis in fp32, key > query set to ``NEG_INF``
  under ``causal``, in the scores' dtype.
- ``softmax_fwd``: the wrapper. On CPU tensors the plain version; on CUDA
  tensors the hand-written kernel of ``csrc/transformer_kernels.cu``, or an
  error for what it does not take. It never falls back.
- ``attn_softmax``: the ``torch.autograd.Function``. Its backward is the JAX
  package's plain ``ds = p * (g - rowsum(g * p)) * scale`` from the saved
  probabilities, in fp32 (the JAX package has no backward kernel either);
  the mask gets no gradient.
"""

import torch

from deepspeed_tpu_torch.ops.transformer.kernels.row_kernels import (
    DTYPE_CODE, charge, cuda_operands, hidden, launch, ptr)

NEG_INF = -1e30

# The longest row the kernel takes: the CTA path stages a row of fp32
# scores in 128 KB of shared memory (csrc/transformer_kernels.cu,
# kSoftmaxMaxKeys).
MAX_KEYS = 32768

# Kernel launches since the last reset.
launches = 0


def reset_launches():
    global launches
    launches = 0


def attn_softmax_reference(scores, mask=None, scale=1.0, causal=False):
    """K9's function: softmax over T_k of ``scores [B, H, T_q, T_k] *
    scale + mask [B, T_k]`` (additive, broadcast over H and T_q), key >
    query set to ``NEG_INF`` (top-left aligned) under ``causal``; fp32
    arithmetic, the result in the scores' dtype."""
    s = scores.float() * scale
    if mask is not None:
        s = s + mask[:, None, None, :].float()
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return (e / e.sum(dim=-1, keepdim=True)).to(scores.dtype)


def _check(scores, mask):
    if scores.dim() != 4:
        raise ValueError("attn_softmax: scores must be [B, H, T_q, T_k], "
                         "got {}".format(tuple(scores.shape)))
    B, _, _, t_k = scores.shape
    if mask is not None:
        if tuple(mask.shape) != (B, t_k):
            raise ValueError("attn_softmax: mask must be [B, T_k] = {}, got "
                             "{}".format((B, t_k), tuple(mask.shape)))
        if not mask.is_floating_point():
            raise TypeError("attn_softmax: mask must be additive (float), "
                            "got {}".format(mask.dtype))
        if mask.device != scores.device:
            raise ValueError("attn_softmax: tensors on {} and {}".format(
                scores.device, mask.device))


def softmax_fwd(scores, mask=None, scale=1.0, causal=False):
    """K9: ``attn_softmax_reference``'s result. On CPU tensors the plain
    version; on CUDA tensors the kernel (contiguous scores of float32,
    bfloat16 or float16, any T_k up to ``MAX_KEYS``), or an error."""
    _check(scores, mask)
    if not cuda_operands("attn_softmax", scores, whole_vectors=False):
        return attn_softmax_reference(scores, mask, scale, causal)
    B, H, t_q, t_k = scores.shape
    if t_k > MAX_KEYS:
        raise ValueError("attn_softmax: the kernel takes at most {} keys, "
                         "got {}".format(MAX_KEYS, t_k))
    with hidden():
        mask32 = None if mask is None else mask.float().contiguous()
        out = torch.empty_like(scores)
        launch("ds_attn_softmax_fwd", "attn_softmax", scores,
               scores.data_ptr(), ptr(mask32), out.data_ptr(), B, H, t_q,
               t_k, DTYPE_CODE[scores.dtype], float(scale), int(bool(causal)))
    global launches
    launches += 1
    charge(attn_softmax_reference, scores, mask, scale, causal)
    return out


class _AttnSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, mask, scale, causal):
        p = softmax_fwd(scores, mask, scale, causal)
        ctx.save_for_backward(p)
        ctx.scale = scale
        return p

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        pf, gf = p.float(), g.float()
        ds = pf * (gf - (gf * pf).sum(dim=-1, keepdim=True)) * ctx.scale
        return ds.to(p.dtype), None, None, None


def attn_softmax(scores, mask=None, scale=1.0, causal=False):
    """softmax(scores * scale + mask [+ causal]) over the last axis,
    differentiable in the scores.

    scores: ``[B, H, T_q, T_k]``; mask: additive ``[B, T_k]`` (any float
    dtype) or None; causal: key j kept for query i iff j <= i. K9 forward
    on CUDA tensors, its plain version on CPU tensors."""
    return _AttnSoftmax.apply(scores, mask, float(scale), bool(causal))
