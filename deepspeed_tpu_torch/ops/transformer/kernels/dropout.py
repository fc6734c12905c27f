"""Dropout with a counter-based mask: kernels K10a (forward) and K10b (the
mask replayed in the backward).

Counterpart of ``deepspeed_tpu/ops/transformer/kernels/dropout.py``. The
mask is a pure function of (seed, flat element index), so the backward
regenerates it instead of storing it, and a recomputation (activation
checkpointing) redraws the same mask.

The bits: Philox-4x32-10 (Salmon et al., SC 2011) under the key (seed low
32 bits, seed high 32 bits), of the counter (i // 4 as a 64-bit pair, 0, 0);
its four outputs are the bits of elements 4i' .. 4i'+3. An element is kept
when its bits >= ``rate * 2**32`` (the JAX package's threshold), and kept
values are scaled by ``1 / (1 - rate)`` (rounded to fp32). The same function
is written once in CUDA (``csrc/transformer_kernels.cu``) and once here in
torch integer arithmetic, so kernel and plain version draw the same mask bit
for bit, on any device. It cannot match JAX's threefry bits.

- ``dropout_reference`` / ``dropout_bwd_reference``: the plain versions of
  K10a (``((x [+ bias]) * keep) * scale [+ residual]`` in fp32, cast to x's
  dtype) and K10b (``(g * keep) * scale``).
- ``dropout_fwd`` / ``dropout_bwd``: the wrappers. On CPU tensors the plain
  versions; on CUDA tensors the kernels, or an error. They never fall back.
- ``dropout`` / ``fused_bias_dropout_residual``: the public functions, a
  ``torch.autograd.Function`` whose backward is K10b. At rate 0, or when
  deterministic, no kernel runs: the fp32 sum of the JAX package.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.transformer.kernels.row_kernels import (
    DTYPE_CODE, charge, cuda_operands, fp32_vector, hidden, launch, ptr)

# Kernel launches since the last reset.
launches = {"dropout_fwd": 0, "dropout_bwd": 0}

_M32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def reset_launches():
    for key in launches:
        launches[key] = 0


def _mulhilo(a, m):
    """(high, low) 32-bit words of ``a * m`` for an int64 tensor ``a`` of
    uint32 values and a uint32 constant ``m``, from 16-bit halves so that no
    partial product overflows int64."""
    a1, a0 = a >> 16, a & 0xFFFF
    m1, m0 = m >> 16, m & 0xFFFF
    mid = a1 * m0 + a0 * m1
    lo = a0 * m0 + ((mid & 0xFFFF) << 16)
    hi = a1 * m1 + (mid >> 16) + (lo >> 32)
    return hi & _M32, lo & _M32


def _key(seed):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def philox_bits(n, seed, device):
    """The 32 random bits of flat elements 0 .. n-1 under ``seed``, as an
    int64 tensor on ``device`` (the kernels' function)."""
    group = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = group & _M32, group >> 32
    c2 = c3 = torch.zeros_like(group)
    k0, k1 = _key(seed)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]


def threshold(rate):
    """Keep an element when its bits are at least this: ``rate * 2**32``."""
    return min(int(rate * 4294967296.0), 4294967295)


def keep_scale(rate):
    """``1 / (1 - rate)`` rounded to fp32, as the kernels take it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_mask(shape, rate, seed, device):
    """The keep mask (bool, ``shape``) that both kernels draw."""
    n = int(np.prod(shape))
    return (philox_bits(n, seed, device) >= threshold(rate)).reshape(shape)


def dropout_reference(x, rate, seed, bias=None, residual=None):
    """K10a's function: ``((x [+ bias]) * keep) * scale [+ residual]`` in
    fp32, cast to x's dtype."""
    z = x.float()
    if bias is not None:
        z = z + bias.float()
    keep = dropout_mask(x.shape, rate, seed, x.device).float()
    y = z * keep * keep_scale(rate)
    if residual is not None:
        y = y + residual.float()
    return y.to(x.dtype)


def dropout_bwd_reference(g, rate, seed):
    """K10b's function: ``(g * keep) * scale`` in fp32, cast to g's dtype,
    with the forward's mask."""
    keep = dropout_mask(g.shape, rate, seed, g.device).float()
    return (g.float() * keep * keep_scale(rate)).to(g.dtype)


def _check_rate(rate):
    if not 0.0 < rate < 1.0:
        raise ValueError("dropout: rate must be in (0, 1) for the kernels, "
                         "got {}".format(rate))


def dropout_fwd(x, bias, residual, rate, seed):
    """K10a. On CPU tensors the plain version; on CUDA tensors the kernel
    (residual of x's dtype and shape, bias of x's last dimension), or an
    error."""
    _check_rate(rate)
    if not cuda_operands("dropout", x, (residual,), (bias,)):
        return dropout_reference(x, rate, seed, bias, residual)
    with hidden():
        out = torch.empty_like(x)
        bias32 = fp32_vector(bias)
        k0, k1 = _key(seed)
        launch("ds_dropout_fwd", "dropout forward", x, x.data_ptr(),
               ptr(bias32), ptr(residual), out.data_ptr(), x.numel(),
               x.shape[-1], DTYPE_CODE[x.dtype], threshold(rate),
               keep_scale(rate), k0, k1)
    launches["dropout_fwd"] += 1
    charge(dropout_reference, x, rate, seed, bias, residual)
    return out


def dropout_bwd(g, rate, seed):
    """K10b. On CPU tensors the plain version; on CUDA tensors the kernel,
    or an error."""
    _check_rate(rate)
    if not cuda_operands("dropout backward", g):
        return dropout_bwd_reference(g, rate, seed)
    with hidden():
        dx = torch.empty_like(g)
        k0, k1 = _key(seed)
        launch("ds_dropout_bwd", "dropout backward", g, g.data_ptr(),
               dx.data_ptr(), g.numel(), DTYPE_CODE[g.dtype], threshold(rate),
               keep_scale(rate), k0, k1)
    launches["dropout_bwd"] += 1
    charge(dropout_bwd_reference, g, rate, seed)
    return dx


class _Dropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, residual, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.res_dtype = None if residual is None else residual.dtype
        return dropout_fwd(x, bias, residual, rate, seed)

    @staticmethod
    def backward(ctx, g):
        dx = dropout_bwd(g.contiguous(), ctx.rate, ctx.seed)
        dbias = None if ctx.bias_dtype is None else \
            dx.float().reshape(-1, dx.shape[-1]).sum(dim=0).to(ctx.bias_dtype)
        dres = None if ctx.res_dtype is None else g.to(ctx.res_dtype)
        return dx, dbias, dres, None, None


def dropout(x, rate, seed, deterministic=False):
    """Inverted dropout whose mask is a function of ``seed`` (an int)."""
    if deterministic or rate <= 0.0:
        return x
    return _Dropout.apply(x, None, None, float(rate), int(seed))


def fused_bias_dropout_residual(x, bias, residual, rate, seed,
                                deterministic=False):
    """``dropout(x + bias) + residual`` in one pass: the layer's post-GEMM
    epilogue. ``bias`` and ``residual`` may be None."""
    if deterministic or rate <= 0.0:
        y = x.float()
        if bias is not None:
            y = y + bias.float()
        if residual is not None:
            y = y + residual.float()
        return y.to(x.dtype)
    return _Dropout.apply(x, bias, residual, float(rate), int(seed))
