"""Fused (bias + residual +) LayerNorm: kernel K8.

Counterpart of ``deepspeed_tpu/ops/transformer/kernels/layer_norm.py``.

- ``ln_fwd_reference``: K8's plain version. LN over the last axis of x
  (+ bias) (+ residual), all in fp32: the mean, then the variance as the
  mean of squared deviations (two-pass), ``rstd = rsqrt(var + eps)``; the
  output in x's dtype, with mu and rstd ``[rows, 1]`` fp32 for the
  backward.
- ``ln_fwd``: the wrapper. On CPU tensors the plain version; on CUDA
  tensors the hand-written kernel of ``csrc/transformer_kernels.cu``, or an
  error for what it does not take. It never falls back.
- ``fused_layer_norm`` / ``fused_bias_residual_layer_norm``: the
  ``torch.autograd.Function`` the layer calls. Its backward is the JAX
  package's closed form from the saved mu and rstd, in plain torch (the JAX
  package has no backward kernel here either).
- ``layer_norm_reference``: the plain LayerNorm the layer reference uses.
"""

import torch

from deepspeed_tpu_torch.ops.transformer.kernels.row_kernels import (
    DTYPE_CODE, charge, cuda_operands, fp32_vector, launch, ptr)
from deepspeed_tpu_torch.ops.transformer.kernels.row_kernels import \
    hidden as hidden_ops

# Kernel launches since the last reset, by variant: "plain" (LN of x) and
# "bias_residual" (LN of x with a bias, a residual or both).
launches = {"plain": 0, "bias_residual": 0}

# The widest row the kernel holds in registers: 32 lanes x 8 vectors of 16
# bytes (csrc/transformer_kernels.cu, layer_norm_kernel).
MAX_ROW_BYTES = 32 * 8 * 16


def reset_launches():
    for key in launches:
        launches[key] = 0


def _ln_input(x, bias, residual):
    z = x.float()
    if bias is not None:
        z = z + bias.float()
    if residual is not None:
        z = z + residual.float()
    return z


def ln_fwd_reference(x, gamma, beta, bias=None, residual=None, eps=1e-12):
    """K8's function: (o in x's dtype and shape, mu ``[rows, 1]``, rstd
    ``[rows, 1]``), statistics in fp32."""
    hidden = x.shape[-1]
    z = _ln_input(x, bias, residual).reshape(-1, hidden)
    mu = z.mean(dim=-1, keepdim=True)
    xc = z - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = xc * rstd * gamma.float() + beta.float()
    return y.to(x.dtype).reshape(x.shape), mu, rstd


def ln_fwd(x, gamma, beta, bias=None, residual=None, eps=1e-12):
    """K8: ``ln_fwd_reference``'s result. On CPU tensors the plain version;
    on CUDA tensors the kernel (x and residual of one dtype, rows of at most
    ``MAX_ROW_BYTES``), or an error."""
    if not cuda_operands("layer_norm", x, (residual,), (gamma, beta, bias)):
        return ln_fwd_reference(x, gamma, beta, bias, residual, eps)
    hidden = x.shape[-1]
    if hidden * x.element_size() > MAX_ROW_BYTES:
        raise ValueError("layer_norm: the kernel takes rows of at most {} "
                         "bytes, got {} x {}".format(
                             MAX_ROW_BYTES, hidden, x.dtype))
    rows = x.numel() // hidden
    with hidden_ops():
        out = torch.empty_like(x)
        mu = torch.empty(rows, 1, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mu)
        g32, b32, bias32 = (fp32_vector(t) for t in (gamma, beta, bias))
        launch("ds_layer_norm_fwd", "layer_norm", x, x.data_ptr(),
               ptr(residual), ptr(bias32), g32.data_ptr(), b32.data_ptr(),
               out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), rows, hidden,
               DTYPE_CODE[x.dtype], float(eps))
    launches["plain" if bias is None and residual is None
             else "bias_residual"] += 1
    charge(ln_fwd_reference, x, gamma, beta, bias, residual, eps)
    return out, mu, rstd


class _FusedLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, bias, residual, eps):
        o, mu, rstd = ln_fwd(x, gamma, beta, bias, residual, eps)
        ctx.save_for_backward(x, gamma, bias, residual, mu, rstd)
        ctx.beta_dtype = beta.dtype
        return o

    @staticmethod
    def backward(ctx, g):
        x, gamma, bias, residual, mu, rstd = ctx.saved_tensors
        hidden = x.shape[-1]
        g2 = g.reshape(-1, hidden).float()
        xhat = (_ln_input(x, bias, residual).reshape(-1, hidden) - mu) * rstd
        gg = g2 * gamma.float()
        # dz = rstd * (gg - mean(gg) - xhat * mean(gg * xhat))
        m1 = gg.mean(dim=-1, keepdim=True)
        m2 = (gg * xhat).mean(dim=-1, keepdim=True)
        dz = rstd * (gg - m1 - xhat * m2)
        dx = dz.reshape(x.shape).to(x.dtype)
        dgamma = (g2 * xhat).sum(dim=0).to(gamma.dtype)
        dbeta = g2.sum(dim=0).to(ctx.beta_dtype)
        dbias = None if bias is None else dz.sum(dim=0).to(bias.dtype)
        dres = None if residual is None else dx.to(residual.dtype)
        return dx, dgamma, dbeta, dbias, dres, None


def fused_layer_norm(x, gamma, beta, eps=1e-12):
    """LayerNorm over the last axis, differentiable in x, gamma and beta."""
    return _FusedLN.apply(x, gamma, beta, None, None, float(eps))


def fused_bias_residual_layer_norm(x, residual, gamma, beta, bias=None,
                                   eps=1e-12):
    """LN(x + bias + residual) in one kernel: the post-LN epilogue of the
    fused layer when dropout is off."""
    return _FusedLN.apply(x, gamma, beta, bias, residual, float(eps))


def layer_norm_reference(x, gamma, beta, eps=1e-12):
    """Plain LayerNorm in fp32 (biased variance), cast to x's dtype."""
    z = x.float()
    mu = z.mean(dim=-1, keepdim=True)
    var = z.var(dim=-1, unbiased=False, keepdim=True)
    y = (z - mu) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)
