"""Fused bias + GELU (tanh approximation): kernel K11.

Counterpart of ``deepspeed_tpu/ops/transformer/kernels/gelu.py``.

- ``bias_gelu_reference``: K11's plain version, ``0.5 z (1 + tanh(sqrt(2 /
  pi) (z + 0.044715 z^3)))`` with ``z = x + bias`` in fp32, cast to x's
  dtype.
- ``bias_gelu_fwd``: the wrapper. On CPU tensors the plain version; on CUDA
  tensors the hand-written kernel of ``csrc/transformer_kernels.cu``, or an
  error. It never falls back.
- ``fused_bias_gelu``: the ``torch.autograd.Function`` the layer calls. Its
  backward recomputes the derivative from the saved pre-activation in plain
  torch, as the JAX package does with jnp.
"""

import torch

from deepspeed_tpu_torch.ops.transformer.kernels.row_kernels import (
    DTYPE_CODE, charge, cuda_operands, fp32_vector, hidden, launch)

_SQRT_2_OVER_PI = 0.7978845608028654

# Kernel launches since the last reset.
launches = 0


def reset_launches():
    global launches
    launches = 0


def _gelu_f32(z):
    return 0.5 * z * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (z + 0.044715 * (z * z * z))))


def _d_gelu_f32(z):
    t = torch.tanh(_SQRT_2_OVER_PI * (z + 0.044715 * (z * z * z)))
    dt = (1.0 - t * t) * _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * z * z)
    return 0.5 * (1.0 + t) + 0.5 * z * dt


def bias_gelu_reference(x, bias):
    """K11's function: gelu_tanh(x + bias) in fp32, in x's dtype."""
    return _gelu_f32(x.float() + bias.float()).to(x.dtype)


def bias_gelu_fwd(x, bias):
    """K11. On CPU tensors the plain version; on CUDA tensors the kernel,
    or an error for what it does not take."""
    if not cuda_operands("bias_gelu", x, vectors=(bias,)):
        return bias_gelu_reference(x, bias)
    with hidden():
        out = torch.empty_like(x)
        bias32 = fp32_vector(bias)
        launch("ds_bias_gelu_fwd", "bias_gelu", x, x.data_ptr(),
               bias32.data_ptr(), out.data_ptr(), x.numel(),
               x.shape[-1], DTYPE_CODE[x.dtype])
    global launches
    launches += 1
    charge(bias_gelu_reference, x, bias)
    return out


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias):
        ctx.save_for_backward(x, bias)
        return bias_gelu_fwd(x, bias)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dz = g.float() * _d_gelu_f32(x.float() + bias.float())
        dbias = dz.reshape(-1, x.shape[-1]).sum(dim=0).to(bias.dtype)
        return dz.to(x.dtype), dbias


def fused_bias_gelu(x, bias):
    """gelu(x + bias), tanh approximation, differentiable in x and bias."""
    return _BiasGelu.apply(x, bias)
