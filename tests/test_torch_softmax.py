"""Port parity for the fused scale + mask + softmax op (kernel K9) on the
CPU.

The same numpy scores, masks and output cotangents go through the JAX
package's ``attn_softmax`` (its Pallas kernel in interpret mode, as its own
tests run it off the TPU) and the port's (the plain version its CUDA kernel
is held against on the card), in fp32. The forward agrees within 1e-6 and
the gradient within 1e-5 of each tensor's max-abs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer.kernels import softmax as tsm

# The JAX package's kernels/__init__.py exports a function named like the
# module's op, so the module is fetched by its full name.
jsm = importlib.import_module("deepspeed_tpu.ops.transformer.kernels.softmax")

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 1e-6, 1e-5


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _inputs(seed, B, H, t_q, t_k, mask_kind):
    """Scores of spread 3, cotangents, and the mask: None, padding (-1e9
    past a random length per batch row) or padding with batch row 1 masked
    at every key."""
    rng = np.random.RandomState(seed)
    s = (3.0 * rng.randn(B, H, t_q, t_k)).astype(np.float32)
    g = rng.randn(B, H, t_q, t_k).astype(np.float32)
    mask = None
    if mask_kind is not None:
        lens = rng.randint(1, t_k, size=B)
        mask = np.where(np.arange(t_k)[None] >= lens[:, None], -1e9,
                        0.0).astype(np.float32)
        if mask_kind == "full_row":
            mask[1] = -1e9
    return s, g, mask


# (case, T_q, T_k, causal, mask): causal rows are square, as the JAX op's
# causal cut assumes; a fully masked row gives the JAX op's (uniform)
# probabilities, not NaN.
CASES = [("plain", 32, 32, False, None),
         ("padding", 32, 32, False, "padding"),
         ("causal", 32, 32, True, None),
         ("causal_padding", 32, 32, True, "padding"),
         ("rect", 16, 40, False, None),
         ("rect_padding", 24, 40, False, "padding"),
         ("full_masked_row", 32, 32, False, "full_row"),
         ("full_masked_row_causal", 32, 32, True, "full_row")]


@pytest.mark.parametrize("scale", [0.125, 1.0])
@pytest.mark.parametrize("case,t_q,t_k,causal,mask_kind", CASES,
                         ids=[c[0] for c in CASES])
def test_attn_softmax_forward_and_grad_match_jax(case, t_q, t_k, causal,
                                                 mask_kind, scale):
    s, g, mask = _inputs(7, 2, 3, t_q, t_k, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    want, vjp = jax.vjp(lambda x: jsm.attn_softmax(x, jmask, scale, causal),
                        jnp.asarray(s))
    want_ds, = vjp(jnp.asarray(g))

    ts = torch.from_numpy(s.copy()).requires_grad_()
    tmask = None if mask is None else torch.from_numpy(mask)
    got = tsm.attn_softmax(ts, tmask, scale, causal)
    got.backward(torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == s.shape
    assert bool(torch.isfinite(got).all())
    _close(got, want, FWD_TOL)
    _close(ts.grad, want_ds, GRAD_TOL)
    if mask_kind == "full_row" and not causal:
        # every key of batch row 1 masked alike: uniform, as the JAX op gives
        _close(got[1], np.full((3, t_q, t_k), 1.0 / t_k), FWD_TOL)


@pytest.mark.parametrize("case,t_q,t_k,causal,mask_kind",
                         [CASES[1], CASES[3], CASES[5]],
                         ids=[CASES[i][0] for i in (1, 3, 5)])
def test_attn_softmax_grad_matches_autograd_through_reference(
        case, t_q, t_k, causal, mask_kind):
    """The Function's closed-form backward against autograd through the
    plain version."""
    s, g, mask = _inputs(11, 2, 2, t_q, t_k, mask_kind)
    tmask = torch.from_numpy(mask)
    a = torch.from_numpy(s.copy()).requires_grad_()
    b = torch.from_numpy(s.copy()).requires_grad_()
    tsm.attn_softmax(a, tmask, 0.125, causal).backward(torch.from_numpy(g))
    tsm.attn_softmax_reference(b, tmask, 0.125, causal).backward(
        torch.from_numpy(g))
    _close(a.grad, b.grad.numpy(), GRAD_TOL)


def test_attn_softmax_matches_the_jax_plain_version_in_bf16_storage():
    """The result takes the scores' dtype, as the JAX op's does: bf16 in,
    bf16 out, one rounding of the fp32 probabilities."""
    s, _, mask = _inputs(13, 2, 2, 16, 48, "padding")
    want = jsm.attn_softmax_reference(jnp.asarray(s).astype(jnp.bfloat16),
                                      jnp.asarray(mask), 0.125, False)
    got = tsm.attn_softmax(torch.from_numpy(s).to(torch.bfloat16),
                           torch.from_numpy(mask), 0.125, False)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 2.0 ** -8)


def test_attn_softmax_refuses_bad_operands():
    s = torch.zeros(2, 2, 4, 8)
    with pytest.raises(ValueError):
        tsm.attn_softmax(s[0])
    with pytest.raises(ValueError):
        tsm.attn_softmax(s, torch.zeros(2, 7))
    with pytest.raises(TypeError):
        tsm.attn_softmax(s, torch.zeros(2, 8, dtype=torch.int32))
