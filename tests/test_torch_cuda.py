"""Kernels on the card: K3 (flash decode) and K1/K2a/K2b (flash attention
for training) against their plain PyTorch versions, and the wrappers'
refusals on CUDA tensors.

Marked ``cuda``: they skip where there is no GPU. On a machine with one,
run ``python -m pytest tests/test_torch_cuda.py -m cuda``. This file
imports no JAX, so it runs where JAX is not installed.
"""

import pytest
import torch

from deepspeed_tpu_torch.ops.transformer.kernels import attention as at
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention as da

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, B, S, T, dtype, pos):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    q = torch.randn(B, 4, S, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(B, 4, T, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(B, 4, T, 64, device=cuda, generator=g).to(dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=cuda)


# (atol, rtol) per element, as in chip_smoke.py: |out - ref| <= atol +
# rtol * (|ref| + spread). fp32 differs only in summation order; bf16 by one
# output ulp (at most 2**-7 of |ref|) plus the reference's bf16
# probabilities (of order 2**-9 * spread).
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 0.0)),
                                       (torch.bfloat16, (2e-3, 2.0 ** -7))])
@pytest.mark.parametrize("S,pos", [(1, [0, 31, 32, 199]), (32, [0, 100])])
def test_kernel_matches_plain(cuda, dtype, tol, S, pos):
    q, k, v, p = _inputs(cuda, len(pos), S, 232, dtype, pos)
    before = da.launches
    out = da.flash_decode_attention(q, k, v, p)
    ref = da.decode_attention_reference(q, k, v, p)
    torch.cuda.synchronize()
    assert da.launches == before + 1
    atol, rtol = tol
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * (ref.float().abs() + _spread(q, k, v, p))
    assert bool((diff <= limit).all())


def _spread(q, k, v, pos):
    """sqrt(sum_t p_t^2 v_t^2) over each row's visible keys, fp32
    probabilities at the default scale."""
    S, T = q.shape[2], k.shape[2]
    q_pos = pos.long()[:, None] + torch.arange(S, device=q.device)
    mask = torch.arange(T, device=q.device)[None, None, :] <= q_pos[:, :, None]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / 8.0
    p = torch.softmax(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    return torch.matmul(p * p, v.float() ** 2).sqrt()


@pytest.mark.parametrize("bad", ["fp16", "head_dim", "rows", "pos_dtype",
                                 "strided"])
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda, bad):
    q, k, v, p = _inputs(cuda, 2, 1, 64, torch.float32, [0, 5])
    if bad == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32].contiguous(), v[..., :32]
        q, v = q.contiguous(), v.contiguous()
    elif bad == "rows":
        q = torch.zeros(2, 4, da.MAX_QUERY_ROWS + 1, 64, device=cuda)
    elif bad == "pos_dtype":
        p = p.long()
    else:
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        da.flash_decode_attention(q, k, v, p)


# K1/K2 per-element limits, as in chip_smoke.py: |out - ref| <= rtol * |ref|
# + ACC * mag, mag = the sum of |terms| the kernel accumulates
# (attention.accumulated_magnitudes). Both sides compute in fp32 from the
# same inputs, so they differ by the summation order (ACC, with room for
# T = 256 terms and atomics) and one rounding of the output (rtol: one ulp
# of bf16 / fp16, 0 for fp32).
FLASH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
              torch.float16: 2.0 ** -10}
ACC = 1e-5


def _flash_inputs(cuda, B, H, T, dtype, masked):
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    q, k, v, do = (torch.randn(B, H, T, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    mask = None
    if masked:
        mask = torch.zeros(B, T, device=cuda)
        mask[0, T // 3:T // 2] = -1e9
        mask[-1, :7] = -1e9
    return q, k, v, do, mask


def _within(out, ref, mag, rtol):
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= rtol * ref.float().abs() + ACC * mag + 1e-30)
                .all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case,T,causal,masked", [
    ("causal", 256, True, False), ("mask", 192, False, True),
    ("ragged", 200, True, True), ("one_tile", 64, True, False)])
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_flash_kernels_match_plain(cuda, dtype, case, T, causal, masked,
                                   mode):
    q, k, v, do, mask = _flash_inputs(cuda, 2, 3, T, dtype, masked)
    before = dict(at.launches)
    o, lse = at.flash_fwd(q, k, v, mask, causal)
    ro, rlse = at.mha_reference(q, k, v, mask, causal, return_lse=True)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    grads = at.flash_bwd(q, k, v, mask, lse, delta, do, causal, mode=mode)
    refs = at.flash_bwd_reference(q, k, v, mask, lse, delta, do, causal)
    mags = at.accumulated_magnitudes(q, k, v, mask, lse, delta, do, causal)
    torch.cuda.synchronize()
    assert at.launches["flash_fwd"] == before["flash_fwd"] + 1
    key = "flash_bwd_" + mode
    assert at.launches[key] == before[key] + (1 if mode == "fused" else 2)
    rtol = FLASH_RTOL[dtype]
    assert bool(((lse - rlse).abs() <= 1e-5 * (1 + rlse.abs())).all())
    assert _within(o, ro, mags[0], rtol)
    for got, ref, mag in zip(grads, refs, mags[1:]):
        assert got.dtype == dtype and got.shape == ref.shape
        assert _within(got, ref, mag, rtol)


def test_flash_attention_grads_match_autograd_fp32(cuda):
    """End to end through the autograd Function. The mask leaves every row
    a visible key: a fully masked row's lse (~ -1e9, fp32 ulp 64) loses the
    log-sum bits, and its recomputed P, clamped as in the JAX package, is
    not autograd's (the kernel-vs-plain test covers such rows)."""
    q, k, v, do, _ = _flash_inputs(cuda, 2, 2, 130, torch.float32, False)
    mask = torch.zeros(2, 130, device=cuda)
    mask[:, 40:50] = -1e9
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = at.flash_attention(*leaves, mask=mask, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = at.mha_reference(*ref_leaves, mask=mask, causal=True)
    want = torch.autograd.grad(ref, ref_leaves, do)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["fp64", "head_dim", "strided", "mask_shape"])
def test_flash_wrapper_refuses_what_the_kernels_cannot_take(cuda, bad):
    q, k, v, _, mask = _flash_inputs(cuda, 2, 2, 64, torch.float32, True)
    if bad == "fp64":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "head_dim":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif bad == "strided":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    else:
        mask = mask[:, :10]
    with pytest.raises((TypeError, ValueError)):
        at.flash_fwd(q, k, v, mask, True)
