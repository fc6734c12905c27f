"""Kernels on the card: K3-K6 (flash decode over dense and paged, fp and
int8 caches), K1/K2a/K2b (flash attention for training), the fused layer's
row kernels K8 (LayerNorm), K10a/K10b (dropout and its replay) and K11
(bias + GELU), the standalone softmax K9, and K7a/K7b (block-sparse
attention, K7b also over layouts of uneven transposed degree) against their
plain PyTorch versions, and the wrappers' refusals on CUDA tensors; then
the serving step in CUDA graphs: K3-K6 replayed in a captured graph, a
graph-served engine against the same step program run eagerly (bit for
bit, dense and paged int8, with and without speculation, whose verify
lane runs K3-K6 at S = spec_k + 1), and a capture that fails raising;
then telemetry on the card: a Prometheus scrape thread during a fresh
engine's captures, telemetry on and off serving the same streams and
programs, a ``profile_window`` trace holding a decode kernel, and a
timer that covers queued device work.

Marked ``cuda``: they skip where there is no GPU. On a machine with one,
run ``python -m pytest tests/test_torch_cuda.py -m cuda``. This file
imports no JAX, so it runs where JAX is not installed.
"""


import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.ops.transformer.kernels import attention as at
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention as da
from deepspeed_tpu_torch.ops.transformer.kernels import dropout as dr
from deepspeed_tpu_torch.ops.transformer.kernels import gelu as ge
from deepspeed_tpu_torch.ops.transformer.kernels import layer_norm as ln
from deepspeed_tpu_torch.ops.transformer.kernels import softmax as sm
from deepspeed_tpu_torch.ops.sparse_attention import kernels as sk

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
    before = da.launches["decode"]
    out = da.flash_decode_attention(q, k, v, p)
    ref = da.decode_attention_reference(q, k, v, p)
    torch.cuda.synchronize()
    assert da.launches["decode"] == before + 1
    atol, rtol = tol
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * (ref.float().abs() + _spread(q, k, v, p))
    assert bool((diff <= limit).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 0.0)),
                                       (torch.bfloat16, (2e-3, 2.0 ** -7))],
                         ids=["fp32", "bf16"])
def test_decode_kernel_at_the_serving_shape(cuda, dtype, tol):
    """chip_smoke.py's first K3 case: 16 decode rows at the serving plane
    (max_len 1024, prefill chunk 32), frontiers from 0 to the plane's end,
    large finite garbage past each frontier."""
    from deepspeed_tpu_torch.inference.kv_pool import plane_len_for
    T = plane_len_for(1024, 32)
    pos = [0, 1, 31, 32, 33, 63, 64, 127, 128, 500, 511, 700, 1000, 1023,
           T - 2, T - 1]
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    q = torch.randn(16, 16, 1, 64, device=cuda, generator=g).to(dtype)
    k, v, garbage = (torch.randn(16, 16, T, 64, device=cuda, generator=g)
                     for _ in range(3))
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    stale = (torch.arange(T, device=cuda)[None, :] > p[:, None].long()
             )[:, None, :, None]
    k = torch.where(stale, 3e4 * torch.sign(garbage), k).to(dtype)
    v = torch.where(stale, -3e4 * torch.sign(garbage), v).to(dtype)
    out = da.flash_decode_attention(q, k, v, p)
    ref = da.decode_attention_reference(q, k, v, p)
    torch.cuda.synchronize()
    atol, rtol = tol
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * (ref.float().abs()
                                        + _spread(q, k, v, p))).all())


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


# K4, K5, K6: each against its plain version with K3's limit, plus for the
# int8 kernels chip_smoke.py's score shift (see its TOL: the kernels keep k
# in fp32 where the plain version rounds it to q's dtype, which moves each
# score by a known d_t); K5 equals K3 on the gathered plane and K6 equals K4
# bit for bit.


def _paged_operands(cuda, planes, pos, S, page_len, g):
    """Scatter logical planes [B, H, T, ...] into an arena through a
    shuffled table; logical pages past each row's frontier page point at
    the trash page 0, which (with two pages no row maps) holds large finite
    garbage."""
    B, T = pos.shape[0], planes[0].shape[2]
    n_lp = T // page_len
    n_pages = B * n_lp + 3
    tbl = torch.randperm(n_pages - 1, device=cuda, generator=g)[
        :B * n_lp].reshape(B, n_lp) + 1
    mapped = torch.arange(n_lp, device=cuda)[None] <= \
        ((pos.long() + S - 1) // page_len)[:, None]
    tbl = torch.where(mapped, tbl, 0).to(torch.int32).contiguous()
    arenas = []
    for plane in planes:
        tail = tuple(plane.shape[3:])
        shape = (n_pages, plane.shape[1], page_len) + tail
        if plane.dtype == torch.int8:
            arena = torch.randint(-127, 128, shape, device=cuda, generator=g,
                                  dtype=torch.int8)
        elif not tail:
            arena = 1e3 * (1 + torch.rand(shape, device=cuda, generator=g))
        else:
            arena = torch.full(shape, 3e4, device=cuda).to(plane.dtype)
        rows = plane.reshape((B, plane.shape[1], n_lp, page_len) + tail)
        arena[tbl[mapped].long()] = rows.movedim(2, 1)[mapped]
        arenas.append(arena.contiguous())
    return arenas, tbl


def _variant_case(cuda, kind, page_len, S, pos, dtype, T):
    """One call of decode kernel ``kind`` (``page_len`` for the paged
    kinds) at frontiers ``pos`` over a plane of T keys, stale keys past
    each frontier: (kernel out, plain out, dense twin's out or None,
    per-element limit). The launch counts one."""
    q, k, v, p = _inputs(cuda, len(pos), S, T, dtype, pos)
    stale = (torch.arange(T, device=cuda)[None] >
             p[:, None].long() + S - 1)[:, None, :, None]
    k = torch.where(stale, torch.full_like(k, 3e4), k)
    v = torch.where(stale, torch.full_like(v, -3e4), v)
    q8 = kind in ("q8", "paged_q8")
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    if q8:
        (kc, ks), (vc, vs) = da.quantize_kv(k), da.quantize_kv(v)
        planes = (kc, vc, ks, vs)
    else:
        planes = (k, v)
    if kind in ("decode", "q8"):
        ops, dense = planes, planes
    else:
        arenas, tbl = _paged_operands(cuda, planes, p, S, page_len, g)
        ops = tuple(arenas) + (tbl,)
        dense = [da.gather_pages(a, tbl) for a in arenas]
    kernel, plain, twin = {
        "decode": (da.flash_decode_attention, da.decode_attention_reference,
                   None),
        "q8": (da.flash_decode_attention_q8,
               da.decode_attention_q8_reference, None),
        "paged": (da.flash_decode_attention_paged,
                  da.decode_attention_paged_reference,
                  da.flash_decode_attention),
        "paged_q8": (da.flash_decode_attention_paged_q8,
                     da.decode_attention_paged_q8_reference,
                     da.flash_decode_attention_q8)}[kind]
    before = da.launches[kind]
    out = kernel(q, *ops, p)
    ref = plain(q, *ops, p)
    twin_out = twin(q, *dense, p) if twin is not None else None
    torch.cuda.synchronize()
    assert da.launches[kind] == before + 1
    kf, vf = (da.dequantize_kv(dense[0], dense[2]),
              da.dequantize_kv(dense[1], dense[3])) if q8 else dense
    atol, rtol = (1e-5, 0.0) if dtype == torch.float32 else (2e-3, 2.0 ** -7)
    limit = atol + rtol * (ref.float().abs() + _spread(q, kf, vf, p))
    if q8:
        qp = p.long()[:, None] + torch.arange(S, device=cuda)
        mask = torch.arange(T, device=cuda)[None, None] <= qp[:, :, None]
        sc = torch.matmul(q.float(), kf.transpose(-1, -2)) / 8.0
        pr = torch.softmax(sc.masked_fill(~mask[:, None], float("-inf")), -1)
        d = torch.matmul(q.float(), (kf - kf.to(dtype).float())
                         .transpose(-1, -2)) / 8.0
        vq, o = vf.to(dtype).float(), ref.float()
        pd = pr * d
        d_max = (d.abs() * (pr > 0)).amax(-1, keepdim=True)
        limit = limit + (torch.matmul(pd, vq)
                         - o * pd.sum(-1, keepdim=True)).abs() \
            + d_max ** 2 * (torch.matmul(pr, vq.abs()) + o.abs())
    return out, ref, twin_out, limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S,pos", [(1, [0, 6, 7, 40, 111]), (9, [0, 60]),
                                   (5, [0, 3, 4, 60, 114])],
                         ids=["decode", "rows9", "verify5"])
@pytest.mark.parametrize("kind,page_len", [("q8", 0), ("paged", 7),
                                           ("paged", 128), ("paged_q8", 7),
                                           ("paged_q8", 128)])
def test_int8_and_paged_kernels_match_plain(cuda, kind, page_len, S, pos,
                                            dtype):
    T = 128 if page_len == 128 else 119   # 17 pages of 7; one of 128
    out, ref, twin, limit = _variant_case(cuda, kind, page_len, S, pos,
                                          dtype, T)
    if twin is not None:
        assert torch.equal(out, twin)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= limit).all())


# The split over the key length: each kernel cuts a row every SPLIT_KEYS
# keys (L) and merges the splits in a second launch. Frontiers just before,
# at and after the first boundary, at the second, and at the plane's last
# key (plus, at B = 16, frontiers in every other split), over a plane of
# 4.5 L keys (the last split ragged) in pages of 48, which do not divide L.
# With S > 1, also frontiers whose last rows reach the next split while the
# first rows do not (at S = 5: the row groups of 4 and 1 stop in different
# splits).
SPLIT_L = da.SPLIT_KEYS
SPLIT_PLANE = 4 * SPLIT_L + SPLIT_L // 2


def _straddling(S, B):
    last = SPLIT_PLANE - S
    edge = [SPLIT_L - 1, SPLIT_L, SPLIT_L + 1, 2 * SPLIT_L, last]
    if S > 1:
        edge += [SPLIT_L - S + 1, SPLIT_L - S + 2, SPLIT_L - 2,
                 2 * SPLIT_L - S + 1]
    if B == 1:
        return [[p] for p in edge]
    more = [0, 5, SPLIT_L // 2, 2 * SPLIT_L - 1, 2 * SPLIT_L + 1,
            3 * SPLIT_L - 1, 3 * SPLIT_L, 3 * SPLIT_L + 1, 4 * SPLIT_L,
            4 * SPLIT_L + 1, last - 1]
    return [[min(p, last) for p in edge + more]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("S", [1, 5, 32, 64])
@pytest.mark.parametrize("kind", ["decode", "q8", "paged", "paged_q8"])
def test_decode_kernels_across_split_boundaries(cuda, kind, S, B, dtype):
    for pos in _straddling(S, B):
        out, ref, twin, limit = _variant_case(cuda, kind, 48, S, pos, dtype,
                                              SPLIT_PLANE)
        assert bool(torch.isfinite(out).all())
        assert bool(((out.float() - ref.float()).abs() <= limit).all()), pos
        if twin is not None:
            assert torch.equal(out, twin), pos


@pytest.mark.parametrize("S", [1, 5, 32])
@pytest.mark.parametrize("page_len", [48, 96, 128])
@pytest.mark.parametrize("kind", ["paged", "paged_q8"])
def test_paged_kernels_equal_their_dense_twins_across_splits(cuda, kind,
                                                             page_len, S):
    """K5 == K3 and K6 == K4 on the gathered plane, bit for bit, where the
    pages do not line up with the splits (48, 96) and where they do."""
    T = 5 * 384  # whole pages of 48, 96 and 128
    pos = [SPLIT_L - 1, SPLIT_L, SPLIT_L + 1, 2 * SPLIT_L, 3 * SPLIT_L - 1,
           700, 1000, T - S, SPLIT_L - 4, 2 * SPLIT_L - 3]
    out, _, twin, _ = _variant_case(cuda, kind, page_len, S, pos,
                                    torch.bfloat16, T)
    assert torch.equal(out, twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 32])
def test_combine_kernel_matches_plain(cuda, S, dtype):
    """The combine kernel alone on plain partials, NaN in every split that
    holds no key of a row: |out - ref| <= rtol |ref| + 1e-6
    of the row's max-abs (both merge in split order in fp32 and differ in
    exp's last bits; rtol one bf16 ulp where the output is bf16)."""
    pos = [0, SPLIT_L - 1, SPLIT_L, 2 * SPLIT_L + 1, SPLIT_PLANE - S]
    q, k, v, p = _inputs(cuda, len(pos), S, SPLIT_PLANE, torch.float32, pos)
    part = da.decode_partials_reference(q, k, v, p)
    run = da._splits_run(p, S, SPLIT_PLANE, SPLIT_L)
    unused = torch.arange(part.shape[0], device=cuda)[:, None, None] >= \
        run[None]
    part.masked_fill_(unused[:, :, None, :, None], float("nan"))
    out = da.combine_partials(part, p, SPLIT_PLANE, dtype)
    ref = da.combine_partials_reference(part, p, SPLIT_PLANE, torch.float32)
    torch.cuda.synchronize()
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    limit = rtol * ref.abs() + 1e-6 * ref.abs().amax(-1, keepdim=True)
    assert bool(((out.float() - ref).abs() <= limit).all())


def test_decode_kernel_on_two_streams_at_once(cuda):
    """K3 launched on two streams at once (each call its own workspace):
    every result equals the same call's result alone."""
    cases = [_inputs(cuda, 16, 1, 1056, torch.bfloat16,
                     [(37 * i + 500 * n) % 1056 for i in range(16)])
             for n in range(2)]
    alone = [da.flash_decode_attention(*c) for c in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(20):
        for n, st in enumerate(streams):
            st.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(st):
                outs[n].append(da.flash_decode_attention(*cases[n]))
    torch.cuda.synchronize()
    for n in range(2):
        assert all(torch.equal(o, alone[n]) for o in outs[n])


@pytest.mark.parametrize("bad", ["codes_fp", "scale_fp16", "tbl_int64",
                                 "tbl_strided", "tbl_on_cpu"])
def test_int8_and_paged_wrappers_refuse_what_the_kernels_cannot_take(cuda,
                                                                      bad):
    q, k, v, p = _inputs(cuda, 2, 1, 64, torch.float32, [0, 5])
    (kc, ks), (vc, vs) = da.quantize_kv(k), da.quantize_kv(v)
    tbl = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    arena = torch.zeros(5, 4, 32, 64, device=cuda)
    if bad == "codes_fp":
        call = (da.flash_decode_attention_q8, (q, k, v, ks, vs, p))
    elif bad == "scale_fp16":
        call = (da.flash_decode_attention_q8, (q, kc, vc, ks.half(), vs, p))
    else:
        if bad == "tbl_int64":
            tbl = tbl.long()
        elif bad == "tbl_strided":
            tbl = tbl.t().contiguous().t()
        else:
            tbl = tbl.cpu()
        call = (da.flash_decode_attention_paged, (q, arena, arena, tbl, p))
    before = dict(da.launches)
    with pytest.raises((TypeError, ValueError)):
        call[0](*call[1])
    assert da.launches == before


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
    if masked == "padding":  # the BERT batches': every other row padded
        lens = torch.randint(T // 4, T, (B,), device=cuda, generator=g)
        drop = torch.arange(T, device=cuda)[None] >= lens[:, None]
        drop[1::2] = False
        mask = torch.where(drop, -1e9, 0.0)
    elif masked:
        mask = torch.zeros(B, T, device=cuda)
        mask[0, T // 3:T // 2] = -1e9
        mask[-1, :7] = -1e9
    return q, k, v, do, mask


def _within(out, ref, mag, rtol):
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= rtol * ref.float().abs() + ACC * mag + 1e-30)
                .all())


# The "_wide" cases of the test below run at more batch rows and heads:
# K2b's dq kernel issues the ragged T's last query tile (40 rows) first,
# and 448 is a masked non-causal T that is not a multiple of 128.
FLASH_WIDE = (3, 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
# The bf16 kernels take 128 query rows (K1) or keys (K2) per block: T = 64,
# 192 and 1000 end inside a block, causal and not, with the padding mask.
@pytest.mark.parametrize("case,T,causal,masked", [
    ("causal", 256, True, False), ("mask", 192, False, True),
    ("ragged", 200, True, True), ("one_tile", 64, True, False),
    ("pad64", 64, False, "padding"), ("pad64_causal", 64, True, "padding"),
    ("pad192", 192, False, "padding"),
    ("pad192_causal", 192, True, "padding"),
    ("pad1000", 1000, False, "padding"),
    ("pad1000_causal", 1000, True, "padding"),
    ("ragged_wide", 1000, True, False), ("one_tile_wide", 64, True, False),
    ("mask448_wide", 448, False, True)])
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_flash_kernels_match_plain(cuda, dtype, case, T, causal, masked,
                                   mode):
    B, H = FLASH_WIDE if case.endswith("_wide") else (2, 3)
    q, k, v, do, mask = _flash_inputs(cuda, B, H, T, dtype, masked)
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


# K8 / K11 per-element limits, as in chip_smoke.py: |out - ref| <= atol +
# rtol * |ref|. Kernel and plain version compute in fp32 from the same
# inputs and differ in summation order and FMA contraction (a few fp32 ulps
# of terms of order 1: atol), then may round to neighbouring values of the
# output type (rtol: one ulp, bf16 2**-7, fp16 2**-10; fp32 2**-20).
ROW_TOL = {torch.float32: (2e-6, 2.0 ** -20),
           torch.bfloat16: (2e-6, 2.0 ** -7),
           torch.float16: (2e-6, 2.0 ** -10)}
ROW_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
ROW_IDS = ["fp32", "bf16", "fp16"]


def _row_inputs(cuda, rows, cols, dtype, seed=2):
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    x, res = (torch.randn(rows, cols, device=cuda, generator=g).to(dtype)
              for _ in range(2))
    gamma, beta, bias = (torch.randn(cols, device=cuda, generator=g)
                         for _ in range(3))
    return x, res, 1.0 + 0.1 * gamma, 0.1 * beta, bias


def _row_within(out, ref, dtype):
    atol, rtol = ROW_TOL[dtype]
    diff = (out.float() - ref.float()).abs()
    return bool((diff <= atol + rtol * ref.float().abs()).all())


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=ROW_IDS)
@pytest.mark.parametrize("cols", [1024, 768, 64])
@pytest.mark.parametrize("variant", ["plain", "residual", "bias_residual"])
def test_layer_norm_kernel_matches_plain(cuda, dtype, cols, variant):
    x, res, gamma, beta, bias = _row_inputs(cuda, 301, cols, dtype)
    x = 2.0 + 3.0 * x.float()
    x = x.to(dtype)
    res = None if variant == "plain" else res
    bias = bias if variant == "bias_residual" else None
    key = "plain" if variant == "plain" else "bias_residual"
    before = ln.launches[key]
    out, mu, rstd = ln.ln_fwd(x, gamma, beta, bias, res, eps=1e-12)
    rout, rmu, rrstd = ln.ln_fwd_reference(x, gamma, beta, bias, res, 1e-12)
    torch.cuda.synchronize()
    assert ln.launches[key] == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    assert mu.shape == rstd.shape == (301, 1)
    assert _row_within(out, rout, dtype)
    torch.testing.assert_close(mu, rmu, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rrstd, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=ROW_IDS)
@pytest.mark.parametrize("cols", [4096, 64])
def test_bias_gelu_kernel_matches_plain(cuda, dtype, cols):
    x, _, _, _, bias = _row_inputs(cuda, 129, cols, dtype)
    x = (3.0 * x.float()).to(dtype)
    before = ge.launches
    out = ge.bias_gelu_fwd(x, bias)
    ref = ge.bias_gelu_reference(x, bias)
    torch.cuda.synchronize()
    assert ge.launches == before + 1
    assert out.dtype == dtype and _row_within(out, ref, dtype)


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=ROW_IDS)
@pytest.mark.parametrize("shape,fused", [((257, 1024), True),
                                         ((3, 4, 33, 64), False)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_kernels_match_plain_bit_for_bit(cuda, dtype, shape, fused,
                                                 rate):
    """K10a and K10b draw the plain version's Philox mask and round as it
    does: the outputs are equal, not close."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    x, res, grad = (torch.randn(*shape, device=cuda, generator=g).to(dtype)
                    for _ in range(3))
    bias = torch.randn(shape[-1], device=cuda, generator=g) if fused \
        else None
    res = res if fused else None
    seed = 2 ** 40 + 12345
    before = dict(dr.launches)
    out = dr.dropout_fwd(x, bias, res, rate, seed)
    dx = dr.dropout_bwd(grad, rate, seed)
    ref = dr.dropout_reference(x, rate, seed, bias, res)
    ref_dx = dr.dropout_bwd_reference(grad, rate, seed)
    torch.cuda.synchronize()
    assert dr.launches == {"dropout_fwd": before["dropout_fwd"] + 1,
                           "dropout_bwd": before["dropout_bwd"] + 1}
    assert torch.equal(out, ref) and torch.equal(dx, ref_dx)
    keep = dr.dropout_mask(shape, rate, seed, cuda)
    assert torch.equal(dx == 0, ~keep | (grad == 0))


def test_row_kernel_autograd_functions_on_the_card(cuda):
    """The layer's autograd Functions run their kernels forward (and K10b
    backward) and agree with the plain path on the CPU."""
    x, res, gamma, beta, bias = _row_inputs(cuda, 64, 256, torch.float32)
    grad = torch.randn_like(x)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).clone().requires_grad_()
                  for t in (x, res, gamma, beta, bias)]
        tx, tr, tg, tb, tbias = leaves
        y = dr.fused_bias_dropout_residual(tx, tbias, tr, 0.1, 77)
        y = ln.fused_layer_norm(y, tg, tb)
        y = ge.fused_bias_gelu(y, tbias)
        y = dr.dropout(y, 0.2, 78)
        y.backward(grad.to(dev))
        outs.append([y.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["fp64", "wide_row", "strided", "res_dtype",
                                 "odd_cols"])
def test_row_kernel_wrappers_refuse_what_the_kernels_cannot_take(cuda, bad):
    x, res, gamma, beta, bias = _row_inputs(cuda, 8, 1024, torch.float32)
    if bad == "fp64":
        x, res = x.double(), res.double()
    elif bad == "wide_row":
        x = torch.zeros(8, 2048, device=cuda)
        res, gamma, beta = torch.zeros_like(x), x[0], x[0]
    elif bad == "strided":
        x = x.t().contiguous().t()
    elif bad == "res_dtype":
        res = res.half()
    else:
        x, res, gamma, beta = x[:, :1023].contiguous(), res[:, :1023]\
            .contiguous(), gamma[:1023], beta[:1023]
    with pytest.raises((TypeError, ValueError)):
        ln.ln_fwd(x, gamma, beta, None, res)


# K9: (B, H, T_q, T_k, causal, masked). T_k = 1, 130 (bf16/fp16 rows of 260
# bytes: the CTA path's element loads), 777 (ragged in every dtype), 1000
# and 512 (the warp path), 4096 and 8192 (the CTA path's vector loads).
SOFTMAX_CASES = [(2, 3, 5, 1, False, False), (2, 3, 17, 1000, False, True),
                 (2, 2, 64, 512, False, True), (1, 2, 9, 4096, False, True),
                 (1, 1, 4, 8192, False, True), (2, 3, 130, 130, True, True),
                 (1, 2, 256, 256, True, False), (2, 2, 7, 777, False, True)]


@pytest.mark.parametrize("dtype", ROW_DTYPES, ids=ROW_IDS)
@pytest.mark.parametrize("B,H,t_q,t_k,causal,masked", SOFTMAX_CASES,
                         ids=["tk{}{}".format(c[3], "_causal" if c[4] else "")
                              for c in SOFTMAX_CASES])
def test_softmax_kernel_matches_plain(cuda, dtype, B, H, t_q, t_k, causal,
                                      masked):
    """K9 within one output ulp of its plain version (ROW_TOL), a row
    masked at every key included."""
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    s = (3.0 * torch.randn(B, H, t_q, t_k, device=cuda, generator=g)) \
        .to(dtype)
    mask = None
    if masked:
        lens = torch.randint(1, t_k + 1, (B,), device=cuda, generator=g)
        mask = torch.where(torch.arange(t_k, device=cuda)[None]
                           >= lens[:, None], -1e9, 0.0)
        mask[-1] = -1e9
    before = sm.launches
    out = sm.softmax_fwd(s, mask, 0.125, causal)
    ref = sm.attn_softmax_reference(s, mask, 0.125, causal)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    assert out.dtype == dtype and out.shape == s.shape
    assert bool(torch.isfinite(out).all())
    assert _row_within(out, ref, dtype)


def test_softmax_autograd_on_the_card_matches_the_cpu(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    s = torch.randn(2, 3, 40, 72, device=cuda, generator=g)
    grad = torch.randn(2, 3, 40, 72, device=cuda, generator=g)
    mask = torch.zeros(2, 72, device=cuda)
    mask[0, 50:] = -1e9
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaf = s.to(dev).clone().requires_grad_()
        p = sm.attn_softmax(leaf, mask.to(dev), 0.125, False)
        p.backward(grad.to(dev))
        outs.append((p.detach().cpu(), leaf.grad.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", ["fp64", "strided", "too_long", "mask_shape",
                                 "mask_device", "rank"])
def test_softmax_wrapper_refuses_what_the_kernel_cannot_take(cuda, bad):
    s = torch.zeros(2, 2, 8, 64, device=cuda)
    mask = torch.zeros(2, 64, device=cuda)
    if bad == "fp64":
        s = s.double()
    elif bad == "strided":
        s = s.transpose(2, 3)
        mask = torch.zeros(2, 8, device=cuda)
    elif bad == "too_long":
        s = torch.zeros(1, 1, 1, sm.MAX_KEYS + 1, device=cuda)
        mask = None
    elif bad == "mask_shape":
        mask = mask[:, :10]
    elif bad == "mask_device":
        mask = mask.cpu()
    else:
        s = s[0]
    with pytest.raises((TypeError, ValueError)):
        sm.softmax_fwd(s, mask, 0.125, False)


# K7a/K7b against their plain versions: |out - ref| <= rtol * |ref| +
# SPARSE_ACC * mag per element (mag: sk.accumulated_magnitudes), the form of
# K1/K2's limit. An element sums at most T = 256 terms here (4096 on the
# sparse BERT path, which sets SPARSE_ACC = 4096 * 2**-24); rtol is one
# output ulp.
SPARSE_ACC = 2.0 ** -12


def _sparse_layout(block, T, H, kind, seed=0):
    """A Fixed layout (bidirectional, or unidirectional for 'fixeduni'), or
    a random one with some query blocks (rows) and key blocks (columns)
    empty, so both LUTs hold -1 entries."""
    nb = T // block
    if kind in ("fixed", "mixed", "fixeduni"):
        from deepspeed_tpu_torch.ops.sparse_attention import (
            FixedSparsityConfig)
        attention = "unidirectional" if kind == "fixeduni" else \
            "bidirectional"
        return FixedSparsityConfig(num_heads=H, block=block,
                                   num_local_blocks=2,
                                   attention=attention).make_layout(T)
    rng = np.random.RandomState(seed)
    layout = (rng.rand(H, nb, nb) < 0.4).astype(np.int64)
    layout[:, 1] = 0
    layout[:, :, 2] = 0
    return layout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["fp32", "bf16",
                                                        "fp16"])
@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("case", ["fixed_kpm_add", "random_causal",
                                  "random_mul_bias", "mixed_kpm_add",
                                  "fixeduni_causal"])
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_sparse_kernels_match_plain(cuda, dtype, block, case, mode):
    # At block 64 bf16, K7a runs over the forward schedule (items counted
    # over both heads): 'fixed' is all pairs of query blocks, 'fixeduni'
    # all single blocks, 'random' one pair of equal rows and five single
    # blocks, and 'mixed' (5 query blocks: Fixed windows of 2, the last cut
    # short) two pairs and a single block per head, in one launch.
    B, H = 2, 2
    T = 320 if case.startswith("mixed") else 256
    g = torch.Generator(device=cuda)
    g.manual_seed(block)
    q, k, v, do = (torch.randn(B, H, T, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    lowered = sk.lower(_sparse_layout(block, T, H, case.split("_")[0],
                                      seed=block), block)
    if block == 64 and dtype == torch.bfloat16:
        paired = (lowered.fwd_schedule[:, 2] >= 0).sum()
        assert (paired, len(lowered.fwd_schedule)) == {
            "fixed": (4, 4), "random": (1, 7), "mixed": (4, 6),
            "fixeduni": (0, 8)}[case.split("_")[0]]
    kw = dict(causal=case.endswith("_causal"))
    if case.endswith("_kpm_add"):
        kpm = torch.zeros(B, T, device=cuda)
        kpm[1, T // 2 + 5:] = -1e9
        kw.update(kpm=kpm)
    if case == "random_mul_bias":
        kw.update(kpm=(torch.rand(B, T, device=cuda, generator=g) > 0.1)
                  .float(), kpm_mode="mul",
                  bias=1.0 + torch.rand(B, H, T, T, device=cuda,
                                        generator=g),
                  bias_mode="mul")
    before = dict(sk.launches)
    o, lse = sk.sparse_fwd(q, k, v, lowered, **kw)
    ro, rlse = sk.sparse_fwd_reference(q, k, v, lowered, **kw)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    grads = sk.sparse_bwd(q, k, v, lowered, lse, delta, do, mode=mode, **kw)
    refs = sk.sparse_bwd_reference(q, k, v, lowered, lse, delta, do, **kw)
    mags = sk.accumulated_magnitudes(q, k, v, lowered, lse, delta, do, **kw)
    torch.cuda.synchronize()
    assert sk.launches["sparse_fwd"] == before["sparse_fwd"] + 1
    key = "sparse_bwd_" + mode
    assert sk.launches[key] == before[key] + (1 if mode == "fused" else 2)
    rtol = FLASH_RTOL[dtype]
    assert bool(((lse - rlse).abs() <= 1e-5 * (1 + rlse.abs())).all())
    for got, ref, mag in zip((o,) + tuple(grads), (ro,) + tuple(refs), mags):
        assert got.dtype == dtype and got.shape == ref.shape
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= rtol * ref.float().abs() + SPARSE_ACC * mag
                     + 1e-30).all())
    if case.startswith("random"):  # rows of the empty query block
        rows = slice(block, 2 * block)
        assert bool((o[:, :, rows] == 0).all())


def _global_rows_layout(H, nb):
    """A band of three blocks per query block plus two key blocks (0 and
    nb // 3) that every query block lists: the transposed LUT's rows hold
    nb entries there and at most 5 elsewhere, against a forward degree of
    at most 5."""
    layout = np.zeros((H, nb, nb), dtype=np.int64)
    for i in range(nb):
        layout[:, i, max(i - 1, 0):i + 2] = 1
    layout[:, :, [0, nb // 3]] = 1
    return layout


# K7b's bf16 dk/dv kernel walks the layout's backward schedule, the largest
# LUT rows first: the sparse BERT path's Fixed layout (transposed rows of 4
# and of 64 query blocks against forward rows of 19, here at H=2 and B=1)
# and layouts whose longest transposed rows are six times their forward
# degree, at every block; both backward modes, against the plain versions
# at SPARSE_ACC.
@pytest.mark.parametrize("case,block,T", [
    ("path_fixed", 64, 4096), ("global_rows", 16, 512),
    ("global_rows", 32, 1024), ("global_rows", 64, 2048)])
@pytest.mark.parametrize("mode", ["fused", "split"])
def test_sparse_backward_over_the_degree_schedule(cuda, case, block, T,
                                                  mode):
    B, H = (1, 2) if case == "path_fixed" else (2, 2)
    g = torch.Generator(device=cuda)
    g.manual_seed(T + block)
    q, k, v, do = (torch.randn(B, H, T, 64, device=cuda, generator=g)
                   .to(torch.bfloat16) for _ in range(4))
    if case == "path_fixed":
        from deepspeed_tpu_torch.ops.sparse_attention import (
            FixedSparsityConfig)
        layout = FixedSparsityConfig(num_heads=H, block=block).make_layout(T)
    else:
        layout = _global_rows_layout(H, T // block)
    lowered = sk.lower(layout, block)
    # Some transposed rows are longer than any forward row.
    assert (lowered.bwd_lut >= 0).sum(-1).max() > \
        (lowered.fwd_lut >= 0).sum(-1).max()
    kpm = torch.zeros(B, T, device=cuda)
    kpm[0, T // 2 + 3:] = -1e9
    o, lse = sk.sparse_fwd(q, k, v, lowered, kpm=kpm)
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    grads = sk.sparse_bwd(q, k, v, lowered, lse, delta, do, kpm=kpm,
                          mode=mode)
    refs = sk.sparse_bwd_reference(q, k, v, lowered, lse, delta, do, kpm=kpm)
    mags = sk.accumulated_magnitudes(q, k, v, lowered, lse, delta, do,
                                     kpm=kpm)[1:]
    torch.cuda.synchronize()
    rtol = FLASH_RTOL[torch.bfloat16]
    for got, ref, mag in zip(grads, refs, mags):
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= rtol * ref.float().abs() + SPARSE_ACC * mag
                     + 1e-30).all())


def test_sparse_forward_takes_an_unaligned_padding_mask(cuda):
    """K7a's block-64 kernel copies the key-padding mask 256 bytes at a
    time, which needs a 16-byte-aligned start: the wrapper copies a mask
    that starts elsewhere, and the result is the aligned mask's."""
    B, H, T, block = 2, 2, 512, 64
    g = torch.Generator(device=cuda)
    g.manual_seed(11)
    q, k, v = (torch.randn(B, H, T, 64, device=cuda, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    lowered = sk.lower(_sparse_layout(block, T, H, "fixed"), block)
    kpm = torch.zeros(B, T, device=cuda)
    kpm[1, 300:] = -1e9
    flat = torch.empty(B * T + 1, device=cuda)
    unaligned = flat[1:].view(B, T)
    unaligned.copy_(kpm)
    assert unaligned.data_ptr() % 16 != 0 and unaligned.is_contiguous()
    o, lse = sk.sparse_fwd(q, k, v, lowered, kpm=kpm)
    o2, lse2 = sk.sparse_fwd(q, k, v, lowered, kpm=unaligned)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_sparse_attention_grads_match_autograd_fp32(cuda):
    """End to end through the autograd Function, with a learned bias: the
    kernels against autograd through the dense reference."""
    B, H, T, block = 2, 2, 128, 32
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    q, k, v, do = (torch.randn(B, H, T, 64, device=cuda, generator=g)
                   for _ in range(4))
    bias = 0.1 * torch.randn(B, H, T, T, device=cuda, generator=g)
    layout = _sparse_layout(block, T, H, "fixed")
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = sk.block_sparse_attention(*leaves[:3], layout, block,
                                    attn_bias=leaves[3])
    got = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    ref = sk.block_sparse_attention_reference(*ref_leaves[:3], layout, block,
                                              attn_bias=ref_leaves[3])
    want = torch.autograd.grad(ref, ref_leaves, do)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", ["fp64", "head_dim", "block", "strided"])
def test_sparse_wrapper_refuses_what_the_kernels_cannot_take(cuda, bad):
    q, k, v = (torch.randn(1, 2, 128, 64, device=cuda) for _ in range(3))
    block = 8 if bad == "block" else 32
    lowered = sk.lower(np.ones((2, 128 // block, 128 // block)), block)
    if bad == "fp64":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "head_dim":
        q, k, v = (t[..., :32].contiguous() for t in (q, k, v))
    elif bad == "strided":
        k = k.transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises((TypeError, ValueError)):
        sk.sparse_fwd(q, k, v, lowered)


# ---------------------------------------------- the serving step in graphs

GRAPH_WRAPPERS = {"decode": da.flash_decode_attention,
                  "q8": da.flash_decode_attention_q8,
                  "paged": da.flash_decode_attention_paged,
                  "paged_q8": da.flash_decode_attention_paged_q8}


def _graph_operands(cuda, kind, dtype, S, seed, B=4, H=4, page_len=48,
                    n_lp=6):
    """Arguments of ``kind``'s wrapper: B rows over a plane of n_lp x
    page_len keys (paged: a shuffled arena with the trash page), ragged
    frontiers."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    T = n_lp * page_len
    q = torch.randn(B, H, S, 64, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(B, H, T, 64, device=cuda, generator=g)
            for _ in range(2))
    pos = torch.randint(0, T - S + 1, (B,), device=cuda, generator=g,
                        dtype=torch.int32)
    if kind.endswith("q8"):
        (k, v), scales = da.quantize_kv(torch.stack((k, v)))
        scales = list(scales)
    else:
        k, v, scales = k.to(dtype), v.to(dtype), []
    planes = [k, v] + scales
    tbl = []
    if kind.startswith("paged"):
        idx = torch.randperm(B * n_lp, device=cuda, generator=g) + 1

        def arena(plane):
            pages = plane.reshape((B, H, n_lp, page_len) + plane.shape[3:])
            pages = pages.movedim(2, 1).reshape(
                (B * n_lp, H, page_len) + plane.shape[3:])
            out = torch.zeros((B * n_lp + 1,) + pages.shape[1:],
                              dtype=plane.dtype, device=cuda)
            out[idx] = pages
            return out

        planes = [arena(p) for p in planes]
        tbl = [idx.view(B, n_lp).to(torch.int32)]
    return [q] + planes + tbl + [pos]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 5, 32])
@pytest.mark.parametrize("kind", ["decode", "q8", "paged", "paged_q8"])
def test_decode_kernels_replay_in_a_cuda_graph(cuda, kind, S, dtype):
    """K3-K6 (the split kernel, its combine chained as a programmatic
    dependent, the workspace from the graph's pool; fp32 with more than 48
    KB of shared memory) captured once and replayed on new operands
    copied into the captured tensors: bit for bit the eager launch."""
    fn = GRAPH_WRAPPERS[kind]
    static = _graph_operands(cuda, kind, dtype, S, seed=0)
    fn(*static)  # warm-up: loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = da.launches[kind]
    with torch.cuda.graph(graph):
        out = fn(*static)
    assert da.launches[kind] == before + 1  # the wrapper counts at capture
    for seed in (1, 2):
        for dst, src in zip(static, _graph_operands(cuda, kind, dtype, S,
                                                    seed)):
            dst.copy_(src)
        graph.replay()
        want = fn(*static)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


class _EagerEngine(InferenceEngine):
    """The engine with every step's program run eagerly: what a
    graph-served engine is held to, bit for bit."""

    def _run_program(self, key):
        self._program(*key)


SMALL_SERVE = {"max_slots": 4, "max_len": 160, "chunk_size": 4,
               "prefill_chunk": 16}


def _small_gpt2(cuda):
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    cfg = GPT2Config(n_embd=256, n_layer=2, n_head=4, vocab_size=1024,
                     n_positions=256, dtype=torch.bfloat16)
    return GPT2LMHeadModel(cfg, device=cuda, seed=0)


def _serve(engine, prompts):
    """Serve ``prompts`` (every third sampled, one with top-k; on a
    speculating engine the fifth opts out) and return the harvest of every
    step and the launch counts."""
    for i, p in enumerate(prompts):
        kw = {"temperature": 0.8, "seed": i, "top_k": 20 if i == 2 else None
              } if i % 3 == 2 else {}
        if i == 4 and engine.config.spec_decode:
            kw["spec_decode"] = False
        engine.submit(p, max_new_tokens=24, **kw)
    da.reset_launches()
    snaps = []
    while not engine.idle:
        engine.step()
        snaps.append(engine._last_snap)
    torch.cuda.synchronize()
    return snaps, dict(da.launches)


def _unread_diffs(graphed, eager, spec):
    """Compare two engines' pools in full, printing the indices of every
    element that differs. Only a speculating paged pool may differ, and
    only where no read sees: its trash page (page 0 of k/v and scales) and
    token-ring entries past a row's frontier. The frozen rows of freed
    slots write their spec_k + 1 verify positions into the trash page
    together, a CUDA indexed write with repeated indices keeps any one of
    the values, and those rows read that page back: their choices, which
    land in the ring past their frontier, may differ too. Anything else
    fails."""
    pos = graphed._pool["pos"].long()
    bad = {}
    for name, t in graphed._pool.items():
        idx = (t != eager._pool[name]).nonzero()
        if not len(idx):
            continue
        print("pool {}: {} elements differ, first {}{}".format(
            name, len(idx), idx[:4].tolist(),
            "" if name != "toks" else ", frontiers of those rows {}".format(
                pos[idx[:4, 0]].tolist())))
        paged = spec and "block_tbl" in graphed._pool
        if name in ("k", "v", "k_scale", "v_scale"):
            unread = paged and bool((idx[:, 1] == 0).all())
        else:
            unread = paged and name == "toks" and bool(
                (idx[:, 1] > pos[idx[:, 0]]).all())
        if not unread:
            bad[name] = idx[:8].tolist()
    assert not bad, bad


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": True, "kv_page_len": 32, "int8_kv": True},
    {"spec_decode": True, "spec_k": 4},
    {"paged_kv": True, "kv_page_len": 32, "int8_kv": True,
     "spec_decode": True, "spec_k": 4}],
    ids=["dense", "paged_int8", "dense_spec", "paged_int8_spec"])
def test_graph_served_engine_equals_the_eager_program(cuda, extra):
    model = _small_gpt2(cuda)
    config = dict(SMALL_SERVE, **extra)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 1024, size=n) for n in (5, 40, 17, 70, 9, 33)]
    graphed = InferenceEngine(model, config=config)
    eager = _EagerEngine(model, config=config)
    got, got_launches = _serve(graphed, prompts)
    want, want_launches = _serve(eager, prompts)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for name in a:
            assert np.array_equal(a[name], b[name]), name
    _unread_diffs(graphed, eager, "spec_decode" in extra)
    # Replays count their launches: the same counts as the eager run.
    assert got_launches == want_launches and sum(got_launches.values()) > 0
    m = graphed.metrics()
    assert 0 < m["compile_count"] <= 8
    assert m["graph_replays"] == len(got) - m["compile_count"] > 0
    assert m["graph_pool_bytes"] > 0 and m["capture_ms"] > 0
    if "paged_kv" in extra:
        assert graphed.kv_page_stats()["pages_in_use"] == 0
    if "spec_decode" in extra:
        assert "toks" in graphed._pool and m["accepted_per_step_mean"] >= 1


def _telemetry_prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 1024, size=n) for n in (5, 40, 17, 70)]


def _generate(engine, prompts):
    """Serve ``prompts`` (the third sampled with top-k) to the end; the
    streams in submission order."""
    reqs = [engine.submit(p, max_new_tokens=24, **(
        {"temperature": 0.8, "top_k": 20, "seed": 3} if i == 2 else {}))
        for i, p in enumerate(prompts)]
    engine.run()
    return [r.tokens for r in reqs]


def test_scrape_during_captures_keeps_streams(cuda):
    """A thread scrapes a PrometheusEndpoint every 5 ms while a fresh
    engine captures its keys: every gauge is host-only, so every capture
    succeeds and the streams equal an unscraped engine's."""
    import threading
    import time
    import urllib.request

    from deepspeed_tpu_torch.telemetry import PrometheusEndpoint

    model = _small_gpt2(cuda)
    want = _generate(InferenceEngine(model, config=SMALL_SERVE),
                     _telemetry_prompts())
    eng = InferenceEngine(model, config=SMALL_SERVE)
    ep = PrometheusEndpoint(eng.telemetry, port=0)
    url = "http://{}:{}/metrics".format(ep.host, ep.port)
    scrapes, errors, stop = [0], [], threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                urllib.request.urlopen(url, timeout=30).read()
                scrapes[0] += 1
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append(e)
            time.sleep(0.005)

    t = threading.Thread(target=scrape)
    try:
        t.start()
        got = _generate(eng, _telemetry_prompts())
    finally:
        stop.set()
        t.join(timeout=60)
        ep.close()
    assert not t.is_alive() and errors == [] and scrapes[0] > 0
    assert got == want
    assert eng.compile_count >= 3 and eng.metrics()["graph_pool_bytes"] > 0


def test_telemetry_off_serves_the_same_streams_and_programs(cuda, tmp_path):
    from deepspeed_tpu_torch.telemetry import validate_trace

    model = _small_gpt2(cuda)
    on = InferenceEngine(model, config=SMALL_SERVE)
    off = InferenceEngine(model, config=dict(SMALL_SERVE, telemetry=False))
    assert _generate(on, _telemetry_prompts()) == \
        _generate(off, _telemetry_prompts())
    assert sorted(on._programs) == sorted(off._programs)
    assert on.compile_count == off.compile_count
    import json
    doc = json.loads(open(on.write_trace(str(tmp_path / "t.json"))).read())
    assert validate_trace(doc) > 0
    steps = [e for e in doc["traceEvents"] if e["name"] == "step/mixed"]
    # One capturing step per key, the capture inside its span.
    assert sum(e["args"]["captured"] for e in steps) == on.compile_count
    assert off.tracer.span_counts() == {}


def test_profile_window_holds_a_decode_kernel(cuda, tmp_path, monkeypatch):
    import json

    from deepspeed_tpu_torch.telemetry import profile_window

    eng = InferenceEngine(_small_gpt2(cuda), config=SMALL_SERVE)
    _generate(eng, _telemetry_prompts())  # captures the keys
    for p in _telemetry_prompts():
        eng.submit(p, max_new_tokens=24)
    eng.step()
    eng.step()
    monkeypatch.setenv("DS_TPU_PROFILE_DIR", str(tmp_path))
    with profile_window("serve") as path:
        for _ in range(3):
            eng.step()
    assert path == str(tmp_path / "serve")
    (trace,) = (tmp_path / "serve").glob("trace.*.json")
    names = [e.get("name", "") for e in
             json.loads(trace.read_text())["traceEvents"]]
    assert "inference/mixed_step" in names
    assert any("decode_split_kernel" in n for n in names)


def test_training_timer_covers_queued_device_work(cuda):
    """A timer's stop synchronizes: its interval holds a device spin
    queued inside it, which the host enqueues in microseconds."""
    from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer

    torch.zeros(1, device=cuda)  # CUDA initialized
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    timers = SynchronizedWallClockTimer()
    timers("spin").start()
    a.record()
    torch.cuda._sleep(100_000_000)
    b.record()
    timers("spin").stop()
    device_s = a.elapsed_time(b) / 1e3
    assert device_s > 0.01
    assert timers("spin").elapsed(reset=False) >= 0.9 * device_s


def test_a_failed_capture_raises(cuda):
    """No fallback: a step program that cannot be captured (here, a host
    sync inside it, legal eagerly) fails the step; it never runs on as an
    eager step. Last in the file: the failed capture is left behind."""
    class Syncing(InferenceEngine):
        def _program(self, *key):
            super()._program(*key)
            self._pool["pos"].sum().item()

    eng = Syncing(_small_gpt2(cuda), config=SMALL_SERVE)
    eng.submit(np.arange(5), max_new_tokens=8)
    with pytest.raises(RuntimeError):
        eng.step()
    assert eng.compile_count == 0
