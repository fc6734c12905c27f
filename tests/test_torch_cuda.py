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
timer that covers queued device work; then the KV hierarchy's prefix
cache and host offload on the card: the tiers on against off, paged int8
against dense int8, the capture/restore round trip on a live pool and a
raise while sessions are swapped out; then several engines on one card,
as the serving fleet runs them: two engines capturing at once on two
threads, a capture beside another engine's swaps and recovery, exact
per-engine launch counts, and the fleet's handoff and prefix-row records
round-tripping on live pools; then ZeRO-Offload: an offload step (also
with stream_gradients) on the card against the same on the CPU, the bf16
parameters as the host op's rounded master, and flash_attention_with_lse's
backward through its lse; then sequence parallelism and 1-bit Adam over
two gloo ranks on cuda:0: ring and Ulysses attention (K1/K2 on each block
with the global lse) against dense attention, the compressed all-reduce
against its numpy reference, a sequence-parallel GPT-2 step against one
process and a 1-bit run against the CPU; activation checkpointing's
bit-equal gradients on the card; and the tooling: the host LUT op's tables
driving K7a/K7b, each training kernel's cost on the card equal to its plain
version's count on the CPU, the x-ray's and the flops profiler's training
step counted alike on the card and the CPU, and the autotuner's sweep (none
inside a graph capture).

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-5, 0.0)),
                                       (torch.bfloat16, (2e-3, 2.0 ** -7))],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["k3_decode", "k5_paged", "k5_lane"])
def test_decode_kernels_at_a_tensor_parallel_rank_shape(cuda, case, dtype,
                                                        tol):
    """K3 and K5 at the shapes a model rank of GPT-2 medium serving over
    mp 2 gives them (8 of the 16 heads): K3 on 16 decode rows at the
    serving plane; K5 on 16 rows through pages of 128, and on the dense
    pool's prefill lane (16 slots' planes as pages of the plane's length,
    the table [[5]], 32 query rows at frontier 500)."""
    from deepspeed_tpu_torch.inference.kv_pool import plane_len_for
    T = plane_len_for(1024, 32)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    H = 8
    if case == "k5_lane":
        B, S, pos = 1, 32, [500]
    else:
        B, S = 16, 1
        pos = [0, 1, 31, 32, 33, 63, 64, 127, 128, 500, 511, 700, 1000,
               1023, T - 2, T - 1]
    q = torch.randn(B, H, S, 64, device=cuda, generator=g).to(dtype)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    if case == "k3_decode":
        k, v = (torch.randn(B, H, T, 64, device=cuda, generator=g).to(dtype)
                for _ in range(2))
        out = da.flash_decode_attention(q, k, v, p)
        ref = da.decode_attention_reference(q, k, v, p)
        kind, dense = "decode", (k, v)
    else:
        if case == "k5_paged":
            page, n_lp = 128, -(-T // 128)
            arena = 1 + B * n_lp
            tbl = (1 + torch.randperm(B * n_lp, device=cuda, generator=g)
                   ).view(B, n_lp).to(torch.int32)
        else:
            page, arena = T, 16
            tbl = torch.tensor([[5]], dtype=torch.int32, device=cuda)
        k, v = (torch.randn(arena, H, page, 64, device=cuda,
                            generator=g).to(dtype) for _ in range(2))
        out = da.flash_decode_attention_paged(q, k, v, tbl, p)
        ref = da.decode_attention_paged_reference(q, k, v, tbl, p)
        kind = "paged"
        dense = (da.gather_pages(k, tbl), da.gather_pages(v, tbl))
        assert torch.equal(out, da.flash_decode_attention(q, *dense, p))
    torch.cuda.synchronize()
    assert da.launches[kind] > 0
    atol, rtol = tol
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * (ref.float().abs() + _spread(q, *dense, p))
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


# The KV hierarchy on the card: SMALL_SERVE with the prefix cache and host
# offload, a stream of HIER_N requests over two shared 24-token system
# prompts (more requests than slots, so sessions swap), every fifth sampled.
HIER = {"prefix_cache": True, "prefix_slots": 4, "prefix_len": 32,
        "min_prefix_len": 4, "host_offload": True, "swap_slots": 4}
HIER_N = 10
HIER_LAYOUTS = {"dense": {}, "int8": {"int8_kv": True},
                "paged_int8_spec": {"paged_kv": True, "kv_page_len": 32,
                                    "int8_kv": True, "spec_decode": True,
                                    "spec_k": 4}}


def _hier_prompts():
    rng = np.random.RandomState(8)
    systems = [rng.randint(0, 1024, size=24) for _ in range(2)]
    return [np.concatenate([systems[i % 2],
                            rng.randint(0, 1024, size=4 + 4 * i)])
            for i in range(HIER_N)]


def _hier_serve(engine, fault_once_swapped=False, roundtrip=None):
    """Serve the hierarchy stream to idle; ``fault_once_swapped`` arms a
    raise once a session is swapped out, ``roundtrip(engine)`` runs once
    every slot is busy and one decodes. Returns the streams, the launches
    and the pool's addresses before."""
    from deepspeed_tpu_torch.inference import Fault, FaultPlan
    addrs = {n: t.data_ptr() for n, t in engine._pool.items()}
    reqs = []
    for i, p in enumerate(_hier_prompts()):
        kw = {"temperature": 0.8, "seed": i, "top_k": 20} if i % 5 == 4 \
            else {}
        reqs.append(engine.submit(p, max_new_tokens=24, **kw))
    da.reset_launches()
    armed = False
    while not engine.idle:
        sched = engine._scheduler
        if fault_once_swapped and sched.swapped and not armed:
            engine.inject_faults(FaultPlan(faults=(Fault("raise",
                                                         step=0),)))
            armed = True
        if roundtrip is not None and \
                len(sched.running) == SMALL_SERVE["max_slots"] and \
                any(r.phase == "decoding" for r in sched.running.values()):
            roundtrip(engine)
            roundtrip = None
        engine.step()
    torch.cuda.synchronize()
    assert all(r.phase == "done" and len(r.tokens) == 24 for r in reqs)
    assert {n: t.data_ptr() for n, t in engine._pool.items()} == addrs
    assert not fault_once_swapped or armed
    return [r.tokens for r in reqs], dict(da.launches)


def _exact_launches(engine, launches):
    """K3-K6 launches: n_layer per decode step of the decode lane's kernel
    and per prefill lane of the lane's (hits, swaps and restores launch
    none)."""
    m = engine.metrics()
    paged, int8 = engine._pager is not None, "k_scale" in engine._pool
    kernel = {(False, False): "decode", (False, True): "q8",
              (True, False): "paged", (True, True): "paged_q8"}[paged, int8]
    lane = "paged_q8" if int8 else "paged"
    want = dict.fromkeys(launches, 0)
    n_layer = engine._params.config.n_layer
    want[kernel] += n_layer * m["decode_steps"]
    want[lane] += n_layer * m["prefill_lanes"]
    assert launches == want


@pytest.mark.parametrize("layout", sorted(HIER_LAYOUTS))
def test_hierarchy_streams_equal_the_tiers_off(cuda, layout):
    """(i): the tiers on against off on the same layout: the same streams,
    hits and swaps fired, exact launches with fewer prefill lanes, no key
    added, no pool tensor rebound, every page returned but the stored
    prefix rows'."""
    model = _small_gpt2(cuda)
    config = dict(SMALL_SERVE, **HIER_LAYOUTS[layout])
    off = InferenceEngine(model, config=config)
    want, _ = _hier_serve(off)
    on = InferenceEngine(model, config=dict(config, **HIER))
    got, launches = _hier_serve(on)
    assert got == want
    m = on.metrics()
    assert min(m["prefix_hits"], m["prefix_inserts"], m["swap_outs"],
               m["swap_ins"]) >= 1
    _exact_launches(on, launches)
    assert m["prefill_lanes"] < off.metrics()["prefill_lanes"]
    assert m["graph_replays"] == m["chunks"] - m["compile_count"] and \
        m["compile_count"] <= 8
    if on._pager is not None:
        pages = sum(len(p) for p, _ in on._hier.store.payload.values())
        assert on.kv_page_stats()["pages_in_use"] == pages


def test_paged_int8_hierarchy_equals_dense_int8(cuda):
    """(ii): paged int8 + prefix + offload + speculation against dense int8
    with the same tiers, token for token (K6 equals K4 on the gathered
    plane)."""
    model = _small_gpt2(cuda)
    paged = HIER_LAYOUTS["paged_int8_spec"]
    dense = {k: v for k, v in paged.items()
             if k not in ("paged_kv", "kv_page_len")}
    got, _ = _hier_serve(InferenceEngine(model, config=dict(
        SMALL_SERVE, **HIER, **paged)))
    want, _ = _hier_serve(InferenceEngine(model, config=dict(
        SMALL_SERVE, **HIER, **dense)))
    assert got == want


@pytest.mark.parametrize("layout", ["dense", "paged_int8_spec"])
def test_capture_restore_is_byte_exact_on_the_card(cuda, layout):
    """(iii): on a running engine's own pool, capture a decoding slot,
    scribble over its footprint, restore in place: the whole pool equals
    a copy taken before, byte for byte; the run then ends in the streams
    of an engine never touched."""
    from deepspeed_tpu_torch.inference.kv_hierarchy import (
        capture_slot, capture_slot_paged, restore_slot, restore_slot_paged)
    model = _small_gpt2(cuda)
    config = dict(SMALL_SERVE, **HIER, **HIER_LAYOUTS[layout])
    checked = []

    def roundtrip(engine):
        pool = engine._pool
        req = next(r for r in engine._scheduler.running.values()
                   if r.phase == "decoding")
        slot = req.slot
        pages = engine._pager.row_pages(slot) if engine._pager else None
        before = {n: t.clone() for n, t in pool.items()}
        rec = capture_slot(pool, slot) if pages is None else \
            capture_slot_paged(pool, slot, pages)
        assert all(not v.is_cuda and v.is_pinned() for v in rec.values())
        at = slot if pages is None else pages
        for name in ("k", "v", "k_scale", "v_scale"):
            if name in pool:
                pool[name][:, at] = 3
        for name in ("pos", "last_tok", "active", "remaining", "toks"):
            if name in pool:
                pool[name][slot] = 0
        if pages is None:
            restore_slot(pool, slot, rec)
        else:
            restore_slot_paged(pool, slot, rec, pages)
        torch.cuda.synchronize()
        checked.append([n for n, t in pool.items()
                        if not torch.equal(t, before[n])])

    got, _ = _hier_serve(InferenceEngine(model, config=config),
                         roundtrip=roundtrip)
    assert checked == [[]]
    want, _ = _hier_serve(InferenceEngine(model, config=config))
    assert got == want


def test_raise_while_swapped_replays_the_streams(cuda):
    """(iv): a raise fault while sessions are swapped out: recovery resets
    the pool in place and replays every session, the swapped ones
    included; the streams equal the fault-free run's, no request is lost,
    compile_count does not move, no key is met anew."""
    model = _small_gpt2(cuda)
    engine = InferenceEngine(model, config=dict(SMALL_SERVE, **HIER,
                                                fault_injection=True))
    want, _ = _hier_serve(engine)
    engine.recompile_detector.mark_warm()
    programs = engine.compile_count
    got, _ = _hier_serve(engine, fault_once_swapped=True)
    assert got == want
    m = engine.metrics()
    assert len(engine.recovery_log) == 1 and m["recoveries"] == 1
    assert engine.compile_count == programs and m["recompiles"] == 0
    assert engine.health == "healthy"


# Several engines on one card (the serving fleet's replicas): each steps
# on its own thread and its own stream, captures under the process-wide
# lock, and counts its own decode-kernel launches.


def _serve_on_thread(engine, prompts, barrier=None, out=None, key=None):
    """Serve ``prompts`` on ``engine`` (greedy, one sampled) to idle after
    ``barrier``; record the harvest of every step and the streams."""
    reqs = [engine.submit(p, max_new_tokens=24, **(
        {"temperature": 0.8, "seed": 4} if i == 1 else {}))
        for i, p in enumerate(prompts)]
    if barrier is not None:
        barrier.wait()
    snaps = []
    while not engine.idle:
        engine.step()
        snaps.append(engine._last_snap)
    result = (snaps, [r.tokens for r in reqs])
    if out is not None:
        out[key] = result
    return result


def _run_threads(targets):
    import threading
    threads = [threading.Thread(target=t) for t in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300.0)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("extra", [
    {}, {"paged_kv": True, "kv_page_len": 32, "int8_kv": True}],
    ids=["dense", "paged_int8"])
def test_two_engines_capture_at_once_on_two_threads(cuda, extra):
    """Two fresh engines step on two threads from one barrier, so their
    first steps (eager runs and captures of each key) meet: each captures
    on its own stream under the capture lock, and each engine's every
    step's harvest equals the same program run eagerly, bit for bit; each
    engine's own launch counts equal the eager run's, and the process
    counts their sum."""
    import threading
    model = _small_gpt2(cuda)
    config = dict(SMALL_SERVE, **extra)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 1024, size=n) for n in (5, 40, 17, 70)]
    eager = _EagerEngine(model, config=config)
    want, want_tokens = _serve_on_thread(eager, prompts)
    engines = [InferenceEngine(model, config=config) for _ in range(2)]
    assert engines[0]._stream != engines[1]._stream
    barrier, out = threading.Barrier(2), {}
    da.reset_launches()
    _run_threads([lambda e=e, i=i: _serve_on_thread(
        e, prompts, barrier, out, i) for i, e in enumerate(engines)])
    torch.cuda.synchronize()
    for i, eng in enumerate(engines):
        got, tokens = out[i]
        assert tokens == want_tokens and len(got) == len(want)
        for a, b in zip(got, want):
            for name in a:
                assert np.array_equal(a[name], b[name]), (i, name)
        assert eng.launches == eager.launches
        m = eng.metrics()
        assert 0 < m["compile_count"] <= 8
        assert m["graph_replays"] == len(got) - m["compile_count"]
    assert da.launches == {k: 2 * n for k, n in eager.launches.items()}


def test_capture_beside_swap_out_and_recovery(cuda):
    """One engine captures its keys for the first time on one thread while
    another, on a second thread, swaps sessions out and in and recovers
    from a raise once one is swapped: both engines' streams equal their
    lone runs, the recovering engine captures nothing new, and no pool
    tensor of either moves."""
    import threading
    from deepspeed_tpu_torch.inference import Fault, FaultPlan
    model = _small_gpt2(cuda)
    hier_cfg = dict(SMALL_SERVE, **HIER, fault_injection=True)
    lone_hier, _ = _hier_serve(InferenceEngine(model, config=hier_cfg))
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 1024, size=n) for n in (9, 33, 60)]
    _, lone = _serve_on_thread(InferenceEngine(model, config=SMALL_SERVE),
                               prompts)
    hier = InferenceEngine(model, config=hier_cfg)
    _hier_serve(hier)  # warm: every key met and captured
    hier.recompile_detector.mark_warm()
    programs = hier.compile_count
    fresh = InferenceEngine(model, config=SMALL_SERVE)
    addrs = [{n: t.data_ptr() for n, t in e._pool.items()}
             for e in (hier, fresh)]
    barrier, out = threading.Barrier(2), {}

    def recovering():
        reqs = [hier.submit(p, max_new_tokens=24, **(
            {"temperature": 0.8, "seed": i, "top_k": 20} if i % 5 == 4
            else {})) for i, p in enumerate(_hier_prompts())]
        barrier.wait()
        armed = False
        while not hier.idle:
            if hier._scheduler.swapped and not armed:
                hier.inject_faults(FaultPlan(faults=(Fault("raise",
                                                           step=0),)))
                armed = True
            hier.step()
        out["hier"] = ([r.tokens for r in reqs], armed)

    _run_threads([recovering, lambda: _serve_on_thread(
        fresh, prompts, barrier, out, "fresh")])
    tokens, armed = out["hier"]
    assert armed and tokens == lone_hier
    assert out["fresh"][1] == lone
    m = hier.metrics()
    assert m["recoveries"] == 1 and m["recompiles"] == 0
    assert hier.compile_count == programs and hier.health == "healthy"
    assert fresh.compile_count > 0
    assert [{n: t.data_ptr() for n, t in e._pool.items()}
            for e in (hier, fresh)] == addrs


@pytest.mark.parametrize("layout", ["dense_bf16", "paged_int8"])
def test_handoff_and_prefix_records_round_trip_on_the_card(cuda, layout):
    """A step's handoff capture (every decoding slot in one
    ``capture_slots`` call, pinned host records), scribbled over and
    restored in place, and a prefix row (dense) or its pages (paged)
    captured and written back: the live pool byte for byte. Then a
    prefill replica hands its streams to a decode replica on the same
    card: the streams equal a lone engine's."""
    from deepspeed_tpu_torch.inference import ServingFleet
    from deepspeed_tpu_torch.inference.kv_hierarchy import (
        capture_prefix_pages, capture_prefix_row, capture_slots,
        capture_slots_paged, restore_prefix_pages, restore_prefix_row,
        restore_slot, restore_slot_paged)
    model = _small_gpt2(cuda)
    extra = {} if layout == "dense_bf16" else {
        "paged_kv": True, "kv_page_len": 32, "int8_kv": True}
    config = dict(SMALL_SERVE, **HIER, **extra)
    checked = []

    def roundtrip(engine):
        pool, pager = engine._pool, engine._pager
        slots = [r.slot for r in engine._scheduler.running.values()
                 if r.phase == "decoding"]
        before = {n: t.clone() for n, t in pool.items()}
        recs = capture_slots(pool, slots) if pager is None else \
            capture_slots_paged(pool, slots,
                                [pager.row_pages(s) for s in slots])
        assert all(not v.is_cuda and v.is_pinned()
                   for rec in recs for v in rec.values())
        for slot in slots:
            at = slot if pager is None else pager.row_pages(slot)
            for name in ("k", "v", "k_scale", "v_scale"):
                if name in pool:
                    pool[name][:, at] = 3
            for name in ("pos", "last_tok", "active", "remaining"):
                pool[name][slot] = 0
        for slot, rec in zip(slots, recs):
            if pager is None:
                restore_slot(pool, slot, rec)
            else:
                restore_slot_paged(pool, slot, rec, pager.row_pages(slot))
        store = engine._hier.store
        row = next(iter(store.tokens))
        if pager is None:
            prec = capture_prefix_row(pool, row, 24)
            pool["pk"][:, row, :, :24] = 3
            restore_prefix_row(pool, row, prec)
        else:
            pages, span = store.payload[row]
            n = -(-span // pager.page_len)
            # The whole of the row's pages, so the restore rewrites each
            # position it scribbled over.
            prec = capture_prefix_pages(pool, pages[:n],
                                        n * pager.page_len)
            assert prec["pk"].dtype == torch.int8
            for name in ("k", "v", "k_scale", "v_scale"):
                pool[name][:, list(pages[:n])] = 3
            restore_prefix_pages(pool, pages[:n], prec)
        torch.cuda.synchronize()
        checked.append([n for n, t in pool.items()
                        if not torch.equal(t, before[n])])

    got, _ = _hier_serve(InferenceEngine(model, config=config),
                         roundtrip=roundtrip)
    assert checked == [[]]
    want, _ = _hier_serve(InferenceEngine(model, config=config))
    assert got == want
    # The handoff itself, prefill replica -> decode replica.
    fleet = ServingFleet(model, n_replicas=2, config=config,
                         roles=("prefill", "decode"), start=False)
    try:
        frs = [fleet.submit(p, max_new_tokens=24, **(
            {"temperature": 0.8, "seed": i, "top_k": 20} if i % 5 == 4
            else {})) for i, p in enumerate(_hier_prompts())]
        assert fleet.wait_idle(timeout_s=120.0)
        assert [fr.tokens for fr in frs] == want
        m = fleet.metrics()["fleet"]
        assert m["handoffs"] == m["handoffs_in"] > 0
        assert m["handoff_fallbacks"] == 0
        assert fleet.replicas[1].engine.metrics()["prefill_lanes"] == 0
    finally:
        fleet.close()


def test_a_failed_capture_raises(cuda):
    """No fallback: a step program that cannot be captured (here, a host
    sync inside it, legal eagerly) never runs on as an eager step. The
    capture's CUDA error is a fatal step error where torch raises it as
    ``torch.AcceleratorError``: the step recovers, and a later step meets
    the key again and fails again, until the retries are spent or the
    device cannot be reset and the engine is dead (EngineDeadError, a
    RuntimeError); where torch raises a bare RuntimeError, the first step
    raises it. Either way no graph is kept and the caller's stream is
    current again. Last in the
    file: the failed capture is left behind."""
    class Syncing(InferenceEngine):
        def _program(self, *key):
            super()._program(*key)
            self._pool["pos"].sum().item()

    eng = Syncing(_small_gpt2(cuda), config=SMALL_SERVE)
    eng.submit(np.arange(5), max_new_tokens=8)
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        eng.run(max_steps=10)
    assert eng.compile_count == 0
    assert torch.cuda.current_stream() == stream
    # recovery_max_retries is 2 by default; a capture error the drain
    # cannot clear ends the engine before the retries are spent.
    assert len(eng.recovery_log) <= 2


# -------------------------------------- the front door, adapters, x-ray


def _small_moe(cuda):
    from deepspeed_tpu_torch.inference.adapters import MoEAdapter
    a = MoEAdapter.from_config(vocab_size=1024, n_layer=2, n_head=4,
                               n_embd=256, n_positions=256, n_experts=4,
                               d_ff=512, dtype=torch.bfloat16)
    return a, a.init_params(seed=0, device=cuda)


def _adapter_engines(cuda, kind):
    """(graph-served, eager) engines of ``kind`` on SMALL_SERVE."""
    from deepspeed_tpu_torch.inference.adapters import LongContextAdapter
    if kind == "moe":
        adapter, weights = _small_moe(cuda)
        return [cls(None, weights, config=dict(SMALL_SERVE), adapter=adapter)
                for cls in (InferenceEngine, _EagerEngine)]
    model = _small_gpt2(cuda)
    adapter = LongContextAdapter.from_model(model, threshold=64, block=16,
                                            num_local_blocks=2)
    return [cls(model, config=dict(SMALL_SERVE), adapter=adapter)
            for cls in (InferenceEngine, _EagerEngine)]


@pytest.mark.parametrize("kind", ["moe", "longcontext"])
def test_adapter_engine_graph_equals_eager(cuda, kind):
    """The MoE and long-context engines served from captured graphs equal
    their eager programs: every harvest (the MoE counters too) and the
    whole pool, bit for bit; neither launches K3-K6."""
    graphed, eager = _adapter_engines(cuda, kind)
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, 1024, size=n) for n in (5, 40, 17, 70, 9, 33)]
    got, got_launches = _serve(graphed, prompts)
    want, want_launches = _serve(eager, prompts)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for name in a:
            assert np.array_equal(a[name], b[name]), name
    for name, t in graphed._pool.items():
        assert torch.equal(t, eager._pool[name]), name
    assert sum(got_launches.values()) == sum(want_launches.values()) == 0
    assert graphed.metrics()["graph_replays"] > 0
    if kind == "moe":
        reg = graphed.telemetry
        assert reg.gauge("moe_tokens_dropped").value == 0.0
        assert reg.gauge("moe_tokens_routed").value > 0


def test_frontdoor_over_a_fleet_captures_nothing_after_warmup(cuda):
    """Two warm replicas behind a FrontDoor: a mixed interactive/batch
    load completes, every stream equals one engine's, and no replica
    captures a program after mark_warm()."""
    from deepspeed_tpu_torch.inference import (FrontDoor, FrontDoorConfig,
                                               PriorityClass, ServingFleet)
    model = _small_gpt2(cuda)
    config = dict(SMALL_SERVE, host_offload=True, swap_slots=4)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 1024, size=n) for n in (5, 40, 17, 70, 9, 33)]
    single = InferenceEngine(model, config=config)
    want = [single.submit(p, max_new_tokens=24) for p in prompts]
    single.run()
    fleet = ServingFleet(model, n_replicas=2, config=config, start=False)
    try:
        for rep in fleet.replicas:
            rep.engine.generate([prompts[1]], max_new_tokens=24)
            rep.engine.recompile_detector.mark_warm()
        keys = [sorted(rep.engine._programs) for rep in fleet.replicas]
        fd = FrontDoor(fleet, FrontDoorConfig(classes=(
            PriorityClass("interactive", ttft_budget_ms=60_000.0),
            PriorityClass("batch", preemptible=True))))
        hs = [fd.submit(p, max_new_tokens=24,
                        priority=("interactive", "batch")[i % 2])
              for i, p in enumerate(prompts)]
        assert fd.wait_idle(timeout_s=120.0)
        assert [h.tokens for h in hs] == [r.tokens for r in want]
        assert [sorted(rep.engine._programs)
                for rep in fleet.replicas] == keys
        assert all(rep.engine.recompile_detector.recompiles.value == 0
                   for rep in fleet.replicas)
    finally:
        fleet.close()


def test_perf_xray_on_a_small_engine(cuda):
    """perf_xray() on the card: a record per key met with flops > 0 (the
    decode kernels' formula included), bytes and graph-pool bytes; MFU and
    MBU of sampled records in (0, 1]; streams equal an x-ray-off engine's;
    no recompile after mark_warm()."""
    model = _small_gpt2(cuda)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(0, 1024, size=n) for n in (5, 40, 17, 70)]
    on = InferenceEngine(model, config=dict(SMALL_SERVE, perf_xray=True,
                                            xray_sample_every=2))
    off = InferenceEngine(model, config=dict(SMALL_SERVE))
    got, _ = _serve(on, prompts)
    want, _ = _serve(off, prompts)
    for a, b in zip(got, want):
        for name in a:
            assert np.array_equal(a[name], b[name]), name
    on.recompile_detector.mark_warm()
    _serve(on, prompts)
    sec = on.perf_xray()
    assert len(sec["programs"]) == on.compile_count
    for p in sec["programs"]:
        assert p["flops"] > 0 and p["kernel_flops"] > 0
        assert p["bytes_accessed"] > 0 and p["graph_pool_bytes"] > 0
        if p["mfu"] is not None:
            assert 0 < p["mfu"] <= 1 and 0 < p["mbu"] <= 1
    assert any(p["mfu"] is not None for p in sec["programs"])
    assert sec["platform"] == "cuda" and sec["hbm"]["live_bytes"] > 0
    assert on.metrics()["recompiles"] == 0
    assert off.perf_xray() is None


# ------------------------------------------------- ZeRO-Offload (slice 14)

def _offload_pair(cuda, config, steps=1):
    """A 2-layer fp32 GPT-2 (width 256) trained ``steps`` steps on the card
    and on the CPU from the same weights: (loss, masters) per device, the
    fp32 masters read from the host state."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    cfg = GPT2Config(n_embd=256, n_layer=2, n_head=4, vocab_size=512,
                     n_positions=128, dtype=torch.float32, dropout=0.0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 512, size=(2, 128)))
    cpu_model = GPT2LMHeadModel(cfg, device="cpu", seed=1)
    out = []
    for device in (cuda, torch.device("cpu")):
        model = cpu_model if device.type == "cpu" else \
            GPT2LMHeadModel(cfg, device=device, seed=None)
        if device.type == "cuda":
            model.load_state_dict(cpu_model.state_dict())
        engine = initialize(model=model, config_params=config,
                            device=device)[0]
        for _ in range(steps):
            loss = engine(ids, ids)
            engine.backward(loss)
            if config["zero_optimization"].get("stream_gradients"):
                assert all(p.grad is None for p in engine._params)
            engine.step()
        assert engine.offload_timing()["chunks"] >= 1
        out.append((float(loss), engine._offload.master.clone(),
                    [p.detach().cpu() for p in engine._params],
                    engine._offload.views(engine._offload.master)))
    return out


def _offload_config(**zero):
    return {"train_batch_size": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                     "eps": 1e-3}},
            "zero_optimization": dict({"stage": 0, "cpu_offload": True},
                                      **zero)}


@pytest.mark.parametrize("stream", [False, True])
def test_offload_step_card_vs_cpu(cuda, stream):
    """Two offload steps (fp32 masters; eps 1e-3 keeps Adam's update
    Lipschitz in the gradient): losses within 1e-5 relative, masters within
    1e-3 lr per step of each other; the card's parameters are its master.
    Streamed: no gradient stays on the card after a backward."""
    (lc, mc, pc, vc), (lh, mh, _, _) = _offload_pair(
        cuda, _offload_config(stream_gradients=stream), steps=2)
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    assert float((mc - mh).abs().max()) <= 2 * 1e-3 * 1e-3 + \
        2.0 ** -22 * float(mh.abs().max())
    for p, v in zip(pc, vc):
        assert torch.equal(p, v)


def test_offload_bf16_parameters_are_the_rounded_master(cuda):
    """bf16: the device parameters after a step are the C++ op's fused
    bf16 copy of the master, equal to torch's rounding of it."""
    cfg = dict(_offload_config(stage=2), bf16={"enabled": True})
    (lc, mc, pc, vc), (lh, _, ph, _) = _offload_pair(cuda, cfg, steps=2)
    assert abs(lc - lh) <= 2.0 ** -8 * abs(lh)
    for p, v in zip(pc, vc):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, v.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_flash_attention_with_lse_backward(cuda, dtype):
    """The lse's gradient through K2 (delta = rowsum(dO * O) - dlse)
    against the plain backward with the same lse and delta, and in fp32
    against autograd through the dense reference."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 256, 64, device=cuda, generator=g)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn(2, 4, 256, 1, device=cuda, generator=g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(at.launches)
    o, lse = at.flash_attention_with_lse(*leaves, causal=True)
    grads = torch.autograd.grad((o, lse), leaves, (do, dlse))
    assert at.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert at.launches["flash_bwd_fused"] + at.launches["flash_bwd_split"] \
        > before["flash_bwd_fused"] + before["flash_bwd_split"]
    delta = (do.float() * o.detach().float()).sum(-1, keepdim=True) - dlse
    refs = at.flash_bwd_reference(q, k, v, None, lse.detach(), delta, do,
                                  True)
    mags = at.accumulated_magnitudes(q, k, v, None, lse.detach(), delta, do,
                                     True)
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for got, ref, mag in zip(grads, refs, mags[1:]):
        limit = rtol * ref.float().abs() + 2.0 ** -14 * mag
        assert bool(((got.float() - ref.float()).abs() <= limit).all())
    if dtype == torch.float32:
        ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ro, rl = at.mha_reference(*ref_leaves, causal=True, return_lse=True)
        want = torch.autograd.grad((ro, rl), ref_leaves, (do, dlse))
        for got, w in zip(grads, want):
            torch.testing.assert_close(got, w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()))


# ------------------------------------------------ data-parallel ZeRO


@pytest.mark.parametrize("stage", [0, 2, 3])
def test_two_rank_gloo_zero_step_on_the_card(cuda, tmp_path, stage):
    """Two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device), started by the port's launcher (tests/torch_dist_worker.py),
    a 2-layer GPT-2 of width 128 (head width 64, the kernels') at fp32
    compute, gas 2: every micro-step's group-mean loss
    within 1e-5 relative of one process on the whole batch on the card,
    the masters within 1e-5 of each tensor's max-abs, K1 and K2a launched
    n_layer times per micro-step on each rank."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from tests.torch_dist_worker import run_ranks

    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
           "steps_per_print": 1000, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2,
                                                     "eps": 1e-3}},
           "zero_optimization": {"stage": stage}}
    width = dict(n_embd=128, n_layer=2, n_head=2, vocab_size=1024,
                 n_positions=128, dropout=0.0)
    model = GPT2LMHeadModel(GPT2Config(dtype=torch.float32, **width),
                            device="cpu", seed=0)
    params = {}
    for name, p in model.named_parameters():
        node = params
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().numpy().copy()
    batches = [(b, b) for b in (np.random.RandomState(s).randint(
        0, 1024, size=(4, 32)) for s in range(4))]
    ranks = run_ranks(2, [dict(name="dp", kind="train", model="gpt2",
                               gpt2_cfg=width, device="cuda:0",
                               params=params, config=cfg, fp32_compute=True,
                               batches=batches)], str(tmp_path / "w"))
    engine = tds.initialize(model=GPT2LMHeadModel(
        GPT2Config(dtype=torch.float32, **width), device=cuda, seed=None),
        model_parameters=params, config_params=cfg, device=cuda)[0]
    engine.compute_dtype = torch.float32
    want = []
    for ids, _ in batches:
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        want.append(float(loss.detach()))
    for r in ranks:
        got = r["dp"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert got["launches"]["flash_fwd"] == 2 * len(batches)
        assert got["launches"]["flash_bwd_fused"] == 2 * len(batches)
        for name, p in zip(engine._names, engine._params):
            w = p.detach().float().cpu().numpy()
            np.testing.assert_allclose(got["masters"][name], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


# ------------------------------------------------ model parallelism


_MP_WIDTH = dict(n_embd=128, n_layer=2, n_head=2, vocab_size=1024,
                 n_positions=128, dropout=0.0)
_MP_CONFIG = {"train_batch_size": 4, "steps_per_print": 1000,
              "gradient_clipping": 0.1,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-2,
                                                        "eps": 1e-3}}}


def _mp_params():
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.runtime.utils import flax_tree

    return flax_tree(GPT2LMHeadModel(GPT2Config(dtype=torch.float32,
                                                **_MP_WIDTH),
                                     device="cpu", seed=0))


def _mp_reference(cuda, params, batches, gas):
    """One process on the card: a step per ``gas`` micro-batches; the
    steps' mean losses and the fp32 masters by name."""
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel

    engine = tds.initialize(model=GPT2LMHeadModel(
        GPT2Config(dtype=torch.float32, **_MP_WIDTH), device=cuda,
        seed=None), model_parameters=params, device=cuda,
        config_params=dict(_MP_CONFIG, gradient_accumulation_steps=gas))[0]
    losses = []
    for i in range(0, len(batches), gas):
        micro = []
        for ids, _ in batches[i:i + gas]:
            loss = engine(ids, ids)
            engine.backward(loss)
            engine.step()
            micro.append(float(loss.detach()))
        losses.append(float(np.mean(micro)))
    return losses, {n: p.detach().float().cpu().numpy()
                    for n, p in zip(engine._names, engine._params)}


def _masters_held(got, want):
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_two_rank_gloo_tensor_parallel_step_on_the_card(cuda, tmp_path):
    """Tensor parallelism over two ranks on cuda:0 over gloo (mp 2: one of
    the 2 heads per rank, K1/K2a on the local head), started by the port's
    launcher: every step's loss within 1e-5 relative of one process on the
    card, the gathered masters within 1e-5 of each tensor's max-abs, K1
    and K2a n_layer times a step on each rank."""
    from tests.torch_dist_worker import run_ranks

    params = _mp_params()
    batches = [(b, b) for b in (np.random.RandomState(s).randint(
        0, 1024, size=(4, 32)) for s in range(4))]
    ranks = run_ranks(2, [dict(name="tp", kind="tp", mp=2,
                               gpt2_cfg=_MP_WIDTH, device="cuda:0",
                               params=params, config=_MP_CONFIG,
                               batches=batches)], str(tmp_path / "w"))
    want, masters = _mp_reference(cuda, params, batches, 1)
    for r in ranks:
        got = r["tp"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert got["launches"]["flash_fwd"] == 2 * len(batches)
        assert got["launches"]["flash_bwd_fused"] == 2 * len(batches)
        _masters_held(got["masters"], masters)


def test_two_rank_gloo_pipeline_step_on_the_card(cuda, tmp_path):
    """The 1F1B pipeline over two ranks on cuda:0 over gloo (2 stages of
    the tied ``gpt2_pipeline``, gas 2, p2p staged through the host):
    every step's loss within 1e-5 relative of one process training the
    same weights on the card, every layer's weights within 1e-5 of each
    tensor's max-abs (the tied head's copy equal to the embedding's), K1
    and K2a once per block and micro-batch on each stage."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, \
        gpt2_layer_params
    from tests.torch_dist_worker import run_ranks

    params = _mp_params()
    cfg = GPT2Config(dtype=torch.float32, **_MP_WIDTH)
    batches = [(b, b) for b in (np.random.RandomState(s).randint(
        0, 1024, size=(2, 32)) for s in range(4))]
    ranks = run_ranks(2, [dict(
        name="pp", kind="pipe", layers="gpt2", gpt2_cfg=_MP_WIDTH,
        stages=2, device="cuda:0", steps=2,
        params=gpt2_layer_params(params, cfg),
        config=dict(_MP_CONFIG, gradient_accumulation_steps=2),
        batches=batches)], str(tmp_path / "w"))
    want, masters = _mp_reference(cuda, params, batches, 2)
    layers = {}
    for r in ranks:
        np.testing.assert_allclose(r["pp"]["losses"], want, rtol=1e-5)
        assert r["pp"]["launches"]["flash_fwd"] == 1 * len(batches)
        assert r["pp"]["launches"]["flash_bwd_fused"] == 1 * len(batches)
        layers.update(r["pp"]["layers"])
    got = {"wte": layers[0]["wte"], "wpe": layers[0]["wpe"],
           "ln_f.scale": layers[3]["ln_f"]["scale"],
           "ln_f.bias": layers[3]["ln_f"]["bias"]}
    for i in range(2):
        blk = layers[1 + i]["Block_0"]
        for a in ("ln_1", "ln_2"):
            for k in ("scale", "bias"):
                got["h_{}.{}.{}".format(i, a, k)] = blk[a][k]
        for a, b in (("attn", "c_attn"), ("attn", "c_proj"),
                     ("mlp", "c_fc"), ("mlp", "c_proj")):
            for k in ("kernel", "bias"):
                got["h_{}.{}.{}.{}".format(i, a, b, k)] = blk[a][b][k]
    np.testing.assert_array_equal(layers[4]["wte"], layers[0]["wte"])
    _masters_held(got, masters)


def test_two_rank_gloo_compiled_pipeline_on_the_card(cuda, tmp_path):
    """The compiled pipeline over two ranks on cuda:0 over gloo (2 stages
    of the untied ``gpt2_pipeline``, one block a stage, gas 2): its tick
    programs captured once each (the training forward and the backward)
    and replayed after, every step's loss within the JAX tests' rtol 2e-4
    of the interpreter's on the same ranks, K1 twice (the tick and its
    recompute) and K2a once per block and micro-batch."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config
    from tests.torch_dist_worker import run_ranks

    params = _mp_params()
    cfg = GPT2Config(dtype=torch.float32, **_MP_WIDTH)
    untied = [{"wte": params["wte"], "wpe": params["wpe"]}] + \
        [{"Block_0": params["h_{}".format(i)]} for i in range(cfg.n_layer)] \
        + [{"ln_f": params["ln_f"], "lm_head": params["wte"]}]
    batches = [(b, b) for b in (np.random.RandomState(s).randint(
        0, 1024, size=(2, 32)) for s in range(8))]
    task = dict(kind="pipe", layers="gpt2", gpt2_cfg=_MP_WIDTH, stages=2,
                device="cuda:0", steps=4, params=untied, tied=False,
                config=dict(_MP_CONFIG, gradient_accumulation_steps=2),
                batches=batches)
    ranks = run_ranks(2, [dict(task, name="cp", compiled=True),
                          dict(task, name="pp")], str(tmp_path / "w"))
    for r in ranks:
        np.testing.assert_allclose(r["cp"]["losses"], r["pp"]["losses"],
                                   rtol=2e-4)
        assert r["cp"]["launches"]["flash_fwd"] == 2 * len(batches)
        assert r["cp"]["launches"]["flash_bwd_fused"] == len(batches)
        assert r["cp"]["graphs"] == (2, 2 * len(batches) - 2)


def test_compiled_pipeline_dropout_graphs_equal_eager_on_the_card(cuda):
    """One stage of the untied ``gpt2_pipeline(compiled=True)`` at dropout
    0.1 (GPT2Config's default), gas 2, under K2b: its tick graphs (two
    captures, then replays) against the same engine run eagerly, every
    loss and parameter bit for bit over 3 steps. Each tick draws fresh
    seeds, so graphs that replayed their capture's masks would part from
    eager."""
    import os

    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_pipeline

    cfg = GPT2Config(dtype=torch.float32, **dict(_MP_WIDTH, dropout=0.1))
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 1024, size=(4, 32))).to(cuda)
    micro = [(ids[:2], ids[:2]), (ids[2:], ids[2:])]
    runs = []
    os.environ["DS_TPU_FLASH_BWD"] = "split"
    try:
        for graphs in (True, False):
            engine = tds.initialize(
                model=gpt2_pipeline(cfg, num_stages=1, tied=False,
                                    compiled=True),
                device="cuda", config_params=dict(
                    _MP_CONFIG, gradient_accumulation_steps=2))[0]
            engine._graphs = graphs
            losses = [engine.train_batch(data_iter=iter(micro))
                      for _ in range(3)]
            runs.append((losses, [p.detach().clone() for p in
                                  engine._params],
                         engine.graph_captures, engine.graph_replays))
    finally:
        del os.environ["DS_TPU_FLASH_BWD"]
    (lg, pg, cg, rg), (le, pe, ce, re_) = runs
    assert lg == le
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))
    assert (cg, rg, ce, re_) == (2, 3 * 2 * 2 - 2, 0, 0)


def _ring_inputs(T, seed, H=4):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(2, H, T, 64).astype(np.float32)
                   for _ in range(4))
    mask = np.where(rng.rand(2, T) > 0.2, 0.0, -1e9).astype(np.float32)
    mask[:, 0] = 0.0
    return q, k, v, do, mask


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_two_rank_gloo_ring_and_ulysses_on_the_card(cuda, tmp_path, dtype,
                                                    tol):
    """Ring and Ulysses attention over two ranks on cuda:0 over gloo, their
    blocks on K1 and K2 fed the global lse and delta: the gathered output
    and dq, dk, dv within ``tol`` of each tensor's max-abs of autograd
    through the plain dense attention (fp32 on the CPU, from the same
    inputs rounded to ``dtype``), and the launches of the schedule: the
    causal ring's rank 0 runs one block a call, rank 1 two; the full ring
    two on each; Ulysses one."""
    from deepspeed_tpu_torch.ops.transformer.kernels.attention import (
        mha_reference)
    from tests.torch_dist_worker import run_ranks

    cases = []
    for i, (mode, causal, masked, T) in enumerate((
            ("ring", True, False, 256), ("ring", False, True, 200),
            ("ulysses", True, False, 256), ("ulysses", False, True, 256))):
        q, k, v, do, mask = _ring_inputs(T, i)
        cases.append(dict(name=str(i), mode=mode, causal=causal, sp=2, q=q,
                          k=k, v=v, do=do, mask=mask if masked else None))
    ranks = run_ranks(2, [dict(name="r", kind="ring", cases=cases,
                               device="cuda:0", dtype=dtype)],
                      str(tmp_path / "w"))
    rounded = getattr(torch, dtype)
    for c in cases:
        leaves = [torch.from_numpy(c[n]).to(rounded).float().requires_grad_()
                  for n in ("q", "k", "v")]
        mask = None if c["mask"] is None else torch.from_numpy(c["mask"])
        ref = mha_reference(*leaves, mask=mask, causal=c["causal"])
        want = [ref] + list(torch.autograd.grad(ref, leaves, torch.from_numpy(
            c["do"]).to(rounded).float()))
        T = c["q"].shape[2]
        for r in ranks:
            got = r["r"][c["name"]]
            sl = slice(got["sp_rank"] * T // 2, (got["sp_rank"] + 1) * T // 2)
            for g, w in zip([got["o"]] + got["grads"], want):
                w = w.detach().numpy()[:, :, sl]
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=tol * np.abs(w).max())
            n = got["launches"]
            blocks = 1 if c["mode"] == "ulysses" else \
                (got["sp_rank"] + 1 if c["causal"] else 2)
            assert n["flash_fwd"] == blocks
            assert n["flash_bwd_fused"] + n["flash_bwd_split"] // 2 == blocks


def _numpy_compressed(buffers, werr, serr):
    """The reference exchange for W workers (numpy)."""
    w, n = buffers.shape
    chunk = n // w
    comp = buffers + werr
    scales = np.linalg.norm(comp, axis=1) / np.sqrt(n)
    signs = np.where(comp >= 0, 1.0, -1.0)
    new_we = comp - scales[:, None] * signs
    out, new_se = np.zeros(n), np.zeros_like(serr)
    for r in range(w):
        sm = np.mean(signs[:, r * chunk:(r + 1) * chunk] * scales[:, None],
                     axis=0) + serr[r]
        ss = np.linalg.norm(sm) / np.sqrt(chunk)
        sign = np.where(sm >= 0, 1.0, -1.0)
        new_se[r] = sm - ss * sign
        out[r * chunk:(r + 1) * chunk] = ss * sign
    return out, new_we, new_se


def test_two_rank_gloo_compressed_allreduce_on_the_card(cuda, tmp_path):
    """The 1-bit exchange on cuda:0 tensors over two gloo ranks: the
    averages and both error buffers within 1e-6 of each tensor's max-abs
    of the numpy reference."""
    from deepspeed_tpu_torch.runtime.custom_collectives import corrected_size
    from tests.torch_dist_worker import run_ranks

    rng = np.random.RandomState(1)
    inp = {"buffers": [], "worker_errors": [], "server_errors": []}
    for n in (corrected_size(1000, 2), corrected_size(48, 2)):
        inp["buffers"].append(rng.randn(2, n).astype(np.float32))
        inp["worker_errors"].append((rng.randn(2, n) * .1).astype(np.float32))
        inp["server_errors"].append((rng.randn(2, n // 2) * .1).astype(
            np.float32))
    ranks = run_ranks(2, [dict(name="c", kind="compressed", device="cuda:0",
                               **inp)], str(tmp_path / "w"))
    for i in range(2):
        out, we, se = _numpy_compressed(*(inp[k][i] for k in (
            "buffers", "worker_errors", "server_errors")))
        for r, rank in enumerate(ranks):
            got = rank["c"]
            for g, w in ((got["out"][i], out), (got["we"][i], we[r]),
                         (got["se"][i], se[r])):
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=1e-6 * np.abs(w).max())


def test_two_rank_gloo_sequence_parallel_and_onebit_steps_on_the_card(
        cuda, tmp_path):
    """GPT-2 (width 128, 2 heads of 64) trained with its tokens split over
    two ranks on cuda:0 (the ring over K1/K2): every step's loss within
    1e-5 relative of one process on the card; and 1-bit Adam over two data
    ranks through its freeze, every loss within 1e-5 relative of the same
    two ranks on the CPU (at lr 1e-5: an element whose compensated momentum
    is within fp32 noise of 0 may take the other sign on the card, a whole
    step the other way, which must move the loss by less than the bound)."""
    from tests.torch_dist_worker import run_ranks

    params = _mp_params()
    ids = np.random.RandomState(0).randint(0, 1024, size=(4, 64))
    sp_cfg = dict(_MP_CONFIG, sequence_parallel={"enabled": True,
                                                  "size": 2})
    onebit = {"train_batch_size": 4, "steps_per_print": 1000,
              "optimizer": {"type": "OneBitAdam", "params": {
                  "lr": 1e-5, "eps": 1e-3, "freeze_step": 2}}}
    width = {k: v for k, v in _MP_WIDTH.items()}
    tasks = [dict(name="sp", kind="sp_train", model="gpt2", gpt2_cfg=width,
                  cfg={"sequence_parallel_axis": "seq"}, params=params,
                  config=sp_cfg, batches=[(ids, ids)] * 3, device="cuda:0",
                  fp32_compute=True),
             dict(name="ob", kind="onebit", model="gpt2", gpt2_cfg=width,
                  params=params, config=onebit, fp32_compute=True,
                  batches=[(ids, ids)] * 4, device="cuda:0")]
    ranks = run_ranks(2, tasks, str(tmp_path / "w"))
    cpu = run_ranks(2, [dict(tasks[1], device="cpu")], str(tmp_path / "c"))
    want, _ = _mp_reference(cuda, params, [(ids, ids)] * 3, 1)
    for r, c in zip(ranks, cpu):
        np.testing.assert_allclose(r["sp"]["losses"], want, rtol=1e-5)
        np.testing.assert_allclose(r["ob"]["losses"], c["ob"]["losses"],
                                   rtol=1e-5)
        assert r["ob"]["frozen"][-1] == (True, False)


def test_checkpointed_gpt2_blocks_bit_equal_on_the_card(cuda, monkeypatch):
    """Two GPT-2 blocks (width 128, dropout 0.1) through
    ``checkpointing.checkpoint``, with and without ``cpu_checkpointing``:
    every gradient bit-equal to the plain stack's (K2b, whose sums have a
    fixed order; K2a adds dq by atomics)."""
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.runtime.activation_checkpointing import (
        checkpointing)

    monkeypatch.setenv("DS_TPU_FLASH_BWD", "split")
    cfg = GPT2Config(dtype=torch.bfloat16, **dict(_MP_WIDTH, dropout=0.1))
    model = GPT2LMHeadModel(cfg, device=cuda).requires_grad_(True)
    x0 = torch.randn(2, 64, cfg.n_embd, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0)).to(
                         torch.bfloat16)
    try:
        grads = []
        for run in ("plain", "ckpt", "cpu"):
            checkpointing.configure(checkpoint_in_cpu=run == "cpu")
            for p in model.parameters():
                p.grad = None
            x = x0.clone().requires_grad_()
            h = x
            for blk, seed in zip(model.blocks(), (3, 4)):
                h = blk(h, cfg, seed) if run == "plain" else \
                    checkpointing.checkpoint(blk, h, cfg, seed)
            h.float().square().sum().backward()
            grads.append([x.grad] + [p.grad.clone() for p in
                                     model.parameters() if p.grad is not None])
        for other in grads[1:]:
            assert len(other) == len(grads[0]) > 1
            for a, b in zip(grads[0], other):
                assert torch.equal(a, b)
    finally:
        checkpointing.configure(checkpoint_in_cpu=False)


# ---------------------------------------------------------------------------
# Module injection and the tooling (the LUT op, costing, the autotuner)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fixed", "bigbird"])
def test_lut_op_tables_drive_k7(cuda, kind):
    """The host C++ op's tables equal the numpy lowering's, and K7a/K7b
    over them equal their plain versions (the sparse cases' limits)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, FixedSparsityConfig)
    cfg = FixedSparsityConfig(num_heads=4, block=64) if kind == "fixed" \
        else BigBirdSparsityConfig(num_heads=4, block=64, seed=3)
    layout = cfg.make_layout(1024)
    lowered = sk.LoweredLayout(layout, 64)
    for got, want in zip((lowered.fwd_lut, lowered.bwd_lut),
                         sk.build_luts_reference(layout)):
        np.testing.assert_array_equal(got, want)
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(2, 4, 1024, 64, device=cuda, generator=g)
                   for _ in range(4))
    sk.reset_launches()
    o, lse = sk.sparse_fwd(q, k, v, lowered)
    ro, rlse = sk.sparse_fwd_reference(q, k, v, lowered)
    torch.testing.assert_close(o, ro, rtol=0, atol=1e-4)
    delta = (do * o).sum(-1, keepdim=True)
    for mode in ("fused", "split"):
        got = sk.sparse_bwd(q, k, v, lowered, lse, delta, do, mode=mode)
        want = sk.sparse_bwd_reference(q, k, v, lowered, lse, delta, do)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-4 * float(b.abs().max()))
    assert sk.launches == {"sparse_fwd": 1, "sparse_bwd_fused": 1,
                           "sparse_bwd_split": 2}


def _costing_cases(device):
    g = torch.Generator(device="cuda").manual_seed(2)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(device)

    q, k, v, do = (r(2, 4, 128, 64) for _ in range(4))
    lse, delta = r(2, 4, 128, 1), r(2, 4, 128, 1)
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    lowered = sk.lower(FixedSparsityConfig(num_heads=4, block=32)
                       .make_layout(128), 32)
    x, res, b = r(64, 256), r(64, 256), r(256)
    return [
        (lambda: at.flash_fwd(q, k, v, None, True),
         lambda: at.mha_reference(q, k, v, None, True, return_lse=True)),
        (lambda: at.flash_bwd(q, k, v, None, lse, delta, do, True),
         lambda: at.flash_bwd_reference(q, k, v, None, lse, delta, do, True)),
        (lambda: sk.sparse_fwd(q, k, v, lowered),
         lambda: sk.sparse_fwd_reference(q, k, v, lowered)),
        (lambda: sk.sparse_bwd(q, k, v, lowered, lse, delta, do),
         lambda: sk.sparse_bwd_reference(q, k, v, lowered, lse, delta, do)),
        (lambda: ln.ln_fwd(x, b, b, b, res),
         lambda: ln.ln_fwd_reference(x, b, b, b, res)),
        (lambda: sm.softmax_fwd(r(2, 4, 16, 64), None, 0.5, True),
         lambda: sm.attn_softmax_reference(r(2, 4, 16, 64), None, 0.5,
                                           True)),
        (lambda: dr.dropout_fwd(x, b, res, 0.1, 7),
         lambda: dr.dropout_reference(x, 0.1, 7, b, res)),
        (lambda: dr.dropout_bwd(x, 0.1, 7),
         lambda: dr.dropout_bwd_reference(x, 0.1, 7)),
        (lambda: ge.bias_gelu_fwd(x, b),
         lambda: ge.bias_gelu_reference(x, b)),
    ]


@pytest.mark.parametrize("case", range(9))
def test_costing_on_the_card_equals_the_plain_count(cuda, case):
    """Under the x-ray's cost modes a kernel launched on the card counts
    exactly the flops and bytes its plain version counts on the CPU, on
    copies of the same tensors (the CPU is what the card is held to: CUDA
    decomposes some composite operators otherwise, e.g. a
    repeat_interleave)."""
    from deepspeed_tpu_torch.telemetry.xray import CostWindow
    kernel, _ = _costing_cases(cuda)[case]
    _, plain = _costing_cases(torch.device("cpu"))[case]
    with CostWindow() as launched:
        kernel()
    with CostWindow() as counted:
        plain()
    assert launched.cost == counted.cost
    assert counted.cost["bytes_accessed"] > 0


@pytest.mark.parametrize("model", ["gpt2", "bert"])
def test_xray_train_record_on_the_card_equals_the_cpu(cuda, model):
    """The x-ray's train_step record and the flops profiler's step, at 4
    layers of full width in fp32: the card (kernels) counts what the CPU
    (plain versions) counts, flops and bytes (the batch on its device
    first: an upload inside the step counts on the card's side only)."""
    import dataclasses
    import deepspeed_tpu_torch as tds
    from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                            GPT2Config, GPT2LMHeadModel)
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
              "flops_profiler": {"enabled": True, "start_step": 0,
                                 "end_step": 0}}
    rng = np.random.RandomState(0)
    out = {}
    for device in ("cuda", "cpu"):
        if model == "gpt2":
            cfg = dataclasses.replace(GPT2Config.gpt2_medium(
                dtype=torch.float32), n_layer=4)
            ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
            m, batch = GPT2LMHeadModel(cfg, device=device), (ids, ids)
        else:
            cfg = BertConfig.bert_large(dtype=torch.float32,
                                        num_hidden_layers=4)
            ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 128)))
            mask = torch.ones(2, 128, dtype=torch.long)
            mask[0, 100:] = 0
            labels = torch.where(torch.from_numpy(rng.rand(2, 128) < 0.15),
                                 ids, -1)
            batch = (ids, mask, torch.zeros_like(ids), labels,
                     torch.tensor([0, 1]))
            m = BertForPreTraining(cfg, device=device)
        engine = tds.initialize(model=m, config_params=config,
                                device=device)[0]
        engine.train_batch(tuple(t.to(device) for t in batch))
        rec = [r for r in engine.perf_xray()["programs"]
               if r["program"] == "train_step"][0]
        out[device] = (rec["flops"], rec["bytes_accessed"],
                       engine.flops_profile["flops"],
                       engine.flops_profile["bytes_accessed"])
    assert out["cuda"] == out["cpu"]


def test_autotune_sweep_and_no_sweep_in_a_capture(cuda, monkeypatch,
                                                  tmp_path):
    """Under DS_TPU_AUTOTUNE=force a flash backward sweeps K2a against
    K2b and writes a valid row; inside a graph capture, under
    DS_TPU_AUTOTUNE=1, a new signature is only looked up."""
    import json
    from deepspeed_tpu_torch.ops import autotuner
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(autotuner, "_MEMO", {})
    monkeypatch.setattr(autotuner, "_USER", None)
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "force")
    g = torch.Generator(device="cuda").manual_seed(3)

    def inputs(B, T):
        q, k, v, do = (torch.randn(B, 8, T, 64, device=cuda, generator=g)
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = at.flash_fwd(q, k, v, None, True)
        return q, k, v, do, lse, (do.float() * o.float()).sum(-1, True)

    q, k, v, do, lse, delta = inputs(2, 512)
    at.flash_bwd(q, k, v, None, lse, delta, do, True)
    with open(autotuner._user_cache_path()) as f:
        table = json.load(f)
    assert autotuner.validate_table(table) == 1
    (key, row), = table.items()
    assert key == autotuner.table_key("flash_attention", at.flash_signature(
        2, 8, 512, 512, 64, torch.bfloat16, True))
    assert set(row["timings"]) == {"fused", "split"}
    monkeypatch.setenv("DS_TPU_AUTOTUNE", "1")
    q, k, v, do, lse, delta = inputs(1, 256)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        at.flash_bwd(q, k, v, None, lse, delta, do, True)
    graph.replay()
    torch.cuda.synchronize()
    with open(autotuner._user_cache_path()) as f:
        assert len(json.load(f)) == 1
    assert not [k for k in autotuner._MEMO if "b1_h8_tq256" in k]
