"""Port parity for block-sparse attention on the CPU, in fp32.

The same numpy inputs go through the JAX package (its Pallas kernels in
interpret mode, as its own tests run them) and the port (the kernels' plain
versions, which the wrappers compute for CPU tensors): the five sparsity
patterns' layouts and their LUTs are equal; ``block_sparse_attention``'s
output agrees within 1e-5 and its q/k/v gradients within 1e-4 of each
tensor's max-abs, in both backward modes, with and without a key-padding
mask and a score bias in both mask modes, and so does the bias's gradient;
``sparse_self_attention`` with an rpe and a 2D attention mask,
``BertSparseSelfAttention`` on carried-over weights, and the padding
helpers agree too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as J
from deepspeed_tpu.ops.sparse_attention.bert_sparse_self_attention import (
    BertConfigLike)
from deepspeed_tpu_torch.ops import sparse_attention as T
from deepspeed_tpu_torch.ops.sparse_attention import kernels as TK
from deepspeed_tpu_torch.runtime.utils import load_flax_tree

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

# (pattern, constructor keywords), each built in both packages.
LAYOUT_CASES = [
    ("Dense", {}),
    ("Fixed", {}),
    ("Fixed", dict(num_local_blocks=2, attention="unidirectional")),
    ("Fixed", dict(num_local_blocks=4, num_global_blocks=2,
                   horizontal_global_attention=True)),
    ("Fixed", dict(different_layout_per_head=True, num_local_blocks=4,
                   num_different_global_patterns=4)),
    ("Variable", dict(num_random_blocks=2, local_window_blocks=[2, 3],
                      global_block_indices=[0, 5], seed=3)),
    ("Variable", dict(different_layout_per_head=True, num_random_blocks=1,
                      global_block_indices=[1],
                      global_block_end_indices=[3],
                      attention="unidirectional")),
    ("BigBird", dict(num_random_blocks=2, seed=7)),
    ("BigBird", dict(different_layout_per_head=True)),
    ("BSLongformer", dict(num_sliding_window_blocks=5,
                          global_block_indices=[0, 4],
                          global_block_end_indices=[2, 6])),
]


def _config(pkg, name, **kw):
    return getattr(pkg, name + "SparsityConfig")(num_heads=4, block=16, **kw)


@pytest.mark.parametrize("seq", [96, 256, 208])
@pytest.mark.parametrize("case", range(len(LAYOUT_CASES)))
def test_layouts_and_luts_equal_the_jax_packages(case, seq):
    name, kw = LAYOUT_CASES[case]
    ours, theirs = _config(T, name, **kw), _config(J, name, **kw)
    layout = ours.make_layout(seq)
    np.testing.assert_array_equal(layout, theirs.make_layout(seq))
    np.testing.assert_array_equal(layout, ours.make_layout(seq))  # reseeded
    for got, want in zip(T.build_luts(layout), J.build_luts(layout)):
        np.testing.assert_array_equal(got, want)


def test_pattern_validation_matches_the_jax_package():
    bad = [("Fixed", dict(num_local_blocks=3, num_global_blocks=2)),
           ("Fixed", dict(attention="sideways")),
           ("Fixed", dict(attention="unidirectional",
                          horizontal_global_attention=True)),
           ("Fixed", dict(num_different_global_patterns=2)),
           ("Variable", dict(global_block_indices=[0, 1],
                             global_block_end_indices=[2])),
           ("BSLongformer", dict(global_block_indices=[3],
                                 global_block_end_indices=[3]))]
    for name, kw in bad:
        with pytest.raises((ValueError, NotImplementedError)) as want:
            _config(J, name, **kw)
        with pytest.raises(want.type):
            _config(T, name, **kw)
    for pkg in (J, T):
        with pytest.raises(ValueError, match="dividable"):
            _config(pkg, "Dense").make_layout(40)
        with pytest.raises(ValueError, match="random blocks"):
            _config(pkg, "BigBird", num_random_blocks=5).make_layout(64)


def _qkv(b=2, h=4, t=64, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for _ in range(3)]


def _close(got, want, tol, msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale,
                               rtol=0, err_msg=msg)


# The JAX package's own kernel-parity cases (tests/unit/
# test_sparse_attention.py), built in each package.
KERNEL_CASES = [
    ("dense", "Dense", {}),
    ("fixed", "Fixed", dict(num_local_blocks=2, num_global_blocks=1)),
    ("fixed_uni", "Fixed", dict(num_local_blocks=2,
                                attention="unidirectional")),
    ("bigbird", "BigBird", dict(num_random_blocks=1,
                                num_sliding_window_blocks=3,
                                num_global_blocks=1, seed=1)),
    ("bslongformer", "BSLongformer", dict(num_sliding_window_blocks=3)),
    ("variable", "Variable", dict(num_random_blocks=1,
                                  local_window_blocks=[2],
                                  global_block_indices=[0], seed=2)),
]


def _layout_of(name, kw, seq=64):
    return _config(T, name, **kw).make_layout(seq), \
        kw.get("attention") == "unidirectional"


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in
                                                    KERNEL_CASES])
def test_forward_matches_jax(case):
    _, name, kw = case
    layout, causal = _layout_of(name, kw)
    q, k, v = _qkv()
    want = J.block_sparse_attention(*map(jnp.asarray, (q, k, v)), layout, 16,
                                    causal=causal)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = T.block_sparse_attention(tq, tk, tv, layout, 16, causal=causal)
    _close(got.numpy(), want, FWD_TOL)
    ref = T.block_sparse_attention_reference(tq, tk, tv, layout, 16,
                                             causal=causal)
    _close(got.numpy(), ref.numpy(), FWD_TOL)
    # The lse the backward keeps: the log-sum-exp of the visible scores.
    o, lse = TK.sparse_fwd(tq, tk, tv, TK.lower(layout, 16), causal=causal)
    s = TK._masked_scores(tq, tk, TK.lower(layout, 16), 0.25, causal, None,
                          "add", None, "add")
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(s, -1, keepdim=True).numpy(),
                               rtol=1e-6, atol=1e-5)
    assert torch.equal(o, got)


def _grads_both(monkeypatch, mode, layout, causal, q, k, v, g, kpm=None,
                kpm_mode="add", bias=None, bias_mode="add"):
    """d(sum(o * g)) by q, k, v (and the bias) in both packages."""
    monkeypatch.setenv("DS_TPU_FLASH_BWD", mode)
    kw = dict(causal=causal, key_padding_mask_mode=kpm_mode,
              attn_bias_mode=bias_mode)

    def jloss(q_, k_, v_, b_):
        o = J.block_sparse_attention(
            q_, k_, v_, layout, 16, key_padding_mask=None if kpm is None
            else jnp.asarray(kpm), attn_bias=b_, **kw)
        return jnp.sum(o * jnp.asarray(g))

    jb = None if bias is None else jnp.asarray(bias)
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    want = jax.grad(jloss, argnums=argnums)(*map(jnp.asarray, (q, k, v)), jb)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tb = None
    if bias is not None:
        tb = torch.from_numpy(bias).requires_grad_()
        leaves.append(tb)
    o = T.block_sparse_attention(
        *leaves[:3], layout, 16, key_padding_mask=None if kpm is None
        else torch.from_numpy(kpm), attn_bias=tb, **kw)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    return got, want


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("case", KERNEL_CASES[:3],
                         ids=[c[0] for c in KERNEL_CASES[:3]])
def test_grads_match_jax_in_both_backward_modes(monkeypatch, case, mode):
    _, name, kw = case
    layout, causal = _layout_of(name, kw)
    q, k, v = _qkv(b=1)
    g = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    got, want = _grads_both(monkeypatch, mode, layout, causal, q, k, v, g)
    for x, y, n in zip(got, want, "qkv"):
        _close(x.numpy(), y, GRAD_TOL, "d" + n)


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("kpm_mode,bias_mode", [("add", "add"),
                                                ("mul", "mul")])
def test_masked_biased_grads_match_jax(monkeypatch, mode, kpm_mode,
                                       bias_mode):
    """A key-padding mask and a learned bias together, in both mask modes:
    q/k/v gradients and the bias's."""
    layout = _config(T, "Fixed", num_local_blocks=2).make_layout(64)
    q, k, v = _qkv(b=2)
    rng = np.random.RandomState(9)
    keep = (np.arange(64) < 48)[None].repeat(2, 0)
    if kpm_mode == "mul":
        kpm = keep.astype(np.float32)
    else:
        kpm = np.where(keep, 0.0, -1e9).astype(np.float32)
    bias = (rng.randn(2, 4, 64, 64) * 0.1).astype(np.float32)
    if bias_mode == "mul":
        bias = 1.0 + np.abs(bias)  # keeps the scores live
    g = rng.randn(*q.shape).astype(np.float32)
    got, want = _grads_both(monkeypatch, mode, layout, False, q, k, v, g,
                            kpm, kpm_mode, bias, bias_mode)
    for x, y, n in zip(got, want, ["dq", "dk", "dv", "dbias"]):
        _close(x.numpy(), y, GRAD_TOL, n)
    assert float(np.abs(want[3]).max()) > 0.0


def test_bias_grad_causal_and_kpm_grad_is_zero():
    layout = _config(T, "Fixed", num_local_blocks=2,
                     attention="unidirectional").make_layout(32)
    q, k, v = _qkv(b=1, t=32)
    bias = (np.random.RandomState(3).randn(1, 4, 32, 32) * 0.1).astype(
        np.float32)
    want = jax.grad(lambda b_: jnp.sum(J.block_sparse_attention(
        *map(jnp.asarray, (q, k, v)), layout, 16, causal=True,
        attn_bias=b_) ** 2))(jnp.asarray(bias))
    tb = torch.from_numpy(bias).requires_grad_()
    kpm = torch.zeros(1, 32, requires_grad=True)
    o = T.block_sparse_attention(*map(torch.from_numpy, (q, k, v)), layout,
                                 16, causal=True, key_padding_mask=kpm,
                                 attn_bias=tb)
    db, dkpm = torch.autograd.grad((o ** 2).sum(), [tb, kpm])
    _close(db.numpy(), want, GRAD_TOL)
    assert torch.equal(dkpm, torch.zeros_like(kpm))


def test_plain_versions_edges():
    """A row with no listed block gives o = 0 and a finite lse in the plain
    forward (the kernel's m_safe and clamp), and the plain backward equals
    autograd through the dense reference."""
    layout = np.ones((2, 4, 4), np.int64)
    layout[:, 1] = 0  # query block 1 sees nothing
    q, k, v = map(torch.from_numpy, _qkv(b=1, h=2, t=64))
    lowered = TK.lower(layout, 16)
    o, lse = TK.sparse_fwd_reference(q, k, v, lowered)
    assert bool((o[:, :, 16:32] == 0).all())
    assert bool(torch.isfinite(lse).all())
    np.testing.assert_allclose(float(lse[0, 0, 20, 0]),
                               0.5 * TK.NEG_INF + np.log(1e-30), rtol=1e-6)
    ref = TK.block_sparse_attention_reference(q, k, v, layout, 16)
    _close(o.numpy(), ref.numpy(), FWD_TOL)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    do = torch.randn_like(q)
    want = torch.autograd.grad(TK.block_sparse_attention_reference(
        *leaves, layout, 16), leaves, do)
    delta = (do * o).sum(-1, keepdim=True)
    got = TK.sparse_bwd_reference(q, k, v, lowered, lse, delta, do)
    for x, y in zip(got, want):
        _close(x.numpy(), y.numpy(), GRAD_TOL)


def _schedule_layout(kind, block):
    """The layouts the backward schedule is tested on: the sparse BERT
    path's Fixed layout at T = 4096 (transposed rows of 4 and of 64 query
    blocks), a random one with an empty query block (row) and key block
    (column), and the causal Fixed-uni one."""
    if kind == "fixed_path":
        return T.FixedSparsityConfig(num_heads=16, block=block).make_layout(
            4096)
    if kind == "fixed_uni":
        return T.FixedSparsityConfig(
            num_heads=4, block=block, num_local_blocks=2,
            attention="unidirectional").make_layout(32 * block)
    rng = np.random.RandomState(block)
    layout = (rng.rand(4, 24, 24) < 0.3).astype(np.int64)
    layout[:, 5] = 0
    layout[:, :, 7] = 0
    return layout


@pytest.mark.parametrize("kind,block", [("fixed_path", 64)] + [
    (kind, block) for kind in ("random", "fixed_uni")
    for block in (16, 32, 64)])
def test_backward_schedule_covers_each_listed_pair_once(kind, block):
    """K7b's schedule: every (h, query block, key block) pair of the layout
    in exactly one item and no other pair, every key block in some item
    (an empty one writes zeros), counts largest first; the LUTs it indexes
    stay the JAX package's."""
    layout = _schedule_layout(kind, block)
    lowered = TK.lower(layout, block)
    for got, want in zip((lowered.fwd_lut, lowered.bwd_lut),
                         J.build_luts(layout)):
        np.testing.assert_array_equal(got, want)
    sched = lowered.bwd_schedule
    assert sched.dtype == np.int32 and sched.shape[1] == 3
    rows = lowered.bwd_lut[sched[:, 0], sched[:, 1]]
    counts = sched[:, 2]
    assert (np.diff(counts) <= 0).all()
    seen = np.zeros(layout.shape, dtype=np.int64)
    for (h, kb, count), row in zip(sched, rows):
        assert (row[:count] >= 0).all() and (row[count:] < 0).all()
        seen[h, row[:count], kb] += 1
    np.testing.assert_array_equal(seen, (layout != 0).astype(np.int64))
    heads, keys = layout.shape[0], layout.shape[2]
    covered = {(int(h), int(kb)) for h, kb in sched[:, :2]}
    assert covered == {(h, kb) for h in range(heads) for kb in range(keys)}
    if kind == "fixed_path":
        assert sorted(set(counts.tolist())) == [4, 64]
    if kind == "random":
        assert (counts == 0).any()  # the empty key block's item


def _fwd_schedule_layout(kind, block):
    """The layouts the forward schedule is tested on, 16 query blocks (the
    path's Fixed layout: 64 at T = 4096): Fixed (windows of 4 equal rows),
    Fixed-uni (no two rows equal), random (with an empty query block),
    BigBird with two global blocks (a pair of equal global rows beside
    single sliding-window rows) and Fixed with a different global pattern
    per head."""
    seq = 16 * block
    if kind == "fixed_path":
        return T.FixedSparsityConfig(num_heads=16, block=block).make_layout(
            4096)
    if kind == "fixed":
        return T.FixedSparsityConfig(num_heads=4, block=block).make_layout(
            seq)
    if kind == "fixed_uni":
        return T.FixedSparsityConfig(
            num_heads=4, block=block,
            attention="unidirectional").make_layout(seq)
    if kind == "bigbird":
        return T.BigBirdSparsityConfig(
            num_heads=4, block=block, num_global_blocks=2,
            num_random_blocks=1, seed=5).make_layout(seq)
    if kind == "per_head":
        return T.FixedSparsityConfig(
            num_heads=4, block=block, num_local_blocks=4,
            different_layout_per_head=True,
            num_different_global_patterns=4).make_layout(seq)
    rng = np.random.RandomState(block)
    layout = (rng.rand(4, 16, 16) < 0.3).astype(np.int64)
    layout[:, 5] = 0
    return layout


FWD_SCHEDULE_KINDS = ("fixed", "fixed_uni", "random", "bigbird", "per_head")


@pytest.mark.parametrize("kind,block", [("fixed_path", 64)] + [
    (kind, block) for kind in FWD_SCHEDULE_KINDS for block in (16, 32, 64)])
def test_forward_schedule_pairs_equal_rows_once_each(kind, block):
    """K7a's block-64 schedule: every (h, query block) in exactly one item;
    a pair only of two query blocks of one head whose LUT rows are equal;
    count the row's listed key blocks; counts largest first; the same
    schedule from the same LUT; every item a pair on the sparse BERT
    path's Fixed layout."""
    layout = _fwd_schedule_layout(kind, block)
    lut = TK.build_luts(layout)[0]
    sched = TK.build_fwd_schedule(lut)
    np.testing.assert_array_equal(sched, TK.build_fwd_schedule(lut.copy()))
    np.testing.assert_array_equal(sched, TK.lower(layout, block)
                                  .fwd_schedule)
    assert sched.dtype == np.int32 and sched.shape[1] == 4
    assert (np.diff(sched[:, 3]) <= 0).all()
    heads, nb = lut.shape[:2]
    seen = np.zeros((heads, nb), dtype=np.int64)
    for h, a, b, count in sched:
        assert count == (lut[h, a] >= 0).sum()
        assert (lut[h, a, :count] >= 0).all() and (lut[h, a, count:] < 0).all()
        seen[h, a] += 1
        if b >= 0:
            assert b != a
            np.testing.assert_array_equal(lut[h, a], lut[h, b])
            seen[h, b] += 1
    np.testing.assert_array_equal(seen, np.ones((heads, nb), np.int64))
    paired = int((sched[:, 2] >= 0).sum())
    if kind in ("fixed_path", "fixed", "per_head"):
        assert paired == len(sched) == heads * nb // 2
    if kind == "fixed_uni":
        assert paired == 0
    if kind == "bigbird":
        assert 0 < paired < len(sched)


def _fwd_by_schedule(q, k, v, lowered, causal, kpm):
    """The forward walked as K7a's block-64 kernel walks it: per schedule
    item, for each of its query blocks, the first query block's LUT row up
    to the item's count, an online softmax over the listed key blocks (m
    from NEG_INF, shifted by max(m, NEG_INF / 2), l clamped at 1e-30), o =
    acc / l and lse = max(m, NEG_INF / 2) + log l."""
    _, _, t, d = q.shape
    blk = lowered.block
    scale = d ** -0.5
    neg = torch.tensor(TK.NEG_INF)
    o = torch.full_like(q, float("nan"))
    lse = torch.full(q.shape[:3] + (1,), float("nan"))
    for h, a, b, count in lowered.fwd_schedule.tolist():
        keys = lowered.fwd_lut[h, a, :count].tolist()
        for qb in [a] + ([b] if b >= 0 else []):
            rows = torch.arange(qb * blk, (qb + 1) * blk)
            m = torch.full((q.shape[0], blk), TK.NEG_INF)
            l = torch.zeros(q.shape[0], blk)
            acc = torch.zeros(q.shape[0], blk, d)
            for kb in keys:
                cols = torch.arange(kb * blk, (kb + 1) * blk)
                s = q[:, h, rows] @ k[:, h, cols].transpose(-1, -2) * scale
                if kpm is not None:
                    s = s + kpm[:, None, cols]
                if causal:
                    s = torch.where(cols[None] > rows[:, None], neg, s)
                m_new = torch.maximum(m, s.amax(-1))
                shift = torch.clamp(m_new, min=0.5 * TK.NEG_INF)
                alpha = torch.exp(m - shift)
                p = torch.exp(s - shift[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ v[:, h, cols]
                m = m_new
            lv = torch.clamp(l, min=1e-30)
            o[:, h, rows] = acc / lv[..., None]
            lse[:, h, rows, 0] = torch.clamp(m, min=0.5 * TK.NEG_INF) + \
                torch.log(lv)
    return o, lse


@pytest.mark.parametrize("kind,causal", [("fixed", False), ("bigbird", False),
                                         ("per_head", False),
                                         ("fixed_uni", True),
                                         ("random", False)])
def test_forward_over_the_schedule_matches_reference_and_jax(kind, causal):
    """The plain forward taken item by item over the block-64 schedule
    (pairs and single blocks, an empty query block, a key-padding mask)
    against ``sparse_fwd_reference`` and the JAX kernel in interpret mode,
    within 1e-5 of max-abs in fp32."""
    block = 64
    layout = _fwd_schedule_layout(kind, block)[:, :8, :8]
    seq = 8 * block
    q, k, v = _qkv(b=2, h=4, t=seq, seed=7)
    kpm = np.zeros((2, seq), np.float32)
    kpm[1, 300:] = -1e9
    tq, tk, tv, tkpm = map(torch.from_numpy, (q, k, v, kpm))
    lowered = TK.lower(layout, block)
    o, lse = _fwd_by_schedule(tq, tk, tv, lowered, causal, tkpm)
    ro, rlse = TK.sparse_fwd_reference(tq, tk, tv, lowered, causal=causal,
                                       kpm=tkpm)
    _close(o.numpy(), ro.numpy(), FWD_TOL)
    _close(lse.numpy(), rlse.numpy(), FWD_TOL)
    want = J.block_sparse_attention(*map(jnp.asarray, (q, k, v)), layout,
                                    block, causal=causal,
                                    key_padding_mask=jnp.asarray(kpm))
    _close(o.numpy(), want, FWD_TOL)


def test_wrappers_check_shapes_and_count_only_kernel_launches():
    layout = _config(T, "Fixed").make_layout(64)
    q, k, v = map(torch.from_numpy, _qkv())
    lowered = TK.lower(layout, 16)
    assert TK.lower(layout.copy(), 16) is lowered  # cached by content
    TK.reset_launches()
    TK.sparse_fwd(q, k, v, lowered)
    assert TK.launches == {"sparse_fwd": 0, "sparse_bwd_fused": 0,
                           "sparse_bwd_split": 0}  # the CPU runs no kernel
    with pytest.raises(ValueError, match="does not cover"):
        TK.sparse_fwd(q[:, :, :32], k[:, :, :32], v[:, :, :32], lowered)
    with pytest.raises(ValueError, match="key_padding_mask"):
        TK.sparse_fwd(q, k, v, lowered, kpm=torch.zeros(2, 32))
    with pytest.raises(ValueError, match="dividable"):
        T.block_sparse_attention(q[:, :, :60], k[:, :, :60], v[:, :, :60],
                                 layout, 16)
    with pytest.raises(ValueError, match="layout heads"):
        T.block_sparse_attention(q[:, :2], k[:, :2], v[:, :2], layout, 16)
    assert lowered.density == float(layout.sum()) / layout.size


@pytest.mark.parametrize("attn_mask_mode", ["mul", "add"])
def test_sparse_self_attention_with_rpe_and_attn_mask(attn_mask_mode):
    q, k, v = _qkv(t=64)
    rng = np.random.RandomState(4)
    rpe = (rng.randn(4, 64, 64) * 0.1).astype(np.float32)
    am = (rng.rand(64, 64) > 0.2).astype(np.float32)
    if attn_mask_mode == "add":
        am = np.where(am > 0, 0.0, -1e4).astype(np.float32)
    kpm = np.where(np.arange(64) < 56, 0.0, -1e9)[None].repeat(2, 0)
    jcfg = _config(J, "Fixed", num_local_blocks=2)
    tcfg = _config(T, "Fixed", num_local_blocks=2)
    for rpe_in in (None, rpe):
        kw = dict(attn_mask_mode=attn_mask_mode)
        want = J.sparse_self_attention(
            *map(jnp.asarray, (q, k, v)), jcfg,
            rpe=None if rpe_in is None else jnp.asarray(rpe_in),
            key_padding_mask=jnp.asarray(kpm), attn_mask=jnp.asarray(am),
            **kw)
        got = T.sparse_self_attention(
            *map(torch.from_numpy, (q, k, v)), tcfg,
            rpe=None if rpe_in is None else torch.from_numpy(rpe_in),
            key_padding_mask=torch.from_numpy(kpm.astype(np.float32)),
            attn_mask=torch.from_numpy(am), **kw)
        _close(got.numpy(), want, FWD_TOL)
    module = T.SparseSelfAttention(tcfg, attn_mask_mode=attn_mask_mode)
    assert list(module.parameters()) == []
    out = module(*map(torch.from_numpy, (q, k, v)),
                 rpe=torch.from_numpy(rpe), attn_mask=torch.from_numpy(am))
    assert out.shape == (2, 4, 64, 16)
    with pytest.raises(NotImplementedError, match="2D attn_mask"):
        T.sparse_self_attention(*map(torch.from_numpy, (q, k, v)), tcfg,
                                attn_mask=torch.ones(1, 64, 64))


def test_bert_sparse_self_attention_matches_jax():
    cfg = BertConfigLike(hidden_size=64, num_attention_heads=4)
    jmod = J.BertSparseSelfAttention(
        config=cfg, sparsity_config=_config(J, "Fixed", num_local_blocks=2))
    x = np.random.RandomState(0).randn(2, 64, 64).astype(np.float32)
    mask = np.where(np.arange(64) < 50, 0.0, -1e9)[None].repeat(2, 0) \
        .astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(mask))
    ours = T.BertSparseSelfAttention(
        cfg, _config(T, "Fixed", num_local_blocks=2), device="cpu",
        seed=None)
    load_flax_tree(ours, jax.tree_util.tree_map(np.asarray,
                                                params["params"]))
    with torch.no_grad():
        got = ours(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got.numpy(), want, FWD_TOL)
    layers = T.SparseAttentionUtils \
        .replace_self_attention_layer_with_sparse_self_attention_layer(
            cfg, [None, None], device="cpu")
    assert len(layers) == 2 and all(
        isinstance(m, T.BertSparseSelfAttention) for m in layers)
    with pytest.raises(ValueError, match="multiple"):
        T.BertSparseSelfAttention(BertConfigLike(65, 4), device="cpu")


def test_pad_unpad_and_position_embedding_match_jax():
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 100, size=(2, 60))
    mask = np.ones((2, 60), np.int64)
    types = np.zeros((2, 60), np.int64)
    emb = rng.randn(2, 60, 8).astype(np.float32)
    table = rng.randn(100, 8).astype(np.float32)
    want = J.SparseAttentionUtils.pad_to_block_size(
        16, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types),
        jnp.asarray(ids), jnp.asarray(emb), 0,
        lambda i: jnp.asarray(table)[i])
    got = T.SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), torch.from_numpy(mask),
        torch.from_numpy(types), torch.from_numpy(ids),
        torch.from_numpy(emb), 0, lambda i: torch.from_numpy(table)[i])
    assert got[0] == want[0] == 4
    for x, y in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    seq = torch.ones(2, 64, 8)
    assert T.SparseAttentionUtils.unpad_sequence_output(4, seq).shape == \
        (2, 60, 8)
    assert T.SparseAttentionUtils.pad_to_block_size(
        16, torch.ones(2, 64, dtype=torch.long), None, None, None, None, 0,
        None)[0] == 0
    pos = np.arange(512 * 4, dtype=np.float32).reshape(512, 4)
    for n in (1024, 1000, 300):
        w = J.SparseAttentionUtils.extend_position_embedding(
            {"embedding": jnp.asarray(pos)}, n)["embedding"]
        g = T.SparseAttentionUtils.extend_position_embedding(
            {"embedding": torch.from_numpy(pos)}, n)["embedding"]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            T.SparseAttentionUtils.extend_position_embedding(
                torch.from_numpy(pos), n).numpy(), np.asarray(w))


def test_tokenizer_length_and_unported_model_swap():
    class Tok:
        model_max_length = 512
        init_kwargs = {}

    tok = T.SparseAttentionUtils.update_tokenizer_model_max_length(Tok(),
                                                                   4096)
    assert tok.model_max_length == 4096
    assert tok.init_kwargs["model_max_length"] == 4096
    # The swap is module_inject's: a plain-layer BERT takes it in place,
    # a model that does not expose its attention raises TypeError.
    from deepspeed_tpu_torch.models import BertConfig, BertForPreTraining
    model = BertForPreTraining(BertConfig.tiny(
        dtype=torch.float32, use_fused_layer=False), device="cpu")
    sc = T.FixedSparsityConfig(num_heads=4, block=16)
    assert T.SparseAttentionUtils \
        .replace_model_self_attention_with_sparse_self_attention(
            model, 4096, sc) is model
    assert isinstance(model.bert.layer_0.attention_module,
                      T.SparseSelfAttention)
    assert model.bert.layer_1.attention_module.sparsity_config is sc
    with pytest.raises(TypeError, match="attention_module"):
        T.SparseAttentionUtils \
            .replace_model_self_attention_with_sparse_self_attention(
                object(), 4096)
