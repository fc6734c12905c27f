"""Port parity: deepspeed_tpu_torch's flash-decode attention against the JAX
package's, on the CPU.

The port's plain version (``decode_attention_reference``, which the CUDA
kernel is held against on the card) must equal both the JAX reference and
the JAX Pallas kernel (run in interpret mode, as the JAX package's own
tests run it) on the same numpy inputs: ragged frontiers including 0, a
frontier whose rows straddle a kernel block, and large finite garbage at
every position past a row's frontier.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.kernels import decode_attention as jda
from deepspeed_tpu_torch.ops.transformer.kernels import decode_attention as tda

torch.set_num_threads(1)

T, D = 256, 64
# Frontiers per query length: 0 (a row that sees one key), rows straddling
# the 128-position block boundary, and the deepest frontier T - S.
FRONTIERS = {1: [0, 127, 200], 5: [0, 126, T - 5], 32: [0, 100, T - 32]}
# bf16: the two frameworks round probabilities and outputs at different
# points; one bf16 ulp at |out| in [4, 8) is 2**-5.
BF16_TOL = 4e-2


def inputs(s, seed=0, h=2):
    rng = np.random.RandomState(seed)
    pos = np.asarray(FRONTIERS[s], np.int32)
    b = pos.size
    q = rng.randn(b, h, s, D).astype(np.float32)
    k = rng.randn(b, h, T, D).astype(np.float32)
    v = rng.randn(b, h, T, D).astype(np.float32)
    stale = (np.arange(T)[None] > pos[:, None] + s - 1)[:, None, :, None]
    garbage = 3e4 * np.sign(rng.randn(b, h, T, D)).astype(np.float32)
    return q, np.where(stale, garbage, k), np.where(stale, -garbage, v), pos


def port(q, k, v, pos, dtype=torch.float32):
    out = tda.flash_decode_attention(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), torch.from_numpy(pos))
    return out.float().numpy()


@pytest.mark.parametrize("s", sorted(FRONTIERS))
def test_plain_matches_jax_reference_fp32(s):
    q, k, v, pos = inputs(s)
    want = jda.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), jnp.asarray(pos))
    np.testing.assert_allclose(port(q, k, v, pos), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", sorted(FRONTIERS))
def test_plain_matches_jax_pallas_kernel_fp32(s):
    q, k, v, pos = inputs(s, seed=1)
    want = jda.flash_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(pos),
                                      block_k=128)
    np.testing.assert_allclose(port(q, k, v, pos), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("s", sorted(FRONTIERS))
def test_plain_matches_jax_reference_bf16(s):
    q, k, v, pos = inputs(s, seed=2)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = jda.decode_attention_reference(*bf, jnp.asarray(pos))
    got = port(q, k, v, pos, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=0)


def test_garbage_past_frontier_never_reaches_the_result():
    q, k, v, pos = inputs(5, seed=3)
    stale = (np.arange(T)[None] > pos[:, None] + 4)[:, None, :, None]
    clean = port(q, np.where(stale, 0.0, k).astype(np.float32),
                 np.where(stale, 0.0, v).astype(np.float32), pos)
    np.testing.assert_array_equal(port(q, k, v, pos), clean)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    q, k, v, pos = [torch.from_numpy(a) for a in inputs(1, seed=4)]
    tda.reset_launches()
    out = tda.flash_decode_attention(q, k, v, pos, scale=0.2)
    torch.testing.assert_close(
        out, tda.decode_attention_reference(q, k, v, pos, scale=0.2),
        rtol=0, atol=0)
    assert not any(tda.launches.values())


@pytest.mark.parametrize("bad", ["k_len_mismatch", "dtype_mismatch",
                                 "pos_rank", "q_rank"])
def test_wrapper_rejects_malformed_input(bad):
    q, k, v, pos = [torch.from_numpy(a) for a in inputs(1, seed=5)]
    if bad == "k_len_mismatch":
        k = k[:, :, :-1]
    elif bad == "dtype_mismatch":
        k = k.to(torch.bfloat16)
    elif bad == "pos_rank":
        pos = pos[:, None]
    else:
        q = q[0]
    with pytest.raises((ValueError, TypeError)):
        tda.flash_decode_attention(q, k, v, pos)


# ------------------------------------------- the kernels' split over keys

# The plain split-and-combine (partials over [s L, (s + 1) L), merged in
# split order) at each split length, against the dense reference and the
# JAX package's decode attention (its Pallas kernel in interpret mode), in
# fp32: each output within 1e-5 of its max-abs. A plane of 640 keys (5 of
# the JAX kernel's 128-key blocks) holds two splits of 256; the frontiers
# put rows just before, at and after the split boundaries L and 2 L, and at
# the plane's end.
SPLIT_T = 640
SPLIT_RTOL = 1e-5


def _split_frontiers(L, s):
    if s == 1:
        return [L - 1, L, L + 1, 2 * L, SPLIT_T - 1]
    return [L - s, L - 1, L + 1, 2 * L - s // 2, SPLIT_T - s]


def _split_inputs(s, frontiers, seed):
    rng = np.random.RandomState(seed)
    pos = np.asarray(frontiers, np.int32)
    b = pos.size
    q = rng.randn(b, 2, s, D).astype(np.float32)
    k = rng.randn(b, 2, SPLIT_T, D).astype(np.float32)
    v = rng.randn(b, 2, SPLIT_T, D).astype(np.float32)
    stale = (np.arange(SPLIT_T)[None] > pos[:, None] + s - 1)[:, None, :,
                                                             None]
    return (q, np.where(stale, 3e4, k).astype(np.float32),
            np.where(stale, -3e4, v).astype(np.float32), pos)


_JAX_SPLIT_CACHE = {}


def _jax_decode(layout, s, frontiers, q, k, v, pos):
    """The JAX kernel's result (interpret mode), once per input set."""
    key = (layout, s, tuple(frontiers))
    if key not in _JAX_SPLIT_CACHE:
        if layout == "dense":
            want = jda.flash_decode_attention(
                *[jnp.asarray(a) for a in (q, k, v, pos)], block_k=128)
        else:
            from tests.test_torch_paged_kv import paged_layout
            ak, av, tbl = paged_layout(k, v, 128, seed=s)
            want = jda.flash_decode_attention_paged(
                *[jnp.asarray(a) for a in (q, ak, av, tbl, pos)])
        _JAX_SPLIT_CACHE[key] = np.asarray(want)
    return _JAX_SPLIT_CACHE[key]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("s", [1, 32])
@pytest.mark.parametrize("L", [32, 128, 256])
def test_split_and_combine_matches_reference_and_jax_kernel(L, s, layout):
    frontiers = _split_frontiers(L, s)
    q, k, v, pos = _split_inputs(s, frontiers, seed=L + s)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    if layout == "paged":
        from tests.test_torch_paged_kv import paged_layout
        ak, av, tbl = (torch.from_numpy(a)
                       for a in paged_layout(k, v, 128, seed=s))
        tk, tv = tda.gather_pages(ak, tbl), tda.gather_pages(av, tbl)
    part = tda.decode_partials_reference(tq, tk, tv, tpos, split_keys=L)
    assert part.shape == (-(-SPLIT_T // L), len(frontiers), 2, s, D + 2)
    got = tda.combine_partials_reference(part, tpos, SPLIT_T, torch.float32,
                                         split_keys=L).numpy()
    for want in (tda.decode_attention_reference(tq, tk, tv, tpos).numpy(),
                 _jax_decode(layout, s, frontiers, q, k, v, pos)):
        np.testing.assert_allclose(
            got, want, rtol=0, atol=SPLIT_RTOL * float(np.abs(want).max()))


def test_combine_reads_only_the_splits_the_kernel_runs():
    """Partials of splits starting past a row's last key may be left
    unwritten by the kernel: NaN there must not reach the result."""
    q, k, v, pos = (torch.from_numpy(a)
                    for a in _split_inputs(1, [0, 127, 128, 300, 639], 7))
    part = tda.decode_partials_reference(q, k, v, pos)
    want = tda.combine_partials_reference(part, pos, SPLIT_T, torch.float32)
    run = tda._splits_run(pos, 1, SPLIT_T, tda.SPLIT_KEYS)
    assert run.tolist() == [[1], [1], [2], [3], [5]]
    unused = torch.arange(part.shape[0])[:, None, None] >= run[None]
    part.masked_fill_(unused[:, :, None, :, None], float("nan"))
    got = tda.combine_partials(part, pos, SPLIT_T, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("T,S", [(1, 1), (127, 1), (128, 32), (129, 64),
                                 (1056, 1), (1152, 32)])
def test_split_plan_is_a_function_of_plane_length_and_rows(T, S):
    plan = tda.split_plan(T, S)
    bounds = plan["bounds"]
    assert bounds[0][0] == 0 and bounds[-1][1] == T
    assert all(hi - lo <= tda.SPLIT_KEYS and lo == i * tda.SPLIT_KEYS
               for i, (lo, hi) in enumerate(bounds))
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert plan["partial_shape"] == (len(bounds), S, tda.HEAD_DIM + 2)
    assert tda.split_plan(T, S) == plan


@pytest.mark.parametrize("page_len", [1, 7, 48, 128])
def test_split_plan_of_a_paged_row_is_its_dense_twins(page_len):
    """The wrapper plans a paged call from n_lp * page_len, which is the
    length of the gathered dense plane: the same splits, the same
    workspace."""
    n_lp, S = -(-300 // page_len), 32
    arena = torch.zeros(n_lp + 1, 2, page_len, D)
    tbl = torch.arange(1, n_lp + 1, dtype=torch.int32)[None]
    dense = tda.gather_pages(arena, tbl)
    q = torch.zeros(1, 2, S, D)
    assert dense.shape[2] == n_lp * page_len
    assert tda.split_plan(n_lp * page_len, S) == \
        tda.split_plan(dense.shape[2], S)
    assert tda._workspace(q, n_lp * page_len).shape == \
        tda._workspace(q, dense.shape[2]).shape


def test_split_keys_match_the_kernel_source():
    import os
    import re
    src = os.path.join(os.path.dirname(tda.__file__), "..", "..", "..",
                       "csrc", "decode_attention.cu")
    with open(src) as f:
        m = re.search(r"constexpr int kSplitKeys = (\d+);", f.read())
    assert m and int(m.group(1)) == tda.SPLIT_KEYS
