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
