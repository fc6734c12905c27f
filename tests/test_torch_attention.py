"""Port parity: deepspeed_tpu_torch's flash attention (K1/K2 and their plain
versions) against the JAX package's ``flash_attention``, on the CPU.

The same numpy q, k, v, mask and output cotangent go through both packages
in fp32. JAX runs its Pallas kernels in interpret mode, as its own tests do
off the TPU (or its dense path, for a ragged shape); the port runs the
plain versions its CUDA kernels are held against on the card. The output,
the logsumexp and dq/dk/dv must agree within 1e-5 absolute, for the fused
and the split backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer.kernels import attention as jat
from deepspeed_tpu_torch.ops.transformer.kernels import attention as tat

torch.set_num_threads(1)

ATOL = 1e-5
B, H, D = 2, 2, 64

# (name, T, causal, masked, JAX tile or None). A tile that does not divide
# T sends the JAX package to its dense path; the port's kernels take any T.
CASES = [("causal", 64, True, False, None),
         ("noncausal_mask", 48, False, True, None),
         ("causal_mask", 32, True, True, None),
         ("ragged", 40, True, True, 16)]


def _inputs(T, masked, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.zeros((B, T), np.float32)
        mask[0, T // 4:T // 2] = -1e9
        mask[1, -3:] = -1e9
    return q, k, v, g, mask


def _jax(q, k, v, g, mask, causal, tile):
    jm = None if mask is None else jnp.asarray(mask)

    def loss(a, b, c):
        o = jat.flash_attention(a, b, c, mask=jm, causal=causal,
                                block_q=tile, block_k=tile)
        return jnp.sum(o * g), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, lse = jat.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
        causal=causal, block_q=tile, block_k=tile)
    return [np.asarray(t) for t in (o, lse) + tuple(grads)]


def _port(q, k, v, g, mask, causal):
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    o = tat.flash_attention(*leaves, mask=tm, causal=causal)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    _, lse = tat.flash_fwd(*(t.detach() for t in leaves), tm, causal)
    return [t.detach().numpy() for t in (o, lse) + tuple(grads)]


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("name,T,causal,masked,tile", CASES)
def test_flash_attention_matches_jax(monkeypatch, mode, name, T, causal,
                                     masked, tile):
    monkeypatch.setenv("DS_TPU_FLASH_BWD", mode)
    q, k, v, g, mask = _inputs(T, masked)
    want = _jax(q, k, v, g, mask, causal, tile)
    got = _port(q, k, v, g, mask, causal)
    for label, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=label)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)])
def test_plain_kernel_functions_match_autograd(causal, masked):
    """K2's plain version (P recomputed from the saved lse, delta =
    rowsum(dO * O)) equals autograd through the dense reference."""
    q, k, v, g, mask = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(48, masked, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tat.mha_reference(*leaves, mask=mask, causal=causal)
    want = torch.autograd.grad(o, leaves, g)
    o2, lse = tat.mha_reference(q, k, v, mask, causal, return_lse=True)
    delta = (g * o2).sum(dim=-1, keepdim=True)
    got = tat.flash_bwd_reference(q, k, v, mask, lse, delta, g, causal)
    torch.testing.assert_close(o2, o.detach(), atol=ATOL, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("env", [None, "fused", "split"])
def test_bwd_mode_is_the_jax_choice(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("DS_TPU_FLASH_BWD", raising=False)
    else:
        monkeypatch.setenv("DS_TPU_FLASH_BWD", env)
    for t_kv in (1024, 6144, 8192, 16384):
        for jd, td in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
            assert tat._bwd_mode(t_kv, 64, td) == jat._bwd_mode(t_kv, 64, jd)


def test_wrapper_counts_no_launch_on_cpu_and_checks_shapes():
    tat.reset_launches()
    q, k, v, _, mask = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(32, True))
    tat.flash_attention(q, k, v, mask=mask, causal=True)
    assert all(n == 0 for n in tat.launches.values())
    with pytest.raises(ValueError):
        tat.flash_attention(q, k[:, :1], v, causal=True)
    with pytest.raises(ValueError):
        tat.flash_attention(q, k, v, mask=mask[:, :5])
    with pytest.raises(TypeError):
        tat.flash_attention(q, k.double(), v)


def _lse_cotangent(T, seed=9):
    return np.random.RandomState(seed).randn(B, H, T, 1).astype(np.float32)


@pytest.mark.parametrize("mode", ["fused", "split"])
@pytest.mark.parametrize("name,T,causal,masked,tile", CASES)
def test_flash_attention_with_lse_matches_jax(monkeypatch, mode, name, T,
                                              causal, masked, tile):
    """(o, lse) and the gradients of sum(o * g) + sum(lse * gl) through
    both outputs, against the JAX ``flash_attention_with_lse``."""
    monkeypatch.setenv("DS_TPU_FLASH_BWD", mode)
    q, k, v, g, mask = _inputs(T, masked)
    gl = _lse_cotangent(T)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(a, b, c):
        o, lse = jat.flash_attention_with_lse(a, b, c, mask=jm,
                                              causal=causal, block_q=tile,
                                              block_k=tile)
        return jnp.sum(o * g) + jnp.sum(lse * gl), (o, lse)

    (_, (jo, jlse)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o, lse = tat.flash_attention_with_lse(
        *leaves, mask=None if mask is None else torch.from_numpy(mask),
        causal=causal)
    grads = torch.autograd.grad((o, lse), leaves, (torch.from_numpy(g),
                                                   torch.from_numpy(gl)))
    got = [o.detach(), lse.detach()] + list(grads)
    want = [jo, jlse] + list(jgrads)
    for label, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, label
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0, err_msg=label)


@pytest.mark.parametrize("outputs", ["both", "o_only", "lse_only"])
def test_flash_attention_with_lse_grads_match_autograd(outputs):
    """The lse's gradient enters K2 through delta alone: against autograd
    through the dense reference, with a cotangent on either output or
    both (an unused output's gradient arrives as None)."""
    q, k, v, g, mask = (None if a is None else torch.from_numpy(a)
                        for a in _inputs(48, True, seed=4))
    gl = torch.from_numpy(_lse_cotangent(48))
    runs = []
    for fn in (tat.flash_attention_with_lse,
               lambda *a, **kw: tat.mha_reference(*a, return_lse=True,
                                                  **kw)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = fn(*leaves, mask=mask, causal=True)
        loss = {"both": (o * g).sum() + (lse * gl).sum(),
                "o_only": (o * g).sum(),
                "lse_only": (lse * gl).sum()}[outputs]
        # The lse does not depend on v: autograd gives None, K2 zeros.
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        runs.append([torch.zeros_like(x) if d is None else d
                     for x, d in zip(leaves, grads)])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
