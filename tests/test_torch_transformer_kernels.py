"""Port parity for the fused transformer layer's row kernels on the CPU:
LayerNorm (K8), bias + GELU (K11) and dropout (K10a/K10b).

The same numpy inputs and output cotangents go through the JAX package's
functions (its Pallas kernels in interpret mode, as its own tests run them
off the TPU) and the port's (the plain versions its CUDA kernels are held
against on the card), in fp32. Forward outputs and every gradient agree
within 1e-5 of each tensor's max-abs.

Dropout at a rate above 0 draws its mask from Philox in the port and from
threefry in the JAX package, so there the port is held to what the mask
must do: kept values exact, the keep rate binomial, the mask a function of
the seed, and the backward replaying the forward's mask.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.transformer.kernels import dropout as tdrop
from deepspeed_tpu_torch.ops.transformer.kernels import gelu as tgelu
from deepspeed_tpu_torch.ops.transformer.kernels import layer_norm as tln

# The JAX package's kernels/__init__.py exports functions named like its
# modules (``dropout``), so the modules are fetched by their full names.
jdrop, jgelu, jln = (importlib.import_module(
    "deepspeed_tpu.ops.transformer.kernels." + name)
    for name in ("dropout", "gelu", "layer_norm"))

torch.set_num_threads(1)

TOL = 1e-5
SHAPE = (3, 10, 128)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


# ------------------------------------------------------------------ K8


@pytest.mark.parametrize("variant", ["plain", "residual", "bias_residual"])
def test_layer_norm_forward_and_grads_match_jax(variant):
    h = SHAPE[-1]
    x, res, gamma, beta, bias, g = _arrays(0, SHAPE, SHAPE, (h,), (h,), (h,),
                                           SHAPE)
    gamma, beta = 1.0 + 0.1 * gamma, 0.1 * beta
    use_res = variant != "plain"
    use_bias = variant == "bias_residual"
    jargs = [jnp.asarray(a) for a in (x, gamma, beta, bias, res)]

    def jfn(x_, g_, b_, bias_, r_):
        if not use_res:
            return jln.fused_layer_norm(x_, g_, b_, 1e-12)
        return jln.fused_bias_residual_layer_norm(
            x_, r_, g_, b_, bias=bias_ if use_bias else None, eps=1e-12)

    jout, vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp(jnp.asarray(g))

    tx, tg, tb, tbias, tres = _t(x, gamma, beta, bias, res)
    if use_res:
        out = tln.fused_bias_residual_layer_norm(
            tx, tres, tg, tb, bias=tbias if use_bias else None, eps=1e-12)
    else:
        out = tln.fused_layer_norm(tx, tg, tb, 1e-12)
    out.backward(torch.from_numpy(g))
    _close(out, jout)
    got = [tx.grad, tg.grad, tb.grad, tbias.grad, tres.grad]
    for name, t_grad, j_grad, used in zip(
            ("x", "gamma", "beta", "bias", "residual"), got, jgrads,
            (True, True, True, use_bias, use_res)):
        if used:
            _close(t_grad, j_grad)
        else:
            assert t_grad is None, name


def test_layer_norm_statistics_match_jax_kernel():
    """K8's plain version returns what the Pallas kernel returns: o, and mu
    and rstd ``[rows, 1]`` (two-pass variance)."""
    h = SHAPE[-1]
    x, res, gamma, beta, bias = _arrays(1, SHAPE, SHAPE, (h,), (h,), (h,))
    x = 3.0 + 100.0 * x  # a large mean: the two-pass variance is exact
    want = jln._ln_fwd(*(jnp.asarray(a) for a in (x, gamma, beta, bias, res)),
                       1e-5)
    got = tln.ln_fwd(*(torch.from_numpy(a) for a in (x, gamma, beta, bias,
                                                     res)), eps=1e-5)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


def test_layer_norm_reference_matches_jax():
    h = SHAPE[-1]
    x, gamma, beta = _arrays(2, SHAPE, (h,), (h,))
    _close(tln.layer_norm_reference(*(torch.from_numpy(a)
                                      for a in (x, gamma, beta))),
           jln.layer_norm_reference(*(jnp.asarray(a)
                                      for a in (x, gamma, beta))))


# ----------------------------------------------------------------- K11


def test_bias_gelu_forward_and_grads_match_jax():
    x, bias, g = _arrays(3, (2, 9, 256), (256,), (2, 9, 256))
    x = 3.0 * x
    jout, vjp = jax.vjp(jgelu.fused_bias_gelu, jnp.asarray(x),
                        jnp.asarray(bias))
    jdx, jdb = vjp(jnp.asarray(g))
    tx, tb = _t(x, bias)
    out = tgelu.fused_bias_gelu(tx, tb)
    out.backward(torch.from_numpy(g))
    _close(out, jout)
    _close(tx.grad, jdx)
    _close(tb.grad, jdb)
    _close(tgelu.bias_gelu_reference(torch.from_numpy(x),
                                     torch.from_numpy(bias)),
           jgelu.bias_gelu_reference(jnp.asarray(x), jnp.asarray(bias)))


# ---------------------------------------------------------------- K10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate,deterministic", [(0.0, False), (0.3, True)])
def test_dropout_off_equals_jax(dtype, rate, deterministic):
    """Rate 0, or deterministic: no kernel, the fp32 sum cast back, bit for
    bit as the JAX package computes it."""
    h = SHAPE[-1]
    x, bias, res = _arrays(4, SHAPE, (h,), SHAPE)
    jx, jres = (jnp.asarray(a, getattr(jnp, dtype)) for a in (x, res))
    tx, tres = (torch.from_numpy(a).to(getattr(torch, dtype))
                for a in (x, res))
    before = dict(tdrop.launches)
    got = tdrop.fused_bias_dropout_residual(
        tx, torch.from_numpy(bias), tres, rate, 7, deterministic)
    want = jdrop.fused_bias_dropout_residual(jx, jnp.asarray(bias), jres,
                                             rate, 7, deterministic)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert tdrop.dropout(tx, rate, 7, deterministic) is tx
    assert jdrop.dropout(jx, rate, 7, deterministic) is jx
    assert tdrop.launches == before


def test_philox_matches_the_published_known_answer():
    """Philox-4x32-10 of counter 0 under key 0: Random123's known-answer
    vector, so the CUDA source and the torch version both implement the
    published generator."""
    bits = tdrop.philox_bits(4, 0, "cpu").tolist()
    assert bits == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_key_takes_both_seed_words():
    """A seed past 2**32 reaches the key's high word, so it draws other
    bits than its low word alone; the key is the seed modulo 2**64."""
    low = tdrop.philox_bits(8, 5, "cpu")
    assert not torch.equal(low, tdrop.philox_bits(8, 5 + 2 ** 32, "cpu"))
    assert torch.equal(tdrop.philox_bits(8, 5 + 2 ** 64, "cpu"), low)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_exact_values_at_a_binomial_rate(rate):
    n_rows, h = 512, 128
    x, bias, res = _arrays(5, (n_rows, h), (h,), (n_rows, h))
    tx, tb, tr = (torch.from_numpy(a) for a in (x, bias, res))
    out = tdrop.fused_bias_dropout_residual(tx, tb, tr, rate, 11).numpy()
    keep = tdrop.dropout_mask((n_rows, h), rate, 11, "cpu").numpy()
    scale = np.float32(1.0 / (1.0 - rate))
    z = x + bias
    np.testing.assert_array_equal(out[keep], (z * scale + res)[keep])
    np.testing.assert_array_equal(out[~keep], res[~keep])
    # (x + b) / (1 - p) + r: exact where 1 / (1 - p) is (p = 0.5), else to
    # the rounding of the scale to fp32.
    np.testing.assert_allclose(out[keep], (z / (1.0 - rate) + res)[keep],
                               rtol=0 if rate == 0.5 else 2e-7, atol=1e-6)
    n = keep.size
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs((n - keep.sum()) - n * rate) < 4 * sigma


def test_dropout_mask_is_a_function_of_the_seed():
    x = torch.ones(64, 128)
    a = tdrop.dropout(x, 0.25, 3)
    b = tdrop.dropout(x, 0.25, 3)
    c = tdrop.dropout(x, 0.25, 4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # The mask depends on the flat index alone, not on the shape.
    assert torch.equal(tdrop.dropout(x.reshape(16, 4, 128), 0.25, 3)
                       .reshape(64, 128), a)
    assert torch.equal(tdrop.dropout_mask((64, 128), 0.25, 3, "cpu")
                       .reshape(-1),
                       tdrop.dropout_mask((8192,), 0.25, 3, "cpu"))


@pytest.mark.parametrize("fused", [True, False])
def test_dropout_backward_replays_the_forward_mask(fused):
    h = 64
    x, bias, res, g = _arrays(6, (40, h), (h,), (40, h), (40, h))
    tx, tb, tr = _t(x, bias, res)
    if fused:
        out = tdrop.fused_bias_dropout_residual(tx, tb, tr, 0.2, 9)
    else:
        out = tdrop.dropout(tx, 0.2, 9)
    out.backward(torch.from_numpy(g))
    dropped = (out - (tr if fused else 0)).detach() == 0
    assert dropped.any() and not dropped.all()
    keep = tdrop.dropout_mask((40, h), 0.2, 9, "cpu")
    assert torch.equal(~dropped, keep)
    dx = tx.grad
    assert bool((dx[dropped] == 0).all())
    scale = np.float32(1.0 / 0.8)
    np.testing.assert_array_equal(dx.numpy(), g * keep.numpy() * scale)
    if fused:
        np.testing.assert_allclose(tb.grad.numpy(), dx.numpy().sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tr.grad.numpy(), g)


def test_wrappers_use_their_plain_versions_only_on_the_cpu():
    """CPU tensors take the plain versions (no launch counted); a tensor on
    any other device that is not CUDA is refused, never computed on the
    host."""
    x = torch.randn(4, 64)
    vec = torch.ones(64)
    before = (dict(tln.launches), dict(tdrop.launches), tgelu.launches)
    tln.ln_fwd(x, vec, vec)
    tdrop.dropout_fwd(x, vec, x, 0.1, 1)
    tdrop.dropout_bwd(x, 0.1, 1)
    tgelu.bias_gelu_fwd(x, vec)
    assert (tln.launches, tdrop.launches, tgelu.launches) == before
    meta = torch.empty(4, 64, device="meta")
    mvec = torch.empty(64, device="meta")
    for call in (lambda: tln.ln_fwd(meta, mvec, mvec),
                 lambda: tdrop.dropout_fwd(meta, None, None, 0.1, 1),
                 lambda: tdrop.dropout_bwd(meta, 0.1, 1),
                 lambda: tgelu.bias_gelu_fwd(meta, mvec)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    with pytest.raises(ValueError, match="rate"):
        tdrop.dropout_fwd(x, None, None, 1.0, 1)
    with pytest.raises(ValueError, match="per-column"):
        tgelu.bias_gelu_fwd(x, torch.ones(32))
