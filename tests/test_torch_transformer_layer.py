"""Port parity for ``DeepSpeedTransformerLayer`` on the CPU, in fp32.

The JAX package's flax layer is initialised from a seed and its 12
parameters are carried into the port's layer. The same numpy input, padding
mask and output cotangent go through both at dropout 0: the output, the
input's gradient and all 12 parameter gradients agree within 1e-5 of each
tensor's max-abs, pre-LN and post-LN, with and without a mask.

At dropout above 0 the masks are the port's own (Philox), so the port is
held to itself: the memory flags (checkpointed recomputation) must redraw
the same masks.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerConfig as JConfig)
from deepspeed_tpu.ops.transformer import (
    DeepSpeedTransformerLayer as JLayer)
from deepspeed_tpu.ops.transformer import (
    transformer_layer_reference as jreference)
from deepspeed_tpu_torch.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer,
                                                 transformer_layer_reference)
from deepspeed_tpu_torch.ops.transformer.transformer import PARAM_NAMES
from deepspeed_tpu_torch.runtime.utils import load_flax_tree

torch.set_num_threads(1)

TOL = 1e-5
B, T, H, HEADS = 2, 32, 64, 4


def _close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=msg)


def _configs(pre_ln, dropout=0.0, **over):
    kw = dict(batch_size=B, max_seq_length=T, hidden_size=H,
              intermediate_size=4 * H, heads=HEADS,
              attn_dropout_ratio=dropout, hidden_dropout_ratio=dropout,
              num_hidden_layers=2, initializer_range=0.02,
              pre_layer_norm=pre_ln, **over)
    return (JConfig(dtype=jnp.float32, **kw),
            DeepSpeedTransformerConfig(dtype=torch.float32, **kw))


def _inputs(masked, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, H).astype(np.float32)
    g = rng.randn(B, T, H).astype(np.float32)
    mask = None
    if masked:  # row 0 pads its last 9 keys, row 1 drops a few inside
        mask = np.zeros((B, T), np.float32)
        mask[0, -9:] = -1e9
        mask[1, 5:8] = -1e9
    return x, g, mask


def _jax_params(jcfg, x):
    params = JLayer(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _port_layer(tcfg, params):
    layer = DeepSpeedTransformerLayer(tcfg, device="cpu", seed=None)
    load_flax_tree(layer, params)
    return layer.requires_grad_(True)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_output_and_every_grad_match_jax(pre_ln, masked):
    jcfg, tcfg = _configs(pre_ln)
    x, g, mask = _inputs(masked)
    params = _jax_params(jcfg, x)
    jmask = None if mask is None else jnp.asarray(mask)

    def jfn(p, x_):
        return JLayer(jcfg).apply({"params": p}, x_, attention_mask=jmask,
                                  deterministic=True)

    jout, vjp = jax.vjp(jfn, jax.tree_util.tree_map(jnp.asarray, params),
                        jnp.asarray(x))
    jgrads, jdx = vjp(jnp.asarray(g))

    layer = _port_layer(tcfg, params)
    tx = torch.from_numpy(x).requires_grad_()
    out = layer(tx, None if mask is None else torch.from_numpy(mask),
                deterministic=True)
    out.backward(torch.from_numpy(g))
    _close(out, jout, msg="output")
    _close(tx.grad, jdx, msg="x")
    for name in PARAM_NAMES:
        _close(getattr(layer, name).grad, jgrads[name], msg=name)


@pytest.mark.parametrize("pre_ln", [True, False])
def test_layer_reference_matches_layer_and_jax_reference(pre_ln):
    jcfg, tcfg = _configs(pre_ln)
    x, _, mask = _inputs(True, seed=1)
    params = _jax_params(jcfg, x)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    ref = transformer_layer_reference(tparams, torch.from_numpy(x),
                                      torch.from_numpy(mask), tcfg)
    _close(ref, jreference(params, jnp.asarray(x), jnp.asarray(mask), jcfg))
    with torch.no_grad():
        out = _port_layer(tcfg, params)(torch.from_numpy(x),
                                        torch.from_numpy(mask))
    _close(out, ref)


def test_init_follows_the_reference_scheme():
    """N(0, std) for the qkv and FF1 weights, N(0, std / sqrt(2L)) for the
    two output projections, zero biases, unit LayerNorm scales."""
    tcfg = dataclasses.replace(_configs(True)[1], hidden_size=256,
                               intermediate_size=1024, num_hidden_layers=8)
    layer = DeepSpeedTransformerLayer(tcfg, device="cpu", seed=3)
    out_std = 0.02 / 4.0
    for name, std in (("attn_qkvw", 0.02), ("inter_w", 0.02),
                      ("attn_ow", out_std), ("output_w", out_std)):
        w = getattr(layer, name)
        assert abs(float(w.std()) - std) < 0.03 * std, name
        assert abs(float(w.mean())) < 0.03 * std, name
    for name in ("attn_nw", "norm_w"):
        assert bool((getattr(layer, name) == 1).all())
    for name in ("attn_qkvb", "attn_ob", "attn_nb", "inter_b", "output_b",
                 "norm_b"):
        assert bool((getattr(layer, name) == 0).all())
    assert not layer.attn_qkvw.requires_grad
    again = DeepSpeedTransformerLayer(tcfg, device="cpu", seed=3)
    assert torch.equal(again.inter_w, layer.inter_w)


def _run(tcfg, params, x, g, mask, seed):
    layer = _port_layer(tcfg, params)
    tx = torch.from_numpy(x).requires_grad_()
    gen = torch.Generator().manual_seed(seed)
    out = layer(tx, None if mask is None else torch.from_numpy(mask),
                deterministic=False, generator=gen)
    out.backward(torch.from_numpy(g))
    return out.detach(), [tx.grad] + [getattr(layer, n).grad
                                      for n in PARAM_NAMES]


@pytest.mark.parametrize("dropout", [0.0, 0.2])
@pytest.mark.parametrize("pre_ln", [True, False])
def test_memory_flags_leave_outputs_and_grads_unchanged(pre_ln, dropout):
    """Each flag checkpoints a sub-computation; at dropout above 0 its
    recomputation in the backward redraws the forward's masks, so outputs
    and gradients equal the unflagged layer's."""
    jcfg, tcfg = _configs(pre_ln, dropout)
    x, g, mask = _inputs(True, seed=2)
    params = _jax_params(jcfg, x)
    base_out, base_grads = _run(tcfg, params, x, g, mask, seed=5)
    for flags in ({"gelu_checkpoint": True},
                  {"attn_dropout_checkpoint": True},
                  {"normalize_invertible": True},
                  {"gelu_checkpoint": True, "attn_dropout_checkpoint": True,
                   "normalize_invertible": True}):
        out, grads = _run(dataclasses.replace(tcfg, **flags), params, x, g,
                          mask, seed=5)
        torch.testing.assert_close(out, base_out, rtol=0, atol=0,
                                   msg=str(flags))
        for a, b in zip(grads, base_grads):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                       msg=str(flags))


def test_dropout_is_on_in_training_and_seeded_by_the_generator():
    jcfg, tcfg = _configs(True, 0.1)
    x, g, _ = _inputs(False, seed=3)
    params = _jax_params(jcfg, x)
    a, _ = _run(tcfg, params, x, g, None, seed=1)
    b, _ = _run(tcfg, params, x, g, None, seed=1)
    c, _ = _run(tcfg, params, x, g, None, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    layer = _port_layer(tcfg, params)
    with torch.no_grad():
        evals = [layer(torch.from_numpy(x), deterministic=True)
                 for _ in range(2)]
        # No generator: the config's seed (42 when unset), as in the JAX
        # package, so two training calls agree.
        trains = [layer(torch.from_numpy(x), deterministic=False)
                  for _ in range(2)]
    assert torch.equal(*evals) and torch.equal(*trains)
    assert not torch.equal(evals[0], trains[0])
    # config.training=False makes deterministic the default.
    layer.config = dataclasses.replace(tcfg, training=False)
    with torch.no_grad():
        assert torch.equal(layer(torch.from_numpy(x)), evals[0])


def test_stochastic_mode_runs_training_attention_in_bf16():
    """An fp32 layer with ``stochastic_mode`` trains its attention in bf16
    (tracking the exact layer at bf16 tolerance, not bit-equal) and
    evaluates exactly, as in the JAX package."""
    jcfg, tcfg = _configs(True)
    x, _, mask = _inputs(True, seed=4)
    params = _jax_params(jcfg, x)
    exact = _port_layer(tcfg, params)
    fast = _port_layer(dataclasses.replace(tcfg, stochastic_mode=True),
                       params)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        e_train = exact(tx, tm, deterministic=False)
        f_train = fast(tx, tm, deterministic=False)
        assert f_train.dtype == torch.float32
        torch.testing.assert_close(f_train, e_train, rtol=5e-2, atol=2e-2)
        assert not torch.equal(f_train, e_train)
        assert torch.equal(fast(tx, tm, deterministic=True),
                           exact(tx, tm, deterministic=True))


def test_config_from_dict_and_json_match_jax(tmp_path):
    spec = {"batch_size": 8, "hidden_size": 128, "heads": 4,
            "attn_dropout_ratio": 0.1, "hidden_dropout_ratio": 0.1,
            "num_hidden_layers": 12, "initializer_range": 0.02,
            "pre_layer_norm": False, "normalize_invertible": True,
            "unknown_key_ignored": 1}
    got = DeepSpeedTransformerConfig.from_dict(spec)
    want = JConfig.from_dict(spec)
    fields = [f.name for f in dataclasses.fields(JConfig) if f.name != "dtype"]
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert got.intermediate_size == 512 and not got.pre_layer_norm
    path = tmp_path / "layer.json"
    path.write_text(json.dumps(spec))
    assert DeepSpeedTransformerConfig.from_json_file(str(path)) == got
