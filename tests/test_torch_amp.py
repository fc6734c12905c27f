"""Port parity for the ``amp`` block, on the CPU: the JAX engine maps
``"amp": {"enabled": true}`` (the reference's apex hook) to bf16 compute on
fp32 masters with no loss scaling (``opt_level`` O0: fp32), refuses it
beside an fp16 or bf16 block and rejects an unknown ``opt_level``; the
port's engine does the same (the counterparts of JAX
``tests/unit/test_engine.py``'s amp tests).

SimpleModel from the JAX model's flax tree, the same numpy batches in both
packages. Tolerances: amp O1 equals the bf16 block's run loss for loss,
exactly, within each package (the same policy); O0 equals the fp32 run
exactly and the JAX O0 run within 1e-5 relative; the bf16 runs of the two
packages within 2**-6 relative (a few bf16 roundings of the logits apart).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.simple import SimpleModel as JSimple
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

torch.set_num_threads(1)

HIDDEN = 16
STEPS = 10


def _config(**extra):
    cfg = {"train_batch_size": 8, "steps_per_print": 100,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(extra)
    return cfg


def _batches():
    out = []
    for i in range(STEPS):
        rng = np.random.RandomState(i % 3)
        out.append((rng.randn(8, HIDDEN).astype(np.float32),
                    rng.randint(0, HIDDEN, size=(8,))))
    return out


@pytest.fixture(scope="module")
def params():
    x, y = _batches()[0]
    return jax.tree_util.tree_map(np.asarray, JSimple(hidden_dim=HIDDEN).init(
        jax.random.PRNGKey(0), x, y)["params"])


def _run(pkg, cfg, params):
    if pkg == "jax":
        engine = jds.initialize(model=JSimple(hidden_dim=HIDDEN),
                                model_parameters=params,
                                config_params=cfg)[0]
    else:
        engine = tds.initialize(model=SimpleModel(HIDDEN, device="cpu"),
                                model_parameters=params, config_params=cfg,
                                device="cpu")[0]
    losses = []
    for x, y in _batches():
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                            else loss))
    return engine, losses


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_amp_maps_to_bf16_policy(pkg, params):
    """amp (O1, the default) trains as the bf16 block does, loss for loss,
    with bf16 compute and no loss scaler; the loss falls."""
    engine, amp = _run(pkg, _config(amp={"enabled": True}), params)
    _, bf16 = _run(pkg, _config(bf16={"enabled": True}), params)
    assert "bfloat16" in str(engine.compute_dtype)
    assert engine.loss_scaler is None
    assert amp == bf16
    assert amp[-1] < amp[0]


def test_amp_runs_agree_across_packages(params):
    _, port = _run("port", _config(amp={"enabled": True}), params)
    _, ref = _run("jax", _config(amp={"enabled": True}), params)
    np.testing.assert_allclose(port, ref, rtol=2.0 ** -6)


def test_amp_opt_level_o0_stays_fp32(params):
    engine, o0 = _run("port", _config(amp={"enabled": True,
                                           "opt_level": "O0"}), params)
    _, fp32 = _run("port", _config(), params)
    _, ref = _run("jax", _config(amp={"enabled": True, "opt_level": "O0"}),
                  params)
    assert engine.compute_dtype == torch.float32
    assert o0 == fp32
    np.testing.assert_allclose(o0, ref, rtol=1e-5)


@pytest.mark.parametrize("block", ["fp16", "bf16"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_amp_exclusive_with_fp16_and_bf16(pkg, block, params):
    cfg = _config(amp={"enabled": True}, **{block: {"enabled": True}})
    with pytest.raises(ValueError, match="mutually exclusive"):
        _run(pkg, cfg, params)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_amp_unknown_opt_level_raises(pkg, params):
    with pytest.raises(ValueError, match="opt_level"):
        _run(pkg, _config(amp={"enabled": True, "opt_level": "O4"}), params)


@pytest.mark.parametrize("amp", [{"enabled": True},
                                 {"enabled": True, "opt_level": "O2",
                                  "loss_scale": "dynamic"},
                                 {"enabled": False}])
def test_amp_block_parses_as_the_jax_package_does(amp):
    cfg = _config(amp=amp)
    want = JConfig(None, param_dict=dict(cfg), world_size=1)
    got = TConfig(None, param_dict=dict(cfg))
    assert got.amp_enabled == want.amp_enabled
    assert got.amp_params == want.amp_params
