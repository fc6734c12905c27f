"""Progressive layer drop in the port against the JAX package's, on the
CPU: the schedule (theta(t) = (1 - theta_bar) exp(-gamma t) + theta_bar),
the engine passing ``progressive_layer_drop``/``pld_theta`` to the forward
and advancing the schedule at each step (PLD_SimpleModel, the same flax
weights and batch in both packages: losses within 1e-5 relative, theta to
1e-12), and a model without those arguments training with the block
disabled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.simple import PLD_SimpleModel as JPLDModel
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop as JPLD)

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.simple import PLD_SimpleModel, SimpleModel
from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop)

torch.set_num_threads(1)

_rng = np.random.RandomState(0)
X = _rng.randn(8, 8).astype(np.float32)
Y = _rng.randint(0, 8, size=(8,))


@pytest.mark.parametrize("theta", [0, 0.1, 0.9, 1.0])
def test_pld_schedule_matches_jax(theta):
    gamma = 0.001
    ours, theirs = ProgressiveLayerDrop(theta, gamma), JPLD(theta, gamma)
    assert ours.get_state() == theirs.get_state()
    for i in range(10):
        ours.update_state(i)
        theirs.update_state(i)
        want = (1. - theta) * np.exp(-gamma * i) + theta
        assert abs(ours.get_theta() - want) < 1e-12
        assert ours.get_theta() == theirs.get_theta()


@pytest.mark.parametrize("theta", [0.1, 1.0])
def test_pld_model_trains_as_jax(theta):
    gamma = 0.1
    config = {"train_batch_size": 8, "steps_per_print": 1,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
              "progressive_layer_drop": {"enabled": True, "theta": theta,
                                         "gamma": gamma}}
    params = jax.tree_util.tree_map(np.asarray, JPLDModel(hidden_dim=8).init(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(Y))["params"])
    engine = tds.initialize(model=PLD_SimpleModel(8, device="cpu"),
                            model_parameters=params, config_params=config,
                            device="cpu")[0]
    jeng = jds.initialize(model=JPLDModel(hidden_dim=8), config_params=config,
                          model_parameters=jax.tree_util.tree_map(
                              jnp.asarray, params),
                          mesh=jmesh.build_mesh(devices=jax.devices()[:1]))[0]
    assert engine.pld_enabled() and engine.progressive_layer_drop is not None
    for i in range(5):
        loss = engine(torch.from_numpy(X), torch.from_numpy(Y))
        engine.backward(loss)
        engine.step()
        jloss = jeng(X, Y)
        jeng.backward(jloss)
        jeng.step()
        want = (1. - theta) * np.exp(-gamma * i) + theta
        assert abs(engine.progressive_layer_drop.get_theta() - want) < 1e-12
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)


def test_non_pld_model():
    engine = tds.initialize(
        model=SimpleModel(8, device="cpu"), device="cpu",
        config_params={"train_batch_size": 8,
                       "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                       "progressive_layer_drop": {"enabled": False}})[0]
    assert not engine.pld_enabled() and engine.progressive_layer_drop is None
    loss = engine(torch.from_numpy(X), torch.from_numpy(Y))
    engine.backward(loss)
    engine.step()
    assert np.isfinite(float(loss.detach()))
