"""Port parity: an MoE model trained through ``initialize`` over gloo ranks
on the CPU (started by the port's launcher through
``tests/torch_dist_worker.py``), against the JAX engine training the JAX
``test_moe_model_trains_with_engine`` model on one device, on the same
flax weights and numpy batches (fp32).

- The port of ``test_moe_model_trains_with_engine`` (20 steps: the loss
  falls, every loss finite) at dp 2 and at mp 2 x dp 2 (experts over
  'model').
- Loss traces within 1e-5 relative of the JAX engine's over 5 steps, and
  the final gathered fp32 masters within 1e-5 of each tensor's max-abs
  (Adam eps 1e-3: with 1e-8 Adam's first step is sign(g), which turns
  fp32 summation noise into whole steps).
- Where capacity binds (factor 0.5, minimum 1: tokens drop), dp 2 and mp
  2 x dp 2 still equal the JAX engine on the whole batch: gating is over
  the global batch, and ``l_aux``'s gradient is counted once.
- 'Jitter' noise at dp 2 is one draw over the global batch: dp 2 equals
  one process on the whole batch from the same seed.
- A checkpoint saved at mp 2 holds the full ``[E, ...]`` expert stacks
  under the JAX names; the port at mp 1 and the JAX engine both load it,
  and one saved by one process loads at mp 2.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.parallel import mesh as jmesh
from tests.unit.test_moe import _moe_layer as _jax_layer
from tests.torch_dist_worker import moe_model, start_ranks, wait_ranks

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.moe import top1gating
from deepspeed_tpu_torch.parallel.mesh import Mesh, build_mesh

torch.set_num_threads(1)

TOL = 1e-5
BASE = {"num_experts": 4, "k": 1, "capacity_factor": 2.0}
BINDS = {"num_experts": 4, "k": 1, "capacity_factor": 0.5,
         "min_capacity": 1}
JITTER = dict(BASE, noisy_gate_policy="Jitter")


class JMoEModel(fnn.Module):
    """The JAX test's model with the MoE's settings as fields."""

    num_experts: int = 4
    k: int = 1
    capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: str = None

    @fnn.compact
    def __call__(self, x, y):
        h = fnn.Dense(16)(x)
        out, l_aux, _ = _jax_layer(
            num_experts=self.num_experts, k=self.k,
            capacity_factor=self.capacity_factor,
            min_capacity=self.min_capacity,
            noisy_gate_policy=self.noisy_gate_policy)(h[:, None, :])
        h = h + out[:, 0]
        logits = fnn.Dense(8)(h)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, y[:, None], axis=1)[:, 0]
        return jnp.mean(lse - gold) + 0.01 * l_aux


def _config(eps=1e-3):
    return {"train_batch_size": 8, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3,
                                                     "eps": eps}}}


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, 16).astype(np.float32)
    y = rng.randint(0, 8, size=(8,))
    return [(x, y)] * n


def _params(kw):
    x, y = _batches(1)[0]
    p = JMoEModel(**kw).init(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(y))["params"]
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_run(kw, params, steps, load=None):
    engine = jds.initialize(
        model=JMoEModel(**kw), model_parameters=jax.tree_util.tree_map(
            jnp.asarray, params), config_params=_config(),
        mesh=jmesh.build_mesh(devices=jax.devices()[:1], num_dp=1))[0]
    if load is not None:
        engine.load_checkpoint(load, tag="ck")
        return engine
    losses = []
    for x, y in _batches(steps):
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses, _flat(engine.params)


def _task(name, mp, kw, params, steps, eps=1e-3, save=None, config=None,
          load=None):
    return {"name": name, "kind": "moe_train", "mp": mp, "moe": kw,
            "params": params, "config": config or _config(eps),
            "batches": _batches(steps), "save": save, "load": load}


def _one_process(kw, params, steps, save=None):
    """The port in one process (no process group): its losses and fp32
    masters after ``steps``, and an optional checkpoint."""
    engine, _, _, _ = tds.initialize(
        model=moe_model(**kw), model_parameters=params,
        config_params=_config(), device="cpu",
        mesh=Mesh((1, 1, 1, 1), 0, None))
    losses = []
    for x, y in _batches(steps):
        loss = engine(torch.from_numpy(x), torch.from_numpy(y))
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    if save is not None:
        engine.save_checkpoint(save, tag="ck")
    return losses, {n: f.numpy() for n, f in
                    zip(engine._names, engine._full_masters())}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_train")
    params = {name: _params(kw) for name, kw in
              (("base", BASE), ("binds", BINDS), ("jitter", JITTER))}
    ck = str(root / "ck_mp2")
    ck1 = str(root / "ck_mp1")
    _, mp1_masters = _one_process(BINDS, params["binds"], 2, save=ck1)
    two = start_ranks(2, [
        _task("dp2", 1, BASE, params["base"], 5),
        _task("dp2_binds", 1, BINDS, params["binds"], 5),
        _task("dp2_jitter", 1, JITTER, params["jitter"], 5),
        _task("dp2_long", 1, BASE, params["base"], 20, eps=1e-8),
        _task("mp2", 2, BINDS, params["binds"], 3, save=ck),
        _task("mp2_load", 2, BINDS, params["binds"], 0, load=ck1)],
        str(root / "w2"))
    four = start_ranks(4, [
        _task("mp2dp2", 2, BASE, params["base"], 5),
        _task("mp2dp2_binds", 2, BINDS, params["binds"], 5),
        _task("mp2dp2_long", 2, BASE, params["base"], 20, eps=1e-8),
        _task("mp2dp2_zero2", 2, BASE, params["base"], 5,
              config=dict(_config(), bf16={"enabled": True},
                          zero_optimization={"stage": 2}))],
        str(root / "w4"))
    jax_runs = {name: _jax_run(kw, params[name], 5) for name, kw in
                (("base", BASE), ("binds", BINDS))}
    return {"params": params, "jax": jax_runs, "ck": ck,
            "mp1_masters": mp1_masters,
            "two": wait_ranks(two, timeout=240),
            "four": wait_ranks(four, timeout=240)}


@pytest.mark.parametrize("name,n", [("dp2_long", "two"),
                                    ("mp2dp2_long", "four")])
def test_moe_model_trains_with_engine(runs, name, n):
    for r in runs[n]:
        losses = r[name]["losses"]
        assert len(losses) == 20 and np.isfinite(losses).all()
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("name,n,ref", [
    ("dp2", "two", "base"), ("mp2dp2", "four", "base"),
    ("dp2_binds", "two", "binds"), ("mp2dp2_binds", "four", "binds")])
def test_losses_and_masters_equal_the_jax_engine(runs, name, n, ref):
    """dp 2, and experts over mp 2 x dp 2, against the JAX engine on the
    whole batch; with ``binds`` capacity drops tokens, so only global
    gating (and ``l_aux``'s gradient counted once) gives JAX's numbers."""
    want_losses, want = runs["jax"][ref]
    for r in runs[n]:
        got = r[name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL)
        assert set(got["masters"]) == set(want)
        for leaf in want:
            scale = np.abs(want[leaf]).max()
            assert np.abs(got["masters"][leaf] - want[leaf]).max() <= \
                TOL * scale, (name, leaf)


def test_capacity_binds(runs):
    """The ``binds`` setting drops tokens on the global batch, and a rank
    gating only its own half would book other slots: the JAX trace is not
    the per-rank gating's."""
    x, _ = _batches(1)[0]
    p = runs["params"]["binds"]
    h = x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"]
    logits = torch.from_numpy(h @ p["MoE_0"]["gate"]["kernel"])
    _, whole, _, counts = top1gating(logits, capacity_factor=0.5,
                                     min_capacity=1)
    assert int(counts.sum()) < 8
    halves = [top1gating(logits[i:i + 4], capacity_factor=0.5,
                         min_capacity=1)[1] for i in (0, 4)]
    assert not torch.equal(torch.cat([c.sum(dim=(1, 2)) for c in halves]),
                           whole.sum(dim=(1, 2)))


def test_jitter_is_one_draw_over_the_global_batch(runs):
    """'Jitter' at dp 2: the noise comes from one generator seeded alike
    on both data ranks and drawn over the gathered logits, so dp 2 trains
    what one process trains on the whole batch from the same seed."""
    losses, masters = _one_process(JITTER, runs["params"]["jitter"], 5)
    for r in runs["two"]:
        got = r["dp2_jitter"]
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
        for leaf, want in masters.items():
            assert np.abs(got["masters"][leaf] - want).max() <= \
                TOL * np.abs(want).max(), leaf


def test_expert_shards_over_the_model_ranks(runs):
    """At mp 2 each rank holds 2 of the 4 experts' stacks; the router and
    the dense layers stay whole."""
    full = _flat(runs["params"]["binds"])
    for r in runs["two"]:
        shards = r["mp2"]["shards"]
        assert set(shards) == set(full)
        for leaf, arr in full.items():
            want = (arr.shape[0] // 2,) + arr.shape[1:] \
                if ".experts." in leaf else arr.shape
            assert shards[leaf] == want, leaf


def test_mp1_checkpoint_loads_at_mp2(runs):
    """A checkpoint saved by one process loads at mp 2: each rank cuts its
    experts' shards, and the gathered masters are the saved ones."""
    want = runs["mp1_masters"]
    for r in runs["two"]:
        got = r["mp2_load"]
        assert got["loaded"]
        assert got["shards"]["MoE_0.experts._MLP_0.Dense_0.kernel"] == \
            (2, 16, 32)
        for leaf, arr in want.items():
            np.testing.assert_array_equal(got["masters"][leaf], arr)


def test_mp2_checkpoint_loads_at_mp1_and_in_jax(runs):
    """The mp-2 checkpoint holds JAX's full ``[E, ...]`` leaves under the
    flax names: the port at mp 1 and the JAX engine load the gathered
    masters."""
    want = runs["two"][0]["mp2"]["masters"]
    engine, _, _, _ = tds.initialize(
        model=moe_model(**BINDS), model_parameters=runs["params"]["binds"],
        config_params=_config(), device="cpu",
        mesh=Mesh((1, 1, 1, 1), 0, None))
    path, _ = engine.load_checkpoint(runs["ck"], tag="ck")
    assert path is not None
    got = {n: f.numpy() for n, f in zip(engine._names,
                                        engine._full_masters())}
    assert got["MoE_0.experts._MLP_0.Dense_0.kernel"].shape == (4, 16, 32)
    for leaf in want:
        np.testing.assert_array_equal(got[leaf], want[leaf])
    jeng = _jax_run(BINDS, runs["params"]["binds"], 0, load=runs["ck"])
    for leaf, arr in _flat(jeng.params).items():
        np.testing.assert_array_equal(arr, want[leaf])


def test_zero2_bf16_over_experts_and_data(runs):
    """ZeRO-2 in bf16 over mp 2 x dp 2: the expert stacks split over
    'model' and partitioned over 'data' on another dim; the data group's
    losses agree on every rank and stay near the fp32 trace."""
    want, _ = runs["jax"]["base"]
    got = [r["mp2dp2_zero2"]["losses"] for r in runs["four"]]
    assert all(g == got[0] for g in got)
    np.testing.assert_allclose(got[0], want, rtol=2e-2)


@pytest.mark.parametrize("what,config,mesh", [
    ("ZeRO stage 3", dict(bf16={"enabled": True},
                          zero_optimization={"stage": 3}), None),
    ("1-bit Adam", {"optimizer": {"type": "OneBitAdam",
                                  "params": {"lr": 1e-3}}}, None),
    ("sequence parallelism", {}, {"num_sp": 2})])
def test_refused_moe_compositions_name_their_item(what, config, mesh):
    with pytest.raises(ValueError, match="item 20") as info:
        tds.initialize(model=moe_model(**BASE),
                       config_params=dict(_config(), **config),
                       device="cpu", mesh=build_mesh(
                           world_size=2, rank=0, **mesh) if mesh else
                       Mesh((1, 1, 1, 1), 0, None))
    assert what in str(info.value)
