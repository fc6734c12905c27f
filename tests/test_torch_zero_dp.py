"""Port parity for data-parallel ZeRO: stages 0-3 over 2 and 4 gloo ranks
on the CPU against the JAX engine on a 2- and 4-device sub-mesh of the
conftest's 8 virtual devices, on the same numpy batches and flax weights.

The ranks are processes started by the port's launcher
(``tests/torch_dist_worker.py``, a FileStore rendezvous in the test's
temporary directory, 60 s process-group timeouts); each takes its rows of
every global micro-batch. Both packages' configs enable bf16 (ZeRO needs
fp16 or bf16 in both) and both engines then compute in fp32
(``compute_dtype`` set before the first forward, as the JAX
``pg_correctness_test`` reference program does), so the two differ only
by fp32 summation order.

Tolerances (the training rule of ``test_torch_offload.py``):
- losses: 1e-5 relative, every micro-step;
- the fp32 masters after training: within 1e-5 of each tensor's max-abs,
  with Adam eps 1e-3 (eps 1e-8 turns fp32 summation noise in
  near-cancelling gradients into updates of up to 2 lr).

Also: each rank's shard shapes against the JAX arrays' shards (gradients
from stage 2, moments from stage 1, parameters at stage 3) on leaves
partitioned on dim 0, on dim 1 and replicated; stage-3 gathers per step
against the analytic count; no reduction inside an accumulation window;
elastic checkpoints saved at dp 4 and loaded at dp 2 in each direction
between the packages (and the port's dp 2 at dp 1); ``pg_correctness_test``
passing and catching a corrupted gradient; the fp16 overflow skip agreed
by a rank whose own shard is finite; two launcher-started ranks against
one process; the refusals of what the slice leaves out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as tds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.models.simple import LinearStack as JLinear
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.models.simple import LinearStack
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig
from tests.torch_dist_worker import start_ranks, wait_ranks

torch.set_num_threads(1)

TOL = 1e-5
STAGES = (0, 1, 2, 3)
DIMS = {"input_dim": 6, "hidden_dim": 6, "output_dim": 8, "num_layers": 2}
ODD = {"vocab_size": 1026, "n_positions": 130}


def _tree(p):
    return jax.tree_util.tree_map(lambda a: np.array(a), p)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, prefix + key + "."))
        else:
            out[prefix + key] = np.asarray(val)
    return out


def _config(stage, batch, gas, extra=None):
    cfg = {"train_batch_size": batch, "gradient_accumulation_steps": gas,
           "steps_per_print": 1000, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {
               "lr": 1e-2, "eps": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0,
           "zero_optimization": {"stage": stage}}
    cfg.update(extra or {})
    return cfg


def _gpt2_params(**kw):
    ids = np.random.RandomState(0).randint(0, 1024, size=(2, 16))
    return _tree(JGPT2(JGPT2Config.tiny(dtype=jnp.float32, **kw)).init(
        jax.random.PRNGKey(0), jnp.asarray(ids))["params"])


def _linear_params(zero_row=False):
    x = np.zeros((2, DIMS["input_dim"]), np.float32)
    p = _tree(JLinear(**DIMS).init(jax.random.PRNGKey(1), x,
                                   np.zeros(2, np.int32))["params"])
    if zero_row:  # input feature 0 reaches no hidden unit
        p["input_layer"]["kernel"][0] = 0.0
    return p


def _linear_batches(n, rows=8, big=None):
    out = []
    for s in range(n):
        rng = np.random.RandomState(100 + s)
        x = rng.randn(rows, DIMS["input_dim"]).astype(np.float32)
        if big is not None and s == big:
            x[:rows // 2, 0] = 3e4  # rank 0's rows, at dp 2
        out.append((x, rng.randint(0, DIMS["output_dim"], size=(rows,))))
    return out


GPT2_BATCHES = [(b, b) for b in (np.random.RandomState(s).randint(
    0, 1024, size=(4, 32)) for s in range(6))]
LIN_BATCHES = _linear_batches(6)


def _jax_engine(make, params, cfg, dp, fp32=True):
    mesh = jmesh.build_mesh(devices=jax.devices()[:dp])
    engine = jds.initialize(model=make(), model_parameters=jax.tree_util
                            .tree_map(jnp.asarray, params),
                            config_params=cfg, mesh=mesh)[0]
    if fp32:
        engine.compute_dtype = jnp.float32
    return engine


def _jax_train(engine, batches, save=None, save_after=None):
    losses = []
    for i, b in enumerate(batches):
        if save is not None and i == save_after:
            engine.save_checkpoint(save, tag="ck")
        loss = engine(*b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses


def _make_gpt2(**kw):
    return lambda: JGPT2(JGPT2Config.tiny(dtype=jnp.float32, **kw))


def _make_linear():
    return lambda: JLinear(**DIMS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX dp-4 checkpoint, then the port's dp-4 and dp-2 runs (one
    launcher call each, side by side: the dp-2 run loads the JAX
    checkpoint, the JAX engine later loads the dp-4 run's)."""
    root = tmp_path_factory.mktemp("zero_dp")
    lin = _linear_params()
    g = _gpt2_params()
    odd = _gpt2_params(**ODD)
    jeng = _jax_engine(_make_linear(), lin, _config(2, 16, 2), 4)
    jax_cont = _jax_train(jeng, LIN_BATCHES, save=str(root / "ck_jax4"),
                          save_after=4)[4:]
    lin_cfg = {s: _config(s, 16, 2) for s in STAGES}
    four = [dict(name="lin{}".format(s), kind="train", model="linear",
                 dims=DIMS, params=lin, config=lin_cfg[s],
                 fp32_compute=True, batches=LIN_BATCHES) for s in STAGES]
    four += [dict(name="odd{}".format(s), kind="train", model="gpt2",
                  cfg=ODD, params=odd, config=_config(s, 4, 1),
                  fp32_compute=True, batches=GPT2_BATCHES[:1])
             for s in STAGES]
    four.append(dict(name="save4", kind="train", model="linear", dims=DIMS,
                     params=lin, config=lin_cfg[2], fp32_compute=True,
                     batches=LIN_BATCHES, save=str(root / "ck_port4"),
                     save_after=4))
    two = [dict(name="gpt{}".format(s), kind="train", model="gpt2",
                params=g, config=_config(s, 8, 2), fp32_compute=True,
                batches=GPT2_BATCHES) for s in STAGES]
    two += [
        dict(name="load", kind="train", model="linear", dims=DIMS,
             params=lin, config=lin_cfg[2], fp32_compute=True,
             batches=LIN_BATCHES[4:], load=str(root / "ck_jax4")),
        dict(name="save2", kind="train", model="linear", dims=DIMS,
             params=lin, config=lin_cfg[2], fp32_compute=True,
             batches=LIN_BATCHES, save=str(root / "ck_port2"),
             save_after=4),
        dict(name="pg", kind="train", model="gpt2", params=g,
             config=_config(2, 8, 2), fp32_compute=True,
             batches=GPT2_BATCHES[:2], pg=True),
        dict(name="pg_corrupt", kind="train", model="gpt2", params=g,
             config=_config(2, 8, 2), fp32_compute=True,
             batches=GPT2_BATCHES[:2], pg=True, pg_corrupt=True),
        dict(name="freed", kind="freed", model="gpt2", params=g,
             config=_config(3, 4, 1), batches=GPT2_BATCHES),
        dict(name="fp16", kind="train", model="linear", dims=DIMS,
             params=_linear_params(zero_row=True),
             config=_fp16_config(), batches=_linear_batches(3, big=1))]
    launches = {4: start_ranks(4, four, str(root / "dp4")),
                2: start_ranks(2, two, str(root / "dp2"))}
    out = {"root": root, "jax_cont": jax_cont, "lin": lin, "gpt2": g,
           "odd": odd}
    out.update({dp: wait_ranks(p) for dp, p in launches.items()})
    return out


def _fp16_config():
    return {"train_batch_size": 8, "steps_per_print": 1000,
            "fp16": {"enabled": True, "loss_scale": 0,
                     "initial_scale_power": 8},
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2,
                                                     "eps": 1e-3}},
            "zero_optimization": {"stage": 2}}


def _masters_close(got, want_tree):
    want = _flat(_tree(want_tree))
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[name], w, atol=TOL * scale, rtol=0,
                                   err_msg=name)


CASES = [(dp, s) for dp in (2, 4) for s in STAGES]


@pytest.mark.parametrize("dp,stage", CASES)
def test_stage_matches_the_jax_engine(runs, dp, stage):
    """dp 2: GPT-2 tiny (K1/K2a's plain versions), gas 2; dp 4: the
    LinearStack whose leaves are partitioned on dim 1 or replicated, gas
    2. Every micro-step's loss and the masters after three steps."""
    if dp == 2:
        make, params, batches = _make_gpt2(), runs["gpt2"], GPT2_BATCHES
        got, cfg = runs[2][0]["gpt{}".format(stage)], _config(stage, 8, 2)
    else:
        make, params, batches = _make_linear(), runs["lin"], LIN_BATCHES
        got, cfg = runs[4][0]["lin{}".format(stage)], _config(stage, 16, 2)
    jeng = _jax_engine(make, params, cfg, dp)
    want = _jax_train(jeng, batches)
    np.testing.assert_allclose(got["losses"], want, rtol=TOL)
    _masters_close(got["masters"], jeng.params)
    # Every rank ends with the same masters.
    for rank in runs[dp][1:]:
        other = rank["gpt{}".format(stage) if dp == 2 else
                     "lin{}".format(stage)]["masters"]
        for name, m in got["masters"].items():
            np.testing.assert_array_equal(other[name], m)


def _jax_shard_shapes(make, params, cfg, dp):
    """{role: {name: the JAX shard shape}} for grads, moments, params."""
    eng = _jax_engine(make, params, cfg, dp)

    def shapes(sharding_tree):
        flat = {}
        for path, sh in jax.tree_util.tree_flatten_with_path(
                sharding_tree)[0]:
            name = ".".join(str(getattr(k, "key", k)) for k in path)
            flat[name] = sh
        leaves = _flat(_tree(params))
        return {n: tuple(flat[n].shard_shape(leaves[n].shape))
                for n in leaves}

    return {"grad": shapes(eng.grad_sharding),
            "moment": shapes(eng.opt_state_sharding["exp_avg"]),
            "param": shapes(eng.param_sharding)}


SHAPE_CASES = [("gpt2", 2, s) for s in STAGES] + \
    [("odd", 4, s) for s in STAGES] + [("linear", 4, s) for s in STAGES]


@pytest.mark.parametrize("model,dp,stage", SHAPE_CASES)
def test_shard_shapes_equal_the_jax_shards(runs, model, dp, stage):
    """Each rank holds what the JAX engine's data-axis sharding gives a
    device: gradient shards from stage 2 (whole below), moment shards from
    stage 1, parameter shards at stage 3 (GPT-2 odd: wte and wpe split on
    dim 1 at dp 4; LinearStack: replicated leaves and a dim-1 split)."""
    key, make, params, cfg = {
        "gpt2": ("gpt{}", _make_gpt2(), runs["gpt2"], _config(stage, 8, 2)),
        "odd": ("odd{}", _make_gpt2(**ODD), runs["odd"], _config(stage, 4,
                                                                  1)),
        "linear": ("lin{}", _make_linear(), runs["lin"],
                   _config(stage, 16, 2))}[model]
    want = _jax_shard_shapes(make, params, cfg, dp)
    for rank in runs[dp]:
        got = rank[key.format(stage)]
        names = got["names"]
        if stage == 0:
            assert "grad" not in got and "moment" not in got
            continue
        for role in ("grad", "moment", "param"):
            if role == "param" and stage < 3:
                assert role not in got
                continue
            held = dict(zip(names, got[role]))
            assert held == {n: want[role][n] for n in names}, role
    if model == "odd" and dp == 4 and stage == 3:
        assert want["param"]["wte"] == (1026, 16)  # dim 1
    if model == "linear" and stage >= 1:
        assert want["moment"]["input_layer.kernel"] == (6, 6)  # replicated
        assert want["moment"]["output_layer.kernel"] == (6, 2)  # dim 1


@pytest.mark.parametrize("model", ["gpt2", "odd", "linear"])
def test_stage3_gathers_per_micro_step(runs, model):
    """Stage 3 gathers the root unit once and each block twice (forward,
    then again for its backward) per micro-step: 1 + 2 n_layer."""
    got = {"gpt2": runs[2][0]["gpt3"], "odd": runs[4][0]["odd3"],
           "linear": runs[4][0]["lin3"]}[model]
    want = 1 if model == "linear" else 1 + 2 * 2
    assert got["gathers"] == [want] * len(got["gathers"])
    for stage in (0, 1, 2):
        key = {"gpt2": "gpt{}", "odd": "odd{}", "linear": "lin{}"}[model]
        dp = 2 if model == "gpt2" else 4
        assert set(runs[dp][0][key.format(stage)]["gathers"]) == {0}


@pytest.mark.parametrize("stage", STAGES)
def test_no_reduction_inside_the_accumulation_window(runs, stage):
    """gas 2: the first micro-step of each window runs no all-reduce or
    reduce-scatter; the boundary's does (stages 2-3 in its backward,
    stages 0-1 at its step)."""
    for key, dp in (("gpt{}", 2), ("lin{}", 4)):
        got = runs[dp][0][key.format(stage)]
        assert got["reductions"][0::2] == [0] * 3
        assert all(n > 0 for n in got["reductions"][1::2])
        if stage >= 2:
            assert all(n > 0 for n in got["backward_reductions"][1::2])
        else:
            assert got["backward_reductions"] == [0] * 6


def test_elastic_checkpoint_jax_dp4_loads_in_the_port_at_dp2(runs):
    """The JAX engine saves stage 2 at dp 4 (four shard files); two port
    ranks load it and their next step equals the JAX engine's own."""
    root = runs["root"]
    for r in range(4):
        assert (root / "ck_jax4" / "ck" /
                "zero_pp_rank_{}_mp_rank_00optim_states.pt".format(r)
                ).exists()
    np.testing.assert_allclose(runs[2][0]["load"]["losses"],
                               runs["jax_cont"], rtol=TOL)


def test_elastic_checkpoint_port_dp4_loads_in_jax_at_dp2(runs):
    """Four port ranks save stage 2 (each rank its file, the JAX layout);
    the JAX engine on two devices loads it; its next step equals the
    port's own."""
    root = runs["root"]
    assert runs[4][0]["save4"]["saved_at"] == 2
    for r in range(4):
        assert (root / "ck_port4" / "ck" /
                "zero_pp_rank_{}_mp_rank_00optim_states.pt".format(r)
                ).exists()
    jeng = _jax_engine(_make_linear(), runs["lin"], _config(2, 16, 2), 2)
    path, _ = jeng.load_checkpoint(str(root / "ck_port4"))
    assert path is not None and jeng.global_steps == 2
    got = _jax_train(jeng, LIN_BATCHES[4:])
    np.testing.assert_allclose(got, runs[4][0]["save4"]["losses"][4:],
                               rtol=TOL)


def test_elastic_checkpoint_port_dp2_loads_at_dp1(runs):
    """The port's dp-2 elastic save loads in one process (stage 2 at dp 1
    partitions nothing): the merged state gives the same next step."""
    engine = tds.initialize(
        model=LinearStack(device="cpu", **DIMS),
        model_parameters=runs["lin"], config_params=_config(2, 16, 2),
        device="cpu")[0]
    engine.compute_dtype = torch.float32
    path, _ = engine.load_checkpoint(str(runs["root"] / "ck_port2"))
    assert path is not None and engine.global_steps == 2
    losses = []
    for x, y in LIN_BATCHES[4:]:
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, runs[2][0]["save2"]["losses"][4:],
                               rtol=TOL)


def test_pg_correctness_test_passes_and_catches_a_fault(runs):
    """With the flag on, stage 2 at dp 2 trains (each step checked against
    the fp32 replicated program over the global batch); a doubled reduced
    gradient raises."""
    ok = runs[2][0]["pg"]
    assert np.isfinite(ok["losses"]).all() and "error" not in ok
    np.testing.assert_allclose(ok["losses"],
                               runs[2][0]["gpt2"]["losses"][:2], rtol=TOL)
    for rank in runs[2]:
        assert "pg_correctness_test" in rank["pg_corrupt"]["error"]


def test_fp16_overflow_skip_is_agreed_over_the_group(runs):
    """fp16 stage 2 at dp 2: the second batch overflows only rank 0's shard
    of the input layer's gradient; both ranks skip that step, and the
    masters equal the JAX engine's (which skips it too)."""
    got = [r["fp16"] for r in runs[2]]
    assert [g["skipped"] for g in got] == [1, 1]
    jeng = _jax_engine(_make_linear(), _linear_params(zero_row=True),
                       _fp16_config(), 2, fp32=False)
    _jax_train(jeng, _linear_batches(3, big=1))
    assert jeng.skipped_steps == 1
    want = _flat(_tree(jeng.params))
    for name, w in want.items():
        np.testing.assert_array_equal(got[0]["masters"][name],
                                      got[1]["masters"][name])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[0]["masters"][name], w,
                                   atol=1e-3 * scale, rtol=0, err_msg=name)


def test_a_dropped_partitioned_engine_is_freed(runs):
    """The gradient hooks hold the partition weakly: a dropped stage-3
    engine and its partition are collected (a strong reference from the
    parameters' C++ hooks kept each dropped engine's state alive)."""
    assert [r["freed"] for r in runs[2]] == [[True, True]] * 2


def test_two_launched_ranks_match_one_process(runs):
    """Two ranks started by the port's launcher (stage 0) give the loss
    trajectory of one process on the whole global batch."""
    engine = tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=runs["gpt2"], config_params=_config(0, 8, 2),
        device="cpu")[0]
    engine.compute_dtype = torch.float32
    losses = []
    for ids, _ in GPT2_BATCHES:
        loss = engine(ids, ids)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(runs[2][0]["gpt0"]["losses"], losses,
                               rtol=TOL)
    assert [r["gpt0"]["dp_rank"] for r in runs[2]] == [0, 1]


@pytest.mark.parametrize("zero", [
    {"stage": 2, "cpu_offload": True},
    {"stage": 2, "cpu_offload": True, "stream_gradients": True},
    {"stage": 0, "stream_gradients": True}])
def test_offload_over_ranks_is_refused(zero):
    """Over two data ranks ``cpu_offload`` parses (the offload tier
    partitions its host state); ``stream_gradients`` stays refused with the
    JAX engine's reason (it is the one-card tier)."""
    cfg = {"train_batch_size": 8, "bf16": {"enabled": True},
           "zero_optimization": zero}
    if not zero.get("stream_gradients"):
        got = TConfig(None, param_dict=cfg, world_size=2)
        assert got.zero_config.cpu_offload and \
            got.train_micro_batch_size_per_gpu == 4
        return
    with pytest.raises(ValueError, match="single-chip offload capacity"):
        TConfig(None, param_dict=cfg, world_size=2)


def test_onebit_adam_over_ranks_is_refused():
    """1-bit Adam parses over several ranks; with ZeRO it stays refused,
    naming its ROADMAP item (before any collective: a stand-in group)."""
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}}
    assert TConfig(None, param_dict=cfg, world_size=2).optimizer_name == \
        "onebitadam"
    grid = tmesh.Mesh((1, 2, 1, 1), 0, object())
    with pytest.raises(NotImplementedError, match="item 9"):
        tds.initialize(model=LinearStack(device="cpu", **DIMS),
                       config_params=_config(1, 4, 1, {"optimizer": cfg[
                           "optimizer"]}), device="cpu", mesh=grid)


@pytest.mark.parametrize("axis,item", [("num_mp", "model"),
                                       ("num_pp", "pipe"),
                                       ("num_sp", "seq")])
def test_other_mesh_axes_are_refused(axis, item):
    """The 'model', 'pipe' and 'seq' axes are all taken now (tensor
    parallelism, the pipeline, sequence parallelism)."""
    grid = tmesh.build_mesh(world_size=4, rank=0, **{axis: 2})
    assert grid.shape["data"] == 2 and grid.shape[item] == 2


def test_lamb_and_stage3_remat_over_ranks_are_refused():
    """Lamb over partitioned ranks builds (its trust ratio takes each
    tensor's norms over the data group: ``tests/test_torch_offload_ranks.py``
    trains it); stage 3 still refuses per-block remat. Both are decided
    while the engine is built, before any collective: a two-rank grid with
    a stand-in group suffices."""
    grid = tmesh.Mesh((1, 2, 1, 1), 0, object())
    lamb = _config(1, 4, 1, {"optimizer": {"type": "Lamb",
                                           "params": {"lr": 1e-3}}})
    engine = tds.initialize(model=LinearStack(device="cpu", **DIMS),
                            config_params=lamb, device="cpu", mesh=grid)[0]
    assert type(engine.optimizer).__name__ == "FusedLamb"
    assert engine.optimizer.norm_reduce is not None
    with pytest.raises(NotImplementedError, match="item 7"):
        tds.initialize(model=GPT2LMHeadModel(GPT2Config.tiny(
            dtype=torch.float32, remat=True), device="cpu"),
            config_params=_config(3, 4, 1), device="cpu", mesh=grid)
