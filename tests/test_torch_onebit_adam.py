"""Port parity for 1-bit Adam and its compressed collectives, on the CPU.

One launch of four gloo ranks (``tests/torch_dist_worker.py`` through the
port's launcher) runs: ``compressed_allreduce_many`` on given worker rows,
once and 30 times with the errors fed back; the engine's 1-bit path on
SimpleModel and tiny GPT-2 at data-parallel size 4 through the freeze
(``freeze_step`` 2); a resume from a checkpoint past the freeze, from the
JAX engine's checkpoint too, and a rollback to one before it; the
pipeline's compressed update (2 stages x 2 data ranks). The JAX side runs
its engine's 1-bit hot path (``shard_map`` over 'data') on four virtual
devices from the same flax weights and batches, and its collectives under
``shard_map``; numpy simulations of the reference algorithm (the JAX
tests') check both.

Tolerances: the compressed all-reduce and the 1-bit update within 1e-6
(relative to each tensor's max-abs) of numpy and of JAX; engine losses
within 1e-5 relative of the JAX engine's through the freeze, and the
masters within 1e-5 of each tensor's max-abs. JAX's HLO wire assertions
are ``comm.stats`` byte counts here: past the freeze a rank hands the
packed signs (n/8 bytes per padded leaf) and one fp32 scale per leaf and
phase, and no gradient all-reduce runs (the one all-reduce left is
``train_batch``'s 4-byte loss mean).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.models.simple import SimpleModel as JSimpleModel
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.runtime import custom_collectives as jcc
from deepspeed_tpu.runtime.fp16.onebit_adam import OnebitAdam as JOnebitAdam
from deepspeed_tpu.utils.jax_compat import shard_map
from tests.torch_dist_worker import start_ranks, wait_ranks
from tests.unit.test_onebit_adam import _numpy_compressed_allreduce

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime import custom_collectives as tcc
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam

torch.set_num_threads(1)

TOL = 1e-6
LOSS_RTOL = 1e-5
WEIGHT_TOL = 1e-5
W = 4
HIDDEN, BATCH, STEPS, FREEZE = 16, 16, 6, 2

_rng = np.random.RandomState(3)
X = _rng.randn(BATCH, HIDDEN).astype(np.float32)
Y = _rng.randint(0, HIDDEN, size=(BATCH,))
GPT2_IDS = np.random.RandomState(4).randint(0, 1024, size=(8, 16))


def _tree(p):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), p)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    limit = tol * max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= limit, (np.abs(got - want).max(),
                                               limit)


def _onebit_config(freeze=FREEZE, batch=BATCH, lr=1e-2, eps=1e-8):
    return {"train_batch_size": batch, "steps_per_print": 1000,
            "optimizer": {"type": "OneBitAdam",
                          "params": {"lr": lr, "freeze_step": freeze,
                                     "eps": eps}}}


def _simple_params():
    return _tree(JSimpleModel(hidden_dim=HIDDEN).init(
        jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(Y))["params"])


def _gpt2_params():
    cfg = JGPT2Config.tiny(dtype=jnp.float32, use_flash_attention=False)
    return _tree(JGPT2(cfg).init(jax.random.PRNGKey(0), jnp.asarray(
        GPT2_IDS[:2]))["params"])


def _jax_engine(model, params, config):
    engine = jds.initialize(
        model=model, config_params=config,
        model_parameters=jax.tree_util.tree_map(jnp.asarray, params),
        mesh=jmesh.build_mesh(devices=jax.devices()[:W]))[0]
    assert engine._onebit_spmd_eligible()
    return engine


def _jax_run(engine, batch, steps):
    return [float(engine.train_batch(batch=batch)) for _ in range(steps)]


def _compressed_inputs():
    rng = np.random.RandomState(1)
    out = {"buffers": [], "worker_errors": [], "server_errors": []}
    for n in (tcc.corrected_size(200, W), tcc.corrected_size(64, W)):
        out["buffers"].append(rng.randn(W, n).astype(np.float32))
        out["worker_errors"].append(
            (rng.randn(W, n) * 0.1).astype(np.float32))
        out["server_errors"].append(
            (rng.randn(W, n // W) * 0.1).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("onebit")
    sp, gp = _simple_params(), _gpt2_params()
    # The JAX engine's own run, and its checkpoint past the freeze.
    jeng = _jax_engine(JSimpleModel(hidden_dim=HIDDEN), sp, _onebit_config())
    jax_losses = _jax_run(jeng, (X, Y), 4)
    jeng.save_checkpoint(str(root / "jax_ck"), tag="ck")
    jax_losses += _jax_run(jeng, (X, Y), STEPS - 4)
    simple = dict(kind="onebit", model="simple", hidden=HIDDEN, params=sp,
                  config=_onebit_config(), batches=[(X, Y)] * STEPS)
    inputs = _compressed_inputs()
    pipe_cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
                "steps_per_print": 1000,
                "optimizer": {"type": "OneBitAdam",
                              "params": {"lr": 1e-3, "freeze_step": 1}}}
    pipe_data = [(np.random.RandomState(7 + i).randn(8, 16).astype(
        np.float32), np.random.RandomState(70 + i).randint(0, 8, size=(8,)))
        for i in range(4)]
    tasks = [
        dict(name="compressed", kind="compressed", repeats=30, **inputs),
        dict(simple, name="simple", save=str(root / "port_ck"), save_after=4,
             save_end=str(root / "port_end")),
        dict(simple, name="resume", load=str(root / "port_ck"), tag="ck",
             batches=[(X, Y)] * (STEPS - 4)),
        dict(simple, name="resume_jax", load=str(root / "jax_ck"), tag="ck",
             batches=[(X, Y)] * (STEPS - 4)),
        dict(simple, name="pre_freeze", config=_onebit_config(freeze=10),
             batches=[(X, Y)], save_end=str(root / "pre")),
        dict(simple, name="rollback", batches=[(X, Y)] * 4,
             rollback={"freeze_step": 10, "load": str(root / "pre")}),
        dict(name="gpt2", kind="onebit", model="gpt2", params=gp,
             config=_onebit_config(batch=8, eps=1e-3), fp32_compute=True,
             batches=[(GPT2_IDS, GPT2_IDS)] * (FREEZE + 1)),
        dict(name="pipe", kind="pipe", layers="dense", stages=2,
             params=None, config=pipe_cfg, batches=pipe_data, steps=2,
             onebit_capture=True),
    ]
    proc = start_ranks(W, tasks, str(root / "w4"))
    jgpt2 = _jax_engine(JGPT2(JGPT2Config.tiny(
        dtype=jnp.float32, use_flash_attention=False)), gp,
        _onebit_config(batch=8, eps=1e-3))
    jgpt2.compute_dtype = jnp.float32
    jax_gpt2 = _jax_run(jgpt2, (GPT2_IDS, GPT2_IDS), FREEZE + 1)
    ranks = wait_ranks(proc, timeout=240)
    return {"ranks": ranks, "jax": jax_losses, "jax_params": _flat(_tree(
        jeng.params)), "jax_gpt2": jax_gpt2, "jax_gpt2_params": _flat(_tree(
            jgpt2.params)), "inputs": inputs, "root": root, "params": sp}


def test_pack_unpack_roundtrip_matches_numpy_and_jax():
    x = np.random.RandomState(0).randn(64).astype(np.float32)
    x[5] = 0.0  # >= 0 packs as 1
    packed = tcc.pack_signs(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(packed, np.packbits(x >= 0))
    np.testing.assert_array_equal(packed, np.asarray(jcc.pack_signs(
        jnp.asarray(x))))
    np.testing.assert_array_equal(tcc.unpack_signs(torch.from_numpy(
        packed)).numpy(), np.where(x >= 0, 1.0, -1.0))


def test_corrected_size_matches_jax():
    for w in (1, 2, 4, 8):
        for n in (7, 64, 100, 1000):
            c = tcc.corrected_size(n, w)
            assert c == jcc.corrected_size(n, w)
            assert c >= n and c % w == 0 and (c // w) % 8 == 0


def test_quantize_error_feedback_matches_jax():
    x = np.random.RandomState(3).randn(64).astype(np.float32)
    err, jerr = torch.zeros(64), jnp.zeros(64)
    total = torch.zeros(64)
    for _ in range(50):
        q, err = tcc.quantize_error_feedback(torch.from_numpy(x), err)
        jq, jerr = jcc.quantize_error_feedback(jnp.asarray(x), jerr)
        _close(q.numpy(), jq)
        total += q
    np.testing.assert_allclose((total / 50).numpy(), x, atol=0.25)


def test_compressed_allreduce_matches_numpy_and_jax(runs):
    """Each buffer's exchange equals the reference algorithm's numpy
    simulation and the JAX collective under shard_map (the averages on
    every rank, each rank's new worker and server errors)."""
    inp = runs["inputs"]
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))

    def per_device(b, we, se):
        out, nwe, nse = jcc.compressed_allreduce(b[0], we[0], se[0], "data")
        return out[None], nwe[None], nse[None]

    fn = jax.jit(shard_map(per_device, mesh=mesh,
                           in_specs=(P("data", None),) * 3,
                           out_specs=(P("data", None),) * 3))
    for i in range(len(inp["buffers"])):
        args = [inp[k][i] for k in ("buffers", "worker_errors",
                                    "server_errors")]
        sim = _numpy_compressed_allreduce(*args)
        jout = [np.asarray(a) for a in fn(*args)]
        for r, rank in enumerate(runs["ranks"]):
            got = rank["compressed"]
            for g, ref_sim, ref_jax in ((got["out"][i], sim[0],
                                         jout[0][r]),
                                        (got["we"][i], sim[1][r],
                                         jout[1][r]),
                                        (got["se"][i], sim[2][r],
                                         jout[2][r])):
                _close(g, ref_sim)
                _close(g, ref_jax)


def test_compressed_wire_bytes(runs):
    """One all-to-all of the packed signs (n/8 bytes, all buffers in one
    message) and three all-gathers: the worker scales, the server chunks'
    signs (n/(8W)) and their scales."""
    n = sum(b.shape[1] for b in runs["inputs"]["buffers"])
    leaves = len(runs["inputs"]["buffers"])
    for rank in runs["ranks"]:
        st = rank["compressed"]["stats"]
        assert (st["all_to_all"], st["all_gather"], st["all_reduce"]) == \
            (1, 3, 0)
        assert st["all_to_all_bytes"] == n // 8
        assert st["all_gather_bytes"] == n // (8 * W) + 2 * 4 * leaves


def test_error_feedback_converges_to_mean(runs):
    """Thirty exchanges of the same buffers, errors fed back: the running
    mean of the outputs tracks the true mean (the JAX test's bound)."""
    for i, b in enumerate(runs["inputs"]["buffers"]):
        true = b.mean(0)
        avg = runs["ranks"][0]["compressed"]["mean_out"][i]
        assert np.abs(avg - true).mean() < \
            0.15 * np.abs(true).mean() + 0.05


def test_onebit_warmup_matches_jax():
    """Before the freeze: Adam without bias correction."""
    rng = np.random.RandomState(4)
    p0, g = (rng.randn(10).astype(np.float32) for _ in range(2))
    opt = OnebitAdam(lr=1e-2, freeze_step=100)
    p = torch.from_numpy(p0.copy())
    state = opt.init_state([p])
    opt.update([p], [torch.from_numpy(g)], state)
    jopt = JOnebitAdam(lr=1e-2, freeze_step=100)
    jp, js = jopt.update({"w": jnp.asarray(p0)}, {"w": jnp.asarray(g)},
                         jopt.init_state({"w": jnp.asarray(p0)}))
    _close(p.numpy(), jp["w"])
    m, v = 0.1 * g, 0.001 * g ** 2
    _close(p.numpy(), p0 - 1e-2 * m / (np.sqrt(v) + 1e-8))
    assert state["step"] == int(js["step"]) == 1


def test_onebit_frozen_phase_matches_jax():
    """One process: the compression degenerates to the one-party
    quantization; the variance freezes, the momentum is +-scale, the error
    buffers engage; every tensor as JAX's."""
    rng = np.random.RandomState(5)
    p0, g = (rng.randn(20).astype(np.float32) for _ in range(2))
    opt = OnebitAdam(lr=1e-2, freeze_step=1)
    p = torch.from_numpy(p0.copy())
    state = opt.init_state([p])
    jopt = JOnebitAdam(lr=1e-2, freeze_step=1)
    jp = {"w": jnp.asarray(p0)}
    js = jopt.init_state(jp)
    for _ in range(2):
        opt.update([p], [torch.from_numpy(g)], state)
        jp, js = jopt.update(jp, {"w": jnp.asarray(g)}, js)
        v_warm = state["exp_avg_sq"][0].clone() if _ == 0 else v_warm
    _close(p.numpy(), jp["w"])
    for key in ("exp_avg", "exp_avg_sq", "worker_error"):
        _close(state[key][0].numpy(), js[key]["w"])
    assert torch.equal(state["exp_avg_sq"][0], v_warm)
    assert len(np.unique(np.round(np.abs(state["exp_avg"][0].numpy()),
                                  5))) <= 2
    assert float(state["worker_error"][0].abs().sum()) > 0


def test_onebit_notify_step_disables_allreduce():
    class FakeEngine:
        enable_backward_allreduce = True
        dp_world_size = 1
    eng = FakeEngine()
    opt = OnebitAdam(deepspeed=eng, freeze_step=5)
    opt.notify_step(4)
    assert eng.enable_backward_allreduce
    opt.notify_step(5)
    assert not eng.enable_backward_allreduce and opt.adam_freeze_key
    opt.load_state_dict({"adam_freeze_key": False})
    assert eng.enable_backward_allreduce and not opt.adam_freeze_key
    assert opt.state_dict()["param_groups"][0]["lr"] == 1e-3


def test_onebit_adam_trains_under_engine_as_jax():
    """One process (the JAX engine on one device: its degenerate path):
    losses through the freeze within 1e-5 relative."""
    params = _simple_params()
    config = _onebit_config(freeze=3, batch=8, lr=1e-3, eps=1e-3)
    x, y = X[:8], Y[:8]
    engine = tds.initialize(model=SimpleModel(HIDDEN, device="cpu"),
                            model_parameters=params, config_params=config,
                            device="cpu")[0]
    losses = [float(engine.train_batch((torch.from_numpy(x),
                                        torch.from_numpy(y))))
              for _ in range(8)]
    jeng = jds.initialize(model=JSimpleModel(hidden_dim=HIDDEN),
                          config_params=config,
                          model_parameters=jax.tree_util.tree_map(
                              jnp.asarray, params),
                          mesh=jmesh.build_mesh(devices=jax.devices()[:1]))[0]
    jlosses = _jax_run(jeng, (x, y), 8)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    assert not engine.enable_backward_allreduce
    assert engine.opt_state["step"] == 8 and not engine._onebit_eligible()


def test_onebit_adam_convergence_vs_dense():
    """The compression phase still converges on a quadratic."""
    target = np.random.RandomState(7).randn(32).astype(np.float32)

    def run(opt, steps=60):
        w = torch.zeros(32)
        state = opt.init_state([w])
        for _ in range(steps):
            opt.update([w], [w - torch.from_numpy(target)], state)
        return w.numpy()

    dense = run(FusedAdam(lr=0.05, bias_correction=False))
    onebit = run(OnebitAdam(lr=0.05, freeze_step=20))
    for got in (dense, onebit):
        assert np.abs(got - target).mean() < np.abs(target).mean() * 0.5


def test_engine_hot_path_matches_jax_through_the_freeze(runs):
    for rank in runs["ranks"]:
        r = rank["simple"]
        assert r["eligible"]
        np.testing.assert_allclose(r["losses"], runs["jax"], rtol=LOSS_RTOL)
        for n, w in runs["jax_params"].items():
            _close(r["masters"][n], w, WEIGHT_TOL)
        assert [f for f, _ in r["frozen"]] == [i + 1 >= FREEZE
                                              for i in range(STEPS)]


def test_gpt2_hot_path_matches_jax(runs):
    """Tiny GPT-2 (Adam eps 1e-3) through the freeze and its first
    compressed step: the losses and the masters as JAX's. Not held: the
    server chunks of each ``c_attn.bias`` that hold its key third, whose
    gradient is 0 in exact arithmetic (a constant shift of every key leaves
    the softmax alone): its momentum is summation noise, 1-bit quantization
    turns the noise's sign into a +-lr scale / sqrt(v) step in either
    package, and the sign noise moves the server scale of every element of
    its chunk."""
    C = 64
    chunk = tcc.corrected_size(3 * C, W) // W
    key_chunks = range(C // chunk, (2 * C - 1) // chunk + 1)
    keep = np.array([i for i in range(3 * C) if i // chunk not in key_chunks])
    assert len(keep) >= C
    for rank in runs["ranks"]:
        r = rank["gpt2"]
        np.testing.assert_allclose(r["losses"], runs["jax_gpt2"],
                                   rtol=LOSS_RTOL)
        for n, w in runs["jax_gpt2_params"].items():
            got = r["masters"][n]
            if n.endswith("attn.c_attn.bias"):
                got, w = got[keep], w[keep]
            _close(got, w, WEIGHT_TOL)


def test_engine_hot_path_compresses_the_wire(runs):
    """Warm-up steps all-reduce the gradients densely; past the freeze the
    momenta travel packed (n/8 bytes a padded leaf) and no gradient
    all-reduce runs: the one all-reduce is the 4-byte loss mean."""
    sizes = [p.size for p in _flat(runs["params"]).values()]
    padded = [tcc.corrected_size(n, W) for n in sizes]
    for rank in runs["ranks"]:
        stats = rank["simple"]["stats"]
        for st in stats[:FREEZE]:
            assert st["all_reduce_bytes"] == 4 * sum(sizes) + 4
            assert st["all_to_all"] == 0
        for st in stats[FREEZE:]:
            assert (st["all_reduce"], st["all_reduce_bytes"]) == (1, 4)
            assert (st["all_to_all"], st["all_gather"]) == (1, 3)
            assert st["all_to_all_bytes"] == sum(padded) // 8
            assert st["all_gather_bytes"] == \
                sum(padded) // (8 * W) + 2 * 4 * len(sizes)


def test_resume_past_freeze_compresses_from_its_first_step(runs):
    """A checkpoint saved past the freeze (by the port, and by the JAX
    engine) resumes compressed: the first step already exchanges packed
    momenta, and the losses continue the saving run's."""
    for name in ("resume", "resume_jax"):
        for rank in runs["ranks"]:
            r = rank[name]
            assert r["loaded"] and r["after_load"] == (True, False)
            assert r["stats"][0]["all_to_all"] == 1
            np.testing.assert_allclose(r["losses"], runs["jax"][4:],
                                       rtol=LOSS_RTOL)


def test_rollback_to_prefreeze_reenters_warmup(runs):
    for rank in runs["ranks"]:
        assert rank["rollback"]["frozen"][-1] == (True, False)
        assert rank["rollback"]["after_rollback"] == (False, True)


def test_checkpoint_error_buffers_load_in_the_jax_engine(runs):
    """The port's checkpoint holds each rank's error buffers as the JAX
    layout's rows; the JAX engine loads it and continues as the port."""
    jeng = _jax_engine(JSimpleModel(hidden_dim=HIDDEN), runs["params"],
                       _onebit_config())
    jeng.load_checkpoint(str(runs["root"] / "port_ck"), tag="ck")
    assert jeng.optimizer.adam_freeze_key
    got = _jax_run(jeng, (X, Y), STEPS - 4)
    np.testing.assert_allclose(got, runs["ranks"][0]["simple"]["losses"][4:],
                               rtol=LOSS_RTOL)
    jeng.load_checkpoint(str(runs["root"] / "port_end"), tag="end")
    names = list(runs["ranks"][0]["simple"]["masters"])
    for key in ("worker_error", "server_error"):
        rows = _flat(_tree(jeng.opt_state[key]))
        for i, name in enumerate(names):
            for r, rank in enumerate(runs["ranks"]):
                np.testing.assert_array_equal(
                    rows[name][r], rank["simple"]["errors"][key][i])


def test_pipeline_compressed_update_matches_numpy_sim(runs):
    """2 stages x 2 data ranks, freeze_step 1: the first compressed update
    of each stage is the reference exchange of its data ranks' local
    momenta and the frozen Adam step (numpy), and that step's ReduceGrads
    all-reduces nothing."""
    ranks = [rank["pipe"] for rank in runs["ranks"]]
    dp, lr, b1, eps = 2, 1e-3, 0.9, 1e-8
    checked = 0
    for stage in (0, 1):
        mine = [r for r in ranks if r["stage"] == stage]
        assert len(mine) == dp
        caps = [r["onebit"] for r in mine]
        for i, p in enumerate(caps[0]["before"]):
            n = p.size
            pad = tcc.corrected_size(n, dp)
            chunk = pad // dp
            buf = np.zeros((dp, pad), np.float32)
            for r, cap in enumerate(caps):
                buf[r, :n] = b1 * cap["m"][i].reshape(-1) + \
                    (1 - b1) * cap["grads"][i].reshape(-1)
            scales = np.linalg.norm(buf, axis=1) / np.sqrt(pad)
            signs = np.where(buf >= 0, 1.0, -1.0)
            out = np.zeros(pad, np.float32)
            for r in range(dp):
                sm = np.mean(signs[:, r * chunk:(r + 1) * chunk] *
                             scales[:, None], axis=0)
                sscale = np.linalg.norm(sm) / np.sqrt(chunk)
                out[r * chunk:(r + 1) * chunk] = sscale * np.where(
                    sm >= 0, 1.0, -1.0)
            want = p - lr * out[:n].reshape(p.shape) / (
                np.sqrt(caps[0]["v"][i]) + eps)
            for cap in caps:
                _close(cap["after"][i], want)
            checked += 1
        for r in mine:
            st = r["step_stats"][1]  # the step past the freeze
            assert st["all_to_all"] == 1
            assert st["all_reduce_bytes"] <= 4 * 2  # loss only
    assert checked >= 4


def test_state_layout_matches_jax():
    """A rank's moments and error buffers have the JAX state's shapes (the
    error buffers one row of its ``[W, ...]`` layout)."""
    from deepspeed_tpu.runtime.fp16.onebit_adam import (
        init_onebit_adam_state as jinit)
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import (
        init_onebit_adam_state)

    shapes = {"a": (7, 5), "b": (13,)}
    for w in (1, 4):
        st = init_onebit_adam_state([torch.zeros(s) for s in shapes.values()],
                                    w)
        jst = jinit({k: jnp.zeros(s) for k, s in shapes.items()}, w,
                    per_worker_rows=True)
        for key in ("exp_avg", "exp_avg_sq", "worker_error", "server_error"):
            for t, name in zip(st[key], shapes):
                want = jst[key][name].shape
                assert t.shape == (want[1:] if key.endswith("error") and
                                   w > 1 else want)


def test_onebit_over_model_ranks_is_refused():
    """1-bit Adam over tensor-parallel ranks stays refused, naming its
    ROADMAP item, before any collective (a stand-in model group)."""
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    from deepspeed_tpu_torch.parallel import mesh as tmesh

    grid = tmesh.Mesh((1, 1, 1, 2), 0, None, mp_group=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        tds.initialize(model=GPT2LMHeadModel(GPT2Config.tiny(
            dtype=torch.float32), device="cpu"), device="cpu", mesh=grid,
            config_params=_onebit_config(batch=8))
