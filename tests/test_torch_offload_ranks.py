"""Port parity for ZeRO-Offload and Lamb over several ranks, on the CPU:
the port's engines over 2 gloo ranks (started by the port's launcher
through ``tests/torch_dist_worker.py``) against the JAX package's engines
in one process on the whole batch, from the same flax weights and numpy
batches.

- Offload over 2 data ranks: stage 0 + ``cpu_offload`` (each rank the
  whole host state, the gradients all-reduced) and ZeRO stage 2 +
  ``cpu_offload`` (each rank its ZeRO partition of the host state, the
  gradients reduce-scattered; both configs take ``cpu_offload`` at stage 2
  only, so there is no stage-1 offload), and offload over 2 model ranks
  (each its tensor-parallel shards), against the JAX one-process offload
  engine (stage 0 + ``cpu_offload``, fp32).
- Lamb at ZeRO stages 1-3 over 2 data ranks on the device (``FusedLamb``)
  and on the host (``DeepSpeedCPULamb`` under stage 2 + ``cpu_offload``),
  against the JAX ``FusedLamb`` and ``DeepSpeedCPULamb`` on the whole
  batch: the trust ratio takes each tensor's norms over its shards.
- The host op's two passes against its one pass at one rank, bit for bit,
  and an offload engine with the two passes against one without.
- Checkpoints across data-parallel sizes: a dp-2 offload checkpoint
  continues at dp 1, the JAX one-process offload checkpoint at dp 2.

Everything computes in fp32: GPT-2 tiny at dropout 0, the bf16 configs
(ZeRO needs fp16 or bf16 in both packages) with the engine's compute dtype
set to fp32 before the first step. Gradient clipping 1.0 (the norm over
the shards), Adam/Lamb eps 1e-3 (``tests/test_torch_offload.py`` says why).
Tolerance: every loss within 1e-5 relative of the JAX run's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from deepspeed_tpu.parallel import mesh as jmesh
from tests.torch_dist_worker import start_ranks, wait_ranks

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.ops.lamb.cpu_lamb import DeepSpeedCPULamb

torch.set_num_threads(1)

TOL = 1e-5
STEPS = 5
SAVE_AFTER = 2


def _config(opt="Adam", stage=0, offload=False):
    cfg = {"train_batch_size": 4, "gradient_clipping": 1.0,
           "steps_per_print": 1000,
           "optimizer": {"type": opt, "params": {
               "lr": 1e-2, "weight_decay": 0.01, "eps": 1e-3}}}
    if stage or offload:
        cfg["zero_optimization"] = {"stage": stage, "cpu_offload": offload}
    if stage:
        cfg["bf16"] = {"enabled": True}
    return cfg


BATCHES = [(b, b) for b in (np.random.RandomState(s).randint(
    0, 1024, size=(4, 32)) for s in range(STEPS))]


def _params():
    ids = BATCHES[0][0]
    return jax.tree_util.tree_map(np.asarray, JGPT2(JGPT2Config.tiny(
        dtype=jnp.float32)).init(jax.random.PRNGKey(0),
                                 jnp.asarray(ids))["params"])


def _jax_run(params, cfg, save=None):
    mesh = jmesh.build_mesh(num_dp=1, devices=jax.devices()[:1])
    eng = jds.initialize(model=JGPT2(JGPT2Config.tiny(dtype=jnp.float32)),
                         model_parameters=jax.tree_util.tree_map(
                             jnp.asarray, params),
                         config_params=cfg, mesh=mesh)[0]
    losses = []
    for i, (x, y) in enumerate(BATCHES):
        if save is not None and i == SAVE_AFTER:
            eng.save_checkpoint(save, tag="ck")
        loss = eng(x, y)
        eng.backward(loss)
        eng.step()
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("offload_ranks")
    params = _params()
    ref = {"adam": _jax_run(params, _config(offload=True),
                            save=str(root / "jax")),
           "lamb": _jax_run(params, _config("Lamb")),
           "lamb_host": _jax_run(params, _config("Lamb", offload=True))}

    def train(name, cfg, **kw):
        return dict(dict(name=name, kind="train", model="gpt2",
                         params=params, config=cfg, batches=BATCHES,
                         fp32_compute=True), **kw)

    tasks = [train("dp_stage0", _config(offload=True)),
             train("dp_stage2", _config(stage=2, offload=True),
                   save=str(root / "dp2"), save_after=SAVE_AFTER),
             train("from_jax", _config(stage=2, offload=True),
                   load=str(root / "jax"), batches=BATCHES[SAVE_AFTER:]),
             dict(name="mp2", kind="tp", mp=2, params=params,
                  config=_config(offload=True), batches=BATCHES)]
    tasks += [train("lamb{}".format(s), _config("Lamb", stage=s))
              for s in (1, 2, 3)]
    tasks.append(train("lamb_host", _config("Lamb", stage=2, offload=True)))
    ranks = wait_ranks(start_ranks(2, tasks, str(root / "w2")), timeout=240)
    return {"root": root, "params": params, "ref": ref, "ranks": ranks}


def _held(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


@pytest.mark.parametrize("name", ["dp_stage0", "dp_stage2", "mp2"])
def test_offload_over_ranks_matches_jax(runs, name):
    """Each rank's losses (the data group's mean) equal the JAX one-process
    offload run's on the whole batch; at stage 2 each rank's host master
    is its partition (fewer elements than the model's), at stage 0 the
    whole model."""
    full = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        runs["params"]))
    for r in runs["ranks"]:
        _held(r[name]["losses"], runs["ref"]["adam"])
    if name == "mp2":
        return
    elems = [r[name]["host_elems"] for r in runs["ranks"]]
    assert all(r[name]["optimizer"] == "DeepSpeedCPUAdam"
               for r in runs["ranks"])
    if name == "dp_stage0":
        assert elems == [full, full]
    else:
        assert elems[0] == elems[1] and full / 2 <= elems[0] < full


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_lamb_over_partitioned_ranks_matches_jax(runs, stage):
    """Device Lamb at ZeRO stages 1-3 over 2 data ranks: the moments are
    partitioned, the losses equal JAX FusedLamb's on the whole batch."""
    for r in runs["ranks"]:
        got = r["lamb{}".format(stage)]
        _held(got["losses"], runs["ref"]["lamb"])
        assert got["moment"] != [tuple(np.asarray(v).shape) for v in
                                 jax.tree_util.tree_leaves(runs["params"])]


def test_host_lamb_over_partitioned_ranks_matches_jax(runs):
    """Host Lamb under stage 2 + cpu_offload over 2 data ranks (the op's
    two passes, the norms summed over the shards) against JAX
    DeepSpeedCPULamb on the whole batch."""
    for r in runs["ranks"]:
        assert r["lamb_host"]["optimizer"] == "DeepSpeedCPULamb"
        _held(r["lamb_host"]["losses"], runs["ref"]["lamb_host"])


def test_dp2_offload_checkpoint_continues_at_dp1(runs):
    """The dp-2 stage-2 offload run saved after 2 steps (the JAX layout:
    the full fp32_master, the moments whole); one process loads it and
    continues as the dp-2 run did."""
    engine = tds.initialize(
        model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                              device="cpu", seed=None),
        model_parameters=runs["params"], device="cpu",
        config_params=_config(stage=2, offload=True))[0]
    engine.compute_dtype = torch.float32
    path, _ = engine.load_checkpoint(str(runs["root"] / "dp2"))
    assert path is not None and engine.global_steps == SAVE_AFTER
    got = []
    for x, y in BATCHES[SAVE_AFTER:]:
        loss = engine(x, y)
        engine.backward(loss)
        engine.step()
        got.append(float(loss.detach()))
    _held(got, runs["ranks"][0]["dp_stage2"]["losses"][SAVE_AFTER:])


def test_one_process_checkpoint_continues_at_dp2(runs):
    """The JAX one-process offload checkpoint (after 2 steps) loads at dp
    2, each rank its partition of the master and moments, and continues
    as the JAX run did."""
    for r in runs["ranks"]:
        _held(r["from_jax"]["losses"], runs["ref"]["adam"][SAVE_AFTER:])


def test_two_pass_host_lamb_equals_one_pass():
    """The host op's pass 1, ratio and pass 2 apart are its one-pass step,
    bit for bit, with and without the fused bf16 copy."""
    gen = torch.Generator().manual_seed(0)
    n, segs = 5000, [(0, 1200), (1200, 3000), (4200, 800)]
    for bf16 in (False, True):
        one, two = DeepSpeedCPULamb(lr=1e-2, weight_decay=0.01), \
            DeepSpeedCPULamb(lr=1e-2, weight_decay=0.01)
        p, g = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
        m = torch.randn(n, generator=gen).abs()
        v = torch.randn(n, generator=gen).abs()
        q, m2, v2 = p.clone(), m.clone(), v.clone()
        o1 = torch.zeros(n, dtype=torch.bfloat16) if bf16 else None
        o2 = torch.zeros(n, dtype=torch.bfloat16) if bf16 else None
        one.step_flat(p, g, m, v, step=3, lr=1e-2, segments=segs,
                      bf16_out=o1)
        scratch = torch.empty(n)
        sq = two.norms_flat(q, g, m2, v2, scratch, 3, segs)
        ratios = [two.ratio(w, u) for w, u in sq.tolist()]
        two.apply_flat(q, scratch, ratios, 1e-2, segs, bf16_out=o2)
        assert ratios == one.get_lamb_coeffs()
        for a, b in ((p, q), (m, m2), (v, v2), (o1, o2)):
            assert a is None or torch.equal(a, b)


def test_offload_engine_two_pass_equals_one_pass():
    """At one rank an offload engine whose host Lamb runs the two passes
    (``norm_reduce`` the identity) trains exactly as the one-pass engine."""
    from tests.test_torch_offload import _config as offload_config

    def run(two_pass):
        engine = tds.initialize(
            model=GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                                  device="cpu", seed=None),
            model_parameters=_params(), device="cpu",
            config_params=offload_config("Lamb", "fp32", clip=1.0,
                                         eps=1e-3))[0]
        if two_pass:
            engine.optimizer.norm_reduce = lambda sq: sq
        losses = []
        for x, y in BATCHES:
            loss = engine(x, y)
            engine.backward(loss)
            engine.step()
            losses.append(float(loss.detach()))
        return losses, engine._offload.master.clone()

    (l1, m1), (l2, m2) = run(False), run(True)
    assert l1 == l2
    assert torch.equal(m1, m2)
