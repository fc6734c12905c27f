"""Port parity for ZeRO-Offload training: the port's offload engine
(``runtime/zero/offload.py`` with the host C++ Adam/LAMB) against the JAX
package's offload engine on the CPU, on the same numpy inputs and flax
weights.

Tolerances:
- Losses: 1e-5 relative, every step of five.
- The fp32 master (the flat host buffer, the same layout in both
  packages): 1e-5 of each tensor's max-abs where the forward is fp32
  (SimpleModel under any engine precision; GPT-2 tiny at stage 0 +
  cpu_offload, which both packages accept without fp16/bf16). GPT-2 runs
  use Adam/LAMB with eps 1e-3: with eps 1e-8 the first update is sign(g),
  and where two steps' gradients nearly cancel the update turns fp32
  summation-order differences (1e-7) into differences of up to 2 lr per
  step (the attention key bias, whose gradient is zero in exact
  arithmetic, moves by lr either way); eps 1e-3 keeps the update Lipschitz
  in the gradient, so such differences stay at their own size.
- GPT-2 with bf16 parameters: each tensor's master within 2**-9 (half a
  bf16 ulp) of its norm, by the norm of the difference. The frameworks
  scatter-add repeated embedding rows' bf16 gradients in other orders, so
  a bf16 rounding of a gradient or a parameter can fall the other way and
  the masters part by up to a few bf16 ulps on single elements; a wrong
  update moves a tensor by far more (the step is lr against parameters of
  0.02-1).

Also: stream_gradients against the materialized transfer, the fp16
overflow skip (both transfers), ``offload_timing``, checkpoints across the
packages with ``fp32_master``, a chunk that fails mid-step, and ZeRO
stages 1-3 at world size 1 against stage 0, bit for bit.
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
from deepspeed_tpu.models.simple import SimpleModel as JSimple
from deepspeed_tpu.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.models.simple import SimpleModel
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.lamb.cpu_lamb import DeepSpeedCPULamb

torch.set_num_threads(1)

TOL = 1e-5
BF16_NORM_TOL = 2.0 ** -9
STEPS = 5
HIDDEN = 16


def _config(opt="Adam", precision="bf16", clip=0.0, stream=False, eps=1e-8,
            stage=2, offload=True):
    cfg = {"train_batch_size": 4,
           "optimizer": {"type": opt, "params": {
               "lr": 1e-2, "weight_decay": 0.01, "eps": eps}},
           "zero_optimization": {"stage": stage, "cpu_offload": offload,
                                 "stream_gradients": stream}}
    if precision == "bf16":
        cfg["bf16"] = {"enabled": True}
    elif precision == "fp16":
        cfg["fp16"] = {"enabled": True, "loss_scale": 0,
                       "initial_scale_power": 32}
    else:  # fp32: stage 0 (ZeRO needs fp16 or bf16), offload still on
        cfg["zero_optimization"]["stage"] = 0
    if clip:
        cfg["gradient_clipping"] = clip
    return cfg


def _simple_setup():
    x0 = np.random.RandomState(0).randn(4, HIDDEN).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, JSimple(hidden_dim=HIDDEN)
                                    .init(jax.random.PRNGKey(0), x0,
                                          np.zeros(4, np.int32))["params"])
    batches = [(np.random.RandomState(s).randn(4, HIDDEN).astype(np.float32),
                np.random.RandomState(s + 9).randint(0, HIDDEN, size=(4,)))
               for s in range(STEPS)]
    return (lambda: JSimple(hidden_dim=HIDDEN),
            lambda: SimpleModel(HIDDEN, device="cpu"), params, batches)


def _gpt2_setup(dtype="fp32"):
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    ids = np.random.RandomState(0).randint(0, 1024, size=(4, 32))
    params = jax.tree_util.tree_map(np.asarray, JGPT2(JGPT2Config.tiny(
        dtype=jdt)).init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    batches = [(b, b) for b in (np.random.RandomState(s).randint(
        0, 1024, size=(4, 32)) for s in range(STEPS))]
    return (lambda: JGPT2(JGPT2Config.tiny(dtype=jdt)),
            lambda: GPT2LMHeadModel(GPT2Config.tiny(dtype=tdt), device="cpu",
                                    seed=None), params, batches)


def _jax_engine(make, params, cfg):
    mesh = mesh_lib.build_mesh(num_dp=1, devices=jax.devices()[:1])
    return jds.initialize(model=make(), model_parameters=jax.tree_util
                          .tree_map(jnp.asarray, params), config_params=cfg,
                          mesh=mesh)[0]


def _port_engine(make, params, cfg):
    return tds.initialize(model=make(), model_parameters=params,
                          config_params=cfg, device="cpu")[0]


def _train(engine, batches):
    losses = []
    for b in batches:
        loss = engine(*b)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss.detach() if isinstance(loss, torch.Tensor)
                            else loss))
    return losses


def _master_close(off, port_master, jax_master, norm_tol=None):
    """Each tensor's span of the master: within TOL of its max-abs, or by
    the norm of the difference within ``norm_tol`` of its norm."""
    for o, n in zip(off.offsets, off.sizes):
        got, want = port_master[o:o + n], jax_master[o:o + n]
        if norm_tol is None:
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0)
        else:
            assert np.linalg.norm(got - want) <= \
                norm_tol * np.linalg.norm(want)


CASES = [("simple", "bf16", "Adam", 0.5), ("simple", "bf16", "Lamb", 0.5),
         ("simple", "fp32", "Adam", 0.5), ("simple", "fp32", "Lamb", 0.0),
         ("gpt2", "fp32", "Adam", 1.0), ("gpt2", "fp32", "Lamb", 1.0),
         ("gpt2", "bf16", "Adam", 1.0)]


@pytest.mark.parametrize("model,precision,opt,clip", CASES)
def test_offload_engine_matches_jax(model, precision, opt, clip):
    if model == "simple":
        jmake, tmake, params, batches = _simple_setup()
        eps = 1e-8
    else:
        jmake, tmake, params, batches = _gpt2_setup()
        eps = 1e-3
    cfg = _config(opt, precision, clip=clip, eps=eps)
    jeng = _jax_engine(jmake, params, cfg)
    teng = _port_engine(tmake, params, cfg)
    assert isinstance(teng.optimizer, DeepSpeedCPUAdam if opt == "Adam"
                      else DeepSpeedCPULamb)
    jl, tl = _train(jeng, batches), _train(teng, batches)
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert teng.opt_state["step"] == int(jeng.opt_state["step"]) == STEPS
    bf16_gpt2 = model == "gpt2" and precision == "bf16"
    _master_close(teng._offload, teng._offload.master.numpy(),
                  jeng._offload["master"],
                  BF16_NORM_TOL if bf16_gpt2 else None)
    # The device parameters are the master in the compute dtype.
    want_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    for p, w in zip(teng._params, teng._offload.views(teng._offload.master)):
        assert p.dtype == want_dtype
        assert torch.equal(p, w.to(want_dtype))


def test_gpt2_bf16_model_offload_losses_match_jax():
    """bf16 compute as well (GPT2Config.tiny(dtype=bf16)): the frameworks
    round the bf16 activations in other orders, so the losses are held to
    two bf16 ulps (2**-7 relative), and each tensor's master update (master
    less its initial value) to the JAX update within 2**-4 of its norm: a
    wrong update (lr, clip, step count, a chunk missed) differs by the size
    of the update itself."""
    jmake, tmake, params, batches = _gpt2_setup("bf16")
    cfg = _config("Adam", "bf16", clip=1.0, eps=1e-3)
    jeng = _jax_engine(jmake, params, cfg)
    teng = _port_engine(tmake, params, cfg)
    jl, tl = _train(jeng, batches), _train(teng, batches)
    np.testing.assert_allclose(tl, jl, rtol=2.0 ** -7)
    off = teng._offload
    start = np.concatenate([np.asarray(_leaf(params, teng._names[i]),
                                       np.float32).reshape(-1)
                            for i in off.order])
    got = off.master.numpy() - start
    want = jeng._offload["master"] - start
    for o, n in zip(off.offsets, off.sizes):
        d, w = got[o:o + n] - want[o:o + n], want[o:o + n]
        assert np.linalg.norm(d) <= 2.0 ** -4 * np.linalg.norm(w)


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_stream_gradients_matches_materialized_and_jax(clip):
    """The same host step from a streamed backward: bit for bit without
    clipping (the same bf16 gradients reach the same fp32 buffer); with
    clipping the factor is applied on the host in fp32 instead of on the
    device in bf16 (the JAX package's 2e-3); and against the JAX streaming
    engine within TOL."""
    jmake, tmake, params, batches = _simple_setup()
    base = _port_engine(tmake, params, _config(clip=clip))
    streamed = _port_engine(tmake, params, _config(clip=clip, stream=True))
    jeng = _jax_engine(jmake, params, _config(clip=clip, stream=True))
    batches = batches[:1] * STEPS  # one batch again: the loss must fall
    bl, sl, jl = (_train(e, batches) for e in (base, streamed, jeng))
    assert all(p.grad is None for p in streamed._params)
    np.testing.assert_allclose(sl, jl, rtol=TOL)
    _master_close(streamed._offload, streamed._offload.master.numpy(),
                  jeng._offload["master"])
    if clip:
        np.testing.assert_allclose(sl, bl, rtol=2e-3, atol=1e-3)
    else:
        assert sl == bl
        assert torch.equal(streamed._offload.master, base._offload.master)
    assert sl[-1] < sl[0]


@pytest.mark.parametrize("stream", [False, True])
def test_fp16_overflow_skip_recovers_like_jax(stream):
    """fp16 at a loss scale of 2**32 overflows: the first steps skip (the
    streamed engine puts the parameters back from the master), the scaler
    backs off, training recovers; skips and losses as the JAX engine's."""
    jmake, tmake, params, batches = _simple_setup()
    cfg = _config(precision="fp16", stream=stream)
    jeng = _jax_engine(jmake, params, cfg)
    teng = _port_engine(tmake, params, cfg)
    batches = batches[:1] * 40
    jl, tl = _train(jeng, batches), _train(teng, batches)
    assert teng.skipped_steps == jeng.skipped_steps
    assert 1 <= teng.skipped_steps < 40
    assert teng.loss_scaler.loss_scale == jeng.loss_scaler.loss_scale
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert np.isfinite(tl[-1]) and tl[-1] < tl[0]
    for p, w in zip(teng._params, teng._offload.views(teng._offload.master)):
        assert torch.equal(p, w.to(torch.float16))


def test_offload_timing_reports_the_phases():
    _, tmake, params, batches = _simple_setup()
    engine = _port_engine(tmake, params, _config())
    assert engine.offload_timing() is None
    _train(engine, batches[:1])
    t = engine.offload_timing()
    assert set(t) == {"stage_s", "adam_s", "upload_s", "queue_s", "wall_s",
                      "chunks", "overlap_ratio"}
    assert t["chunks"] == 1 and t["wall_s"] > 0 and t["overlap_ratio"] > 0
    assert min(t["stage_s"], t["adam_s"], t["upload_s"]) >= 0


def test_first_step_fp32_staging_is_freed():
    """The state is built at the first step, whose gradients are still
    fp32: their staging buffer goes with that step, and only the compute
    dtype's stays."""
    _, tmake, params, batches = _simple_setup()
    engine = _port_engine(tmake, params, _config())
    _train(engine, batches[:1])
    assert set(engine._offload.staging) == {torch.bfloat16}
    _train(engine, batches[1:2])
    assert set(engine._offload.staging) == {torch.bfloat16}


def test_chunks_follow_jax_leaf_order_and_size(monkeypatch):
    """Chunks of ~CHUNK_ELEMS elements in the JAX flattening order; a
    smaller chunk size gives several chunks and the same training."""
    from deepspeed_tpu_torch.runtime.zero import offload
    _, tmake, params, batches = _gpt2_setup()
    one = _port_engine(tmake, params, _config(eps=1e-3))
    _train(one, batches[:2])
    monkeypatch.setattr(offload, "CHUNK_ELEMS", 5000)
    many = _port_engine(tmake, params, _config(eps=1e-3))
    _train(many, batches[:2])
    off = many._offload
    assert [many._names[i] for i in off.order] == sorted(
        many._names, key=lambda n: n.split("."))
    assert len(off.chunks) > 5 and one.offload_timing()["chunks"] == 1
    assert [i for c in off.chunks for i in c] == off.order
    assert torch.equal(many._offload.master, one._offload.master)


def test_a_failed_chunk_puts_the_parameters_back():
    """A host step that fails mid-way leaves every device parameter equal
    to the master (the updated chunks' new values, the rest their old), and
    the engine trains on."""
    from deepspeed_tpu_torch.runtime.zero import offload
    _, tmake, params, batches = _gpt2_setup()
    engine = _port_engine(tmake, params, _config(eps=1e-3))
    _train(engine, batches[:1])
    real = engine.optimizer.step_flat
    calls = []

    def failing(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected host failure")
        return real(*args, **kwargs)

    engine.optimizer.step_flat = failing
    saved = offload.CHUNK_ELEMS
    offload.CHUNK_ELEMS = 5000
    try:
        engine._init_offload()
    finally:
        offload.CHUNK_ELEMS = saved
    for p in engine._params:
        with torch.no_grad():
            p.add_(1.0)  # stale device values the restore must overwrite
    with pytest.raises(RuntimeError, match="injected"):
        _train(engine, batches[1:2])
    for p, w in zip(engine._params,
                    engine._offload.views(engine._offload.master)):
        assert torch.equal(p, w.to(p.dtype))
    engine.optimizer.step_flat = real
    assert np.isfinite(_train(engine, batches[2:3])).all()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_offload_checkpoint_across_packages_keeps_fp32_master(tmp_path,
                                                             direction):
    """Three offload steps in one package, save (the zero file holds the
    moments and fp32_master); a fresh engine of the other package loads
    it, with the master bit for bit (not rebuilt from the bf16 module);
    the next two steps' losses match the saver's own."""
    jmake, tmake, params, batches = _simple_setup()
    cfg = _config(clip=0.5)
    src, dst = _jax_engine(jmake, params, cfg), _port_engine(tmake, params,
                                                             cfg)
    if direction == "port_to_jax":
        src, dst = dst, src
    _train(src, batches[:3])
    src.save_checkpoint(str(tmp_path), tag="s3")
    assert (tmp_path / "s3" / "zero_pp_rank_0_mp_rank_00optim_states.pt"
            ).exists()
    path, _ = dst.load_checkpoint(str(tmp_path))
    assert path is not None and dst.global_steps == 3

    def master(e):  # the JAX engine keeps a dict, the port an object
        return e._offload["master"] if isinstance(e._offload, dict) else \
            e._offload.master.numpy()

    np.testing.assert_array_equal(master(dst), master(src))
    bf16 = np.asarray(master(src).astype(jnp.bfloat16), np.float32)
    assert not np.array_equal(master(src), bf16)
    want, got = _train(src, batches[3:]), _train(dst, batches[3:])
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert int(dst.opt_state["step"]) == int(src.opt_state["step"]) == 5


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stages_at_world_size_one_equal_stage_zero(stage):
    """A stage partitions nothing over one rank: losses and parameters
    equal stage 0's bit for bit (bf16, device Adam)."""
    _, tmake, params, batches = _gpt2_setup()
    runs = []
    for s in (0, stage):
        engine = _port_engine(tmake, params, _config(stage=s,
                                                     offload=False))
        assert engine.zero_optimization_stage() == s
        runs.append((_train(engine, batches[:3]),
                     [p.detach().clone() for p in engine._params]))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
