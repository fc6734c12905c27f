"""Port parity for the compiled pipeline (``runtime/pipe/compiled.py``): the
port's ``CompiledPipelineEngine`` over 2 and 4 gloo ranks on the CPU (one
rank per stage, started by the port's launcher through
``tests/torch_dist_worker.py``) against the port's interpreter
``PipelineEngine`` on the same ranks and against the JAX
``CompiledPipelineEngine`` on the conftest's 8 virtual devices, from the
JAX compiled engine's own initial layer trees (``_cp_unstacked()``, handed
to the port as ``model_parameters``). These are the port's counterparts of
the JAX package's ``tests/unit/test_pipe_compiled.py``.

Tolerances (the JAX tests'): losses within rtol 2e-4 and atol 1e-5, every
step, between the two port engines and against the JAX compiled engine;
flash against dense attention within rtol 5e-3, atol 1e-3. Everything
runs in fp32 at dropout 0, but for the eval test's dropout 0.1 (whose eval
runs without dropout). GPT-2 trains with Adam eps 1e-3 (as
``tests/test_torch_pipe.py`` says why).
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import gpt2_pipeline as jgpt2_pipeline
from deepspeed_tpu.models.simple import DenseOut as JDenseOut
from deepspeed_tpu.models.simple import DenseRelu as JDenseRelu
from deepspeed_tpu.models.simple import ce_loss as jce_loss
from deepspeed_tpu.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.pipe import PipelineModule as JPipelineModule
from tests.torch_dist_worker import pipe_module, start_ranks, wait_ranks

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, gpt2_pipeline
from deepspeed_tpu_torch.models.simple import DenseOut, DenseRelu, ce_loss
from deepspeed_tpu_torch.parallel import mesh as tmesh
from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule, TiedLayerSpec

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5
FEAT = 32
N_BLOCKS = 8


def _config(gas, extra=None):
    cfg = {"train_batch_size": 8 * gas, "gradient_accumulation_steps": gas,
           "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(extra or {})
    return cfg


GPT2_CONFIG = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
               "steps_per_print": 1000,
               "optimizer": {"type": "Adam", "params": {"lr": 1e-3,
                                                        "eps": 1e-3}}}


def _batches(steps, gas, seed0=7):
    """The JAX tests' ``batches``: per step, gas micro-batches of 8 x 32
    inputs and 8 labels."""
    rng = np.random.RandomState(seed0)
    return [[(rng.randn(8, FEAT).astype(np.float32),
              rng.randint(0, 8, size=(8,))) for _ in range(gas)]
            for _ in range(steps)]


def _gpt2_micro(T=32):
    ids = np.random.RandomState(0).randint(0, 256, size=(8, T))
    return [(ids[:4], ids[:4]), (ids[4:], ids[4:])]


def _gpt2_cfg(**kw):
    return dict(dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=4,
                     n_head=4, dropout=0.0), **kw)


def _tree(t):
    return None if t is None else jax.tree_util.tree_map(
        lambda a: np.array(a, dtype=np.float32), t)


def _jax_engine(kind, stages, gas, config=None, flash=False, dropout=0.0):
    if kind == "gpt2":
        cfg = JGPT2Config(**dict(_gpt2_cfg(), dropout=dropout,
                                 use_flash_attention=flash))
        module = jgpt2_pipeline(cfg, num_stages=stages, compiled=True)
    else:
        layers = [JLayerSpec(JDenseRelu, FEAT) for _ in range(N_BLOCKS)] + \
            [JLayerSpec(JDenseOut, 8)]
        module = JPipelineModule(layers=layers, num_stages=stages,
                                 loss_fn=jce_loss, seed_layers=True,
                                 base_seed=42, partition_method="uniform",
                                 compiled=True)
    return jds.initialize(model=module,
                          config_params=config or _config(gas))[0]


def _jax_run(kind, stages, gas, data, steps, config=None, save=None,
             save_after=None):
    """(initial per-layer trees, per-step losses) of the JAX compiled
    engine; each step trains on ``data[step]`` (a list of micro-batches)."""
    eng = _jax_engine(kind, stages, gas, config)
    xs = np.stack([np.asarray(m[0]) for m in data[0]])
    eng._cp_materialize(xs[0])
    init = [_tree(p) for p in eng._cp_unstacked()]
    losses = []
    for step in range(steps):
        if save is not None and step == save_after:
            eng.save_checkpoint(save, tag="ck")
        losses.append(float(eng.train_batch(
            data_iter=iter(list(data[step])))))
    return init, losses


def _flat(data):
    return [m for step in data for m in step]


def _held(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX compiled references, then one 2-rank and one 4-rank launch
    running every port task side by side."""
    root = tmp_path_factory.mktemp("pipe_compiled")
    ref = {}
    for stages, gas in ((2, 1), (2, 2), (4, 2), (4, 6)):
        data = _batches(1, gas) * 4  # one batch, repeated: the loss drops
        ref[(stages, gas)] = _jax_run("dense", stages, gas, data, 4) + \
            (data,)
    ck = _batches(5, 2)
    ref["ck"] = _jax_run("dense", 2, 2, ck, 4, save=str(root / "jax"),
                         save_after=2) + (ck,)
    gdata = [_gpt2_micro()] * 3
    ref["gpt2"] = _jax_run("gpt2", 2, 2, gdata, 3, config=GPT2_CONFIG) + \
        (gdata,)

    def task(name, stages, gas, data, steps, params, compiled=True, **kw):
        spec = dict(name=name, kind="pipe", layers="uniform",
                    n_blocks=N_BLOCKS, stages=stages, compiled=compiled,
                    params=params, config=kw.pop("config", _config(gas)),
                    batches=_flat(data), steps=steps)
        spec.update(kw)
        return spec

    def pair(stages, gas, **kw):
        init, _, data = ref[(stages, gas)]
        tag = "{}x{}".format(stages, gas)
        return [task("c" + tag, stages, gas, data, 4, init, **kw),
                task("i" + tag, stages, gas, data, 4, init, compiled=False,
                     **kw)]

    ck_init = ref["ck"][0]
    g_init, _, gdata = ref["gpt2"]
    gpt2 = dict(layers="gpt2", gpt2_cfg=_gpt2_cfg(use_flash_attention=True),
                config=GPT2_CONFIG)
    two = pair(2, 1) + pair(2, 2) + [
        # Checkpoints: compiled -> interpreter and compiled, interpreter ->
        # compiled; the JAX compiled engine's -> compiled.
        task("warm", 2, 2, ck, 4, ck_init, save=str(root / "warm"),
             save_after=2),
        task("cold", 2, 2, ck[2:], 2, ck_init, load=str(root / "warm")),
        task("interp_load", 2, 2, ck[2:], 2, ck_init, compiled=False,
             load=str(root / "warm"), save_end=str(root / "interp")),
        task("from_interp", 2, 2, ck[4:], 1, ck_init,
             load=str(root / "interp")),
        task("interp_on", 2, 2, ck[4:], 1, ck_init, compiled=False,
             load=str(root / "interp")),
        task("from_jax", 2, 2, ck[2:], 2, ck_init, load=str(root / "jax")),
        task("gpt2", 2, 2, gdata, 3, g_init, **gpt2),
        task("gpt2_interp", 2, 2, gdata, 3, g_init, compiled=False,
             tied=False, **gpt2),
        task("gpt2_dense", 2, 2, gdata, 3, g_init, **dict(
            gpt2, gpt2_cfg=_gpt2_cfg())),
        task("gpt2_drop", 2, 2, gdata, 2, g_init, eval_twice=True,
             save_end=str(root / "drop"), **dict(
                 gpt2, gpt2_cfg=_gpt2_cfg(dropout=0.1))),
        task("gpt2_drop_interp", 2, 2, gdata, 0, g_init, compiled=False,
             tied=False, eval=True, load=str(root / "drop"), **dict(
                 gpt2, gpt2_cfg=_gpt2_cfg(dropout=0.1)))]
    zero_cfg = _config(2, {"train_batch_size": 16, "bf16": {"enabled": True},
                           "zero_optimization": {"stage": 1}})
    zdata = _batches(1, 2) * 3
    lamb = {"type": "Lamb", "params": {"lr": 1e-2}}
    four = pair(4, 2) + pair(4, 6) + [
        task("zero", 2, 2, zdata, 3, ref[(2, 2)][0], config=zero_cfg),
        task("nozero", 2, 2, zdata, 3, ref[(2, 2)][0], config=dict(
            zero_cfg, zero_optimization={"stage": 0})),
        task("zero_lamb", 2, 2, zdata, 3, ref[(2, 2)][0], config=dict(
            zero_cfg, optimizer=lamb)),
        task("nozero_lamb", 2, 2, zdata, 3, ref[(2, 2)][0], config=dict(
            zero_cfg, optimizer=lamb, zero_optimization={"stage": 0}))]
    procs = {2: start_ranks(2, two, str(root / "w2")),
             4: start_ranks(4, four, str(root / "w4"))}
    out = {"root": root, "ref": ref, "ck": ck}
    out.update({n: wait_ranks(p, timeout=240) for n, p in procs.items()})
    return out


@pytest.mark.parametrize("stages,gas", [(2, 1), (2, 2), (4, 2), (4, 6)])
def test_compiled_matches_interpreter(runs, stages, gas):
    """Same layers, same weights, same data: the compiled engine tracks the
    port's interpreter and the JAX compiled engine step for step, and the
    loss drops."""
    _, want, _ = runs["ref"][(stages, gas)]
    tag = "{}x{}".format(stages, gas)
    for r in runs[stages]:
        _held(r["c" + tag]["losses"], r["i" + tag]["losses"])
        _held(r["c" + tag]["losses"], want)
    assert want[-1] < want[0]


@pytest.mark.parametrize("stages", [2, 4])
def test_compiled_transfers_are_the_wavefront(runs, stages):
    """Each stage sends M activations to the next stage and M gradients to
    the one before, a step (step 2: the shapes went once, at step 1), and
    no other edge: no activation goes from the last stage to the first
    (the JAX engine's ring has no wrap edge)."""
    gas = 2
    for r in runs[stages]:
        s = r["c{}x{}".format(stages, gas)]["stage"]
        edges = r["c{}x{}".format(stages, gas)]["p2p"][1]["edges"]
        want = {}
        if s + 1 < stages:
            want[(s, s + 1)] = gas
        if s > 0:
            want[(s, s - 1)] = gas
        assert edges == want, (s, edges)


def test_compiled_checkpoint_interchanges_with_interpreter(runs):
    """The compiled engine writes the interpreter's per-layer files: its
    checkpoint loads into the interpreter and into a fresh compiled engine
    (before any batch), and they continue in lockstep with the run that
    saved it; the interpreter's loads into the compiled engine."""
    for r in runs[2]:
        warm = r["warm"]["losses"][2:]
        _held(r["cold"]["losses"], warm)
        _held(r["interp_load"]["losses"], warm)
        assert r["cold"]["loaded_steps"] == 2
        _held(r["from_interp"]["losses"], r["interp_on"]["losses"])
    names = sorted(os.listdir(os.path.join(str(runs["root"] / "warm"),
                                           "ck")))
    assert names[:N_BLOCKS + 1] == ["layer_{:02d}-model_states.pt".format(i)
                                    for i in range(N_BLOCKS + 1)]


def test_compiled_checkpoints_cross_the_packages(runs):
    """The JAX compiled engine's checkpoint (after 2 steps) loads into the
    port's compiled engine, which continues as the JAX run did; the port's
    loads into the JAX compiled engine, which continues as the port's run
    did."""
    _, jax_losses, _ = runs["ref"]["ck"]
    for r in runs[2]:
        _held(r["from_jax"]["losses"], jax_losses[2:4])
    eng = _jax_engine("dense", 2, 2)
    eng.load_checkpoint(str(runs["root"] / "warm"))
    assert eng.global_steps == 2
    got = [float(eng.train_batch(data_iter=iter(list(runs["ck"][s]))))
           for s in (2, 3)]
    _held(got, runs[2][0]["warm"]["losses"][2:])


def test_compiled_zero_shards_moments_over_data(runs):
    """ZeRO-1 with the compiled engine (2 stages x 2 data ranks, bf16
    config): the stacked blocks' moments are sharded over the stage's data
    ranks on the first dim past [L], the trajectory equals the unsharded
    run's, and the loss drops."""
    for r in runs[4]:
        z, plain = r["zero"], r["nozero"]
        stacked = z["moments"]["blocks.Dense_0__kernel"]
        assert stacked == (4, 16, 32), stacked
        assert plain["moments"]["blocks.Dense_0__kernel"] == (4, 32, 32)
        assert z["shards"]["blocks.Dense_0__kernel"] == (4, 32, 32)
        _held(z["losses"], plain["losses"])
        assert z["losses"][-1] < z["losses"][0]


def test_compiled_zero_lamb_takes_each_tensors_norms(runs):
    """Lamb under ZeRO-1 with the compiled engine: each stacked leaf's
    trust ratio is the whole leaf's (its shards' squares added over the
    stage's data ranks), so the trajectory equals the unsharded Lamb's."""
    for r in runs[4]:
        assert r["zero_lamb"]["moments"]["blocks.Dense_0__kernel"] == \
            (4, 16, 32)
        # Both fp32 and the same arithmetic but the squares' summation
        # order: a shard's own ratio would move the losses far more.
        _held(r["zero_lamb"]["losses"], r["nozero_lamb"]["losses"],
              rtol=1e-6, atol=0)
        assert r["zero_lamb"]["losses"] != r["zero"]["losses"]


def test_gpt2_pipeline_compiled_matches_untied_interpreter_and_jax(runs):
    """gpt2_pipeline(compiled=True) (untied: embedding prologue, the blocks
    stacked 2 a stage, the final LayerNorm and head as epilogue) against
    the port's untied interpreter and the JAX compiled engine."""
    _, want, _ = runs["ref"]["gpt2"]
    for r in runs[2]:
        _held(r["gpt2"]["losses"], r["gpt2_interp"]["losses"])
        _held(r["gpt2"]["losses"], want)
    assert want[-1] < want[0]


def test_gpt2_pipeline_compiled_flash_matches_dense(runs):
    """K1/K2's wrappers inside the compiled ticks (their plain versions on
    the CPU) against dense attention, within the JAX test's tolerance."""
    for r in runs[2]:
        _held(r["gpt2"]["losses"], r["gpt2_dense"]["losses"], rtol=5e-3,
              atol=1e-3)
        assert r["gpt2"]["losses"][-1] < r["gpt2"]["losses"][0]


def test_compiled_eval_batch_deterministic_and_matches_interpreter(runs):
    """eval_batch at dropout 0.1: no dropout, so two evals agree; through a
    checkpoint the interpreter's eval of the same weights is equal."""
    for r in runs[2]:
        e1, e2 = r["gpt2_drop"]["evals"]
        assert e1 == e2
        _held([r["gpt2_drop_interp"]["eval"]], [e1])


def _one_stage(layers=None, config=None, **kw):
    if layers is None:
        layers = [LayerSpec(DenseRelu, FEAT) for _ in range(4)] + \
            [LayerSpec(DenseOut, 8, in_features=FEAT)]
    module = PipelineModule(layers=layers, num_stages=kw.pop("stages", 1),
                            loss_fn=ce_loss, seed_layers=True, base_seed=42,
                            partition_method="uniform", compiled=True)
    return tds.initialize(model=module, device="cpu",
                          config_params=config or _config(2), **kw)[0]


def test_compiled_load_checkpoint_missing_files_raises(tmp_path):
    cold = _one_stage()
    (tmp_path / "ck" / "global_step0").mkdir(parents=True)
    (tmp_path / "ck" / "latest").write_text("global_step0")
    with pytest.raises(ValueError, match="layer"):
        cold.load_checkpoint(str(tmp_path / "ck"))


def test_compiled_rejects_tied_and_nonuniform():
    tied = [TiedLayerSpec("emb", DenseRelu, FEAT), LayerSpec(DenseRelu, FEAT),
            LayerSpec(DenseRelu, FEAT), TiedLayerSpec("emb", DenseRelu, FEAT)]
    with pytest.raises(ValueError, match="TiedLayerSpec"):
        _one_stage(tied, stages=2)
    mixed = [LayerSpec(DenseRelu, 32), LayerSpec(DenseRelu, 16),
             LayerSpec(DenseRelu, 64), LayerSpec(DenseOut, 8)]
    with pytest.raises(ValueError, match="identical"):
        _one_stage(mixed, stages=4)
    with pytest.raises(ValueError, match="tied=False"):
        gpt2_pipeline(GPT2Config.tiny(dtype=torch.float32), num_stages=2,
                      tied=True, compiled=True)


@pytest.mark.parametrize("what", ["onebit", "fp16", "zero2", "pipe_axis",
                                  "model_axis"])
def test_compiled_keeps_the_jax_refusals(what):
    """OneBitAdam, fp16 loss scaling and ZeRO stage 2 (the JAX engine's
    ValueErrors), a 'pipe' axis other than the stage count, a 'model'
    axis."""
    kw, cfg, match = {}, _config(2), what
    if what == "onebit":
        cfg = _config(2, {"optimizer": {"type": "OneBitAdam", "params": {
            "lr": 1e-2, "freeze_step": 2}}})
        match = "OnebitAdam"
    elif what == "fp16":
        cfg = _config(2, {"fp16": {"enabled": True}})
        match = "loss scaling"
    elif what == "zero2":
        cfg = _config(2, {"bf16": {"enabled": True},
                          "zero_optimization": {"stage": 2}})
        match = "stage 2"
    elif what == "pipe_axis":
        kw = {"stages": 2, "mesh": tmesh.Mesh((1, 1, 1, 1), 0, None)}
        match = "pipe axis"
    else:
        kw = {"mesh": tmesh.Mesh((1, 1, 1, 2), 0, None)}
        match = "'model' axis"
    with pytest.raises(ValueError, match=match):
        _one_stage(config=cfg, **kw)


def test_compiled_one_stage_trains_and_splits_the_batch():
    """One stage: ``train_batch(batch=...)`` is the gas micro-batches of the
    batch's rows, the layout keeps its blocks stacked, and the engine runs
    eagerly on the CPU (no graph captured)."""
    data = _batches(1, 2)[0]
    x = np.concatenate([d[0] for d in data])
    y = np.concatenate([d[1] for d in data])
    a, b = _one_stage(), _one_stage()
    la = [a.train_batch(batch=(x, y)) for _ in range(3)]
    lb = [b.train_batch(data_iter=iter(list(data))) for _ in range(3)]
    assert la == lb and la[-1] < la[0]
    assert a._names == ["4.Dense_0.kernel", "blocks.Dense_0__kernel"]
    assert a.graph_captures == 0 and a.graph_replays == 0


def test_compiled_block_generators_draw_the_int_seeds_masks():
    """The card's capture-safe dropout (GPT-2 at dropout 0.1): the stage's
    blocks fed their slots' generators, seeded by ``_seeded_gens`` with a
    tick's seeds, give the int-seeded tick's output and input gradient bit
    for bit, again when re-seeded (the backward's recompute); other seeds
    give other masks."""
    cfg = GPT2Config.tiny(dtype=torch.float32, dropout=0.1)
    engine = tds.initialize(model=gpt2_pipeline(cfg, num_stages=1,
                                                compiled=True),
                            device="cpu", config_params=GPT2_CONFIG)[0]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, cfg.n_embd, generator=gen)
    dy = torch.randn(4, 16, cfg.n_embd, generator=gen)
    engine._acc = [torch.zeros_like(p) for p in engine.module.stacked()]
    seeds = engine._draw_seeds()
    want = engine._fwd_tick(x, seeds=seeds)
    want_dx = engine._bwd_tick(x, dy, seeds=seeds)
    for _ in range(2):
        gens = engine._seeded_gens(seeds)
        assert all(isinstance(g, torch.Generator) for g in gens.values())
        assert torch.equal(engine._fwd_tick(x, seeds=gens), want)
        assert torch.equal(engine._bwd_tick(x, dy, seeds=
                                            engine._seeded_gens(seeds)),
                           want_dx)
    other = engine._fwd_tick(x, seeds=engine._seeded_gens(
        engine._draw_seeds()))
    assert not torch.equal(other, want)
    assert engine._seeded_gens({}) is None


def test_pipeline_module_compiled_flag_selects_the_engine():
    from deepspeed_tpu_torch.runtime.pipe.compiled import (
        CompiledPipelineEngine, _uniform_run)
    assert isinstance(_one_stage(), CompiledPipelineEngine)
    specs = [LayerSpec(DenseRelu, FEAT) for _ in range(5)] + \
        [LayerSpec(DenseOut, 8)]
    assert _uniform_run(specs, 2) == (0, 4)
    assert _uniform_run(specs, 5) == (0, 5)
    assert _uniform_run(specs, 6) is None
    cfg = GPT2Config.tiny(dtype=torch.float32)
    module = gpt2_pipeline(cfg, num_stages=2, compiled=True)
    assert _uniform_run(module.layer_specs, 2) == (1, 1 + cfg.n_layer)
    assert pipe_module({"layers": "uniform", "n_blocks": 4,
                        "compiled": True}, 2).compiled
