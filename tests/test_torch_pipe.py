"""Port parity for the pipeline engine: the port's ``PipelineEngine`` over 2
and 4 gloo ranks on the CPU (one rank per stage, started by the port's
launcher through ``tests/torch_dist_worker.py``) against the JAX
``PipelineEngine`` on the conftest's 8 virtual devices, on the same numpy
batches and the JAX engine's own initial layer trees (its
``layer_params``, handed to the port as ``model_parameters``).

The JAX engine places each stage on 8 / stages devices and shards a
micro-batch over them; the port's ranks each hold one stage and the whole
micro-batch. Both compute in fp32 at dropout 0 (the GPT-2 pipeline with
``use_flash_attention``: the JAX Pallas kernels in interpret mode, the
port's K1/K2 wrappers on their plain versions), so they differ only by
summation order.

Tolerances: losses within 1e-5 relative, every step; final layer weights
within 1e-4 of each tensor's max-abs. GPT-2 trains with Adam eps 1e-3:
with eps 1e-8 Adam's first steps are sign(g), and fp32 summation noise in
the near-zero gradients of unused embedding rows becomes steps of up to
lr.

Covered: the DenseRelu stack at 2 and 4 stages, ``eval_batch`` with the
parameters unchanged, the fp16 overflow skip agreed by both stages,
tied layers (with and without ``forward_fn``), ``activation_checkpoint_
interval``, checkpoints saved at 2 stages and loaded at 4 stages across
the packages in both directions, tiny GPT-2's ``gpt2_pipeline`` tied and
untied (and tied over 2 stages x mp 2 against the JAX pipeline), pipe x
tensor parallelism (the JAX composition test's setup), the partition
methods and functions, ``train_batch(batch=...)``, dropout, and
the refusals (``forward``/``backward``/``step``, 1-bit Adam, ZeRO with a
pipeline, the config's module-only keys); ``compiled=True`` selects the
compiled engine.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2Config as JGPT2Config
from deepspeed_tpu.models.gpt2 import gpt2_pipeline as jgpt2_pipeline
from deepspeed_tpu.models.simple import DenseOut as JDenseOut
from deepspeed_tpu.models.simple import DenseRelu as JDenseRelu
from deepspeed_tpu.models.simple import ce_loss as jce_loss
from deepspeed_tpu.parallel import mesh as jmesh
from deepspeed_tpu.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.pipe import TiedLayerSpec as JTiedLayerSpec
from tests.torch_dist_worker import pipe_module, start_ranks, wait_ranks
from tests.unit.test_pipe import TiedEmbed as JTiedEmbed

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, params_from_jax
from deepspeed_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
WEIGHT_TOL = 1e-4
GAS = 2


def _config(extra=None, fp16=False):
    cfg = {"train_batch_size": 8 * GAS, "gradient_accumulation_steps": GAS,
           "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if fp16:
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 8,
                       "loss_scale_window": 1000, "hysteresis": 1}
    cfg.update(extra or {})
    return cfg


GPT2_CONFIG = _config({"optimizer": {"type": "Adam", "params": {
    "lr": 1e-2, "eps": 1e-3}}})


def _dense_batches(n):
    out = []
    for i in range(n * GAS):
        rng = np.random.RandomState(i % 3)
        out.append((rng.randn(8, 16).astype(np.float32),
                    rng.randint(0, 8, size=(8,))))
    return out


def _tied_batches(n):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 16, size=(8, 4))
    labels = rng.randint(0, 16, size=(8, 4))
    return [(ids, labels)] * (n * GAS)


def _gpt2_batches(n):
    out = []
    for i in range(n * GAS):
        ids = np.random.RandomState(10 + i).randint(0, 1024, size=(4, 16))
        out.append((ids, ids))
    return out


def _jax_module(kind, stages, remat=0, tied=True, forward_fn=False,
                tp_rules=None):
    if kind == "gpt2":
        cfg = JGPT2Config.tiny(dtype=jnp.float32, use_flash_attention=True)
        return jgpt2_pipeline(cfg, num_stages=stages, tied=tied)
    if kind == "tied":
        def project(layer, params, x):
            return x @ params["embedding"].T
        layers = [JTiedLayerSpec("embed", JTiedEmbed),
                  JLayerSpec(JDenseRelu, 8),
                  JTiedLayerSpec("embed", JTiedEmbed,
                                 forward_fn=project if forward_fn else None)]
    else:
        layers = [JLayerSpec(JDenseRelu, 32) for _ in range(3)] + \
            [JLayerSpec(JDenseOut, 8)]
    module = JPipelineModule(layers=layers, num_stages=stages,
                             loss_fn=jce_loss, seed_layers=True,
                             base_seed=42, partition_method="uniform",
                             activation_checkpoint_interval=remat)
    if tp_rules is not None:
        module.tp_rules = tp_rules
    return module


def _jax_engine(module, config, mp=1):
    mesh = None
    if mp > 1:
        mesh = jmesh.build_mesh(devices=jax.devices(),
                                num_pp=module.num_stages, num_mp=mp,
                                num_dp=8 // (module.num_stages * mp))
    return jds.initialize(model=module, config_params=config, mesh=mesh)[0]


def _tree(t):
    return None if t is None else jax.tree_util.tree_map(
        lambda a: np.array(a, dtype=np.float32), t)


def _jax_run(kind, stages, batches, steps, config=None, save=None,
             save_after=None, mp=1, **kw):
    """The JAX engine's initial layer trees, its losses, its final layer
    trees and the engine."""
    eng = _jax_engine(_jax_module(kind, stages, **kw), config or _config(),
                      mp=mp)
    eng._materialize(batches[0])
    init = [_tree(p) for p in eng.layer_params]
    losses = []
    for step in range(steps):
        if save is not None and step == save_after:
            eng.save_checkpoint(save, tag="ck")
        losses.append(float(eng.train_batch(
            data_iter=iter(batches[step * GAS:(step + 1) * GAS]))))
    return init, losses, [_tree(p) for p in eng.layer_params], eng


def _held(got, want, rtol=LOSS_RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _weights_held(port_layers, jax_layers):
    for idx, tree in port_layers.items():
        flat_p = _flat(tree)
        flat_j = _flat(jax_layers[idx])
        assert set(flat_p) == set(flat_j), idx
        for n in flat_j:
            scale = max(np.abs(flat_j[n]).max(), 1e-12)
            assert np.abs(flat_p[n] - flat_j[n]).max() <= WEIGHT_TOL * scale, \
                (idx, n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _merged(ranks, name):
    """Every stage's layers of a task, from the data/model rank 0 of each
    stage."""
    out = {}
    for r in ranks:
        out.update(r[name]["layers"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, then one 2-rank and one 4-rank launch running
    every port task side by side."""
    root = tmp_path_factory.mktemp("pipe")
    dense = _dense_batches(5)
    tied = _tied_batches(4)
    gpt2 = _gpt2_batches(3)
    ref = {}
    ref["dense2"] = _jax_run("dense", 2, dense, 5)
    ref["dense4"] = _jax_run("dense", 4, dense, 5)
    ref["remat"] = _jax_run("dense", 2, dense, 4, remat=2)
    ref["tied"] = _jax_run("tied", 2, tied, 4,
                           config=_config({"train_batch_size": 8 * GAS}))
    ref["tied_fn"] = _jax_run("tied", 2, tied, 4, forward_fn=True)
    ref["gpt2"] = _jax_run("gpt2", 2, gpt2, 3, config=GPT2_CONFIG)
    ref["gpt2_untied"] = _jax_run("gpt2", 2, gpt2, 3, config=GPT2_CONFIG,
                                  tied=False)
    ref["fp16"] = _jax_run("dense", 2, dense, 4, config=_config(fp16=True))
    ref["tp"] = _jax_run("dense", 2, dense, 3, mp=2,
                         tp_rules=((r".*kernel$", 1),))
    # The JAX checkpoint at 2 stages (after 3 steps) for the port's 4.
    ref["jax_ck"] = _jax_run("dense", 2, dense, 5, save=str(root / "jax2"),
                             save_after=3)

    def task(name, kind, stages, batches, steps, ref_key, **kw):
        return dict(name=name, kind="pipe", layers=kind, stages=stages,
                    params=ref[ref_key][0], config=kw.pop("config",
                                                          _config()),
                    batches=batches, steps=steps, **kw)

    two = [task("dense2", "dense", 2, dense, 5, "dense2", eval=True),
           task("remat", "dense", 2, dense, 4, "remat", remat=2),
           task("tied", "tied", 2, tied, 4, "tied"),
           task("tied_fn", "tied", 2, tied, 4, "tied_fn", forward_fn=True),
           task("gpt2", "gpt2", 2, gpt2, 3, "gpt2", config=GPT2_CONFIG),
           task("gpt2_untied", "gpt2", 2, gpt2, 3, "gpt2_untied",
                tied=False, config=GPT2_CONFIG),
           task("fp16", "dense", 2, dense, 4, "fp16",
                config=_config(fp16=True), overflow=True),
           task("save2", "dense", 2, dense, 5, "dense2",
                save=str(root / "port2"), save_after=3)]
    four = [task("dense4", "dense", 4, dense, 5, "dense4"),
            task("dense2_dp2", "dense", 2, dense, 5, "dense2"),
            task("load_jax", "dense", 4, dense[3 * GAS:], 2, "dense4",
                 load=str(root / "jax2")),
            task("tp", "dense", 2, dense, 3, "tp", mp=2,
                 tp_rules=((r".*kernel$", 1),)),
            task("gpt2_tp", "gpt2", 2, gpt2, 3, "gpt2", mp=2,
                 config=GPT2_CONFIG)]
    procs = {2: start_ranks(2, two, str(root / "w2")),
             4: start_ranks(4, four, str(root / "w4"))}
    out = {"root": root, "ref": ref, "dense": dense}
    out.update({n: wait_ranks(p) for n, p in procs.items()})
    return out


@pytest.mark.parametrize("name,world,ref", [
    ("dense2", 2, "dense2"), ("dense4", 4, "dense4"),
    ("dense2_dp2", 4, "dense2")])
def test_dense_stack_matches_jax(runs, name, world, ref):
    """2 and 4 stages, and 2 stages x 2 data ranks (each its half of every
    micro-batch, the gradients averaged over the data group, the loss its
    mean), against the JAX engine (whose stages are data-parallel over
    their devices)."""
    _, want, final, _ = runs["ref"][ref]
    ranks = runs[world]
    for r in ranks:
        _held(r[name]["losses"], want)
    _weights_held(_merged(ranks, name), final)
    assert want[-1] < want[0]


def test_eval_batch_matches_jax_and_leaves_params(runs):
    eng = runs["ref"]["dense2"][3]
    want = eng.eval_batch(data_iter=iter(runs["dense"][:GAS]))
    for r in runs[2]:
        _held([r["dense2"]["eval"]], [want])
        assert r["dense2"]["eval_unchanged"]


def test_fp16_overflow_skip(runs):
    _, want, _, _ = runs["ref"]["fp16"]
    for r in runs[2]:
        _held(r["fp16"]["losses"], want)
        ov = r["fp16"]["overflow"]
        # Only stage 0 saw an inf gradient; both stages skip.
        assert ov == {"skipped": 1, "scale_down": True, "unchanged": True,
                      "grads_cleared": True}


@pytest.mark.parametrize("name", ["tied", "tied_fn"])
def test_tied_layers_match_jax(runs, name):
    _, want, final, _ = runs["ref"][name]
    for r in runs[2]:
        _held(r[name]["losses"], want)
    merged = _merged(runs[2], name)
    # Both stages' copies of the tied key stay equal, and equal JAX's.
    _weights_held(merged, final)
    for a, b in zip(_flat(merged[0]).values(), _flat(merged[2]).values()):
        np.testing.assert_array_equal(a, b)


def test_activation_checkpoint_interval_matches_jax(runs):
    _, want, _, _ = runs["ref"]["remat"]
    for r in runs[2]:
        _held(r["remat"]["losses"], want)
    # Remat changes nothing: the port's plain run over the same steps.
    _held(runs[2][0]["remat"]["losses"], runs[2][0]["dense2"]["losses"][:4])


@pytest.mark.parametrize("name", ["gpt2", "gpt2_untied"])
def test_gpt2_pipeline_matches_jax(runs, name):
    _, want, final, _ = runs["ref"][name]
    for r in runs[2]:
        _held(r[name]["losses"], want)
    _weights_held(_merged(runs[2], name), final)


def test_checkpoint_port_2_stages_loads_in_jax_at_4(runs, tmp_path):
    """The port saved at 2 stages after 3 steps; the JAX engine at 4
    stages loads it and continues as the port's run did."""
    ck = str(runs["root"] / "port2")
    want = runs[2][0]["save2"]["losses"][3:]
    eng = _jax_engine(_jax_module("dense", 4), _config())
    dense = runs["dense"]
    eng._materialize(dense[0])
    path, _ = eng.load_checkpoint(ck)
    assert path is not None and eng.global_steps == 3
    got = [float(eng.train_batch(data_iter=iter(
        dense[s * GAS:(s + 1) * GAS]))) for s in (3, 4)]
    _held(got, want)
    assert sorted(os.listdir(os.path.join(ck, "ck")))[:4] == [
        "layer_00-model_states.pt", "layer_01-model_states.pt",
        "layer_02-model_states.pt", "layer_03-model_states.pt"]


def test_checkpoint_jax_2_stages_loads_in_port_at_4(runs):
    _, jax_losses, _, _ = runs["ref"]["jax_ck"]
    for r in runs[4]:
        assert r["load_jax"]["loaded"]
        assert r["load_jax"]["loaded_steps"] == 3
        _held(r["load_jax"]["losses"], jax_losses[3:])


def test_pipe_tensor_parallel_composition(runs):
    """PP x TP (the JAX composition test's setup: 2 stages, mp 2, the
    kernels column-sharded by ``((".*kernel$", 1),)``) against the JAX
    engine; each rank holds half of each kernel's columns."""
    _, want, final, _ = runs["ref"]["tp"]
    ranks = runs[4]
    for r in ranks:
        _held(r["tp"]["losses"], want)
    _weights_held(_merged([ranks[0], ranks[2]], "tp"), final)
    shards = ranks[0]["tp"]["shards"]
    assert shards["0.Dense_0.kernel"] == (16, 16)
    assert shards["1.Dense_0.kernel"] == (32, 16)


def test_gpt2_pipeline_with_tensor_parallel_stages(runs):
    """PP x TP on GPT-2: 2 stages x mp 2, each stage's blocks split by
    heads (DEFAULT_TP_RULES, K1/K2 on the local heads); the losses and
    weights equal the JAX pure-pipeline run's (value semantics)."""
    _, want, final, _ = runs["ref"]["gpt2"]
    ranks = runs[4]
    for r in ranks:
        _held(r["gpt2_tp"]["losses"], want)
    _weights_held(_merged([ranks[0], ranks[2]], "gpt2_tp"), final)
    shards = ranks[0]["gpt2_tp"]["shards"]
    assert shards["1.Block_0.attn.c_attn.kernel"] == (64, 96)
    assert shards["1.Block_0.mlp.c_proj.kernel"] == (128, 64)
    assert shards["0.wte"] == (1024, 64)


def _local_engine(**kw):
    module = pipe_module({"layers": "dense"}, 1)
    for k, v in kw.items():
        setattr(module, k, v)
    return tds.initialize(model=module, device="cpu",
                          config_params=_config())[0]


def test_pipe_engine_rejects_forward_backward_step():
    engine = _local_engine()
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.forward(np.zeros((8, 16), np.float32))
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.backward(None)
    with pytest.raises(RuntimeError, match="train_batch"):
        engine.step()


def test_refusals_name_their_roadmap_items():
    from deepspeed_tpu_torch.runtime.pipe.compiled import (
        CompiledPipelineEngine)

    # compiled=True selects the compiled engine (its own tests:
    # tests/test_torch_pipe_compiled.py).
    assert isinstance(_local_engine(compiled=True), CompiledPipelineEngine)
    # 1-bit Adam builds (its compressed path needs data ranks); a pipeline
    # over a 'seq' axis stays refused.
    onebit = tds.initialize(model=pipe_module({"layers": "dense"}, 1),
                            device="cpu", config_params=_config(
                                {"optimizer": {"type": "OneBitAdam",
                                               "params": {"lr": 1e-3}}}))[0]
    assert not onebit._onebit_eligible()
    with pytest.raises(NotImplementedError, match="item 10"):
        tds.initialize(model=pipe_module({"layers": "dense"}, 1),
                       device="cpu", config_params=_config(),
                       mesh=tmesh.Mesh((1, 1, 2, 1), 0, None))
    with pytest.raises(NotImplementedError, match="pipeline.partition"):
        tds.initialize(model=pipe_module({"layers": "dense"}, 1),
                       device="cpu", config_params=_config(
                           {"pipeline": {"partition": "uniform"}}))
    with pytest.raises(ValueError, match="stages"):
        tds.initialize(model=pipe_module({"layers": "dense"}, 1),
                       device="cpu", config_params=_config(
                           {"pipeline": {"stages": 2}}))


def test_pipe_axis_needs_a_pipeline_module():
    """A 'pipe' axis wider than 1 is the PipelineEngine's: the plain
    engine refuses it (each stage would train a full replica, with no
    gradient reduced over the pipe axis), before any collective, so a grid
    with a stand-in group suffices."""
    from deepspeed_tpu_torch.models.simple import LinearStack
    from deepspeed_tpu_torch.parallel import mesh as tmesh

    grid = tmesh.Mesh((2, 1, 1, 1), 0, None, pp_group=object())
    model = LinearStack(input_dim=6, hidden_dim=6, output_dim=8,
                        num_layers=2, device="cpu")
    with pytest.raises(ValueError, match="PipelineModule"):
        tds.initialize(model=model, device="cpu", mesh=grid,
                       config_params=_config({"train_batch_size": 8,
                                              "gradient_accumulation_steps":
                                              1}))


def test_params_from_jax_takes_the_layer_params_list(runs):
    init = runs["ref"]["gpt2"][0]
    cfg = GPT2Config.tiny(dtype=torch.float32)
    trees = params_from_jax(init, cfg)
    assert len(trees) == cfg.n_layer + 3
    assert set(trees[1]) == {"Block_0"} and set(trees[-1]) == {"wte", "wpe"}
    with pytest.raises(KeyError, match="lm_head"):
        params_from_jax(init[:-1], cfg)  # no tied head: read as untied
    with pytest.raises(ValueError, match="layer trees"):
        params_from_jax(init[:-2], cfg)


def test_one_stage_engine_saves_jax_layout(tmp_path):
    engine = _local_engine()
    batches = _dense_batches(1)
    engine.train_batch(data_iter=iter(batches))
    engine.save_checkpoint(str(tmp_path), tag="t")
    with open(tmp_path / "t" / "layer_03-model_states.pt", "rb") as f:
        tree = pickle.load(f)
    assert tree["Dense_0"]["kernel"].shape == (32, 8)
    with open(tmp_path / "t" / "zero_pp_rank_0_mp_rank_00optim_states.pt",
              "rb") as f:
        states = pickle.load(f)
    assert len(states) == 4 and set(states[0]) == {"exp_avg", "exp_avg_sq",
                                                   "step"}


class _Counted(object):
    """A layer type with a parameter count, for the 'parameters' method
    (both packages read ``num_params`` off the type)."""
    num_params = 100


class _Small(object):
    num_params = 7


@pytest.mark.parametrize("method", ["uniform", "parameters", "type:_small",
                                    "type:.*counted"])
@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_partition_methods_cut_the_jax_stages(method, stages):
    """``uniform``, ``parameters`` and ``type:regex`` cut the same stage
    boundaries as the JAX module over one layer list of mixed types."""
    from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule

    kinds = [_Counted, _Small, _Small, _Counted, _Counted, _Small, _Counted,
             _Small, _Counted]
    port = PipelineModule([LayerSpec(k) for k in kinds], num_stages=stages,
                          partition_method=method)
    ref = JPipelineModule([JLayerSpec(k) for k in kinds], num_stages=stages,
                          partition_method=method)
    assert port.parts == ref.parts
    for s in range(stages):
        assert port.stage_layer_range(s) == ref.stage_layer_range(s)
    for i in range(len(kinds)):
        assert port.stage_owner(i) == ref.stage_owner(i)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("parts", [1, 2, 3, 5])
def test_partition_functions_match_jax(seed, parts):
    from deepspeed_tpu.runtime import utils as jutils

    from deepspeed_tpu_torch.runtime import utils as tutils

    weights = list(np.random.RandomState(seed).randint(1, 50, size=11))
    assert tutils.partition_balanced(weights, parts) == \
        jutils.partition_balanced(weights, parts)
    assert tutils.partition_uniform(len(weights), parts) == \
        jutils.partition_uniform(len(weights), parts)


def test_train_batch_splits_the_global_batch():
    """``train_batch(batch=...)`` is ``gradient_accumulation_steps``
    micro-batches of the batch's rows; an indivisible batch is refused."""
    x = np.concatenate([b[0] for b in _dense_batches(1)])
    y = np.concatenate([b[1] for b in _dense_batches(1)])
    one, two = _local_engine(), _local_engine()
    a = one.train_batch(batch=(x, y))
    b = two.train_batch(data_iter=iter([(x[:8], y[:8]), (x[8:], y[8:])]))
    assert a == b and np.isfinite(a)
    with pytest.raises(ValueError, match="divisible"):
        one.train_batch(batch=(x[:15], y[:15]))


def test_gpt2_pipeline_dropout_trains_and_eval_is_deterministic():
    """With dropout on, a layer's masks come from a seed per micro-batch
    (training) and eval runs without them: two evals agree."""
    from deepspeed_tpu_torch.models.gpt2 import gpt2_pipeline

    cfg = GPT2Config.tiny(dtype=torch.float32, dropout=0.1)
    engine = tds.initialize(model=gpt2_pipeline(cfg, num_stages=1),
                            device="cpu", config_params=GPT2_CONFIG)[0]
    data = _gpt2_batches(1)
    losses = [engine.train_batch(data_iter=iter(data)) for _ in range(2)]
    assert np.isfinite(losses).all()
    assert engine.eval_batch(iter(data)) == engine.eval_batch(iter(data))
