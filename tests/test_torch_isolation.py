"""The port stands alone: deepspeed_tpu_torch and chip_smoke.py never import
JAX or the JAX package, the host C++ it builds is its own copy, and the
port's entry points never fall back to the CPU on their own."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "deepspeed_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "deepspeed_tpu")


def _sources(target):
    if target == "chip_smoke":
        return [os.path.join(REPO, "chip_smoke.py")]
    return [os.path.join(root, f) for root, _, files in os.walk(PKG)
            for f in files if f.endswith(".py")]


def test_import_loads_no_jax_module():
    names = [m.name for m in pkgutil.walk_packages(
        deepspeed_tpu_torch.__path__, "deepspeed_tpu_torch.")]
    code = ("import importlib, sys\n"
            "for n in {!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in {!r})\n"
            "print(','.join(bad))\n").format(names, FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
    assert len(names) >= 25  # every module of slices 1 and 2 was imported
    # ... and of the sparse-attention slice
    assert {"deepspeed_tpu_torch.ops.sparse_attention." + m for m in (
        "kernels", "sparsity_config", "sparse_self_attention",
        "bert_sparse_self_attention", "sparse_attention_utils")} <= set(names)
    # ... and of the telemetry slice
    assert {"deepspeed_tpu_torch." + m for m in (
        "telemetry.registry", "telemetry.tracing", "telemetry.distributed",
        "telemetry.timeseries", "telemetry.exporters",
        "telemetry.instrumentation", "loadgen.workload", "loadgen.slo",
        "loadgen.report", "loadgen.runner", "utils.logging",
        "utils.timer")} <= set(names)
    # ... and of the ZeRO-Offload slice
    assert {"deepspeed_tpu_torch." + m for m in (
        "ops.adam.cpu_adam", "ops.lamb.cpu_lamb", "ops.lamb.fused_lamb",
        "runtime.zero.offload", "runtime.dataloader", "models.simple",
        "runtime.fp16.fused_optimizer", "runtime.fp16.unfused_optimizer"
    )} <= set(names)
    # ... and of the data-parallel slice
    assert set(DATA_PARALLEL_MODULES) <= set(names)
    # ... and of the module-injection and tooling slice
    assert set(TOOLING_MODULES) <= set(names)


# The data-parallel slice's modules: none may import JAX or the JAX package.
DATA_PARALLEL_MODULES = tuple("deepspeed_tpu_torch." + m for m in (
    "launcher.launch", "launcher.runner", "launcher.multinode_runner",
    "elasticity", "elasticity.config", "elasticity.constants",
    "elasticity.elasticity", "utils.distributed", "runtime.csr_tensor",
    "parallel.mesh", "parallel.comm", "runtime.zero.partition", "version"))


# The module-injection and tooling slice's modules.
TOOLING_MODULES = tuple("deepspeed_tpu_torch." + m for m in (
    "module_inject", "module_inject.replace_module",
    "module_inject.torch_checkpoint", "profiling", "profiling.config",
    "profiling.flops_profiler", "profiling.flops_profiler.profiler",
    "ops.autotuner", "env_report", "analysis", "analysis.__main__",
    "analysis.annotations", "analysis.core", "analysis.rules",
    "analysis.rules.hostsync", "analysis.rules.recompile",
    "analysis.rules.donation", "analysis.rules.determinism",
    "analysis.rules.threadrace", "analysis.rules.adapter"))


@pytest.mark.parametrize("module", DATA_PARALLEL_MODULES + TOOLING_MODULES)
def test_data_parallel_modules_import_no_jax(module):
    """Each module's own source imports neither JAX nor the JAX package,
    at its top or inside a function (``test_import_loads_no_jax_module``
    imports them all in a fresh interpreter)."""
    import importlib

    path = importlib.import_module(module).__file__
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


def test_host_sources_are_the_ports_own():
    """Every C++ source the host route compiles lies under
    deepspeed_tpu_torch/csrc/, none under the JAX package's tree."""
    from deepspeed_tpu_torch.op_builder import host_sources
    csrc = os.path.join(PKG, "csrc") + os.sep
    srcs = host_sources()
    assert len(srcs) == 4
    assert sorted(os.path.basename(s) for s in srcs) == [
        "cpu_adam.cpp", "cpu_lamb.cpp", "flatten_unflatten.cpp", "lut.cpp"]
    for src in srcs:
        real = os.path.realpath(src)
        assert real.startswith(csrc) and os.path.isfile(real), src
        assert os.sep + "deepspeed_tpu" + os.sep not in real


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_no_jax_import_in_source(target):
    found = []
    for path in _sources(target):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            found += ["{}: {}".format(path, m) for m in mods
                      if m.split(".")[0] in FORBIDDEN]
    assert not found


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                            device="cpu")
    config = {"max_len": 64}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model, config=config)
    engine = deepspeed_tpu_torch.init_inference(model, config=config,
                                                device="cpu")
    assert engine.device.type == "cpu"
    train_config = {"train_batch_size": 2}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model,
                                       config_params=train_config)
    trainer, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config_params=train_config, device="cpu")
    assert trainer.device.type == "cpu"


@pytest.mark.parametrize("entry", ["model", "params_from_jax", "init_cache",
                                   "init_pool", "bert", "bert_model",
                                   "bert_params_from_jax",
                                   "transformer_layer", "sparse_bert",
                                   "bert_sparse_self_attention",
                                   "sparse_attention_layers",
                                   "serving_fleet", "moe_init_params",
                                   "moe_params_from_jax", "moe_engine",
                                   "longcontext_engine", "simple_model",
                                   "linear_stack",
                                   "replace_transformer_layer"])
def test_state_builders_default_to_cuda(entry):
    """Every public builder of device state defaults to the GPU: without
    one it raises, and with ``device="cpu"`` it builds on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from deepspeed_tpu_torch.inference import (InferenceEngine,
                                               ServingFleet, kv_pool)
    from deepspeed_tpu_torch.inference.adapters import (LongContextAdapter,
                                                        MoEAdapter, moe)
    from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                            BertModel, GPT2Config,
                                            GPT2LMHeadModel, bert, generation,
                                            params_from_jax)
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BertSparseSelfAttention, FixedSparsityConfig, SparseAttentionUtils)
    from deepspeed_tpu_torch.models.simple import LinearStack, SimpleModel
    from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerLayer
    from deepspeed_tpu_torch.module_inject import replace_transformer_layer
    cfg = GPT2Config.tiny(dtype=torch.float32)
    gcfg = generation.as_gencfg(cfg)
    bcfg = BertConfig.tiny(dtype=torch.float32)
    tree = {name: p.numpy() for name, p in
            GPT2LMHeadModel(cfg, device="cpu").named_parameters()}
    btree = {name: p.numpy() for name, p in
             BertForPreTraining(bcfg, device="cpu").named_parameters()}
    moe_adapter = MoEAdapter.from_config(vocab_size=64, n_positions=64)
    cpu_moe = moe_adapter.init_params(device="cpu")
    moe_tree = {"wte": cpu_moe.wte.numpy(), "wpe": cpu_moe.wpe.numpy(),
                "ln_f": {"scale": cpu_moe.ln_f.scale.numpy(),
                         "bias": cpu_moe.ln_f.bias.numpy()}}
    for i, b in enumerate(cpu_moe.blocks):
        moe_tree["h_{}".format(i)] = {
            "ln_1": vars(b.ln_1), "ln_2": vars(b.ln_2),
            "attn": {n: vars(getattr(b.attn, n))
                     for n in ("c_attn", "c_proj")},
            "router": vars(b.router), "experts": vars(b.experts)}
    build = {
        "model": lambda **kw: GPT2LMHeadModel(cfg, **kw).wte,
        "params_from_jax": lambda **kw: params_from_jax(
            _nest(tree), cfg, **kw).wte,
        "init_cache": lambda **kw: generation.init_cache(gcfg, 2, 8,
                                                         **kw)["k"],
        "init_pool": lambda **kw: kv_pool.init_pool(gcfg, 2, 8, **kw)["k"],
        "bert": lambda **kw: BertForPreTraining(bcfg, **kw).mlm_bias,
        "bert_model": lambda **kw: BertModel(bcfg, **kw).pooler.kernel,
        "bert_params_from_jax": lambda **kw: bert.params_from_jax(
            _nest(btree), bcfg, **kw).mlm_bias,
        "transformer_layer": lambda **kw: DeepSpeedTransformerLayer(
            bcfg.ds_layer_config(), **kw).attn_qkvw,
        "sparse_bert": lambda **kw: BertForPreTraining(BertConfig.tiny(
            dtype=torch.float32, use_fused_layer=False,
            sparse_attention_config=FixedSparsityConfig(4, block=32)),
            **kw).mlm_bias,
        "bert_sparse_self_attention": lambda **kw: BertSparseSelfAttention(
            bcfg, **kw).query.kernel,
        "sparse_attention_layers": lambda **kw: SparseAttentionUtils
        .replace_self_attention_layer_with_sparse_self_attention_layer(
            bcfg, [None], **kw)[0].value.kernel,
        "serving_fleet": lambda **kw: ServingFleet(
            cfg, _nest(tree), n_replicas=2, start=False,
            config={"max_len": 64, "max_slots": 2},
            **kw).replicas[1].engine._pool["k"],
        "moe_init_params": lambda **kw: moe_adapter.init_params(**kw).wte,
        "moe_params_from_jax": lambda **kw: moe.params_from_jax(
            moe_tree, moe_adapter.gcfg, **kw).blocks[0].experts.w1,
        "moe_engine": lambda **kw: InferenceEngine(
            None, moe_tree, config={"max_len": 64, "max_slots": 2},
            adapter=moe_adapter, **kw)._pool["aux_moe_load"],
        "longcontext_engine": lambda **kw: InferenceEngine(
            cfg, _nest(tree), config={"max_len": 64, "max_slots": 2},
            adapter=LongContextAdapter.from_model(cfg, threshold=32,
                                                  block=8), **kw)._pool["k"],
        "simple_model": lambda **kw: SimpleModel(8, **kw).linear.kernel,
        "replace_transformer_layer": lambda **kw: replace_transformer_layer(
            params={}, bert_config=bcfg, **kw)[0].attn_qkvw,
        "linear_stack": lambda **kw: LinearStack(4, 4, 4, 1, **kw)
        .serial_0.kernel,
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    assert build(device="cpu").device.type == "cpu"


def _nest(flat):
    """{"a.b.c": x} -> {"a": {"b": {"c": x}}}, as a flax tree is laid out."""
    tree = {}
    for name, val in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree
