"""The port stands alone: deepspeed_tpu_torch and chip_smoke.py never import
JAX or the JAX package, and the port's entry points never fall back to the
CPU on their own."""

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
                                   "sparse_attention_layers"])
def test_state_builders_default_to_cuda(entry):
    """Every public builder of device state defaults to the GPU: without
    one it raises, and with ``device="cpu"`` it builds on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    from deepspeed_tpu_torch.inference import kv_pool
    from deepspeed_tpu_torch.models import (BertConfig, BertForPreTraining,
                                            BertModel, GPT2Config,
                                            GPT2LMHeadModel, bert, generation,
                                            params_from_jax)
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BertSparseSelfAttention, FixedSparsityConfig, SparseAttentionUtils)
    from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerLayer
    cfg = GPT2Config.tiny(dtype=torch.float32)
    gcfg = generation.as_gencfg(cfg)
    bcfg = BertConfig.tiny(dtype=torch.float32)
    tree = {name: p.numpy() for name, p in
            GPT2LMHeadModel(cfg, device="cpu").named_parameters()}
    btree = {name: p.numpy() for name, p in
             BertForPreTraining(bcfg, device="cpu").named_parameters()}
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
