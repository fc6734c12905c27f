"""The port's ds_config parser against the JAX package's, on the CPU.

A config written for the JAX package parses to the same batch triangle,
precision, clipping, optimizer, scheduler, loss-scale arguments, timer and
tensorboard switches and sparse-attention block. A key
that switches on a subsystem the port does not have yet raises
NotImplementedError (its default still parses), and the training entry
point refuses the CPU unless asked for it.
"""

import pytest
import torch

import deepspeed_tpu_torch as tds
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig as TConfig

torch.set_num_threads(1)

FIELDS = ("train_batch_size", "train_micro_batch_size_per_gpu",
          "gradient_accumulation_steps", "steps_per_print",
          "gradient_clipping", "fp16_enabled", "bfloat16_enabled",
          "loss_scale", "initial_dynamic_scale", "dynamic_loss_scale_args",
          "optimizer_name", "optimizer_params", "scheduler_name",
          "scheduler_params", "zero_enabled",
          "checkpoint_tag_validation_enabled",
          "checkpoint_tag_validation_fail", "wall_clock_breakdown",
          "memory_breakdown", "tensorboard_enabled",
          "tensorboard_output_path", "tensorboard_job_name")

CONFIGS = [
    {"train_batch_size": 8},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8,
     "steps_per_print": 5, "gradient_clipping": 1.0,
     "optimizer": {"type": "AdamW", "params": {"lr": 1e-4,
                                               "max_grad_norm": 1.0}},
     "scheduler": {"type": "WarmupDecayLR",
                   "params": {"total_num_steps": 100}},
     "bf16": {"enabled": True}},
    {"train_batch_size": 8, "fp16": {"enabled": True, "loss_scale": 0,
                                     "initial_scale_power": 16,
                                     "hysteresis": 2},
     "zero_optimization": {"stage": 0, "reduce_bucket_size": 1000},
     "checkpoint": {"tag_validation": "fail"},
     "tensorboard": {"enabled": False}, "pipeline": {"stages": "auto"}},
    {"train_batch_size": 8, "fp16": {"enabled": True, "loss_scale": 128},
     "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
     "zero_optimization": False, "amp": {"enabled": False},
     "activation_checkpointing": {}},
    {"train_batch_size": 8, "wall_clock_breakdown": True,
     "memory_breakdown": True, "steps_per_print": 1,
     "tensorboard": {"enabled": True, "output_path": "runs",
                     "job_name": "gpt2"}},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_parses_as_the_jax_package_does(i):
    want = JConfig(None, param_dict=dict(CONFIGS[i]), world_size=1)
    got = TConfig(None, param_dict=dict(CONFIGS[i]))
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("extra", [
    {"zero_optimization": {"stage": 1}},
    {"zero_optimization": {"stage": 0, "cpu_offload": True}},
    {"zero_optimization": True},
    {"amp": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True}},
    {"sequence_parallel": {"enabled": True, "size": 2}},
    {"zero_optimization": {"stage": 2}},
    {"zero_optimization": {"stage": 3}},
    {"flops_profiler": {"enabled": True}},
    {"elasticity": {"enabled": True}},
    {"activation_checkpointing": {"partition_activations": True}},
    {"pipeline": {"stages": 2}},
    {"optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}},
    {"optimizer": {"type": "OneBitAdam", "params": {"lr": 1e-3}}},
    {"activation_checkpointing": {"contiguous_memory_optimization": True}},
])
def test_unported_subsystems_raise(extra):
    cfg = dict({"train_batch_size": 8}, **extra)
    with pytest.raises(NotImplementedError, match="not ported"):
        TConfig(None, param_dict=cfg)


@pytest.mark.parametrize("block", [
    {}, {"mode": "dense", "block": 32},
    {"mode": "fixed", "block": 64, "num_local_blocks": 8,
     "attention": "unidirectional", "different_layout_per_head": True,
     "num_different_global_patterns": 2},
    {"mode": "variable", "num_random_blocks": 2,
     "local_window_blocks": [4, 8], "global_block_indices": [0, 3],
     "global_block_end_indices": [2, 5], "horizontal_global_attention": True},
    {"mode": "bigbird", "num_random_blocks": 3,
     "num_sliding_window_blocks": 5, "num_global_blocks": 2},
    {"mode": "bslongformer", "global_block_indices": [0]},
    {"mode": "fixed", "unknown_key": 1},
])
def test_sparse_attention_block_parses_as_the_jax_package_does(block):
    cfg = {"train_batch_size": 8, "sparse_attention": block}
    want = JConfig(None, param_dict=dict(cfg), world_size=1).sparse_attention
    assert TConfig(None, param_dict=dict(cfg)).sparse_attention == want
    assert want["mode"] == block.get("mode", "fixed")


def test_sparse_attention_unknown_mode_raises_like_the_jax_package():
    cfg = {"train_batch_size": 8, "sparse_attention": {"mode": "strided"}}
    with pytest.raises(NotImplementedError, match="strided") as want:
        JConfig(None, param_dict=dict(cfg), world_size=1)
    with pytest.raises(NotImplementedError) as got:
        TConfig(None, param_dict=dict(cfg))
    assert str(got.value) == str(want.value)
    assert TConfig(None, param_dict={"train_batch_size": 8}) \
        .sparse_attention is None


def test_bad_configs_raise_like_the_jax_package():
    with pytest.raises(ValueError):
        TConfig(None, param_dict={"train_batch_size": 8,
                                  "train_micro_batch_size_per_gpu": 3,
                                  "gradient_accumulation_steps": 2})
    with pytest.raises(ValueError):
        TConfig(None, param_dict={"steps_per_print": 3})
    with pytest.raises(TypeError):
        TConfig(None, param_dict={"train_batch_size": 8, "fp16": True})
    with pytest.raises(ValueError):
        TConfig(None, param_dict={"train_batch_size": 8,
                                  "checkpoint": {"tag_validation": "x"}})


def test_config_file_with_duplicate_keys_raises(tmp_path):
    path = tmp_path / "ds_config.json"
    path.write_text('{"train_batch_size": 8, "train_batch_size": 4}')
    with pytest.raises(ValueError, match="Duplicate"):
        TConfig(str(path))
    path.write_text('{"train_batch_size": 8}')
    assert TConfig(str(path)).train_micro_batch_size_per_gpu == 8


def test_initialize_defaults_to_cuda_and_refuses_what_is_not_ported():
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                            device="cpu")
    cfg = {"train_batch_size": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tds.initialize(model=model, config_params=cfg)
    with pytest.raises(NotImplementedError, match="dataloader"):
        tds.initialize(model=model, config_params=cfg, device="cpu",
                       training_data=[1, 2])
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tds.initialize(model=model, device="cpu", config_params=dict(
            cfg, optimizer={"type": "SGD", "params": {"lr": 1e-3}}))
    engine, opt, loader, sched = tds.initialize(model=model,
                                                config_params=cfg,
                                                device="cpu")
    assert loader is None and sched is None and opt is engine.optimizer
    assert engine.get_lr() == [1e-3]
    assert all(p.requires_grad for p in model.parameters())
