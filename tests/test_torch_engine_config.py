"""The port's ds_config parser against the JAX package's, on the CPU.

A config written for the JAX package parses to the same batch triangle,
precision, clipping, optimizer, scheduler, loss-scale arguments, ZeRO stage
and offload switches, timer and tensorboard switches and sparse-attention
block, and the slice-17 blocks (OneBitAdam, sequence_parallel,
progressive_layer_drop, activation_checkpointing) and the flops_profiler
block. A key that switches on a
subsystem the port does not have yet raises NotImplementedError (its
default still parses), ``stream_gradients`` over several ranks raises the
JAX engine's ValueError, and the training entry point refuses the CPU
unless asked for it. The ``amp`` block: ``tests/test_torch_amp.py``.
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
          "tensorboard_output_path", "tensorboard_job_name",
          "zero_optimization_stage")

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
    # ZeRO at world size 1 (ZeRO needs fp16 or bf16 in both packages).
    {"train_batch_size": 8, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 1}},
    {"train_batch_size": 8,
     "zero_optimization": {"stage": 0, "cpu_offload": True}},
    {"train_batch_size": 8, "fp16": {"enabled": True},
     "zero_optimization": True},
    {"train_batch_size": 8, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 2, "cpu_offload": True,
                           "stream_gradients": True}},
    {"train_batch_size": 8, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 3}},
    {"train_batch_size": 8,
     "optimizer": {"type": "Lamb", "params": {"lr": 1e-3,
                                              "max_coeff": 5.0}}},
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_parses_as_the_jax_package_does(i):
    want = JConfig(None, param_dict=dict(CONFIGS[i]), world_size=1)
    got = TConfig(None, param_dict=dict(CONFIGS[i]))
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name
    for name in ("cpu_offload", "stream_gradients", "stage"):
        assert getattr(got.zero_config, name) == \
            getattr(want.zero_config, name), name


@pytest.mark.parametrize("extra", [
    {"pipeline": {"partition": "uniform"}},
    {"pipeline": {"seed_layers": True}},
])
def test_unported_subsystems_raise(extra):
    cfg = dict({"train_batch_size": 8}, **extra)
    with pytest.raises(NotImplementedError, match="not ported"):
        TConfig(None, param_dict=cfg)


# The blocks this slice ports, each with the fields the JAX config reads
# from it.
_PORTED_BLOCKS = [
    ({"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                 "gamma": 0.01}},
     ("pld_enabled", "pld_params")),
    ({"progressive_layer_drop": {"enabled": False}},
     ("pld_enabled", "pld_params")),
    ({"sequence_parallel": {"enabled": True, "size": 2}},
     ("sequence_parallel_enabled", "sequence_parallel_size")),
    ({"sequence_parallel": {"enabled": True}},
     ("sequence_parallel_enabled", "sequence_parallel_size")),
    ({"activation_checkpointing": {"partition_activations": True}},
     ("activation_checkpointing_config",)),
    ({"activation_checkpointing": {"contiguous_memory_optimization": True,
                                   "number_checkpoints": 4,
                                   "cpu_checkpointing": True}},
     ("activation_checkpointing_config",)),
    ({"optimizer": {"type": "OneBitAdam",
                    "params": {"lr": 1e-3, "freeze_step": 10}}},
     ("optimizer_name", "optimizer_params")),
    ({"flops_profiler": {"enabled": True}}, ("flops_profiler_config",)),
    ({"flops_profiler": {"enabled": True, "start_step": 2, "end_step": 4,
                         "module_depth": 2, "top_modules": 5}},
     ("flops_profiler_config",)),
]


@pytest.mark.parametrize("i", range(len(_PORTED_BLOCKS)))
def test_slice_blocks_parse_as_the_jax_package_does(i):
    """OneBitAdam, sequence_parallel, progressive_layer_drop,
    activation_checkpointing and flops_profiler parse to the JAX config's
    values."""
    extra, fields = _PORTED_BLOCKS[i]
    cfg = dict({"train_batch_size": 8}, **extra)
    want = JConfig(None, param_dict=dict(cfg), world_size=1)
    got = TConfig(None, param_dict=dict(cfg))
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        if name in ("activation_checkpointing_config",
                    "flops_profiler_config"):
            a, b = a.repr(), b.repr()
        assert a == b, name


def test_pipeline_engine_keys_parse():
    """``pipeline.stages`` and ``pipeline.activation_checkpoint_interval``
    are the pipeline engine's and parse (``runtime/pipe/engine.py`` honours
    them); the block's other keys stay refused above."""
    cfg = TConfig(None, param_dict={
        "train_batch_size": 8,
        "pipeline": {"stages": 2, "activation_checkpoint_interval": 1}})
    assert cfg.pipeline["stages"] == 2
    assert cfg.pipeline["activation_checkpoint_interval"] == 1
    assert cfg.pipeline["partition"] == "best"


@pytest.mark.parametrize("zero", [
    {"stage": 2, "cpu_offload": True, "stream_gradients": True},
    {"stage": 2, "cpu_offload": True}, {"stage": 0, "cpu_offload": True}])
def test_world_size_other_than_one_raises(zero):
    """At a world size of 2 the JAX config takes ZeRO-Offload, and so does
    the port's (the offload tier partitions over the data ranks); the JAX
    engine refuses ``stream_gradients`` on a multi-device mesh, and the
    port's config raises it, with the same reason."""
    cfg = {"train_batch_size": 8, "bf16": {"enabled": True},
           "zero_optimization": zero}
    want = JConfig(None, param_dict=dict(cfg), world_size=2)
    if zero.get("stream_gradients"):
        with pytest.raises(ValueError, match="single-chip offload"):
            TConfig(None, param_dict=dict(cfg), world_size=2)
        return
    got = TConfig(None, param_dict=dict(cfg), world_size=2)
    for name in ("cpu_offload", "stage"):
        assert getattr(got.zero_config, name) == \
            getattr(want.zero_config, name)
    assert got.train_micro_batch_size_per_gpu == \
        want.train_micro_batch_size_per_gpu


@pytest.mark.parametrize("world_size", [2, 4])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_world_sizes_parse_as_the_jax_package_does(stage, world_size):
    """Stages 0-3 at a world size of 2 and 4: the batch triangle
    (train = micro x accumulation x world size) and the ZeRO fields equal
    the JAX config's, and sparse_gradients is read."""
    for batch in ({"train_batch_size": 16},
                  {"train_batch_size": 16, "gradient_accumulation_steps": 2},
                  {"train_micro_batch_size_per_gpu": 2,
                   "gradient_accumulation_steps": 2}):
        cfg = dict(batch, bf16={"enabled": True}, sparse_gradients=True,
                   zero_optimization={"stage": stage,
                                      "reduce_bucket_size": 1000,
                                      "allgather_bucket_size": 2000,
                                      "overlap_comm": True,
                                      "contiguous_gradients": True,
                                      "elastic_checkpoint": False,
                                      "load_from_fp32_weights": False})
        want = JConfig(None, param_dict=dict(cfg), world_size=world_size)
        got = TConfig(None, param_dict=dict(cfg), world_size=world_size)
        for name in FIELDS + ("sparse_gradients_enabled", "world_size"):
            assert getattr(got, name) == getattr(want, name), name
        for name in ("stage", "reduce_bucket_size", "allgather_bucket_size",
                     "overlap_comm", "contiguous_gradients",
                     "elastic_checkpoint", "load_from_fp32_weights"):
            assert getattr(got.zero_config, name) == \
                getattr(want.zero_config, name), name
    with pytest.raises(ValueError) as err:
        TConfig(None, param_dict={"train_batch_size": 6,
                                  "train_micro_batch_size_per_gpu": 2,
                                  "gradient_accumulation_steps": 2},
                world_size=world_size)
    assert "world_size" in str(err.value)


@pytest.mark.parametrize("cfg", [
    {"train_batch_size": 8, "zero_optimization": {"stage": 1}},
    {"train_batch_size": 8, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 4}},
    {"train_batch_size": 8, "bf16": {"enabled": True},
     "zero_optimization": {"stage": 1, "cpu_offload": True}},
])
def test_zero_checks_refuse_like_the_jax_package(cfg):
    """ZeRO without fp16/bf16, a stage above 3, cpu_offload off stage 2:
    the JAX config asserts, the port raises ValueError with the same
    text."""
    with pytest.raises(AssertionError) as want:
        JConfig(None, param_dict=dict(cfg), world_size=1)
    with pytest.raises(ValueError) as got:
        TConfig(None, param_dict=dict(cfg))
    assert str(got.value) == str(want.value)


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
    _, _, loader, _ = tds.initialize(model=model, config_params=cfg,
                                     device="cpu", training_data=[1, 2])
    assert len(loader) == 1 and list(loader)[0].tolist() == [1, 2]
    with pytest.raises(ValueError, match="Unknown optimizer"):
        tds.initialize(model=model, device="cpu", config_params=dict(
            cfg, optimizer={"type": "SGD", "params": {"lr": 1e-3}}))
    engine, opt, loader, sched = tds.initialize(model=model,
                                                config_params=cfg,
                                                device="cpu")
    assert loader is None and sched is None and opt is engine.optimizer
    assert engine.get_lr() == [1e-3]
    assert all(p.requires_grad for p in model.parameters())
