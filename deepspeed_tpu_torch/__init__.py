"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for one
NVIDIA H100.

The JAX package beside it is the reference; this package mirrors its module
layout (``models/generation.py``, ``inference/engine.py``, ...) so each piece
has an obvious counterpart. It imports ``torch`` and never ``jax``, and
nothing of ``deepspeed_tpu``. Every Pallas kernel on a ported path becomes a
kernel written by hand for Hopper (``csrc/*.cu``, built by ``op_builder``).

Slice 1 is serving: ``init_inference`` builds the continuous-batching
``InferenceEngine`` over GPT-2. Slice 2 is training: ``initialize`` builds
the ``DeepSpeedEngine`` (forward/backward/step, ``train_batch``, bf16/fp16,
AdamW, LR schedules, checkpoints) over the GPT-2 training forward with the
flash-attention kernels K1/K2. Slice 3 is BERT pretraining on the fused
transformer layer (K8, K10a/K10b, K11). Slice 4 serves from a paged and/or
int8 KV pool (``inference.paged_kv`` / ``int8_kv``) through the decode
kernels K4-K6. Slice 5 pretrains BERT on block-sparse attention
(``ops.sparse_attention``, kernels K7a/K7b) at long sequences. Slices 6-13
bring the rest of serving. Slice 14 trains with ZeRO-Offload: the fp32
masters and optimizer moments in host memory, updated by the host C++ ops
(``ops.adam.cpu_adam``, ``ops.lamb.cpu_lamb``), with the dataloader, Lamb,
the fp16 optimizer wrappers and the remat XE head. Slice 15 trains over
several ``torch.distributed`` ranks: the process groups
(``parallel.mesh``, ``utils.distributed``), ZeRO stages 1-3 partitioned
over the data group (``runtime.zero.partition``), sparse (CSR) embedding
gradients, elastic checkpoints, ``elasticity`` and the launcher
(``launcher.runner``, ``launcher.launch``). Slice 16 is model
parallelism over ranks: tensor parallelism on the grid's 'model' axis
(``parallel.tensor_parallel``, GPT-2's Megatron split) and the 1F1B
pipeline (``runtime.pipe``: topology, schedules, ``PipelineModule``, p2p,
tied layers, per-layer checkpoints), ``initialize`` picking the
``PipelineEngine`` for a ``PipelineModule``. Slice 17 splits a sequence
over the grid's 'seq' axis (``ops.transformer.ring_attention``: the ring
over K1/K2 with global statistics, and Ulysses; the ``sequence_parallel``
block), trains with 1-bit Adam over data ranks
(``runtime.fp16.onebit_adam``, ``runtime.custom_collectives``), and ports
activation checkpointing (``runtime.activation_checkpointing``) and
progressive layer drop.
"""

from deepspeed_tpu_torch.device import resolve_device


def init_inference(model, params=None, config=None, device=None, mesh=None):
    """Build the serving engine (mirrors ``deepspeed_tpu.init_inference``).

    ``model`` is a ``models.gpt2.GPT2LMHeadModel`` holding its weights, or a
    ``GPT2Config`` together with ``params``, a flax GPT-2 parameter tree of
    numpy arrays (see ``models.gpt2.params_from_jax``). ``config`` is an
    ``InferenceConfig``, a bare ``inference`` block dict, or a ds_config
    dict carrying an ``"inference"`` key. ``device`` defaults to ``cuda``;
    without a GPU the call raises unless ``device="cpu"`` is passed.
    ``mesh`` (``parallel.mesh.build_mesh(num_mp=...)``): serve this rank's
    shard of the model over the mesh's 'model' axis; every rank makes the
    same calls (``inference/engine.py``, "serving over a mesh").

    Returns the ``InferenceEngine``.
    """
    from deepspeed_tpu_torch.inference import InferenceConfig, InferenceEngine

    if isinstance(config, dict) and "inference" in config:
        config = InferenceConfig.from_dict(config["inference"])
    return InferenceEngine(model, params, config=config, device=device,
                           mesh=mesh)


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config_params=None,
               device=None, collate_fn=None, mesh=None,
               dist_init_required=None):
    """Build the training engine (mirrors ``deepspeed_tpu.initialize``).

    ``model`` is a ``torch.nn.Module`` whose forward returns the loss (the
    port's ``GPT2LMHeadModel`` with labels, ``models.simple.SimpleModel``);
    ``model_parameters`` may be a flax parameter tree of numpy arrays to
    load into it. The ds_config comes from ``config_params`` (a dict) or
    ``args.deepspeed_config`` (a JSON file). ``training_data``, an indexable
    dataset, becomes the engine's ``DeepSpeedDataLoader`` (``collate_fn``
    stacks its samples; default: numpy stacking). ``device`` defaults to
    ``cuda``; without a GPU the call raises unless ``device="cpu"`` is
    passed.

    Over several ranks (the launcher's ``RANK``/``WORLD_SIZE``/
    ``MASTER_ADDR``/``MASTER_PORT``/``LOCAL_RANK``), the engine starts the
    default process group (``utils.distributed.init_distributed``; nccl on
    CUDA, gloo on the CPU) unless one exists or ``dist_init_required`` is
    False, and trains data-parallel over ``mesh`` (default
    ``parallel.mesh.build_mesh()``: every rank on the data axis), each rank
    on its own micro-batch; ZeRO stages 1-3 partition as the JAX engine
    shards. ``device`` defaults to ``cuda:<LOCAL_RANK>`` there. A mesh
    with a 'model' axis wider than 1 shards the model over it (tensor
    parallelism).

    A ``runtime.pipe.PipelineModule`` model selects the ``PipelineEngine``
    (``train_batch`` / ``eval_batch`` over the 1F1B schedule; the mesh's
    'pipe' axis is its stage count); ``model_parameters`` may then be the
    per-layer trees of the JAX ``PipelineEngine``'s ``layer_params``.
    ``PipelineModule(compiled=True)`` selects the ``CompiledPipelineEngine``
    (``runtime/pipe/compiled.py``: the GPipe wavefront of a uniform block
    run, its ticks CUDA graphs on the card).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.runtime.pipe.compiled import (
        CompiledPipelineEngine)
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine
    from deepspeed_tpu_torch.runtime.pipe.module import PipelineModule

    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a model")
    cls = DeepSpeedEngine
    if isinstance(model, PipelineModule):
        cls = CompiledPipelineEngine if model.compiled else PipelineEngine
    engine = cls(args, model, optimizer=optimizer,
                             model_parameters=model_parameters,
                             training_data=training_data,
                             lr_scheduler=lr_scheduler,
                             config_params=config_params, device=device,
                             collate_fn=collate_fn, mesh=mesh,
                             dist_init_required=dist_init_required)
    return engine, engine.optimizer, engine.training_dataloader, \
        engine.lr_scheduler


__all__ = ["init_inference", "initialize", "resolve_device"]
