"""DeepSpeedEngine: the training engine, on one card or over several ranks.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` on the path a GPT-2
run takes: ``forward`` / ``backward`` / ``step`` driven by an unchanged
ds_config, ``train_batch``, gradient accumulation, clipping, bf16 and fp16
(dynamic loss scaling with overflow skip), the LR schedules, and
checkpoints in the JAX package's layout and format.

- Precision: the module's parameters are the fp32 master weights. With
  bf16 or fp16 enabled (or ``amp``, which the JAX engine maps to bf16
  compute, ``opt_level`` O0 to fp32) every floating parameter is cast to
  that dtype at each call (``torch.func.functional_call`` over the cast
  copies), as the JAX engine casts its parameter tree before ``apply``;
  gradients flow back through the casts into fp32 ``.grad``.
- ``forward`` runs the module (dropout on while training, its masks seeded
  from the engine's ``torch.Generator``) and returns the loss;
  ``backward(loss)`` backpropagates ``loss * loss_scale / gas``, adding into
  ``.grad``; ``step`` at a gradient-accumulation boundary unscales, skips on
  fp16 overflow, clips, runs ``adam_update`` and steps the scheduler.
- ``train_batch`` is forward, backward and step, eagerly. (The JAX package
  fuses them into one program; a CUDA graph of the step is later work.)
- Checkpoints: ``<dir>/<tag>/mp_rank_00_model_states.pt``, a pickle of
  numpy arrays under the flax names, plus the ``latest`` file; a checkpoint
  of either package loads in the other.
- Telemetry, as in the JAX engine: one ``MetricsRegistry``
  (``self.telemetry``) with the ``global_steps``, ``global_samples``,
  ``skipped_steps`` and ``lr`` gauges and the throughput timer's
  ``samples_per_sec``; ``wall_clock_breakdown`` times forward, backward
  (``backward_inner``: the autograd call alone) and step, each interval
  bracketed by ``torch.cuda.synchronize()`` and observed into the
  ``timer_seconds`` histograms, and logs them every ``steps_per_print``
  steps (with ``memory_breakdown``, the allocator's current and peak
  bytes); the ``tensorboard`` block writes per-step scalars and the
  registry through ``telemetry.TensorBoardScalarWriter``, a warn-once
  no-op where the ``tensorboard`` package is missing. The throughput
  timer synchronizes only when its timing begins and at each
  ``steps_per_print`` report, not at every step as the JAX (and the
  reference's) timer does (``utils/timer.ThroughputTimer``).
- The perf x-ray (``telemetry/xray.py``): ``train_batch`` stashes its
  step under ``train_step`` with the batch's shapes as the signature; a
  signature's first step runs under the x-ray's cost modes (the torch
  operators' flops and bytes of forward, backward and step; each training
  kernel on the card charges its plain version's, so the record is the
  same on the card as on the CPU) and ``perf_xray()`` returns the
  section. No step is sampled (``sample_every`` 0, as in the JAX engine).
- The flops profiler (``profiling/flops_profiler``), as in the JAX engine:
  with the ``flops_profiler`` block enabled, rank 0 starts a
  ``FlopsProfiler`` at the forward of step ``start_step``; each step until
  it stops is measured under the x-ray's cost modes from its forward to the
  end of its backward (the JAX profiler's fused program) and added to it;
  after the backward of step ``end_step`` it stops, prints the profile,
  keeps it in ``flops_profile`` and ends.

- The optimizer table (JAX ``_configure_basic_optimizer``): Adam or AdamW
  -> ``FusedAdam``, Lamb -> ``FusedLamb`` on the device; under
  ``zero_optimization.cpu_offload`` -> ``DeepSpeedCPUAdam`` /
  ``DeepSpeedCPULamb``, the host C++ ops.
- ZeRO in one process without a process group: a stage partitions
  nothing (the JAX package's one-device mesh), so stages 1-3 train as
  stage 0, bit for bit; a checkpoint's optimizer state goes to the zero
  file, as in JAX. (With a process group, even of one rank, stages 1-3
  take the partitioned path below, its collectives over the group.)
- Data parallelism over ``torch.distributed`` ranks (``parallel/mesh.py``:
  the JAX layout's data axis, one process group per data line; the
  default process group comes from the launcher's environment through
  ``utils/distributed.init_distributed``). Each rank runs its own
  micro-batch. Stage 0 (or ZeRO off) averages the gradients over the data
  group at the accumulation boundary only (``allreduce_gradients``);
  stages 1-3 partition the masters, moments, gradients and parameters as
  the JAX engine shards them over its data axis
  (``runtime/zero/partition.py``), built at the first forward (or load),
  so ``compute_dtype`` may still be set before it. The global gradient norm
  counts each replicated leaf once, the fp16 overflow flag is agreed over
  the group (every rank skips the same step), ``train_batch`` returns the
  group's mean loss, and dropout seeds are folded with the data rank.
  ``sparse_gradients`` exchanges the embedding tables' gradients as
  (row, value) pairs (``runtime/csr_tensor.py``). ``pg_correctness_test``
  (module flag) checks each step's reduced gradients against an fp32,
  unpartitioned program over the whole global batch. Checkpoints: the
  model file holds the full fp32 masters (rank 0 writes it); with
  ``elastic_checkpoint`` each rank writes its own
  ``zero_pp_rank_<r>_mp_rank_00optim_states.pt`` in the JAX layout, and a
  load at another data-parallel size reassembles and repartitions.
- ZeRO-Offload (``runtime/zero/offload.py``): at the first offload step
  the fp32 master moves to host memory (flat buffers in JAX's leaf order)
  and the device parameters drop to the compute dtype; each step unscales
  and clips on the card, then runs the pipelined host step (downloads on a
  side stream, the C++ optimizer chunk by chunk, uploads on another
  stream). ``offload_timing()`` reports its phases. Over several data
  ranks (ZeRO stage 2 + ``cpu_offload``) each rank keeps its ZeRO
  partition on the host (``ShardedHostOffload``): the gradients are
  reduce-scattered (under sequence parallelism after their mean over the
  seq line, as every gradient path takes it), the rank's shard goes down, the host step updates it,
  the compute-dtype shard comes back and the parameters are all-gathered;
  under tensor parallelism each model rank offloads its own shards. The
  checkpoint's ``fp32_master`` is the full array in JAX's leaf order, so it
  loads at any data or model size.
- ``stream_gradients``: each gradient is copied to pinned host memory by a
  post-accumulate hook as the backward produces it, and freed; only the
  squared norms stay on the card. Needs gradient_accumulation_steps 1 and
  one rank (the JAX engine's conditions).
- LAMB (device ``FusedLamb`` or host ``DeepSpeedCPULamb``) over ranks that
  hold shards of a tensor (ZeRO's partition, tensor parallelism): its
  per-tensor trust ratio takes the whole tensor's norms, each shard's sums
  of squares added in one all-reduce a group (``_lamb_norm_reduce``).
- ``training_data``: ``deepspeed_io`` builds the ``DeepSpeedDataLoader``
  (``initialize`` returns it), and ``train_batch(data_iter=...)`` draws
  from it.

- Tensor parallelism over the mesh's 'model' axis
  (``parallel/tensor_parallel.py``): the module's parameters are cut to
  the rank's shards by ``DEFAULT_TP_RULES`` (or the module's ``tp_rules``)
  after ``model_parameters`` load; a GPT-2 block computes Megatron's split,
  any other leaf a rule shards is stored sharded and all-gathered for use.
  Gradients are reduced over the data group only; the global norm sums
  each model-sharded leaf's squares over the model group once (a
  replicated leaf once in all); the fp16 overflow flag is agreed over the
  whole world. ZeRO partitions a TP leaf on its first other dim that dp
  divides (JAX ``zero_shardings``). Checkpoints hold the JAX full layout:
  each leaf gathered over the model group, its columns put back in order,
  so a checkpoint loads in either package at another mp/dp.
- Mixture of experts (``moe.MoE`` layers anywhere in the module, the aux
  loss added by the model as in JAX): each layer gates over its data
  line's global batch and draws its Jitter noise from one generator seeded
  alike on every data rank (``_configure_moe``), so dp ranks train the
  JAX program's function; the expert stacks split over 'model' by the
  experts' rule (expert parallelism, ``moe/layer.py``), under ZeRO 1-2
  partitioned over 'data' on another dim. ZeRO-3, 1-bit Adam, sequence
  parallelism and the pipeline with an MoE model raise (ROADMAP Queue 1
  item 20).
- The pipeline: ``runtime/pipe/engine.PipelineEngine`` subclasses this.

- Sequence parallelism (``sequence_parallel``: ``enabled``, ``size``): the
  grid gets a 'seq' axis of ``size`` (a user mesh must have it), one
  process group per seq line. The model must be sequence-shardable
  (``sequence_parallel_axis='seq'``); the engine hands it its seq line
  (``set_sequence_parallel``). Each rank passes its data rank's
  micro-batch and the engine keeps its token shard (dim 1 of every array
  of rank >= 2, ``mesh.seq_shard``, with JAX's divisibility error). The
  model's loss is the line's global mean; the gradients take the mean over
  the seq line, then over the data group (``parallel/sequence_parallel.py``
  says why the mean), with ZeRO before its reduce-scatter. Dropout seeds
  are folded with ``data_rank * sp + seq_rank``. ``pg_correctness_test``
  runs its reference serially over the full sequences.
- 1-bit Adam (``OneBitAdam``, ``runtime/fp16/onebit_adam.py``). On a pure
  data-parallel grid (no ZeRO, model, pipe or seq ranks, no sparse
  gradients: ``_onebit_eligible``) the warm-up averages the gradients
  densely and clips; past ``freeze_step`` each rank's local gradient feeds
  its momentum, the momenta are exchanged compressed over the data group
  and no dense gradient all-reduce runs (``enable_backward_allreduce``
  False; clipping is skipped with a warning, once). Elsewhere the
  gradients are averaged as usual and the compression degenerates to the
  one-party quantization, as in JAX. Checkpoints hold the error buffers in
  the JAX layout (each rank's row gathered into ``[W, padded]``), and the
  phase resumes both ways. ZeRO and tensor parallelism with 1-bit Adam are
  refused (ROADMAP Queue 1 item 9).
- Progressive layer drop (``progressive_layer_drop``): the forward gets
  ``progressive_layer_drop=True, pld_theta=...`` and the schedule advances
  at each boundary. ``activation_checkpointing``: the block configures
  ``runtime/activation_checkpointing/checkpointing.py`` (with the grid, for
  ``partition_activations``).
"""

import inspect
import json
import logging
import os
import pickle
import weakref

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.ops.lamb.cpu_lamb import DeepSpeedCPULamb
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel import mesh as mesh_lib
from deepspeed_tpu_torch.parallel import sequence_parallel
from deepspeed_tpu_torch.parallel import tensor_parallel
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.config import (
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER,
    STREAM_MULTI_RANK, DeepSpeedConfig, get_sequence_parallel_enabled,
    get_sequence_parallel_size)
from deepspeed_tpu_torch.runtime.constants import AMP_OPT_LEVELS
from deepspeed_tpu_torch.runtime.csr_tensor import (  # noqa: F401
    CSRTensor, csr_allreduce, pad_csr, sparse_grad_exchange,
    split_half_float_double_csr)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import CreateLossScaler
from deepspeed_tpu_torch.runtime.fp16.onebit_adam import OnebitAdam
from deepspeed_tpu_torch.runtime.progressive_layer_drop import (
    ProgressiveLayerDrop)
from deepspeed_tpu_torch.runtime.utils import (ensure_directory_exists,
                                               global_norm, has_overflow,
                                               load_flax_tree)
from deepspeed_tpu_torch.runtime.zero.offload import (HostOffload,
                                                      ShardedHostOffload,
                                                      join_jax_flat,
                                                      split_jax_flat)
from deepspeed_tpu_torch.runtime.zero.partition import ZeroPartition
from deepspeed_tpu_torch.telemetry import (MetricsRegistry, ProgramRegistry,
                                           TensorBoardScalarWriter)
from deepspeed_tpu_torch.utils import distributed as dist_utils
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

logger = logging.getLogger(__name__)

MEMORY_OPT_ALLREDUCE_SIZE = 500000000

# Debug cross-check (the reference's stage2.py pg_correctness_test, the JAX
# engine's flag): with it on, every step checks the data group's reduced
# gradients against an fp32 program over the whole global batch with
# unpartitioned, replicated parameters, and raises on a mismatch. The
# reference program runs without dropout: turn it on for models whose
# dropout is off.
pg_correctness_test = False

# Flax names of embedding tables (the JAX engine's _embedding_grad_paths):
# their gradients take the sparse exchange under sparse_gradients.
_EMBED_NAMES = ("embedding", "wte", "word_embeddings")

_DEEPSPEED_STATES = (
    "module", "optimizer", "lr_scheduler", "csr_tensor_module_names",
    "skipped_steps", "global_steps", "global_samples", "dp_world_size",
    "mp_world_size", "loss_scaler")


def _nest(names, tensors):
    """{"a.b": t} -> {"a": {"b": numpy}}: a flax-shaped tree of arrays."""
    tree = {}
    for name, t in zip(names, tensors):
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().float().cpu().numpy()
    return tree


def _leaf(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return np.asarray(tree)


def _host_leaf(tree, name):
    """A saved leaf as a contiguous fp32 CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        _leaf(tree, name).astype(np.float32)))


# Host-LAMB keys (the JAX table's): others are device-only and ignored.
_HOST_LAMB_KEYS = ("lr", "bias_correction", "betas", "eps", "weight_decay",
                   "max_coeff", "min_coeff", "amsgrad")

_ONEBIT_ITEM = "ROADMAP Queue 1 item 9"
_MOE_ITEM = "ROADMAP Queue 1 item 20"
_SEQ_ITEM = "ROADMAP Queue 1 item 10"


def _peek_sequence_parallel(args, config_params):
    """(enabled, size) of the ``sequence_parallel`` block, read before the
    full parse: the grid it builds sets the data-parallel size of the batch
    triangle."""
    raw = config_params
    path = getattr(args, "deepspeed_config", None) if args else None
    if raw is None and path and os.path.isfile(path):
        with open(path) as f:
            raw = json.load(f)
    if not isinstance(raw, dict):
        return False, None
    return get_sequence_parallel_enabled(raw), \
        get_sequence_parallel_size(raw)


def setup_placement(device=None, mesh=None, dist_init_required=None,
                    **mesh_kw):
    """(device, mesh) of a training engine: the device (``cuda:<LOCAL_RANK>``
    under the launcher), the default process group from the launcher's
    environment (unless one exists, ``mesh`` is given or
    ``dist_init_required`` is False), and the rank grid (``build_mesh``
    with ``mesh_kw`` unless ``mesh`` is given)."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if device is None and world > 1 and "LOCAL_RANK" in os.environ:
        device = "cuda:{}".format(os.environ["LOCAL_RANK"])
    device = resolve_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if dist_init_required is None:
        dist_init_required = mesh is None and world > 1 and \
            not dist_utils.is_initialized()
    if dist_init_required:
        dist_utils.init_distributed(device=device)
    return device, mesh if mesh is not None else \
        mesh_lib.build_mesh(**mesh_kw)


class DeepSpeedEngine(object):
    """The training engine (module docstring). ``model`` is a
    ``torch.nn.Module`` whose forward returns the loss (or a tuple whose
    first element is the loss); ``model_parameters`` may be a flax
    parameter tree of numpy arrays to load into it."""

    _pipelined = False  # PipelineEngine: the one engine over a 'pipe' axis

    def __init__(self, args, model, optimizer=None, model_parameters=None,
                 training_data=None, lr_scheduler=None, config_params=None,
                 device=None, seed=1234, collate_fn=None, mesh=None,
                 dist_init_required=None):
        # The rank grid (parallel/mesh.py): this rank's coordinates and the
        # process groups of its data, model, pipe and seq lines.
        sp_enabled, sp_size = _peek_sequence_parallel(args, config_params)
        mesh_kw = {}
        if sp_enabled and mesh is None:
            mesh_kw["num_sp"] = sp_size or int(os.environ.get("WORLD_SIZE",
                                                              1))
        self.device, self.mesh = setup_placement(device, mesh,
                                                 dist_init_required,
                                                 **mesh_kw)
        self._check_seq_mesh(sp_enabled, sp_size, mesh is not None)
        if mesh_lib.pp_size(self.mesh) > 1 and not self._pipelined:
            raise ValueError(
                "a 'pipe' axis {} wide needs a PipelineModule (the "
                "PipelineEngine splits the model into stages); this engine "
                "would train a full replica on each stage".format(
                    mesh_lib.pp_size(self.mesh)))
        self.dp_world_size = mesh_lib.dp_size(self.mesh)
        self.mp_world_size = mesh_lib.mp_size(self.mesh)
        self.dp_rank = self.mesh.dp_rank
        self.mp_rank = self.mesh.mp_rank
        self.global_rank = self.mesh.rank
        self.dp_group = self.mesh.dp_group
        self.mp_group = self.mesh.mp_group
        self.pp_group = self.mesh.pp_group
        self.sp_world_size = mesh_lib.sp_size(self.mesh)
        self.sp_rank = self.mesh.sp_rank
        self.sp_group = self.mesh.sp_group
        # 1-bit Adam clears it at its freeze (the reference's flag): no
        # dense gradient all-reduce from then on.
        self.enable_backward_allreduce = True
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self.training = True
        self.collate_fn = collate_fn
        self._config = self._configure_with_arguments(args, config_params)
        self._tb_writer = None
        self._last_loss = None
        # Telemetry (module docstring): the phase timers observe into the
        # registry, and the gauges read the engine's state at scrape time.
        self.telemetry = MetricsRegistry(engine="training")
        self.timers = SynchronizedWallClockTimer(registry=self.telemetry)
        # The perf x-ray of train_batch's step (module docstring).
        self.xray = ProgramRegistry(self.telemetry,
                                    platform=self.device.type,
                                    sample_every=0)
        # The flops profiler (module docstring): the profiler while it
        # runs, the open window of the step it is measuring, and the last
        # profile it printed.
        self.flops_profiler = None
        self._profile_window = None
        self.flops_profile = None
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_micro_batch_size_per_gpu(),
            num_workers=self.dp_world_size,
            steps_per_output=self.steps_per_print(), monitor_memory=False,
            registry=self.telemetry)
        # Through a weak reference: a dropped engine (its parameters and
        # optimizer state) is freed at once, not by the cycle collector.
        ref = weakref.ref(self)
        self.telemetry.gauge("global_steps").set_fn(
            lambda: ref().global_steps)
        self.telemetry.gauge("global_samples").set_fn(
            lambda: ref().global_samples)
        self.telemetry.gauge("skipped_steps").set_fn(
            lambda: ref().skipped_steps)
        self.telemetry.gauge("lr").set_fn(
            lambda: (ref().get_lr() if ref().optimizer else [0.0])[0])

        self.compute_dtype = self._configure_precision()

        self.module = model.to(self.device)
        if isinstance(model_parameters, dict):
            if set(model_parameters) == {"params"}:
                model_parameters = model_parameters["params"]
            load_flax_tree(self.module, model_parameters)
        # Tensor parallelism: the full parameters cut to this rank's shards.
        self._tp = None
        tp = tensor_parallel.model_context(self.mesh)
        if tp is not None:
            self._tp = tensor_parallel.apply_rules(
                self.module, tp, getattr(self.module, "tp_rules", None),
                getattr(self.module, "rule_path", None))
        named = [(n, p) for n, p in self.module.named_parameters()]
        self._names = [n for n, _ in named]
        self._params = [p for _, p in named]
        for p in self._params:
            p.requires_grad_(True)
        accepted = inspect.signature(self.module.forward).parameters
        self._takes_deterministic = "deterministic" in accepted
        self._takes_generator = "generator" in accepted
        # Dropout seeds come from here (a CPU generator: drawing a seed
        # never waits for the card), folded with the data and seq ranks (as
        # the JAX engine folds its key with the axis indices).
        self._generator = torch.Generator()
        fold = self.dp_rank * self.sp_world_size + self.sp_rank
        self._generator.manual_seed(
            _fold_seed(seed, fold)
            if self.dp_world_size * self.sp_world_size > 1 else seed)
        self._moe = self._configure_moe(seed)
        self._sp = self._configure_sequence_parallel()

        self.loss_scaler = None
        if self.fp16_enabled():
            self.loss_scaler = CreateLossScaler(
                dynamic_scaling=self._config.loss_scale == 0,
                static_loss_scale=self._config.loss_scale or 1.0,
                dynamic_loss_args=self._config.dynamic_loss_scale_args)
        self._offload = None  # the ZeRO-Offload tier's host state
        self._streamed = None  # the streamed backward's squared norms
        self._stream_token = None
        # ZeRO stages 1-3 over several ranks (runtime/zero/partition.py),
        # built at the first forward, load or save.
        self._zero = None
        self._partitioned = self.zero_optimization() and \
            self.zero_optimization_stage() >= 1 and \
            self.dp_group is not None
        self._sparse = frozenset(
            i for i, (n, p) in enumerate(zip(self._names, self._params))
            if p.dim() >= 2 and any(k in _EMBED_NAMES or
                                    k.endswith("_embeddings")
                                    for k in n.split("."))) \
            if self.sparse_gradients_enabled() and self.dp_world_size > 1 \
            else frozenset()
        self._sparse_k = 0
        self._pg_inputs = []
        self._configure_optimizer(optimizer)
        if self._offload_mode():
            # The offload tier partitions its own host state.
            self._partitioned = False
        self._check_onebit()
        self._check_partitioned()
        self._check_moe()
        if hasattr(self.optimizer, "norm_reduce") and self.mesh.size > 1:
            # LAMB's trust ratio over ranks that each hold a shard.
            ref = weakref.ref(self)
            self.optimizer.norm_reduce = \
                lambda sq: ref()._lamb_norm_reduce(sq)
        self._configure_lr_scheduler(lr_scheduler)
        pld = self._config.pld_params
        self.progressive_layer_drop = ProgressiveLayerDrop(
            theta=pld.get("theta", 1.0), gamma=pld.get("gamma", 0.001)) \
            if self.pld_enabled() else None
        self._configure_checkpointing()
        self.training_dataloader = self.deepspeed_io(training_data) \
            if training_data is not None else None

    # ------------------------------------------------------------- config

    def _check_seq_mesh(self, enabled, size, user_mesh):
        """The grid against the ``sequence_parallel`` block (the JAX
        engine's checks of a user mesh)."""
        have = mesh_lib.sp_size(self.mesh)
        if enabled and user_mesh and have <= 1:
            raise ValueError("sequence_parallel is enabled but the provided "
                             "mesh has no 'seq' axis (build_mesh(num_sp=...))")
        if enabled and size is not None and size != have:
            raise ValueError("sequence_parallel size {} != mesh 'seq' axis {}"
                             .format(size, have))

    def _configure_sequence_parallel(self):
        """The model's seq line (module docstring), or None without a 'seq'
        axis."""
        if self.sp_world_size <= 1:
            return None
        cfg = getattr(self.module, "config", None)
        if getattr(cfg, "sequence_parallel_axis", None) != mesh_lib.SEQ_AXIS:
            raise ValueError(
                "sequence_parallel is enabled but the model is not "
                "sequence-shardable: its config must set "
                "sequence_parallel_axis='{}' (attention must mix tokens "
                "across shards - silently sharding a serial model would "
                "train a different function)".format(mesh_lib.SEQ_AXIS))
        if self.sparse_gradients_enabled():
            raise NotImplementedError(
                "sequence_parallel cannot be combined with sparse_gradients")
        if self.mp_world_size > 1:
            raise NotImplementedError(
                "sequence parallelism with tensor parallelism is not ported "
                "({})".format(_SEQ_ITEM))
        sp = sequence_parallel.context(self.mesh)
        self.module.set_sequence_parallel(sp)
        return sp

    def _configure_moe(self, seed):
        """The module's ``moe.MoE`` layers (module docstring): each gates
        over its data line's global batch and draws its Jitter noise from
        one generator seeded alike on every data rank."""
        layers = [m for m in self.module.modules() if isinstance(m, MoE)]
        if layers:
            self._refuse_moe(("sequence parallelism", self.sp_world_size > 1),
                             ("the pipeline", self._pipelined))
            gen = torch.Generator(device=self.device).manual_seed(seed)
            group = self.dp_group if self.dp_world_size > 1 else None
            for m in layers:
                m.set_data_parallel(group, gen)
        return layers

    def _check_moe(self):
        """The optimizer compositions an MoE model does not train in yet."""
        if self._moe:
            self._refuse_moe(("ZeRO stage 3", self.zero_optimization() and
                              self.zero_optimization_stage() >= 3),
                             ("1-bit Adam", isinstance(self.optimizer,
                                                       OnebitAdam)))

    @staticmethod
    def _refuse_moe(*cases):
        refused = [what for what, on in cases if on]
        if refused:
            raise ValueError("an MoE model with {} is not ported ({})".format(
                " and ".join(refused), _MOE_ITEM))

    def _check_onebit(self):
        """1-bit Adam with ZeRO or over model ranks is not ported; on its
        pure data-parallel path the optimizer exchanges over the data
        group."""
        if not isinstance(self.optimizer, OnebitAdam):
            return
        if self.zero_optimization():
            raise NotImplementedError(
                "1-bit Adam with ZeRO stage {} is not ported ({})".format(
                    self.zero_optimization_stage(), _ONEBIT_ITEM))
        if self.mp_world_size > 1:
            raise NotImplementedError(
                "1-bit Adam over {} tensor-parallel ranks is not ported ({})"
                .format(self.mp_world_size, _ONEBIT_ITEM))
        if self._onebit_eligible():
            self.optimizer.group = self.dp_group

    def _onebit_eligible(self):
        """The compressed exchange (module docstring): 1-bit Adam over pure
        data-parallel ranks."""
        return isinstance(self.optimizer, OnebitAdam) and \
            self.dp_world_size > 1 and self.mesh.size == self.dp_world_size \
            and not self.zero_optimization() and \
            not self.sparse_gradients_enabled()

    def _onebit_compressed(self):
        """Past the freeze on the compressed path: local gradients, no
        dense all-reduce."""
        return self._onebit_eligible() and not self.enable_backward_allreduce

    def _warn_onebit_clip_once(self, clip):
        if clip > 0.0 and not getattr(self, "_onebit_clip_warned", False):
            self._onebit_clip_warned = True
            logger.warning(
                "1-bit Adam compressed phase ignores gradient_clipping=%s: "
                "clipping applies only during warmup; the quantization "
                "scale bounds the exchanged update instead.", clip)

    def _configure_checkpointing(self):
        """An ``activation_checkpointing`` block configures the module
        (with the grid, for ``partition_activations``); without the block
        a caller's own ``configure`` stands."""
        from deepspeed_tpu_torch.runtime.activation_checkpointing import (
            checkpointing)
        from deepspeed_tpu_torch.runtime.activation_checkpointing.config \
            import ACT_CHKPT
        if ACT_CHKPT not in self._config._param_dict:
            return
        cfg = self._config.activation_checkpointing_config
        checkpointing.configure(
            partition_activations=cfg.partition_activations,
            contiguous_checkpointing=cfg.contiguous_memory_optimization,
            num_checkpoints=cfg.number_checkpoints,
            checkpoint_in_cpu=cfg.cpu_checkpointing,
            synchronize=cfg.synchronize_checkpoint_boundary,
            profile=cfg.profile, mesh_=self.mesh)

    def _configure_precision(self):
        """The compute dtype (fp32 masters always). ``amp`` is the JAX
        engine's mapping of the reference's apex hook: bf16 compute, no loss
        scaling (``opt_level`` O0: fp32), exclusive with the fp16 and bf16
        blocks."""
        if self.amp_enabled():
            if self.fp16_enabled() or self.bfloat16_enabled():
                raise ValueError(
                    "amp is mutually exclusive with the fp16/bf16 config "
                    "blocks (reference semantics); enable exactly one")
            opt_level = dict(self.amp_params() or {}).get("opt_level", "O1")
            if opt_level not in AMP_OPT_LEVELS:
                raise ValueError("unknown amp opt_level {!r}".format(
                    opt_level))
            return torch.float32 if opt_level == "O0" else torch.bfloat16
        if self.fp16_enabled():
            return torch.float16
        if self.bfloat16_enabled():
            return torch.bfloat16
        return torch.float32

    def _configure_with_arguments(self, args, config_params):
        config_file = getattr(args, "deepspeed_config", None) if args \
            else None
        if config_file is None and config_params is None:
            raise ValueError("DeepSpeed requires --deepspeed_config or "
                             "config_params")
        if config_file is not None and config_params is not None:
            raise ValueError("pass exactly one of a deepspeed_config file and "
                             "a config_params dict")
        if config_file is not None and not os.path.isfile(config_file):
            raise FileNotFoundError("DeepSpeed config file not found: "
                                    "{}".format(config_file))
        return DeepSpeedConfig(config_file, param_dict=config_params,
                               world_size=self.dp_world_size)

    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def fp16_enabled(self):
        return self._config.fp16_enabled

    def bfloat16_enabled(self):
        return self._config.bfloat16_enabled

    def amp_enabled(self):
        return self._config.amp_enabled

    def amp_params(self):
        return self._config.amp_params

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_stage(self):
        return self._config.zero_optimization_stage

    def zero_cpu_offload(self):
        return bool(self._config.zero_config.cpu_offload)

    def zero_elastic_checkpoint(self):
        return self._config.zero_config.elastic_checkpoint

    def sparse_gradients_enabled(self):
        return self._config.sparse_gradients_enabled

    def pld_enabled(self):
        return self._config.pld_enabled

    def zero_gathers(self):
        """Stage-3 parameter gathers so far (0 before the partition is
        built or below stage 3)."""
        return 0 if self._zero is None else self._zero.gathers

    def offload_timing(self):
        """The last offload step's phases on the host clock: queue_s
        (scaling the gradients and queueing their downloads, before the
        pipeline), stage_s (waits for the downloads and their widening to
        fp32, on the worker), adam_s (the C++ optimizer), upload_s
        (queueing the parameter uploads), wall_s (the pipeline), chunks,
        and overlap_ratio = (stage_s + adam_s + upload_s) / wall_s (1.0
        serial, above 1 overlapped); on the card also download_s and
        upload_device_s, the transfers' CUDA-event time. None before an
        offload step has run."""
        return None if self._offload is None else self._offload.timing

    def sparse_attention(self):
        return self._config.sparse_attention

    def flops_profiler_enabled(self):
        return self._config.flops_profiler_config.enabled

    def flops_profiler_start_step(self):
        return self._config.flops_profiler_config.start_step

    def flops_profiler_end_step(self):
        return self._config.flops_profiler_config.end_step

    def _start_flops_profiler(self):
        from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler
        self.flops_profiler = FlopsProfiler(self.module, xray=self.xray)
        self.flops_profiler.start_profile()

    def _stop_flops_profiler(self):
        """Stop, print and end the profile; its totals and text stay in
        ``flops_profile``."""
        prof = self.flops_profiler
        prof.stop_profile()
        text = prof.print_model_profile(
            profile_step=self.global_steps,
            module_depth=self._config.flops_profiler_config.module_depth,
            top_modules=self._config.flops_profiler_config.top_modules)
        self.flops_profile = {
            "flops": prof.get_total_flops(),
            "bytes_accessed": prof.get_total_bytes(),
            "params": prof.get_total_params(),
            "steps": prof.get_total_steps(),
            "duration_s": prof.get_total_duration(),
            "modules": prof.module_breakdown(
                self._config.flops_profiler_config.module_depth),
            "text": text}
        prof.end_profile()

    def _close_profile_window(self):
        window, self._profile_window = self._profile_window, None
        if window is not None:
            window.__exit__(None, None, None)

    def _profiler_step_end(self):
        """Close the step's profiling window; stop at ``end_step``."""
        self._close_profile_window()
        if self.flops_profiler is not None and \
                self.flops_profiler.started and \
                self.global_steps == self.flops_profiler_end_step():
            self._stop_flops_profiler()

    def wall_clock_breakdown(self):
        return self._config.wall_clock_breakdown

    def memory_breakdown(self):
        return self._config.memory_breakdown

    def tensorboard_enabled(self):
        return self._config.tensorboard_enabled

    def tensorboard_output_path(self):
        return self._config.tensorboard_output_path

    def tensorboard_job_name(self):
        return self._config.tensorboard_job_name

    def _tensorboard_log_dir(self, name="DeepSpeedJobName", base=None):
        """Event-file directory: ``<output_path>/<job_name>``, or under
        ``base`` (default ``~/tensorboard``) and the $DLWS/DLTS job id."""
        if self.tensorboard_output_path():
            return os.path.join(self.tensorboard_output_path(),
                                self.tensorboard_job_name() or name)
        summary_writer_dir_name = (self.tensorboard_job_name() or name)
        if base is None:
            base = os.path.join(os.path.expanduser("~"), "tensorboard")
        if "DLWS_JOB_ID" in os.environ:
            infra_job_id = os.environ["DLWS_JOB_ID"]
        elif "DLTS_JOB_ID" in os.environ:
            infra_job_id = os.environ["DLTS_JOB_ID"]
        else:
            infra_job_id = "unknown-job-id"
        return os.path.join(base, infra_job_id, summary_writer_dir_name)

    def _scalar_writer(self, name="DeepSpeedJobName", base=None):
        """The lazy ``telemetry.TensorBoardScalarWriter`` behind the
        ``tensorboard`` block: a warn-once no-op without the tensorboard
        package, so training never stops over an exporter."""
        if self._tb_writer is None:
            self._tb_writer = TensorBoardScalarWriter(
                self._tensorboard_log_dir(name=name, base=base))
        return self._tb_writer

    def get_summary_writer(self, name="DeepSpeedJobName", base=None):
        """The raw SummaryWriter (the reference's API); raises where the
        tensorboard package is unavailable."""
        writer = self._scalar_writer(name=name, base=base)._get()
        if writer is None:
            raise RuntimeError(
                "tensorboard is unavailable (torch.utils.tensorboard "
                "failed to import or the log dir is unwritable)")
        return writer

    def _tensorboard_step_events(self):
        """Per-step scalars (train loss, lr and the loss scale at each
        boundary step, against global_samples) and the registry snapshot
        (phase-timer percentiles, samples/sec, the step gauges) under
        ``telemetry/``."""
        if not self.tensorboard_enabled():
            return
        tb = self._scalar_writer()
        if not tb.available:  # warned once inside the writer
            return
        if self._last_loss is not None:
            tb.add_scalar("Train/Samples/train_loss", float(self._last_loss),
                          self.global_samples)
        if self.optimizer is not None:
            tb.add_scalar("Train/Samples/lr", self.get_lr()[0],
                          self.global_samples)
        if self.loss_scaler is not None:
            tb.add_scalar("Train/Samples/loss_scale",
                          self.loss_scaler.loss_scale, self.global_samples)
        tb.publish(self.telemetry, self.global_samples)
        tb.flush()

    def _report_progress(self, step):
        """The ``steps_per_print`` line, read from the telemetry registry:
        the gauges Prometheus and TensorBoard export."""
        snap = self.telemetry.snapshot()
        logger.info("step={}, skipped={}, lr={}, mom={}, samples={}, "
                    "samples/sec={:.2f}".format(
                        step, self.skipped_steps, self.get_lr(),
                        self.get_mom(), int(snap.get("global_samples", 0)),
                        snap.get("samples_per_sec", 0.0)))

    def _configure_optimizer(self, client_optimizer):
        self.optimizer = client_optimizer
        if client_optimizer is not None:
            if self.zero_cpu_offload() and not self._offload_mode():
                logger.warning(
                    "zero_optimization.cpu_offload is set but the client "
                    "optimizer is not DeepSpeedCPUAdam or DeepSpeedCPULamb: "
                    "its state stays on the device (no offload)")
        elif self._config.optimizer_name is not None:
            self.optimizer = self._configure_basic_optimizer()
        self.opt_state = None
        if self.optimizer is not None and not self._offload_mode() and \
                not self._partitioned:
            self.opt_state = self.optimizer.init_state(self._params)
        self._check_streaming()

    def _check_partitioned(self):
        """What ZeRO over several ranks, and tensor parallelism, do not
        cover yet."""
        if not self._partitioned:
            return
        if not isinstance(self.optimizer, (FusedAdam, FusedLamb)):
            raise NotImplementedError(
                "ZeRO stage {} over {} ranks partitions the state of the "
                "DeepSpeed optimizers (Adam, AdamW, Lamb); a client {} is "
                "not partitioned".format(self.zero_optimization_stage(),
                                         self.dp_world_size,
                                         type(self.optimizer).__name__))
        if self._tp is not None and self._tp.stored and \
                self.zero_optimization_stage() >= 3:
            raise NotImplementedError(
                "ZeRO stage 3 with tensor-parallel leaves the model does not "
                "compute split ({}) is not ported yet: stage 3 gathers a "
                "block's parameters inside its forward, after the engine "
                "gathers the stored shards (ROADMAP Queue 1 item 6)".format(
                    [self._names[i] for i in self._tp.stored][:3]))
        if self.zero_optimization_stage() >= 3 and getattr(
                getattr(self.module, "config", None), "remat", False):
            raise NotImplementedError(
                "ZeRO stage 3 over several ranks with per-block remat is not "
                "ported yet: the recomputed forward would free its gathered "
                "parameters (ROADMAP Queue 1 item 7)")

    def _ensure_zero(self):
        """Build the partition (masters, moments as shards, the module's
        parameters in the compute dtype) on first use."""
        if not self._partitioned or self._zero is not None:
            return
        zc = self._config.zero_config
        self._zero = ZeroPartition(
            self.module, self._params,
            self.zero_optimization_stage(), self.dp_group,
            self.compute_dtype, zc.reduce_bucket_size,
            zc.allgather_bucket_size, sparse=self._sparse,
            skip_dims=self._tp.dims if self._tp is not None else None,
            seq_group=self.sp_group if self._sp is not None else None)
        if self.optimizer is not None:
            self.opt_state = self.optimizer.init_state(self._zero.master)

    def _configure_basic_optimizer(self):
        """The optimizer table (JAX ``_configure_basic_optimizer``)."""
        params = dict(self._config.optimizer_params or {})
        params.pop("torch_adam", None)
        name = self._config.optimizer_name
        adam_w_mode = params.pop("adam_w_mode", name == ADAMW_OPTIMIZER) or \
            name == ADAMW_OPTIMIZER
        if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            if self.zero_cpu_offload():
                return DeepSpeedCPUAdam(model_params=self._params,
                                        adamw_mode=adam_w_mode, **params)
            return FusedAdam(params=self._params, adam_w_mode=adam_w_mode,
                             **params)
        if name == LAMB_OPTIMIZER:
            if self.zero_cpu_offload():
                dropped = [k for k in params if k not in _HOST_LAMB_KEYS]
                if dropped:
                    logger.warning("Lamb params %s are not supported by the "
                                   "host (cpu_offload) tier and are ignored",
                                   dropped)
                return DeepSpeedCPULamb(
                    model_params=self._params,
                    **{k: v for k, v in params.items()
                       if k in _HOST_LAMB_KEYS})
            return FusedLamb(params=self._params, **params)
        if name == ONEBIT_ADAM_OPTIMIZER:
            if self.zero_cpu_offload():
                raise ValueError(
                    "zero_optimization.cpu_offload requires an Adam/AdamW "
                    "optimizer (got {}); the host tier is DeepSpeedCPUAdam"
                    .format(name))
            return OnebitAdam(params=self._params, deepspeed=self, **params)
        raise ValueError("Unknown optimizer: {}".format(name))

    def _offload_mode(self):
        return isinstance(self.optimizer, (DeepSpeedCPUAdam,
                                           DeepSpeedCPULamb))

    def _stream_grads_active(self):
        return self._offload_mode() and \
            bool(self._config.zero_config.stream_gradients)

    def _check_streaming(self):
        """The JAX engine's conditions for stream_gradients (it asserts
        them at the forward)."""
        if self._stream_grads_active() and self.mesh.size > 1:
            raise ValueError("stream_gradients over {} ranks: {}".format(
                self.mesh.size, STREAM_MULTI_RANK))
        if self._stream_grads_active() and \
                self.gradient_accumulation_steps() != 1:
            raise ValueError("stream_gradients requires "
                             "gradient_accumulation_steps=1 (each backward "
                             "streams its gradients to the host)")

    def deepspeed_io(self, dataset, batch_size=None, route="train",
                     pin_memory=True, data_sampler=None, collate_fn=None,
                     num_local_io_workers=None):
        """The ``DeepSpeedDataLoader`` over ``dataset`` at the micro-batch
        size, handing batches to the engine's device (pinned and
        ``non_blocking`` on the card)."""
        if batch_size is None:
            batch_size = self.train_micro_batch_size_per_gpu()
        return DeepSpeedDataLoader(
            dataset=dataset, batch_size=batch_size,
            data_parallel_world_size=self.dp_world_size,
            data_parallel_rank=self.dp_rank,
            collate_fn=collate_fn or self.collate_fn,
            num_local_io_workers=num_local_io_workers,
            data_sampler=data_sampler, device=self.device)

    def _configure_lr_scheduler(self, client_lr_scheduler):
        name = self._config.scheduler_name
        if name is not None and self.optimizer is not None:
            scheduler = getattr(lr_schedules, name, None)
            if scheduler is None:
                raise ValueError("DeepSpeed does not recognize LR scheduler "
                                 "{}".format(name))
            self.lr_scheduler = scheduler(self.optimizer,
                                          **(self._config.scheduler_params
                                             or {}))
        elif callable(client_lr_scheduler) and self.optimizer is not None:
            self.lr_scheduler = client_lr_scheduler(self.optimizer)
        else:
            self.lr_scheduler = client_lr_scheduler

    # ------------------------------------------------------------ forward

    def train(self, mode=True):
        self.training = mode

    def eval(self):
        self.training = False

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return x

    def _run_module(self, inputs, kwargs):
        # Stored tensor-parallel shards are gathered for use.
        stored = self._tp.stored if self._tp is not None else []
        gathered = {self._names[i]: self._tp.gathered(
            i, self._params[i].to(self.compute_dtype)) for i in stored}
        if self.compute_dtype == torch.float32 or self._zero is not None:
            # fp32, or partitioned: the module's parameters already hold
            # the compute dtype.
            if not gathered:
                return self.module(*inputs, **kwargs)
            return torch.func.functional_call(self.module, gathered, inputs,
                                              kwargs)
        cast = {n: p.to(self.compute_dtype) if p.is_floating_point() else p
                for n, p in zip(self._names, self._params)}
        cast.update(gathered)
        return torch.func.functional_call(self.module, cast, inputs, kwargs)

    def forward(self, *inputs, **kwargs):
        """Run the module on ``inputs`` (numpy arrays or tensors, moved to
        the engine's device) and return its loss. While training, dropout
        is on and the graph is kept for ``backward``."""
        if self.flops_profiler_enabled() and \
                self.global_steps == self.flops_profiler_start_step() and \
                self.global_rank == 0 and (self.flops_profiler is None or
                                           not self.flops_profiler.started):
            self._start_flops_profiler()
        if self.wall_clock_breakdown():
            self.timers("forward_microstep").start()
            self.timers("forward").start()
        inputs = tuple(self._to_device(x) for x in inputs)
        kwargs = {k: self._to_device(v) for k, v in kwargs.items()}
        if self.progressive_layer_drop is not None:
            kwargs.update(self.progressive_layer_drop.get_state())
        self._ensure_zero()
        if self.training and self._stream_grads_active():
            self._begin_streaming()
        if self.training and self._sparse:
            # The exchange budget: one touched row per integer input
            # element (the JAX engine's k).
            self._sparse_k += sum(
                x.numel() for x in list(inputs) + list(kwargs.values())
                if isinstance(x, torch.Tensor) and
                not x.is_floating_point() and x.dtype != torch.bool)
        if self.training and pg_correctness_test:
            self._pg_inputs.append(tuple(x.detach().cpu() for x in inputs))
        if self._sp is not None:
            # This rank's token shard (the batch is its data rank's).
            n, r = self._sp.size, self._sp.rank
            inputs = tuple(mesh_lib.seq_shard(x, n, r) for x in inputs)
            kwargs = {k: mesh_lib.seq_shard(v, n, r)
                      for k, v in kwargs.items()}
        if self.flops_profiler is not None and self.flops_profiler.started:
            # Closed after this step's backward (or below, in eval): the
            # step's forward and backward in one measurement.
            self._close_profile_window()
            self._profile_window = self.flops_profiler.window().__enter__()
        try:
            if not self.training:
                with torch.no_grad():
                    out = self._run_module(inputs, kwargs)
            else:
                self.tput_timer.start()
                if self._takes_deterministic:
                    kwargs.setdefault("deterministic", False)
                if self._takes_generator:
                    kwargs.setdefault("generator", self._generator)
                out = self._run_module(inputs, kwargs)
        except BaseException:
            self._profiler_step_end()
            raise
        if not self.training:
            self._profiler_step_end()
        if self.wall_clock_breakdown():
            self.timers("forward").stop()
            self.timers("forward_microstep").stop()
        return out[0] if isinstance(out, tuple) else out

    # ----------------------------------------------------------- backward

    def backward(self, loss):
        """Add the gradients of ``loss * loss_scale /
        gradient_accumulation_steps`` into the parameters' ``.grad``."""
        if not loss.requires_grad:
            raise RuntimeError("backward() needs the loss of a training "
                               "forward()")
        self._last_loss = loss.detach()
        breakdown = self.wall_clock_breakdown()
        if breakdown:
            self.timers("backward_microstep").start()
            self.timers("backward").start()
            self.timers("backward_inner").start()
        scale = self.loss_scaler.loss_scale if self.loss_scaler else 1.0
        if self._zero is not None:
            self._zero.boundary = self.is_gradient_accumulation_boundary()
        try:
            (loss * (scale / self.gradient_accumulation_steps())).backward()
        finally:
            self._profiler_step_end()
        if self._zero is not None:
            self._zero.end_backward()
        if self._streamed is not None:
            # Every streamed copy is behind this event; the step waits on it
            # before it reads the host buffer.
            self._stream_token = self._offload.streamed_token()
        if breakdown:
            self.timers("backward_inner").stop()
            self.timers("backward").stop()
            self.timers("backward_microstep").stop()
        return loss

    # ----------------------------------------------------- ZeRO-Offload tier

    def _sharded_offload(self):
        """ZeRO-Offload over several data ranks: each keeps its partition."""
        return self._offload_mode() and self.zero_optimization() and \
            self.dp_world_size > 1

    def _init_offload(self):
        """Build the host state (``runtime/zero/offload.py``): the fp32
        master, m and v in host memory (over several data ranks, this
        rank's ZeRO partition of them), per-parameter views of the moments
        as ``opt_state``, the device parameters in the compute dtype."""
        if self._offload is not None:
            self._offload.close()
        if self._sharded_offload():
            skip = self._tp.dims if self._tp is not None else \
                [None] * len(self._params)
            dims = [mesh_lib.zero_partition_dim(p.shape, self.dp_world_size,
                                                d)
                    for p, d in zip(self._params, skip)]
            self._offload = ShardedHostOffload(
                self._names, self._params, self.compute_dtype, dims,
                self.dp_group, self._config.zero_config.reduce_bucket_size,
                seq_group=self.sp_group if self._sp is not None else None)
        else:
            self._offload = HostOffload(self._names, self._params,
                                        self.compute_dtype)
        self._offload.drop_device_params()
        self.opt_state = {"step": 0,
                          "exp_avg": self._offload.views(self._offload.m),
                          "exp_avg_sq": self._offload.views(self._offload.v)}
        if self._stream_grads_active():
            self._register_stream_hooks()

    def _register_stream_hooks(self):
        """One post-accumulate hook per parameter: stream its gradient to
        the host and free it (JAX ``_stream_sink`` under io_callback)."""
        if getattr(self, "_stream_hooks", None):
            return
        ref = weakref.ref(self)

        def make(i):
            def hook(p):
                eng = ref()
                if eng is None or eng._streamed is None:
                    return
                eng._streamed[i] = eng._offload.stream_sink(i, p.grad)
                p.grad = None
            return hook

        self._stream_hooks = [p.register_post_accumulate_grad_hook(make(i))
                              for i, p in enumerate(self._params)]

    def _begin_streaming(self):
        if self._offload is None:
            self._init_offload()
        self._offload.begin_streamed_backward()
        self._streamed = [None] * len(self._params)
        self._stream_token = None

    def _streamed_sq(self):
        """The streamed backward's per-parameter squared norms (device
        fp32); a parameter that got no gradient streams zeros."""
        for i, sq in enumerate(self._streamed):
            if sq is None:
                self._offload.zero_span(i)
                self._streamed[i] = torch.zeros(
                    (), dtype=torch.float32, device=self.device)
        return torch.stack(self._streamed)

    def _offload_step(self, grads, inv_scale, lr):
        """The host step: unscale and global-norm clip on the card (JAX
        ``_get_offload_pre_fn``), then the pipelined host step. Streamed:
        the same factor from the squared norms, applied on the host."""
        clip = self.gradient_clipping()
        if grads is None:  # streamed
            total_sq = float(self._streamed_sq().double().sum())
            host_scale = float(inv_scale)
            if clip > 0.0:
                norm = total_sq ** 0.5 * float(inv_scale)
                host_scale *= min(clip / (norm + 1e-6), 1.0)
            self._offload.step(self.optimizer, lr, host_scale=host_scale,
                               token=self._stream_token)
        else:
            if self._offload is None:
                self._init_offload()
            scale = None
            if clip > 0.0:
                # Over ranks each holds shards: the norm over their groups.
                norm = self._global_norm(grads) if self.mesh.size > 1 \
                    else global_norm(grads)
                scale = inv_scale * torch.clamp(
                    clip / (norm * inv_scale + 1e-6), max=1.0)
            elif inv_scale != 1.0:
                scale = torch.tensor(inv_scale, dtype=torch.float32,
                                     device=self.device)
            self._offload.step(self.optimizer, lr, grads=grads, scale=scale)
        self.opt_state["step"] = self._offload.step_count

    def _offload_restore_params(self):
        """Device parameters again from the host master (after a skipped
        streamed step, as the JAX engine must)."""
        self._offload.restore_params()

    # --------------------------------------------------------------- step

    def is_gradient_accumulation_boundary(self):
        return (self.micro_steps + 1) % \
            self.gradient_accumulation_steps() == 0

    def zero_grad(self):
        for p in self._params:
            p.grad = None
        if self._zero is not None:
            self._zero.clear_grads()

    def get_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def set_lr(self, lr):
        for g in self.optimizer.param_groups:
            g["lr"] = lr

    def get_mom(self):
        return [g.get("betas", (0.0, 0.0))[0]
                for g in self.optimizer.param_groups]

    # ------------------------------------------- data-parallel reduction

    def _agreed(self, flag):
        """``flag`` (a 0-d bool tensor) OR-ed over the data group, or over
        the whole world when the grid has model or pipe ranks."""
        if self.mesh.size <= 1:
            return bool(flag)
        group = self.dp_group if self.mesh.size == self.dp_world_size \
            else None
        t = flag.reshape(1).to(torch.int32)
        return int(comm.all_reduce(t, group)) > 0

    @torch.no_grad()
    def allreduce_gradients(self, bucket_size=MEMORY_OPT_ALLREDUCE_SIZE):
        """Average every ``.grad`` over the data group (stage 0 / ZeRO off,
        at the accumulation boundary), under sequence parallelism over the
        seq line first: dense leaves in flat buckets of ``bucket_size``
        elements, embedding tables under ``sparse_gradients`` through the
        (row, value) exchange."""
        if self.dp_world_size <= 1 and self._sp is None:
            return
        for p in self._params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        dense = [p for i, p in enumerate(self._params)
                 if i not in self._sparse]
        for start, end in comm.buckets([p.numel() for p in dense],
                                       bucket_size):
            chunk = dense[start:end]
            flat = torch.cat([p.grad.reshape(-1).float() for p in chunk])
            if self._sp is not None:
                comm.all_reduce(flat, self.sp_group, mean=True)
            if self.dp_world_size > 1:
                comm.all_reduce(flat, self.dp_group, mean=True)
            off = 0
            for p in chunk:
                p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
                off += p.numel()
        for i in sorted(self._sparse):
            p = self._params[i]
            p.grad = sparse_grad_exchange(p.grad, self.dp_group,
                                          self._sparse_k)
        self._sparse_k = 0

    def csr_allreduce_no_retain(self, csr_list):
        """Average a list of CSRTensors over the data group: each rank's
        (index, value) rows padded to the group's largest count and
        all-gathered (duplicates kept; ``to_dense`` sums them). At one rank,
        copies."""
        out = []
        for c in csr_list:
            if self.dp_world_size <= 1:
                out.append(CSRTensor(indices=c.indices, values=c.values,
                                     dense_size=c.dense_size))
                continue
            rows = torch.tensor([c.indices.shape[0]], dtype=torch.int64,
                                device=c.values.device)
            rows = int(max(comm.all_gather(rows, self.dp_group)))
            idx, val = pad_csr(c.indices, c.values, rows)
            idx, val = csr_allreduce(idx, val, self.dp_group, average=True)
            out.append(CSRTensor(indices=idx, values=val,
                                 dense_size=c.dense_size))
        return out

    def sparse_allreduce_bucket(self, bucket):
        return self.csr_allreduce_no_retain(bucket)

    def _global_norm(self, grads, skip=()):
        """The global 2-norm of ``grads`` (this rank's: ZeRO shards,
        tensor-parallel shards or whole leaves): the squares of a leaf
        partitioned over the data group summed over it, of a leaf sharded
        over the model group summed over that, each replicated leaf
        counted once; over the pipe group the stages' sums (``skip``: the
        leaves another stage counts)."""
        dims = self._dp_dims()
        buckets = [[], [], [], []]  # none, data, model, both
        for i, g in enumerate(grads):
            if i in skip:
                continue
            k = (1 if dims is not None and dims[i] is not None else 0) + \
                (2 if self._tp is not None and self._tp.sharded(i) else 0)
            buckets[k].append(g)
        sq = [global_norm(b).to(self.device).square() for b in buckets]
        if dims is not None:
            t = comm.all_reduce(torch.stack([sq[1], sq[3]]), self.dp_group)
            sq[1], sq[3] = t[0], t[1]
        if self._tp is not None:
            t = comm.all_reduce(torch.stack([sq[2], sq[3]]), self.mp_group)
            sq[2], sq[3] = t[0], t[1]
        total = sq[0] + sq[1] + sq[2] + sq[3]
        if self.pp_group is not None:
            total = comm.all_reduce(total.reshape(1), self.pp_group)[0]
        return total.sqrt()

    def _dp_dims(self):
        """Per leaf, the dim the data group partitions this rank's
        gradients on (None: whole), or None without a partition."""
        if self._zero is not None:
            return self._zero.dims
        if isinstance(self._offload, ShardedHostOffload):
            return self._offload.dims
        return None

    def _update_dims(self):
        """``_dp_dims`` of the tensors the optimizer updates."""
        return self._dp_dims()

    def _lamb_norm_reduce(self, sq):
        """LAMB's per-tensor [||p||^2, ||u||^2] (``sq``, [n, 2], this rank's
        shards) of the whole tensors: one all-reduce over the data group of
        the rows of the leaves it partitions, one over the model group of
        those tensor parallelism shards."""
        dims = self._update_dims()
        masks = []
        if dims is not None:
            masks.append(([d is not None for d in dims], self.dp_group))
        if self._tp is not None:
            masks.append(([self._tp.sharded(i) for i in range(len(sq))],
                          self.mp_group))
        for mask, group in masks:
            if not any(mask):
                continue
            keep = torch.tensor(mask, device=sq.device)[:, None]
            part = comm.all_reduce(torch.where(keep, sq, 0.0), group)
            sq = torch.where(keep, part, sq)
        return sq

    def _reduce_partitioned(self):
        """The boundary's reduction of the partitioned gradients: the
        sparse tables' exchange, and at stage 1 the all-reduce of the
        accumulated gradients (stages 2-3 reduced them in the backward).
        Returns the rank's gradient shards."""
        z = self._zero
        for i in sorted(self._sparse):
            z.set_reduced(i, sparse_grad_exchange(
                z.take_sparse(i), self.dp_group, self._sparse_k))
        self._sparse_k = 0
        if z.stage == 1:
            z.reduce_all()
        return z.grad_shards()

    def _pg_correctness_check(self, grads, scale):
        """``pg_correctness_test``: the reduced gradients (each rank's
        shards, or whole) against an fp32 program over the global batch
        (every rank's recorded micro-batches, concatenated in rank order)
        with unpartitioned parameters; raises RuntimeError on a mismatch.
        Skipped on an fp16 overflow step (its gradients are non-finite by
        design)."""
        if self._tp is not None:
            raise NotImplementedError("pg_correctness_test under tensor "
                                      "parallelism is not ported")
        records, self._pg_inputs = self._pg_inputs, []
        if self.loss_scaler is not None and \
                self._agreed(has_overflow(grads)):
            return
        every = comm.all_gather_object(records, self.dp_group) \
            if self.dp_world_size > 1 else [records]
        fulls = self._zero.full_masters() if self._zero is not None else \
            [p.detach().float() for p in self._params]
        ref = {n: f.detach().clone().requires_grad_(True)
               for n, f in zip(self._names, fulls)}
        gas = self.gradient_accumulation_steps()
        if self._zero is not None:
            self._zero.suspended = True
        if self._sp is not None:
            # The reference runs serially over the full sequences.
            self.module.set_sequence_parallel(None)
        try:
            with torch.enable_grad():
                for step in range(len(records)):
                    args = tuple(torch.cat([r[step][j] for r in every]).to(
                        self.device) for j in range(len(records[step])))
                    kwargs = {"deterministic": True} \
                        if self._takes_deterministic else {}
                    out = torch.func.functional_call(self.module, ref, args,
                                                     kwargs)
                    loss = out[0] if isinstance(out, tuple) else out
                    (loss * (scale / gas)).backward()
        finally:
            if self._zero is not None:
                self._zero.suspended = False
            if self._sp is not None:
                self.module.set_sequence_parallel(self._sp)
        tol = 1e-4 if self.compute_dtype == torch.float32 else 2e-2
        for i, (name, g) in enumerate(zip(self._names, grads)):
            want = ref[name].grad
            want = torch.zeros_like(fulls[i]) if want is None else want
            if tuple(g.shape) != tuple(want.shape):
                want = mesh_lib.shard_slice(want, self._zero.dims[i],
                                            self._zero.rank, self._zero.dp)
            a = g.detach().float().cpu().numpy()
            b = want.detach().float().cpu().numpy()
            if not np.allclose(a, b, rtol=tol, atol=tol):
                raise RuntimeError(
                    "pg_correctness_test: reduced gradient for {} diverges "
                    "from the fp32 replicated reference (max abs diff "
                    "{})".format(name, np.abs(a - b).max()))

    @torch.no_grad()
    def _update(self, grads, inv_scale, skip=()):
        """Unscale and clip ``grads`` (this rank's shards or whole leaves;
        ``skip`` as for ``_global_norm``), then the optimizer's update: of
        the rank's master shards, published, under ZeRO; of the parameters
        otherwise."""
        if inv_scale != 1.0:
            torch._foreach_mul_(grads, inv_scale)
        clip = self.gradient_clipping()
        if self._onebit_compressed():
            # The compressed phase works on unclipped local gradients.
            self._warn_onebit_clip_once(clip)
            clip = 0.0
        if clip > 0.0:
            norm = self._global_norm(grads, skip)
            torch._foreach_mul_(grads, torch.clamp(clip / (norm + 1e-6),
                                                   max=1.0))
        group = self.optimizer.param_groups[0]
        params, grads = self._step_params(grads)
        self.optimizer.update(params, grads, self.opt_state, lr=group["lr"],
                              betas=group.get("betas", (0.9, 0.999)))
        self._publish()

    def _step_params(self, grads):
        """The tensors the optimizer updates and their gradients: the
        rank's master shards under ZeRO, else the parameters."""
        return (self._zero.master if self._zero is not None else
                self._params), grads

    def _publish(self):
        """The module's parameters from what the update wrote."""
        if self._zero is not None:
            self._zero.publish()

    @torch.no_grad()
    def _take_model_step(self, lr_kwargs=None):
        streamed = self._streamed is not None
        grads = None
        if self._zero is not None:
            grads = self._reduce_partitioned()
        elif not streamed and self._sharded_offload():
            # The data group's mean (the seq line's first), reduce-scattered
            # to this rank's partition (the host state's).
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
            self.zero_grad()
            if self._offload is None:
                self._init_offload()
            grads = self._offload.reduce(grads)
        elif not streamed:
            if not self._onebit_compressed():
                self.allreduce_gradients()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
        overflow = False
        cur_scale = 1.0
        if self.loss_scaler is not None:
            cur_scale = self.loss_scaler.loss_scale
        if pg_correctness_test and grads is not None:
            self._pg_correctness_check(grads, cur_scale)
        if self.loss_scaler is not None:
            if streamed:
                # inf/nan in any gradient reaches its squared norm.
                overflow = not bool(torch.isfinite(
                    self._streamed_sq().sum()))
            else:
                # Agreed over the group: every rank skips the same step.
                overflow = self._agreed(has_overflow(grads))
            self.loss_scaler.update_scale(overflow)
        if overflow:
            self.skipped_steps += 1
            if streamed:
                self._offload_restore_params()
            logger.info("OVERFLOW! Skipping step. Attempted loss scale: {}, "
                        "reducing to {}".format(cur_scale,
                                                self.loss_scaler.loss_scale))
        else:
            if self._offload_mode():
                # The gradients leave .grad: the host step consumes them.
                self.zero_grad()
                self._offload_step(grads, 1.0 / cur_scale,
                                   self.optimizer.param_groups[0]["lr"])
            else:
                self._update(grads, 1.0 / cur_scale)
            if self.lr_scheduler is not None:
                self.lr_scheduler.step(**(lr_kwargs or {}))
            if self.global_rank == 0 and \
                    (self.global_steps + 1) % self.steps_per_print() == 0:
                self._report_progress(self.global_steps + 1)
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._notify_optimizer()
        self.zero_grad()
        self._streamed = None
        self._stream_token = None
        self._tensorboard_step_events()

    def _notify_optimizer(self):
        """1-bit Adam's freeze bookkeeping, by the updates applied (an fp16
        overflow skip does not count)."""
        if hasattr(self.optimizer, "notify_step"):
            self.optimizer.notify_step(self.global_steps - self.skipped_steps)

    def step(self, lr_kwargs=None):
        """The weight update, at gradient-accumulation boundaries."""
        if self.optimizer is None:
            raise RuntimeError("must provide an optimizer during init in "
                               "order to use step")
        breakdown = self.wall_clock_breakdown()
        if breakdown:
            self.timers("step_microstep").start()
            self.timers("step").start()
        boundary = self.is_gradient_accumulation_boundary()
        if boundary:
            if self.progressive_layer_drop is not None:
                self.progressive_layer_drop.update_state(self.global_steps)
            self._take_model_step(lr_kwargs)
        self.tput_timer.stop()
        if breakdown:
            self.timers("step").stop()
            self.timers("step_microstep").stop()
            if boundary and self.global_steps % self.steps_per_print() == 0:
                self.timers.log(["forward_microstep", "backward_microstep",
                                 "step_microstep"],
                                memory_breakdown=self.memory_breakdown())
        self.micro_steps += 1

    def train_batch(self, batch=None, data_iter=None):
        """forward, backward and step on one micro-batch (a tuple of inputs
        or one input). Returns the loss, detached."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or a data_iter")
            batch = next(data_iter)
        args = tuple(batch) if isinstance(batch, (tuple, list)) \
            else (batch,)
        self.xray.stash("train_step", None, *args)

        def run():
            loss = self.forward(*args)
            self.backward(loss)
            self.step()
            return loss

        loss = self.xray.measure("train_step", run)
        self.xray.note("train_step", tokens=self.train_batch_size())
        loss = loss.detach()
        if self.dp_world_size > 1:
            # The data group's mean (the JAX step's pmean).
            loss = comm.all_reduce(loss.float().clone(), self.dp_group,
                                   mean=True)
        return loss

    def perf_xray(self):
        """The schema-versioned ``perf_xray`` section of the training
        side: one record per batch signature ``train_batch`` met, with its
        measured flops and bytes (``telemetry/xray.py``)."""
        return self.xray.to_json()

    # --------------------------------------------------------- checkpoint

    def _get_ckpt_name(self, checkpoints_path, tag):
        return os.path.join(checkpoints_path, str(tag),
                            "mp_rank_00_model_states.pt")

    def _get_zero_ckpt_name(self, checkpoints_path, tag, dp_rank=0):
        return os.path.join(checkpoints_path, str(tag),
                            "zero_pp_rank_{}_mp_rank_00optim_states.pt"
                            .format(dp_rank))

    def _state_shards(self, state):
        """This rank's elastic shard tree of the partitioned optimizer
        state (the JAX ``_partition_state_for_rank`` layout): ("shard", dim,
        array) for a partitioned leaf, ("full", array) for a replicated one
        and the step in rank 0's file, ("ref",) in the others'."""
        z = self._zero
        first = self.dp_rank == 0

        def leaves(tensors):
            tree = {}
            for i, (name, t) in enumerate(zip(self._names, tensors)):
                node = tree
                *path, leaf = name.split(".")
                for key in path:
                    node = node.setdefault(key, {})
                arr = t.detach().float().cpu().numpy()
                node[leaf] = ("shard", z.dims[i], arr) if z.owned(i) else \
                    (("full", arr) if first else ("ref",))
            return tree

        return {"step": ("full", np.asarray(state["step"], np.int32))
                if first else ("ref",),
                "exp_avg": leaves(state["exp_avg"]),
                "exp_avg_sq": leaves(state["exp_avg_sq"])}

    def _load_zero_state(self, load_dir, tag):
        """The optimizer state dict of the zero file(s), the full logical
        state: an elastic checkpoint's shard files are all read and merged
        (the JAX ``_load_zero_state``), whatever data-parallel size saved
        them. None without a zero file."""
        zero_path = self._get_zero_ckpt_name(load_dir, tag)
        if not os.path.exists(zero_path):
            return None
        with open(zero_path, "rb") as f:
            head = pickle.load(f)
        if "state_shards" not in head:
            return head["optimizer_state_dict"]
        saved_world = head["zero_dp_world_size"]
        shard_trees = [head["state_shards"]]
        for r in range(1, saved_world):
            path_r = self._get_zero_ckpt_name(load_dir, tag, dp_rank=r)
            if not os.path.exists(path_r):
                raise FileNotFoundError(
                    "elastic zero checkpoint saved at dp={} is missing shard "
                    "file {}".format(saved_world, path_r))
            with open(path_r, "rb") as f:
                shard_trees.append(pickle.load(f)["state_shards"])
        opt_sd = dict(head["optimizer_state_dict"])
        opt_sd["state"] = _merge_state_shards(shard_trees)
        if saved_world != self.dp_world_size:
            logger.info("elastic zero checkpoint: re-partitioning optimizer "
                        "state saved at dp=%d onto dp=%d", saved_world,
                        self.dp_world_size)
        return opt_sd

    def _full(self, tensors, partitioned=True):
        """Full fp32 leaves from this rank's ``tensors`` (one per
        parameter): gathered over the data group where ZeRO (or the offload
        tier) partitions them (``partitioned``: they are this rank's
        partition), then over the model group where tensor parallelism
        shards them (collective: every rank calls it)."""
        if self._zero is not None and partitioned:
            tensors = self._zero.gather_states(tensors)
        elif isinstance(self._offload, ShardedHostOffload) and partitioned:
            tensors = self._offload.gather(tensors)
        tensors = [t.detach().float() for t in tensors]
        if self._tp is not None:
            tensors = [self._tp.full(i, t) for i, t in enumerate(tensors)]
        return tensors

    def _full_masters(self):
        """Every leaf's full fp32 master (collective)."""
        if self._zero is not None:
            return self._full(self._zero.master)
        return self._full(self._params, partitioned=False)

    def _local(self, i, full):
        """This rank's leaf ``i`` (its tensor-parallel shard, then its ZeRO
        shard) of a full saved leaf."""
        if self._tp is not None:
            full = self._tp.local(i, full)
        if self._zero is not None:
            return self._zero.shard_of(i, full)
        if isinstance(self._offload, ShardedHostOffload):
            return self._offload.shard(i, full)
        return full

    def _onebit_error_rows(self):
        """1-bit Adam's error buffers in the JAX layout, {key: per leaf}: on
        the compressed path every rank's row gathered into ``[W, ...]``
        (collective), else the rank's own buffers; None without them."""
        if self.opt_state is None or "worker_error" not in self.opt_state:
            return None
        out = {}
        for key in ("worker_error", "server_error"):
            bufs = self.opt_state[key]
            if not self._onebit_eligible():
                out[key] = bufs
                continue
            sizes = [b.numel() for b in bufs]
            every = comm.all_gather(torch.cat(bufs), self.dp_group).view(
                self.dp_world_size, -1)
            out[key] = [part for part in torch.split(every, sizes, dim=1)]
        return out

    def _optimizer_state_for_save(self, shards=False, onebit_rows=None):
        """{"state": step and moments as flax trees of numpy arrays (None
        before an offload step built them), the optimizer's param_groups,
        and under offload "fp32_master", the flat host master in JAX's
        leaf order}. Partitioned: with ``shards`` the state is this rank's
        elastic shard tree (``_state_shards``); without, the moments are
        all-gathered whole (every rank must call it)."""
        sd = {"state": None}
        if self.opt_state is not None and shards:
            sd["state"] = self._state_shards(self.opt_state)
        elif self.opt_state is not None:
            sd["state"] = {
                "step": np.asarray(self.opt_state["step"], np.int32),
                "exp_avg": _nest(self._names,
                                 self._full(self.opt_state["exp_avg"])),
                "exp_avg_sq": _nest(self._names,
                                    self._full(self.opt_state["exp_avg_sq"]))}
            for key, rows in (onebit_rows or {}).items():
                sd["state"][key] = _nest(self._names, rows)
        if self._offload is not None:
            # Resuming keeps full master precision (the bf16 module
            # parameters would drift the trajectory): the full array in
            # JAX's leaf order, gathered over the ranks that hold shards.
            master = self._offload.master
            if self.mesh.size > 1:
                master = join_jax_flat(self._names, self._full(
                    self._offload.views(master)))
            sd["fp32_master"] = master.numpy().copy()
        sd.update(self.optimizer.state_dict())
        return sd

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write ``<save_dir>/<tag>/mp_rank_00_model_states.pt`` (a pickle of
        numpy arrays under the flax names, as the JAX package writes it) and
        the ``latest`` file."""
        if tag is None:
            tag = "global_step{}".format(self.global_steps)
        save_path = self._get_ckpt_name(save_dir, tag)
        ensure_directory_exists(save_path)
        self._ensure_zero()
        # Rank 0 of the data, model and seq lines writes the shared files.
        first = self.dp_rank == 0 and self.mp_rank == 0 and self.sp_rank == 0
        zero = self.zero_optimization()
        # Elastic per-rank files at mp 1; over a model axis the zero file
        # holds the full state.
        elastic = self._zero is not None and self.zero_elastic_checkpoint() \
            and self._tp is None
        onebit_rows = self._onebit_error_rows()  # collective
        optimizer = None
        if self.optimizer is not None and (first or elastic):
            optimizer = self._optimizer_state_for_save(
                shards=elastic, onebit_rows=onebit_rows)
        elif (self._zero is not None or self._tp is not None or
              isinstance(self._offload, ShardedHostOffload)) and \
                self.optimizer is not None:
            self._optimizer_state_for_save(shards=False)  # collective
        # The full fp32 masters (all-gathers when partitioned or sharded).
        module = _nest(self._names, self._full_masters())
        if first:
            state = {
                "module": module,
                "optimizer": None if zero else optimizer,
                "lr_scheduler": self.lr_scheduler.state_dict()
                if self.lr_scheduler is not None else None,
                "csr_tensor_module_names": [],
                "skipped_steps": self.skipped_steps,
                "global_steps": self.global_steps,
                "global_samples": self.global_samples,
                "dp_world_size": self.dp_world_size,
                "mp_world_size": self.mp_world_size,
                "loss_scaler": self.loss_scaler.__dict__.copy()
                if self.loss_scaler is not None else None,
            }
            if client_state is not None:
                state.update(client_state)
            with open(save_path, "wb") as f:
                pickle.dump(state, f)
        if zero and elastic and self.sp_rank == 0:
            # One file per data rank, each written by its rank.
            shards = optimizer.pop("state")
            with open(self._get_zero_ckpt_name(save_dir, tag, self.dp_rank),
                      "wb") as f:
                pickle.dump({"optimizer_state_dict": optimizer,
                             "state_shards": shards,
                             "zero_dp_world_size": self.dp_world_size}, f)
        elif zero and first:
            with open(self._get_zero_ckpt_name(save_dir, tag), "wb") as f:
                pickle.dump({"optimizer_state_dict": optimizer}, f)
        if save_latest and first:
            with open(os.path.join(save_dir, "latest"), "w") as fd:
                fd.write(str(tag))
        if self.mesh.size > 1:
            torch.distributed.barrier()
        return True

    @torch.no_grad()
    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Load a checkpoint written by either package. Returns (load path,
        client state), or (None, None) when there is none. The file is a
        pickle: load only checkpoints this program or the JAX package
        wrote."""
        if tag is None:
            latest_path = os.path.join(load_dir, "latest")
            if not os.path.isfile(latest_path):
                logger.warning("Unable to find latest file at %s",
                               latest_path)
                return None, None
            with open(latest_path, "r") as fd:
                tag = fd.read().strip()
        load_path = self._get_ckpt_name(load_dir, tag)
        if not os.path.exists(load_path):
            logger.warning("checkpoint %s does not exist", load_path)
            return None, None
        with open(load_path, "rb") as f:
            checkpoint = pickle.load(f)

        self._ensure_zero()
        if self._zero is not None:
            fulls = [_host_leaf(checkpoint["module"], n) for n in self._names]
            if self._tp is not None:
                fulls = [self._tp.local(i, f) for i, f in enumerate(fulls)]
            self._zero.load_full(fulls)
        elif self._tp is not None:
            for i, (n, p) in enumerate(zip(self._names, self._params)):
                p.data.copy_(self._tp.local(
                    i, _host_leaf(checkpoint["module"], n)))
        else:
            load_flax_tree(self.module, checkpoint["module"])
        if self._offload_mode():
            self._init_offload()
        opt_sd = checkpoint.get("optimizer")
        if self.zero_optimization():
            opt_sd = self._load_zero_state(load_dir, tag) or opt_sd
        if load_optimizer_states and self.optimizer is not None and \
                opt_sd is not None and opt_sd.get("state") is not None:
            saved = opt_sd["state"]
            if self._offload is not None:
                self._load_offload_state(saved, opt_sd.get("fp32_master"),
                                         checkpoint["module"])
            elif self._zero is not None or self._tp is not None:
                # The full logical state, sliced to this rank's shards.
                for key in ("exp_avg", "exp_avg_sq"):
                    for i, (name, t) in enumerate(zip(self._names,
                                                      self.opt_state[key])):
                        t.copy_(self._local(i, _host_leaf(saved[key], name)))
            else:
                for key in ("exp_avg", "exp_avg_sq"):
                    for name, t in zip(self._names, self.opt_state[key]):
                        t.copy_(_host_leaf(saved[key], name))
            self._load_onebit_errors(saved)
            self.opt_state["step"] = int(np.asarray(saved["step"]))
            self.optimizer.load_state_dict(opt_sd)
        if load_lr_scheduler_states and self.lr_scheduler is not None and \
                checkpoint.get("lr_scheduler") is not None:
            self.lr_scheduler.load_state_dict(checkpoint["lr_scheduler"])
        if self.loss_scaler is not None and checkpoint.get("loss_scaler"):
            self.loss_scaler.__dict__.update(checkpoint["loss_scaler"])
        self.global_steps = checkpoint.get("global_steps", 0)
        self.global_samples = checkpoint.get(
            "global_samples", self.global_steps * self.train_batch_size())
        self.skipped_steps = checkpoint.get("skipped_steps", 0)
        self.micro_steps = \
            self.global_steps * self.gradient_accumulation_steps()
        # A resume past the freeze compresses from its first step.
        self._notify_optimizer()
        client_state = {k: v for k, v in checkpoint.items()
                        if k not in _DEEPSPEED_STATES}
        return load_path, client_state

    def _load_offload_state(self, saved, master, module):
        """The host state from a saved optimizer state: the moments and the
        flat ``fp32_master`` (JAX's leaf order, full leaves), each leaf cut
        to this rank's shard."""
        def local(leaves):
            return [self._local(i, f).contiguous()
                    for i, f in enumerate(leaves)]

        masters = None
        if master is not None:
            shapes = [_leaf(module, n).shape for n in self._names]
            masters = local(split_jax_flat(torch.from_numpy(
                np.asarray(master, np.float32)), self._names, shapes))
        self._offload.load_moments(
            local([_host_leaf(saved["exp_avg"], n) for n in self._names]),
            local([_host_leaf(saved["exp_avg_sq"], n) for n in self._names]),
            masters)
        self._offload.step_count = int(np.asarray(saved["step"]))

    def _load_onebit_errors(self, saved):
        """1-bit Adam's error buffers from a saved state of either package:
        this rank's row of a ``[W, ...]`` leaf on the compressed path (row 0
        elsewhere, the JAX package's degenerate path), a 1-D leaf as it
        is."""
        if "worker_error" not in self.opt_state or \
                "worker_error" not in saved:
            return
        row = self.dp_rank if self._onebit_eligible() else 0
        for key in ("worker_error", "server_error"):
            for name, t in zip(self._names, self.opt_state[key]):
                leaf = _host_leaf(saved[key], name)
                if leaf.dim() == 2:
                    leaf = leaf[row]
                t.copy_(leaf.view_as(t))


def _fold_seed(seed, rank):
    """A seed for data rank ``rank`` derived from ``seed`` (distinct per
    rank, the same on every run)."""
    return (seed * 0x9E3779B1 + 0x85EBCA6B * (rank + 1)) % (2 ** 63)


def _merge_state_shards(shard_trees):
    """The full logical state from every saved rank's shard tree (the JAX
    ``_merge_state_shards``): a replicated leaf from rank 0's ("full", ...)
    entry, a partitioned one concatenated along its dim."""
    first = shard_trees[0]
    if isinstance(first, dict):
        return {k: _merge_state_shards([t[k] for t in shard_trees])
                for k in first}
    if first[0] in ("full", "ref"):
        return next(e for e in shard_trees if e[0] == "full")[1]
    return np.concatenate([e[2] for e in shard_trees], axis=first[1])
