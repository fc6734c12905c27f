"""DeepSpeedConfig: parse a ds_config (JSON file or dict).

Counterpart of ``deepspeed_tpu/runtime/config.py`` for the training path:
the batch triangle (any two of train_batch_size /
train_micro_batch_size_per_gpu / gradient_accumulation_steps imply the
third), ``optimizer``, ``scheduler``, ``fp16`` (with the dynamic loss-scale
arguments), ``bf16``, ``gradient_clipping``, ``steps_per_print``, the
timers and telemetry (``wall_clock_breakdown``, ``memory_breakdown``, the
``tensorboard`` block) and the checkpoint tag validation mode. Every
scalar is one row of ``_SCHEMA``, read by one reader, as in the JAX
package.

A ds_config written for the JAX package parses unchanged. A key that
switches on a subsystem the port does not have yet parses only at its
default (``_check_ported``); any other value raises NotImplementedError
naming the ROADMAP item that brings it, never a quiet run without it.

ZeRO (``zero_optimization``: every stage the JAX config accepts) holds
the JAX package's checks (ZeRO needs fp16 or bf16, stage at most 3,
cpu_offload only at stage 2). ``world_size`` is the data-parallel size:
the batch triangle is train = micro x accumulation x world_size. Over
several ranks ``stream_gradients`` is refused, with the JAX engine's
reason; ``cpu_offload`` is taken.

``amp`` (``amp_enabled``, ``amp_params``: the block without ``enabled``)
parses as in the JAX config; the engine maps it to bf16 compute on fp32
masters (``opt_level`` O0: fp32).

``OneBitAdam`` (the optimizer type), ``sequence_parallel`` (``enabled``,
``size``), ``progressive_layer_drop`` (``enabled``, ``theta``, ``gamma``:
``pld_params``) and ``activation_checkpointing``
(``activation_checkpointing_config``) parse as in the JAX config.

The ``pipeline`` block: ``stages`` and ``activation_checkpoint_interval``
are read (``self.pipeline``) and honoured by the pipeline engine
(``runtime/pipe/engine.py``); ``partition`` and ``seed_layers`` belong to
the ``PipelineModule`` and parse only at their defaults.

``flops_profiler`` (``flops_profiler_config``: ``enabled``, ``start_step``,
``end_step``, ``module_depth``, ``top_modules``) parses as in the JAX
config; the engine runs ``profiling.flops_profiler.FlopsProfiler`` over
the steps it names.

``elasticity`` (``enabled: true``) overwrites the batch triangle with the
elastic schedule for this world size before it is parsed, as the JAX
config's ``_apply_elasticity`` does.
"""

import json

from deepspeed_tpu_torch.runtime.activation_checkpointing.config import (
    DeepSpeedActivationCheckpointingConfig)
from deepspeed_tpu_torch.elasticity import (ElasticityConfigError,
                                            compute_elastic_config,
                                            elasticity_enabled,
                                            ensure_immutable_elastic_config)
from deepspeed_tpu_torch.elasticity.constants import (
    ELASTICITY, IGNORE_NON_ELASTIC_BATCH_INFO,
    IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)
from deepspeed_tpu_torch.runtime.config_utils import (
    dict_raise_error_on_duplicate_keys, get_scalar_param)
from deepspeed_tpu_torch.runtime.constants import (
    AMP, AMP_ENABLED, AMP_ENABLED_DEFAULT, BFLOAT16, BFLOAT16_ENABLED, BFLOAT16_ENABLED_DEFAULT, CHECKPOINT,
    CHECKPOINT_TAG_VALIDATION, CHECKPOINT_TAG_VALIDATION_DEFAULT,
    CHECKPOINT_TAG_VALIDATION_MODES, FP16, FP16_ENABLED, FP16_ENABLED_DEFAULT,
    FP16_HYSTERESIS, FP16_HYSTERESIS_DEFAULT, FP16_INITIAL_SCALE_POWER,
    FP16_INITIAL_SCALE_POWER_DEFAULT, FP16_LOSS_SCALE,
    FP16_LOSS_SCALE_DEFAULT, FP16_LOSS_SCALE_WINDOW,
    FP16_LOSS_SCALE_WINDOW_DEFAULT, FP16_MIN_LOSS_SCALE,
    FP16_MIN_LOSS_SCALE_DEFAULT, GRADIENT_ACCUMULATION_STEPS,
    GRADIENT_ACCUMULATION_STEPS_DEFAULT, GRADIENT_CLIPPING,
    GRADIENT_CLIPPING_DEFAULT, MAX_GRAD_NORM, OPTIMIZER, OPTIMIZER_PARAMS,
    OPTIMIZER_TYPE_DEFAULT, SCHEDULER, SCHEDULER_PARAMS,
    SCHEDULER_TYPE_DEFAULT, SPARSE_ATTENTION, SPARSE_ATTENTION_TYPE,
    SPARSE_ATTENTION_TYPE_DEFAULT, SPARSE_BIGBIRD_MODE, SPARSE_BLOCK,
    SPARSE_BLOCK_DEFAULT, SPARSE_BSLONGFORMER_MODE, SPARSE_DENSE_MODE,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT, SPARSE_FIXED_MODE,
    SPARSE_GLOBAL_BLOCK_END_INDICES, SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT,
    SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT, SPARSE_LOCAL_WINDOW_BLOCKS,
    SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT, SPARSE_MODE, SPARSE_MODE_DEFAULT,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT, SPARSE_NUM_GLOBAL_BLOCKS,
    SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT, SPARSE_NUM_LOCAL_BLOCKS,
    SPARSE_NUM_LOCAL_BLOCKS_DEFAULT, SPARSE_NUM_RANDOM_BLOCKS,
    SPARSE_NUM_RANDOM_BLOCKS_DEFAULT, SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
    SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT, SPARSE_VARIABLE_MODE,
    SPARSE_GRADIENTS, SPARSE_GRADIENTS_DEFAULT,
    MEMORY_BREAKDOWN, MEMORY_BREAKDOWN_DEFAULT, PLD_ENABLED,
    PLD_ENABLED_DEFAULT, PROGRESSIVE_LAYER_DROP, SEQUENCE_PARALLEL,
    SEQUENCE_PARALLEL_ENABLED, SEQUENCE_PARALLEL_ENABLED_DEFAULT,
    SEQUENCE_PARALLEL_SIZE, SEQUENCE_PARALLEL_SIZE_DEFAULT, STEPS_PER_PRINT,
    STEPS_PER_PRINT_DEFAULT, TENSORBOARD, TENSORBOARD_ENABLED,
    TENSORBOARD_ENABLED_DEFAULT, TENSORBOARD_JOB_NAME,
    TENSORBOARD_JOB_NAME_DEFAULT, TENSORBOARD_OUTPUT_PATH,
    TENSORBOARD_OUTPUT_PATH_DEFAULT, TRAIN_BATCH_SIZE,
    TRAIN_BATCH_SIZE_DEFAULT, WALL_CLOCK_BREAKDOWN,
    WALL_CLOCK_BREAKDOWN_DEFAULT,
    TRAIN_MICRO_BATCH_SIZE_PER_GPU, TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT,
    TYPE, ValidationMode)
from deepspeed_tpu_torch.profiling.config import DeepSpeedFlopsProfilerConfig
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig
from deepspeed_tpu_torch.utils.logging import logger
from deepspeed_tpu_torch.version import version as __version__
from deepspeed_tpu_torch.runtime.zero.constants import (
    MAX_STAGE_ZERO_OPTIMIZATION, ZERO_OPTIMIZATION_GRADIENTS)

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
DEEPSPEED_OPTIMIZERS = [ADAM_OPTIMIZER, ADAMW_OPTIMIZER, LAMB_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER]

_RUNTIME = "the remaining training runtime (ROADMAP Queue 1)"
# The JAX engine's reason for refusing stream_gradients on a mesh of more
# than one device.
STREAM_MULTI_RANK = ("stream_gradients targets single-chip offload "
                     "capacity; use plain cpu_offload on multi-device meshes")

def _read(param_dict, path, default):
    """Scalar at ``path`` (a key tuple into sub-dicts), or ``default`` when
    a level is absent. A level present but not an object raises (a typo
    like ``"fp16": true`` must not train without loss scaling)."""
    node = param_dict
    for key in path[:-1]:
        node = node.get(key)
        if node is None:
            return default
        if not isinstance(node, dict):
            raise TypeError("DeepSpeedConfig: expected '{}' to be a JSON "
                            "object, got {!r}".format(key, node))
    return get_scalar_param(node, path[-1], default)


# attr -> (path, default[, gate]): a gated key is read only when the attr
# it names (assigned above it) is truthy.
_SCHEMA = (
    ("train_batch_size", (TRAIN_BATCH_SIZE,), TRAIN_BATCH_SIZE_DEFAULT),
    ("train_micro_batch_size_per_gpu", (TRAIN_MICRO_BATCH_SIZE_PER_GPU,),
     TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT),
    ("gradient_accumulation_steps", (GRADIENT_ACCUMULATION_STEPS,),
     GRADIENT_ACCUMULATION_STEPS_DEFAULT),
    ("steps_per_print", (STEPS_PER_PRINT,), STEPS_PER_PRINT_DEFAULT),
    ("gradient_clipping", (GRADIENT_CLIPPING,), GRADIENT_CLIPPING_DEFAULT),
    ("sparse_gradients_enabled", (SPARSE_GRADIENTS,),
     SPARSE_GRADIENTS_DEFAULT),
    ("sequence_parallel_enabled", (SEQUENCE_PARALLEL,
     SEQUENCE_PARALLEL_ENABLED), SEQUENCE_PARALLEL_ENABLED_DEFAULT),
    ("sequence_parallel_size", (SEQUENCE_PARALLEL, SEQUENCE_PARALLEL_SIZE),
     SEQUENCE_PARALLEL_SIZE_DEFAULT),
    ("pld_enabled", (PROGRESSIVE_LAYER_DROP, PLD_ENABLED),
     PLD_ENABLED_DEFAULT),
    ("fp16_enabled", (FP16, FP16_ENABLED), FP16_ENABLED_DEFAULT),
    ("bfloat16_enabled", (BFLOAT16, BFLOAT16_ENABLED),
     BFLOAT16_ENABLED_DEFAULT),
    ("amp_enabled", (AMP, AMP_ENABLED), AMP_ENABLED_DEFAULT),
    ("loss_scale", (FP16, FP16_LOSS_SCALE), FP16_LOSS_SCALE_DEFAULT,
     "fp16_enabled"),
    ("wall_clock_breakdown", (WALL_CLOCK_BREAKDOWN,),
     WALL_CLOCK_BREAKDOWN_DEFAULT),
    ("memory_breakdown", (MEMORY_BREAKDOWN,), MEMORY_BREAKDOWN_DEFAULT),
    ("tensorboard_enabled", (TENSORBOARD, TENSORBOARD_ENABLED),
     TENSORBOARD_ENABLED_DEFAULT),
    ("tensorboard_output_path", (TENSORBOARD, TENSORBOARD_OUTPUT_PATH),
     TENSORBOARD_OUTPUT_PATH_DEFAULT, "tensorboard_enabled"),
    ("tensorboard_job_name", (TENSORBOARD, TENSORBOARD_JOB_NAME),
     TENSORBOARD_JOB_NAME_DEFAULT, "tensorboard_enabled"),
)

# fp16 sub-keys that, when any is present, become the dynamic loss
# scaler's arguments.
_DYNAMIC_SCALE_ARGS = (
    ("INITIAL_LOSS_SCALE", FP16_INITIAL_SCALE_POWER,
     FP16_INITIAL_SCALE_POWER_DEFAULT),
    ("SCALE_WINDOW", FP16_LOSS_SCALE_WINDOW, FP16_LOSS_SCALE_WINDOW_DEFAULT),
    ("DELAYED_SHIFT", FP16_HYSTERESIS, FP16_HYSTERESIS_DEFAULT),
    ("MIN_LOSS_SCALE", FP16_MIN_LOSS_SCALE, FP16_MIN_LOSS_SCALE_DEFAULT),
)

# Sparse-attention blocks: per sparsity mode, the keys that mode accepts
# (the JAX package's table). The parsed dict is {mode, **{key:
# value-or-default}}.
_SPARSE_MODE_KEYS = {
    SPARSE_DENSE_MODE: (SPARSE_BLOCK,),
    SPARSE_FIXED_MODE: (
        SPARSE_BLOCK, SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
        SPARSE_NUM_LOCAL_BLOCKS, SPARSE_NUM_GLOBAL_BLOCKS,
        SPARSE_ATTENTION_TYPE, SPARSE_HORIZONTAL_GLOBAL_ATTENTION,
        SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS),
    SPARSE_VARIABLE_MODE: (
        SPARSE_BLOCK, SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
        SPARSE_NUM_RANDOM_BLOCKS, SPARSE_LOCAL_WINDOW_BLOCKS,
        SPARSE_GLOBAL_BLOCK_INDICES, SPARSE_GLOBAL_BLOCK_END_INDICES,
        SPARSE_ATTENTION_TYPE, SPARSE_HORIZONTAL_GLOBAL_ATTENTION),
    SPARSE_BIGBIRD_MODE: (
        SPARSE_BLOCK, SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
        SPARSE_NUM_RANDOM_BLOCKS, SPARSE_NUM_SLIDING_WINDOW_BLOCKS,
        SPARSE_NUM_GLOBAL_BLOCKS),
    SPARSE_BSLONGFORMER_MODE: (
        SPARSE_BLOCK, SPARSE_DIFFERENT_LAYOUT_PER_HEAD,
        SPARSE_NUM_SLIDING_WINDOW_BLOCKS, SPARSE_GLOBAL_BLOCK_INDICES,
        SPARSE_GLOBAL_BLOCK_END_INDICES),
}

_SPARSE_KEY_DEFAULTS = {
    SPARSE_BLOCK: SPARSE_BLOCK_DEFAULT,
    SPARSE_DIFFERENT_LAYOUT_PER_HEAD: SPARSE_DIFFERENT_LAYOUT_PER_HEAD_DEFAULT,
    SPARSE_NUM_LOCAL_BLOCKS: SPARSE_NUM_LOCAL_BLOCKS_DEFAULT,
    SPARSE_NUM_GLOBAL_BLOCKS: SPARSE_NUM_GLOBAL_BLOCKS_DEFAULT,
    SPARSE_ATTENTION_TYPE: SPARSE_ATTENTION_TYPE_DEFAULT,
    SPARSE_HORIZONTAL_GLOBAL_ATTENTION:
        SPARSE_HORIZONTAL_GLOBAL_ATTENTION_DEFAULT,
    SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS:
        SPARSE_NUM_DIFFERENT_GLOBAL_PATTERNS_DEFAULT,
    SPARSE_NUM_RANDOM_BLOCKS: SPARSE_NUM_RANDOM_BLOCKS_DEFAULT,
    SPARSE_LOCAL_WINDOW_BLOCKS: SPARSE_LOCAL_WINDOW_BLOCKS_DEFAULT,
    SPARSE_GLOBAL_BLOCK_INDICES: SPARSE_GLOBAL_BLOCK_INDICES_DEFAULT,
    SPARSE_GLOBAL_BLOCK_END_INDICES: SPARSE_GLOBAL_BLOCK_END_INDICES_DEFAULT,
    SPARSE_NUM_SLIDING_WINDOW_BLOCKS:
        SPARSE_NUM_SLIDING_WINDOW_BLOCKS_DEFAULT,
}


def get_sequence_parallel_enabled(param_dict):
    """The engine reads this before the full parse (the mesh it builds
    decides the data-parallel size of the batch triangle)."""
    return _read(param_dict, (SEQUENCE_PARALLEL, SEQUENCE_PARALLEL_ENABLED),
                 SEQUENCE_PARALLEL_ENABLED_DEFAULT)


def get_sequence_parallel_size(param_dict):
    return _read(param_dict, (SEQUENCE_PARALLEL, SEQUENCE_PARALLEL_SIZE),
                 SEQUENCE_PARALLEL_SIZE_DEFAULT)


def _typed_block(param_dict, section, exclude):
    """A copy of ``param_dict[section]`` without ``exclude`` (the PLD
    constructor's arguments), or False when the block is absent."""
    if section not in param_dict:
        return False
    block = dict(param_dict[section])
    block.pop(exclude, None)
    return block


def parse_sparse_attention(param_dict):
    """``sparse_attention`` block -> flat {mode, **fields} dict, or None."""
    if SPARSE_ATTENTION not in param_dict:
        return None
    sparsity = param_dict[SPARSE_ATTENTION]
    mode = get_scalar_param(sparsity, SPARSE_MODE, SPARSE_MODE_DEFAULT)
    if mode not in _SPARSE_MODE_KEYS:
        raise NotImplementedError(
            "Given sparsity mode, {}, has not been implemented yet!".format(
                mode))
    parsed = {SPARSE_MODE: mode}
    for key in _SPARSE_MODE_KEYS[mode]:
        parsed[key] = get_scalar_param(sparsity, key,
                                       _SPARSE_KEY_DEFAULTS[key])
    return parsed


# The pipeline engine reads these (runtime/pipe/engine.py); the rest of
# the block must stay at its defaults.
_PIPELINE_ENGINE_KEYS = ("stages", "activation_checkpoint_interval")
_PIPELINE_DEFAULTS = {"stages": "auto", "partition": "best",
                      "seed_layers": False,
                      "activation_checkpoint_interval": 0}


def _named_block(param_dict, section, default_name, params_key):
    """(name, params) from an {"type": ..., "params": {...}} block."""
    block = param_dict.get(section)
    name = block.get(TYPE, default_name) if isinstance(block, dict) \
        else default_name
    params = block.get(params_key) if name is not None and \
        isinstance(block, dict) else None
    return name, params


def _refuse(what, where):
    raise NotImplementedError("ds_config {} is not ported yet: {}".format(
        what, where))


def _check_ported(param_dict):
    """Raise NotImplementedError for any key that switches on a subsystem
    the port does not have (module docstring)."""
    pipeline = param_dict.get("pipeline", {})
    for key in sorted(pipeline):
        if key in _PIPELINE_ENGINE_KEYS:
            continue
        if key not in _PIPELINE_DEFAULTS or \
                pipeline[key] != _PIPELINE_DEFAULTS[key]:
            _refuse("'pipeline.{}': {!r} (set it on the PipelineModule)"
                    .format(key, pipeline[key]), _RUNTIME)


class DeepSpeedConfig(object):
    def __init__(self, json_file, param_dict=None, world_size=1):
        if param_dict is None:
            with open(json_file, "r") as f:
                param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        self._param_dict = param_dict
        self.world_size = world_size
        self.elasticity_enabled = elasticity_enabled(param_dict)
        if self.elasticity_enabled:
            self._apply_elasticity()
        self._initialize_params(param_dict)
        self._configure_train_batch_size()
        self._check_zero()
        self._check_data_parallel()

    def _apply_elasticity(self):
        """Overwrite the batch triangle with the elastic schedule (the JAX
        config's ``_apply_elasticity``)."""
        logger.info("DeepSpeed elasticity support enabled")
        final_batch_size, valid_gpus, micro_batch_size = \
            compute_elastic_config(ds_config=self._param_dict,
                                   target_deepspeed_version=__version__,
                                   world_size=self.world_size)
        elastic_dict = self._param_dict[ELASTICITY]
        ensure_immutable_elastic_config(
            runtime_elastic_config_dict=elastic_dict)
        if not elastic_dict.get(IGNORE_NON_ELASTIC_BATCH_INFO,
                                IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT):
            batch_params = [TRAIN_BATCH_SIZE, TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                            GRADIENT_ACCUMULATION_STEPS]
            if any(t in self._param_dict for t in batch_params):
                raise ElasticityConfigError(
                    "One or more batch related parameters were found in your "
                    "ds_config ({}, {}, and/or {}). These parameters *will "
                    "not be used* since elastic training is enabled, which "
                    "takes control of these parameters. If you want to "
                    "suppress this error (the parameters will be silently "
                    "ignored) please set {}':true in your elasticity "
                    "config.".format(TRAIN_BATCH_SIZE,
                                     TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                                     GRADIENT_ACCUMULATION_STEPS,
                                     IGNORE_NON_ELASTIC_BATCH_INFO))
        gradient_accu_steps = final_batch_size // (micro_batch_size *
                                                   self.world_size)
        logger.info("[Elasticity] valid GPU counts: %s", valid_gpus)
        self._param_dict[TRAIN_BATCH_SIZE] = final_batch_size
        self._param_dict[TRAIN_MICRO_BATCH_SIZE_PER_GPU] = micro_batch_size
        self._param_dict[GRADIENT_ACCUMULATION_STEPS] = gradient_accu_steps

    def _initialize_params(self, param_dict):
        for row in _SCHEMA:
            attr, path, default = row[0], row[1], row[2]
            gate = row[3] if len(row) > 3 else None
            if gate is not None and not getattr(self, gate):
                setattr(self, attr, default)
            else:
                setattr(self, attr, _read(param_dict, path, default))

        power = _read(param_dict, (FP16, FP16_INITIAL_SCALE_POWER),
                      FP16_INITIAL_SCALE_POWER_DEFAULT) \
            if self.fp16_enabled else FP16_INITIAL_SCALE_POWER_DEFAULT
        self.initial_dynamic_scale = 2 ** power
        self.dynamic_loss_scale_args = None
        if self.fp16_enabled:
            fp16_block = param_dict[FP16]
            if any(key in fp16_block for _, key, _ in _DYNAMIC_SCALE_ARGS):
                args = {arg: get_scalar_param(fp16_block, key, default)
                        for arg, key, default in _DYNAMIC_SCALE_ARGS}
                args["INITIAL_LOSS_SCALE"] = 2 ** args["INITIAL_LOSS_SCALE"]
                self.dynamic_loss_scale_args = args

        self.pipeline = dict(_PIPELINE_DEFAULTS,
                             **param_dict.get("pipeline", {}))
        self.optimizer_name, self.optimizer_params = _named_block(
            param_dict, OPTIMIZER, OPTIMIZER_TYPE_DEFAULT, OPTIMIZER_PARAMS)
        if self.optimizer_name is not None and \
                self.optimizer_name.lower() in DEEPSPEED_OPTIMIZERS:
            self.optimizer_name = self.optimizer_name.lower()
        self.scheduler_name, self.scheduler_params = _named_block(
            param_dict, SCHEDULER, SCHEDULER_TYPE_DEFAULT, SCHEDULER_PARAMS)

        self.zero_config = DeepSpeedZeroConfig(param_dict)
        self.zero_optimization_stage = self.zero_config.stage
        self.zero_enabled = self.zero_optimization_stage > 0
        _check_ported(param_dict)
        self.amp_params = _typed_block(param_dict, AMP, AMP_ENABLED)
        self.pld_params = _typed_block(param_dict, PROGRESSIVE_LAYER_DROP,
                                       PLD_ENABLED) \
            if self.pld_enabled else False
        self.activation_checkpointing_config = \
            DeepSpeedActivationCheckpointingConfig(param_dict)
        self.inference = self._parse_inference(param_dict)
        self.sparse_attention = parse_sparse_attention(param_dict)
        self.flops_profiler_config = DeepSpeedFlopsProfilerConfig(param_dict)

        tag_mode = str(_read(param_dict, (CHECKPOINT,
                                          CHECKPOINT_TAG_VALIDATION),
                             CHECKPOINT_TAG_VALIDATION_DEFAULT)).upper()
        if tag_mode not in CHECKPOINT_TAG_VALIDATION_MODES:
            raise ValueError(
                "Checkpoint config contains invalid tag_validation value of "
                "{}, expecting one of {}".format(
                    tag_mode, CHECKPOINT_TAG_VALIDATION_MODES))
        self.checkpoint_tag_validation_enabled = \
            tag_mode != ValidationMode.IGNORE
        self.checkpoint_tag_validation_fail = tag_mode == ValidationMode.FAIL

        if self.optimizer_params and \
                self.optimizer_params.get(MAX_GRAD_NORM, 0) > 0 and \
                not self.fp16_enabled:
            # The reference's FP32 rule (the JAX package keeps it).
            self.optimizer_params[MAX_GRAD_NORM] = 0.0

    @staticmethod
    def _parse_inference(param_dict):
        """The ``inference`` block, checked by the serving config's own
        parser (unknown keys raise ValueError, unported values
        NotImplementedError)."""
        from deepspeed_tpu_torch.inference.config import InferenceConfig

        block = param_dict.get("inference", {})
        if not isinstance(block, dict):
            raise TypeError("DeepSpeedConfig: expected 'inference' to be a "
                            "JSON object, got {!r}".format(block))
        InferenceConfig.from_dict(block)
        return dict(block)

    def _set_batch_related_parameters(self):
        """Batch triangle completion (the JAX package's rules)."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        if train_batch is not None and micro_batch is not None and \
                grad_acc is not None:
            return
        if train_batch is not None and micro_batch is not None:
            self.gradient_accumulation_steps = \
                train_batch // micro_batch // self.world_size
        elif train_batch is not None and grad_acc is not None:
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size // grad_acc
        elif micro_batch is not None and grad_acc is not None:
            self.train_batch_size = micro_batch * grad_acc * self.world_size
        elif train_batch is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = \
                train_batch // self.world_size
        elif micro_batch is not None:
            self.train_batch_size = micro_batch * self.world_size
            self.gradient_accumulation_steps = 1
        else:
            raise ValueError("Either train_batch_size or "
                             "train_micro_batch_size_per_gpu needs to be "
                             "provided")

    def _check_zero(self):
        """The JAX config's ZeRO checks (its ``_do_error_check``), raised as
        ValueError."""
        if not self.zero_enabled:
            return
        if not (self.fp16_enabled or self.bfloat16_enabled):
            raise ValueError("DeepSpeedConfig: ZeRO is only supported if "
                             "fp16 or bf16 is enabled")
        if self.zero_optimization_stage > MAX_STAGE_ZERO_OPTIMIZATION:
            raise ValueError("DeepSpeedConfig: Maximum supported ZeRO stage "
                             "is {}".format(MAX_STAGE_ZERO_OPTIMIZATION))
        if self.zero_config.cpu_offload is True and \
                self.zero_optimization_stage != ZERO_OPTIMIZATION_GRADIENTS:
            raise ValueError("DeepSpeedConfig: cpu-offload supported ZeRO "
                             "stage is {}".format(
                                 ZERO_OPTIMIZATION_GRADIENTS))

    def _check_data_parallel(self):
        """Over several ranks: ``stream_gradients`` is the one-card tier (the
        JAX engine refuses it on a multi-device mesh)."""
        if self.world_size > 1 and self.zero_config.stream_gradients:
            raise ValueError("'zero_optimization.stream_gradients' at "
                             "data-parallel size {}: {}".format(
                                 self.world_size, STREAM_MULTI_RANK))

    def _configure_train_batch_size(self):
        self._set_batch_related_parameters()
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        grad_acc = self.gradient_accumulation_steps
        for name, val in (("train_batch_size", train_batch),
                          ("train_micro_batch_size_per_gpu", micro_batch),
                          ("gradient_accumulation_steps", grad_acc)):
            if not val or val <= 0:
                raise ValueError("{}: {} has to be greater than 0".format(
                    name, val))
        if train_batch != micro_batch * grad_acc * self.world_size:
            raise ValueError(
                "Check batch related parameters. train_batch_size is not "
                "equal to micro_batch_per_gpu * gradient_acc_step * "
                "world_size {} != {} * {} * {}".format(
                    train_batch, micro_batch, grad_acc, self.world_size))
