"""ZeRO sub-config object (counterpart of
``deepspeed_tpu/runtime/zero/config.py``): the dict form and the deprecated
boolean form (``"zero_optimization": true`` -> stage 1). The port parses
every key; ``DeepSpeedConfig`` applies the JAX package's checks.
"""

from deepspeed_tpu_torch.runtime.config_utils import get_scalar_param
from deepspeed_tpu_torch.runtime.zero.constants import (
    ZERO_OPTIMIZATION,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
    ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
    ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT,
    ZERO_OPTIMIZATION_CPU_OFFLOAD,
    ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
    ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT,
    ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
    ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT,
    ZERO_OPTIMIZATION_OPTIMIZER_STATES,
    ZERO_OPTIMIZATION_OVERLAP_COMM,
    ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
    ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT,
    ZERO_OPTIMIZATION_REDUCE_SCATTER,
    ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT,
    ZERO_OPTIMIZATION_STAGE,
    ZERO_OPTIMIZATION_STAGE_DEFAULT,
    ZERO_OPTIMIZATION_STREAM_GRADIENTS,
    ZERO_OPTIMIZATION_STREAM_GRADIENTS_DEFAULT,
)


class DeepSpeedZeroConfig(object):
    def __init__(self, param_dict):
        self.stage = None
        self.contiguous_gradients = None
        self.reduce_scatter = None
        self.reduce_bucket_size = None
        self.allgather_partitions = None
        self.allgather_bucket_size = None
        self.overlap_comm = None
        self.cpu_offload = None
        self.stream_gradients = None
        self.elastic_checkpoint = None
        self.load_from_fp32_weights = None

        if ZERO_OPTIMIZATION in param_dict:
            zero_config_dict = param_dict[ZERO_OPTIMIZATION]
            if isinstance(zero_config_dict, bool):
                zero_config_dict = self.read_zero_config_deprecated(param_dict)
        else:
            zero_config_dict = {}
        self._initialize(zero_config_dict)

    def read_zero_config_deprecated(self, param_dict):
        zero_config_dict = {}
        zero_config_dict[ZERO_OPTIMIZATION_STAGE] = (
            1 if param_dict[ZERO_OPTIMIZATION] else 0)
        if zero_config_dict[ZERO_OPTIMIZATION_STAGE] > 0:
            zero_config_dict[ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE] = \
                get_scalar_param(param_dict,
                                 ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
                                 ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        return zero_config_dict

    def _initialize(self, zero_config_dict):
        self.stage = get_scalar_param(zero_config_dict,
                                      ZERO_OPTIMIZATION_STAGE,
                                      ZERO_OPTIMIZATION_STAGE_DEFAULT)
        self.contiguous_gradients = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
            ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT)
        self.reduce_bucket_size = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
            ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT)
        self.reduce_scatter = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_REDUCE_SCATTER,
            ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT)
        self.overlap_comm = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_OVERLAP_COMM,
            ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT)
        self.allgather_partitions = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
            ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT)
        self.allgather_bucket_size = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
            ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT)
        self.cpu_offload = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_CPU_OFFLOAD,
            ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT)
        self.stream_gradients = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_STREAM_GRADIENTS,
            ZERO_OPTIMIZATION_STREAM_GRADIENTS_DEFAULT)
        self.elastic_checkpoint = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
            ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT)
        self.load_from_fp32_weights = get_scalar_param(
            zero_config_dict,
            ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
            ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT)

    def repr(self):
        return self.__dict__

    def __repr__(self):
        import json
        return json.dumps(self.__dict__, sort_keys=True, indent=4)
