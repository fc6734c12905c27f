"""Elasticity: the elastic batch schedule (counterpart of
``deepspeed_tpu/elasticity``)."""

from deepspeed_tpu_torch.elasticity.config import (
    ElasticityConfig,
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
)
from deepspeed_tpu_torch.elasticity.elasticity import (
    compute_elastic_config,
    elasticity_enabled,
    ensure_immutable_elastic_config,
)
