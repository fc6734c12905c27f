"""The fused transformer layer and its kernels (mirrors
``deepspeed_tpu.ops.transformer``; ring attention comes with the
sequence-parallel slice)."""

from deepspeed_tpu_torch.ops.transformer.kernels.attention import (  # noqa: F401
    flash_attention)
from deepspeed_tpu_torch.ops.transformer.transformer import (  # noqa: F401
    DeepSpeedTransformerConfig, DeepSpeedTransformerLayer,
    transformer_layer_reference)
