"""Pipeline-parallelism names (``deepspeed_tpu.pipe``'s)."""
from deepspeed_tpu_torch.runtime.pipe import (LayerSpec,  # noqa: F401
                                              PipelineModule, TiedLayerSpec)
