from deepspeed_tpu_torch.runtime.pipe.module import (LayerSpec,  # noqa: F401
                                                     PipelineModule,
                                                     TiedLayerSpec)
from deepspeed_tpu_torch.runtime.pipe.topology import (  # noqa: F401
    PipeDataParallelTopology, PipelineParallelGrid,
    PipeModelDataParallelTopology, ProcessTopology)
