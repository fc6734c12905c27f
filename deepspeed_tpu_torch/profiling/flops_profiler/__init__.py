from deepspeed_tpu_torch.profiling.flops_profiler.profiler import (  # noqa: F401
    FlopsProfiler, get_model_profile)
