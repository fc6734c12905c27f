from deepspeed_tpu_torch.op_builder.builder import (build_all, build_log, load,
                                                   sources)

__all__ = ["build_all", "build_log", "load", "sources"]
