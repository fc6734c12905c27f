from deepspeed_tpu_torch.op_builder.builder import (build_all, build_log,
                                                   flatten_into,
                                                   host_sources, load,
                                                   load_host, sources,
                                                   unflatten_into)

__all__ = ["build_all", "build_log", "flatten_into", "host_sources", "load",
           "load_host", "sources", "unflatten_into"]
