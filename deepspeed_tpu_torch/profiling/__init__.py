"""Profiling (mirrors ``deepspeed_tpu.profiling``): the flops profiler and
its ds_config block."""
