"""Host utilities of the port: the package logger, the wall-clock and
throughput timers and the process-group bootstrap (counterparts of
``deepspeed_tpu/utils``)."""
