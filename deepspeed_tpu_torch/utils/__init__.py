"""Host utilities of the port: the package logger and the wall-clock
and throughput timers (counterparts of ``deepspeed_tpu/utils``)."""
