"""deepspeed_tpu_torch.parallel: the rank grid and process groups
(``mesh``: the JAX layout's axes, one group per data line, the ZeRO
partition rule, the serving fleet's ``replica_devices``) and the
collectives ZeRO runs over them (``comm``). Counterpart of
``deepspeed_tpu/parallel``."""
