"""deepspeed_tpu_torch.parallel: device placement (counterpart of
``deepspeed_tpu/parallel``). Only the serving fleet's
``mesh.replica_devices`` is ported so far."""
