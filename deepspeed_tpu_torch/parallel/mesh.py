"""Device placement for the serving fleet.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``: only
``replica_devices`` is ported; the training mesh comes with the tensor
and pipeline parallel slices (ROADMAP Queue 1).
"""

import torch

from deepspeed_tpu_torch.device import resolve_device


def replica_devices(n, devices=None, device=None):
    """Device per serving replica of a fleet of ``n`` (inference/fleet.py):
    round-robin over ``devices``, so ``n <= len(devices)`` gives each
    replica its own card and more replicas pack fairly. ``devices``
    defaults to every visible CUDA device, or to ``[device]`` when the
    caller names one (``device="cpu"``: the tests' replicas all share the
    host). Raises like ``resolve_device`` when no CUDA device is
    visible and none was named."""
    if n < 1:
        raise ValueError("replica count must be >= 1, got {}".format(n))
    if devices is None:
        if device is not None:
            devices = [resolve_device(device)]
        else:
            resolve_device(None)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = list(devices)
    return [devices[i % len(devices)] for i in range(n)]
