"""The cost of the training kernels, as the perf x-ray and the flops
profiler measure a step.

The x-ray (``telemetry/xray.py``) measures one eager run under two dispatch
modes: ``FlopCounterMode`` (matrix products) and ``_ByteMode`` (each
operator's tensor bytes). On CPU tensors a kernel wrapper computes its plain
version in torch operators, which the modes count. On the card the wrapper
launches a ctypes kernel on raw pointers, which no mode sees. So while a
``costing()`` block is open, each wrapper of K1/K2a/K2b, K7a/K7b and K8-K11
that launches on the card

- runs its own work (allocations, casts, the launch) under ``hidden()``, out
  of the modes' sight, and
- ``charge``s the modes with its plain version, run on meta tensors of the
  same shapes and dtypes: no data moves, and the modes count the same
  operators at the same shapes as on the CPU.

A step's flops and bytes are then the same on the card as on the CPU, and
``FlopCounterMode``'s module hierarchy places each kernel's share under the
module that called it. The block is process-wide, not per thread: autograd
runs a CUDA backward on its own device thread. Outside a block the wrappers
pay one integer test.
"""

import contextlib

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils._pytree import tree_map

_depth = 0


@contextlib.contextmanager
def costing():
    """While the block runs, the training kernels' wrappers charge the
    active dispatch modes with their plain versions (module docstring)."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def active():
    return _depth > 0


def hidden():
    """A block the active dispatch modes do not see (a wrapper's own work
    on the card), or nothing outside ``costing()``."""
    if _depth > 0:
        return _disable_current_modes()
    return contextlib.nullcontext()


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(tuple(x.shape), dtype=x.dtype, device="meta")
    return x


def charge(plain, *args, **kwargs):
    """Inside ``costing()``, run ``plain(*args, **kwargs)`` on meta copies
    of its tensor arguments, where the active modes count it; else
    nothing."""
    if _depth <= 0:
        return
    with _disable_current_modes():
        args, kwargs = tree_map(_meta, (args, kwargs))
    with torch.no_grad():
        plain(*args, **kwargs)
