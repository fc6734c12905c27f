"""Rank layout, process groups and the ZeRO partition rule.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``. The JAX package builds
one ``jax.sharding.Mesh`` with the axes ('pipe', 'data', 'seq', 'model')
and lets GSPMD place every collective. Here the same layout is a grid of
``torch.distributed`` ranks, ``model`` innermost: rank = ((pipe * dp +
data) * sp + seq) * mp + model, as a flat ``jax.devices()`` reshape lays
the JAX mesh out. ``build_mesh`` makes one process group per ``data`` line
(the ranks that differ only in their data coordinate; ZeRO's collectives
and the gradient reduction run over it), then one per ``model`` line (the
tensor-parallel collectives, ``parallel/tensor_parallel.py``) and one per
``pipe`` line (the pipeline's loss broadcast, norm and overflow, tied
gradients: ``runtime/pipe/engine.py``).

A ``seq`` axis above 1 raises NotImplementedError naming the ROADMAP item
that brings it.

The partition rule is the JAX ``zero_shardings`` leaf rule as a pure
function over shapes (``zero_partition_dim``): ZeRO's data partition goes
on a leaf's first dimension of size >= dp that dp divides; a leaf with no
such dimension stays replicated. Stage 1 partitions the optimizer state,
stage 2 the gradients too, stage 3 the parameters too
(``runtime/zero/partition.py``); with a ``model`` axis the dim a
tensor-parallel rule shards is skipped (the JAX ``zero_shardings``
composition). ``DEFAULT_TP_RULES`` and ``_tp_dim`` are the JAX
tensor-parallel rules, applied by ``parallel/tensor_parallel.py``.

``replica_devices`` places the serving fleet's replicas.
"""

import re

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.utils.distributed import group_timeout

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, MODEL_AXIS)

# The ROADMAP item that brings each axis wider than 1.
_UNPORTED_AXES = {
    SEQ_AXIS: "sequence parallelism over the 'seq' axis (ROADMAP Queue 1 "
              "item 10)",
}

# Megatron-style tensor-parallel rules (path regex, sharded dim), the JAX
# package's, first match wins; paths join the flax names with '/'
# (``parallel/tensor_parallel.py`` applies them).
DEFAULT_TP_RULES = (
    (r".*experts/.*", 0),
    (r".*(attn/c_attn|mlp/c_fc)/kernel$", 1),
    (r".*(attn/c_attn|mlp/c_fc)/bias$", 0),
    (r".*(attn|mlp)/c_proj/kernel$", 0),
)


def _tp_dim(path_str, shape, rules, mp):
    """The dim a TP rule puts on the 'model' axis, or None: the first
    matching pattern decides, and an indivisible dim means replicated."""
    if mp <= 1 or rules is None:
        return None
    for pattern, dim in rules:
        if re.match(pattern, path_str):
            if dim < len(shape) and shape[dim] % mp == 0:
                return dim
            return None
    return None


def zero_partition_dim(shape, dp, skip=None):
    """The dim ZeRO partitions a leaf of ``shape`` on over ``dp`` ranks: the
    first of size >= dp that dp divides, other than ``skip`` (the dim a
    tensor-parallel rule puts on 'model'), or None when the leaf stays
    replicated (always None at dp 1). Moments are partitioned so from stage
    1, gradients from stage 2, parameters at stage 3."""
    if dp <= 1:
        return None
    for dim, size in enumerate(shape):
        if dim != skip and size >= dp and size % dp == 0:
            return dim
    return None


def shard_slice(t, dim, rank, dp):
    """Rank ``rank``'s shard of ``t`` along ``dim`` (a view), or ``t`` when
    ``dim`` is None."""
    if dim is None:
        return t
    per = t.shape[dim] // dp
    return t.narrow(dim, rank * per, per)


class Mesh(object):
    """The rank grid (module docstring). ``rank`` is this process's global
    rank, ``coords`` its (pipe, data, seq, model) coordinates, ``dp_rank``,
    ``mp_rank`` and ``pp_rank`` its data, model and pipe coordinates,
    ``dp_group``, ``mp_group`` and ``pp_group`` the process groups of its
    data, model and pipe lines (None when no process group exists, and
    the model and pipe groups also when that axis is 1 wide)."""

    def __init__(self, shape, rank, dp_group, mp_group=None, pp_group=None):
        self.shape = dict(zip(AXES, shape))
        self.rank = rank
        self.coords = dict(zip(AXES, np.unravel_index(rank, shape)))
        self.dp_rank = int(self.coords[DATA_AXIS])
        self.mp_rank = int(self.coords[MODEL_AXIS])
        self.pp_rank = int(self.coords[PIPE_AXIS])
        self.dp_group = dp_group
        self.mp_group = mp_group
        self.pp_group = pp_group

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    def data_line(self, rank=None):
        """The global ranks of ``rank``'s data line, in data order."""
        return self.line(DATA_AXIS, rank)

    def line(self, axis, rank=None):
        """The global ranks of ``rank``'s line along ``axis``, in order."""
        grid = np.arange(self.size).reshape(tuple(self.shape[a]
                                                  for a in AXES))
        c = self.coords if rank is None else dict(zip(AXES, np.unravel_index(
            rank, grid.shape)))
        index = tuple(slice(None) if a == axis else c[a] for a in AXES)
        return [int(r) for r in grid[index]]


def build_mesh(num_dp=None, num_mp=1, num_pp=1, num_sp=1, world_size=None,
               rank=None):
    """The ('pipe', 'data', 'seq', 'model') rank grid over ``world_size``
    ranks (default: the initialised process group's, else 1), with one
    process group per data line, then (where the axis is wider than 1) one
    per model line and one per pipe line. ``num_dp`` defaults to what the
    other axes leave. Every rank must call it, in the same order as its
    other group constructions (``torch.distributed.new_group`` is
    collective). Without an initialised process group the grid has no
    groups (one process trains alone)."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    for axis, n in ((SEQ_AXIS, num_sp),):
        if n != 1:
            raise NotImplementedError(
                "a '{}' axis of size {} is not ported yet: {}".format(
                    axis, n, _UNPORTED_AXES[axis]))
    if num_dp is None:
        if world_size % (num_mp * num_pp * num_sp):
            raise ValueError("{} ranks not divisible by mp={} * pp={} * sp={}"
                             .format(world_size, num_mp, num_pp, num_sp))
        num_dp = world_size // (num_mp * num_pp * num_sp)
    shape = (num_pp, num_dp, num_sp, num_mp)
    if int(np.prod(shape)) != world_size:
        raise ValueError("mesh {}x{}x{}x{} != {} ranks".format(
            num_pp, num_dp, num_sp, num_mp, world_size))
    mesh = Mesh(shape, rank, None)
    if live:
        for axis, attr in ((DATA_AXIS, "dp_group"), (MODEL_AXIS, "mp_group"),
                           (PIPE_AXIS, "pp_group")):
            if axis != DATA_AXIS and mesh.shape[axis] == 1:
                continue
            for ranks in _lines(shape, axis):
                group = dist.new_group(ranks, timeout=group_timeout())
                if rank in ranks:
                    setattr(mesh, attr, group)
    return mesh


def _lines(shape, axis):
    """Every line of the grid ``shape`` along ``axis`` (its ranks in axis
    order), the other axes in row-major order."""
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    k = AXES.index(axis)
    moved = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
    return [[int(r) for r in row] for row in moved]


def dp_size(mesh):
    return mesh.shape.get(DATA_AXIS, 1)


def mp_size(mesh):
    return mesh.shape.get(MODEL_AXIS, 1)


def pp_size(mesh):
    return mesh.shape.get(PIPE_AXIS, 1)


def sp_size(mesh):
    return mesh.shape.get(SEQ_AXIS, 1)


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
