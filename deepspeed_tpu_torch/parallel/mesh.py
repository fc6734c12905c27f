"""Rank layout, process groups and the ZeRO partition rule.

Counterpart of ``deepspeed_tpu/parallel/mesh.py``. The JAX package builds
one ``jax.sharding.Mesh`` with the axes ('pipe', 'data', 'seq', 'model')
and lets GSPMD place every collective. Here the same layout is a grid of
``torch.distributed`` ranks, ``model`` innermost: rank = ((pipe * dp +
data) * sp + seq) * mp + model, as a flat ``jax.devices()`` reshape lays
the JAX mesh out. ``build_mesh`` makes one process group per ``data`` line
(the ranks that differ only in their data coordinate; ZeRO's collectives
and the gradient reduction run over it), then one per ``model`` line (the
tensor-parallel collectives, ``parallel/tensor_parallel.py``), one per
``pipe`` line (the pipeline's loss broadcast, norm and overflow, tied
gradients: ``runtime/pipe/engine.py``) and one per ``seq`` line (ring and
Ulysses attention, the sequence-parallel loss and the gradients' mean over
the sequence shards: ``parallel/sequence_parallel.py``).

The batch split of sequence parallelism (``shard_batch``, ``seq_shard``):
the batch over 'data', the tokens (dim 1 of every array of rank >= 2) over
'seq', with the JAX engine's divisibility errors.

The partition rule is the JAX ``zero_shardings`` leaf rule as a pure
function over shapes (``zero_partition_dim``): ZeRO's data partition goes
on a leaf's first dimension of size >= dp that dp divides; a leaf with no
such dimension stays replicated. Stage 1 partitions the optimizer state,
stage 2 the gradients too, stage 3 the parameters too
(``runtime/zero/partition.py``); with a ``model`` axis the dim a
tensor-parallel rule shards is skipped (the JAX ``zero_shardings``
composition). ``DEFAULT_TP_RULES`` and ``_tp_dim`` are the JAX
tensor-parallel rules, applied by ``parallel/tensor_parallel.py``.

``kv_heads`` is the JAX ``kv_cache_spec`` policy for a serving rank: the
k/v planes' heads over 'model' when mp divides them, else replicated.

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


def kv_heads(n_head, mp=1, mp_rank=0):
    """(first head, head count) of the k/v planes a serving rank holds:
    heads ``[r H/mp, (r + 1) H/mp)`` on model rank r when mp divides
    ``n_head`` (the JAX ``kv_cache_spec``: the planes' heads dim over
    'model', aligned with the column-parallel qkv split), else every head
    (replicated: correct, without the memory saving)."""
    if mp > 1 and n_head % mp == 0:
        per = n_head // mp
        return mp_rank * per, per
    return 0, n_head


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
    ``mp_rank``, ``pp_rank`` and ``sp_rank`` its data, model, pipe and seq
    coordinates, ``dp_group``, ``mp_group``, ``pp_group`` and ``sp_group``
    the process groups of its data, model, pipe and seq lines (None when no
    process group exists, and the model, pipe and seq groups also when that
    axis is 1 wide)."""

    def __init__(self, shape, rank, dp_group, mp_group=None, pp_group=None,
                 sp_group=None):
        self.shape = dict(zip(AXES, shape))
        self.rank = rank
        self.coords = dict(zip(AXES, np.unravel_index(rank, shape)))
        self.dp_rank = int(self.coords[DATA_AXIS])
        self.mp_rank = int(self.coords[MODEL_AXIS])
        self.pp_rank = int(self.coords[PIPE_AXIS])
        self.sp_rank = int(self.coords[SEQ_AXIS])
        self.dp_group = dp_group
        self.mp_group = mp_group
        self.pp_group = pp_group
        self.sp_group = sp_group

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
    per model line, one per pipe line and one per seq line. ``num_dp``
    defaults to what the other axes leave. Every rank must call it, in the same order as its
    other group constructions (``torch.distributed.new_group`` is
    collective). Without an initialised process group the grid has no
    groups (one process trains alone)."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
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
                           (PIPE_AXIS, "pp_group"), (SEQ_AXIS, "sp_group")):
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


def seq_shard(x, sp, sp_rank):
    """Rank ``sp_rank``'s token shard of one batch array: dim 1 of an array
    of rank >= 2 cut into ``sp`` equal pieces (other arrays and non-tensors
    as they are). A token dim that ``sp`` does not divide raises the JAX
    engine's ValueError."""
    shape = tuple(getattr(x, "shape", ()))
    if sp <= 1 or len(shape) < 2:
        return x
    if shape[1] % sp:
        raise ValueError(
            "sequence_parallel: token dim {} of shape {} not divisible by "
            "sp={} (all rank>=2 batch arrays are token-sharded on dim 1)"
            .format(shape[1], shape, sp))
    per = shape[1] // sp
    return x[:, sp_rank * per:(sp_rank + 1) * per]


def shard_batch(x, mesh):
    """This rank's piece of a GLOBAL batch array: the batch (dim 0) over
    'data', then the tokens (``seq_shard``) over 'seq'; the JAX engine's
    errors for a dim the axis does not divide."""
    dp, sp = dp_size(mesh), sp_size(mesh)
    shape = tuple(getattr(x, "shape", ()))
    if len(shape) >= 1 and dp > 1:
        if shape[0] % dp:
            raise ValueError(
                "sequence_parallel: batch dim {} of shape {} not divisible "
                "by dp={}".format(shape[0], shape, dp))
        per = shape[0] // dp
        x = x[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]
    return seq_shard(x, sp, mesh.sp_rank)


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
