"""The sequence-parallel context of a model and its differentiable
collectives.

The JAX package runs a sequence-parallel model inside ``shard_map`` with
the 'seq' mesh axis bound (``parallel/mesh.py:active_sp_axis``): a model
takes its sequence-parallel paths (ring or Ulysses attention, offset
positions, the global loss) only there. Here the engine hands the model a
``SeqContext`` (the rank's seq-line process group, its coordinate and the
axis size) through ``set_sequence_parallel``; a model without one runs
serially, as the JAX model does outside ``shard_map``.

``psum`` is ``jax.lax.psum`` under ``shard_map``'s autodiff: a sum over the
seq line whose backward is again that sum (the transpose of psum is psum).
With it every rank's gradient is the gradient of the global loss through
its own shard's computation scaled by the axis size, so the engine takes
the MEAN of the gradients over the seq line (the JAX engine's pmean over
'seq'); a replicated computation (BERT's NSP head, fed the [CLS] vector
summed from shard 0) is counted once by the same rule. ``shift`` is the
ring shift of a tensor that carries no gradient (labels).
"""

import collections

import torch

from deepspeed_tpu_torch.parallel import comm

SeqContext = collections.namedtuple("SeqContext", ["group", "rank", "size"])


def context(mesh):
    """The ``SeqContext`` of this rank's seq line, or None when the 'seq'
    axis is 1 wide or no process group exists."""
    if mesh.shape.get("seq", 1) <= 1 or mesh.sp_group is None:
        return None
    return SeqContext(mesh.sp_group, mesh.sp_rank, mesh.shape["seq"])


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return comm.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce(grad.contiguous().clone(), ctx.group), None


def psum(x, sp):
    """The sum of ``x`` over the seq line; its backward sums the
    cotangents over the line (module docstring)."""
    return _PSum.apply(x, sp.group)


def shift(x, sp, offset):
    """``x`` of seq rank r delivered to rank (r + offset) mod size (no
    gradient)."""
    return comm.ring_shift(x.contiguous(), sp.group, offset)
