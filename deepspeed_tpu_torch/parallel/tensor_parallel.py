"""Tensor parallelism over the 'model' axis of the rank grid.

The JAX package has no module for this: it shards the parameter tree over
its mesh's 'model' axis by ``DEFAULT_TP_RULES`` (``parallel/mesh.py``) and
GSPMD inserts the collectives. Here the rules are applied to a module's
parameters once (``apply_rules``), and the collectives are explicit
autograd functions over the model group's ``parallel/comm.py`` calls
(gloo stages them through pinned host memory):

- ``copy_to_model``: identity forward, all-reduce backward (the input of a
  column-parallel layer: each rank's gradient of it is partial);
- ``reduce_from_model``: all-reduce forward, identity backward (the output
  of a row-parallel layer);
- ``gather_from_model``: all-gather forward, the rank's slice backward.

A leaf a rule shards is held one of two ways:

- **split**: the module computes with its shard. A submodule declares the
  leaves it can compute split (``tensor_parallel_leaves(mp)``: name ->
  (dim, column order)); where every one of them gets exactly that dim from
  the rules, each rank holds its shard and ``set_tensor_parallel`` switches
  the submodule to its split forward (GPT-2's attention and MLP: Megatron's
  column- and row-parallel layers, ``models/gpt2.py``).
- **stored**: any other leaf a rule shards. Each rank stores its
  contiguous shard and the engine all-gathers it for use
  (``gather_from_model``); every model rank then computes the full
  gradient on replicated activations and keeps its slice. This is GSPMD's
  value semantics at a cost in memory traffic.

A submodule's column order lets a split shard be non-contiguous: GPT-2's
``c_attn`` shard holds the rank's heads of q, k and v (JAX's shard is the
contiguous block of [q|k|v] columns). ``TPLayout.local`` cuts a rank's
shard from a full leaf, ``TPLayout.full`` gathers the leaf and puts its
columns back, so checkpoints keep the JAX full layout.

Serving over the model group (``models/generation.py``, the MoE adapter)
runs no autograd: a row-parallel partial is summed in place by
``serving_reduce``. Inside ``segmented(cut)`` (the serving engine's
capture of a step program as a chain of CUDA graphs) the reduce is not
run but handed to ``cut``, which ends the captured segment there; the
engine runs the all-reduce between the segments' replays.
"""

import contextlib
import threading

import torch

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.mesh import DEFAULT_TP_RULES, _tp_dim


class TPContext(object):
    """This rank's place on its model line: ``group`` (the model group),
    ``size`` (mp) and ``rank`` (its model coordinate)."""

    def __init__(self, group, size, rank):
        self.group, self.size, self.rank = group, size, rank


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce(grad.contiguous().clone(), ctx.tp.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return comm.all_reduce(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, dim, tp):
        ctx.dim, ctx.tp = dim, tp
        return _gather(shard, dim, tp)

    @staticmethod
    def backward(ctx, grad):
        per = grad.shape[ctx.dim] // ctx.tp.size
        return grad.narrow(ctx.dim, ctx.tp.rank * per, per).contiguous(), \
            None, None


def copy_to_model(x, tp):
    """``x`` forward; its gradient all-reduced over the model group."""
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x, tp):
    """The sum of ``x`` over the model group; the gradient passes as is."""
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(shard, dim, tp):
    """Every rank's contiguous ``shard`` concatenated along ``dim``; the
    gradient is the rank's slice of the full gradient."""
    return _GatherFromModel.apply(shard, dim, tp)


_SEGMENT = threading.local()


@contextlib.contextmanager
def segmented(cut):
    """Within the block, ``serving_reduce(t, tp)`` calls ``cut(t, tp)``
    instead of reducing (this thread only)."""
    prev = getattr(_SEGMENT, "cut", None)
    _SEGMENT.cut = cut
    try:
        yield
    finally:
        _SEGMENT.cut = prev


def serving_reduce(t, tp):
    """The sum of the contiguous partial ``t`` over the model group of
    ``tp``, in place (no autograd; ``comm.all_reduce_exchange``); returns
    ``t``. Under ``segmented`` the cut takes it instead."""
    cut = getattr(_SEGMENT, "cut", None)
    if cut is not None:
        return cut(t, tp)
    return comm.all_reduce_exchange(t, tp.group)


def shard_of(full, dim, tp, order=None):
    """Rank ``tp.rank``'s shard of ``full`` along ``dim``: the indices
    ``order(rank, mp)`` when given (GPT-2's ``qkv_order``), else the
    contiguous block (a view)."""
    if order is not None:
        return full.index_select(dim, order(tp.rank, tp.size).to(
            full.device))
    per = full.shape[dim] // tp.size
    return full.narrow(dim, tp.rank * per, per)


def _gather(shard, dim, tp):
    """Rank-ordered concatenation of ``shard`` along ``dim`` (no grad)."""
    moved = shard.movedim(dim, 0).contiguous()
    flat = comm.all_gather(moved.reshape(-1), tp.group)
    full = flat.view(tp.size * moved.shape[0], *moved.shape[1:])
    return full.movedim(0, dim)


def _path(name):
    """A parameter name as a rule path: flax names joined with '/'."""
    return name.replace(".", "/")


class TPLayout(object):
    """Where each of ``names`` lives on the model axis: ``dims[i]`` (the
    sharded dim, or None: replicated), ``kinds[i]`` ("split", "stored" or
    None) and ``order_fns[i]`` (for a split shard that is no contiguous
    block: (rank, mp) -> the full leaf's indices along its dim that rank
    holds); ``full_shapes[i]`` the full leaf's shape."""

    def __init__(self, tp, names, dims, kinds, order_fns, full_shapes):
        self.tp = tp
        self.names = list(names)
        self.dims = dims
        self.kinds = kinds
        self.order_fns = order_fns
        self.full_shapes = full_shapes

    def _order(self, i, rank):
        fn = self.order_fns.get(i)
        return None if fn is None else fn(rank, self.tp.size)

    @property
    def stored(self):
        return [i for i, k in enumerate(self.kinds) if k == "stored"]

    def sharded(self, i):
        return self.dims[i] is not None

    def local(self, i, full):
        """Rank's shard of leaf ``i`` from its full tensor (a copy; the
        full tensor itself when the leaf is replicated)."""
        d = self.dims[i]
        if d is None:
            return full
        return shard_of(full, d, self.tp, self.order_fns.get(i)).contiguous()

    def full(self, i, local):
        """Leaf ``i``'s full tensor from every model rank's ``local``
        (collective over the model group for a sharded leaf)."""
        d = self.dims[i]
        if d is None:
            return local
        gathered = _gather(local, d, self.tp)
        if i not in self.order_fns:
            return gathered.contiguous()
        order = torch.cat([self._order(i, r)
                           for r in range(self.tp.size)]).to(local.device)
        out = torch.empty_like(gathered)
        out.index_copy_(d, order, gathered)
        return out

    def gathered(self, i, p):
        """A stored leaf's full tensor for the forward (autograd through
        the gather)."""
        return gather_from_model(p, self.dims[i], self.tp)


def _providers(module):
    """(prefix, submodule) for each submodule that can compute split."""
    return [(name + "." if name else "", m)
            for name, m in module.named_modules()
            if callable(getattr(m, "tensor_parallel_leaves", None))]


def apply_rules(module, tp, rules=None, path_of=None):
    """Shard ``module``'s parameters (full leaves on entry) over the model
    group of ``tp`` (a ``TPContext``) by ``rules`` (default
    ``DEFAULT_TP_RULES``), in place; returns the ``TPLayout`` over
    ``module.named_parameters()``. ``path_of(name)`` gives the name the
    rules see (default: the whole name)."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    named = list(module.named_parameters())
    index = {n: i for i, (n, _) in enumerate(named)}
    path_of = path_of or (lambda n: n)
    dims = [_tp_dim(_path(path_of(n)), tuple(p.shape), rules, tp.size)
            for n, p in named]
    kinds = ["stored" if d is not None else None for d in dims]
    order_fns = {}
    for prefix, m in _providers(module):
        mine = [index[prefix + n] for n, _ in m.named_parameters()]
        if all(dims[i] is None for i in mine):
            continue
        leaves = {index[prefix + n]: v for n, v in
                  m.tensor_parallel_leaves(tp.size).items()}
        if all(dims[i] == d for i, (d, _) in leaves.items()):
            for i, (d, fn) in leaves.items():
                kinds[i] = "split"
                if fn is not None:
                    order_fns[i] = fn
            m.set_tensor_parallel(tp)
    layout = TPLayout(tp, [n for n, _ in named], dims, kinds, order_fns,
                      [tuple(p.shape) for _, p in named])
    with torch.no_grad():
        for i, (_, p) in enumerate(named):
            if dims[i] is not None:
                p.data = layout.local(i, p.data)
    return layout


def model_context(mesh):
    """The ``TPContext`` of ``mesh`` (a ``parallel.mesh.Mesh``), or None
    when its model axis is 1 wide."""
    size = mesh.shape.get("model", 1)
    if size <= 1:
        return None
    if mesh.mp_group is None:
        raise ValueError("a 'model' axis of size {} needs a process group "
                         "(torch.distributed)".format(size))
    return TPContext(mesh.mp_group, size, mesh.mp_rank)


__all__ = ["TPContext", "TPLayout", "apply_rules", "copy_to_model",
           "reduce_from_model", "gather_from_model", "model_context",
           "segmented", "serving_reduce", "shard_of"]
