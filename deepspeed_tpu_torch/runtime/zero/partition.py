"""ZeRO stages 1-3 partitioned over the ranks of a data group.

The JAX engine expresses each stage as a sharding of its parameter tree
over the mesh's 'data' axis (``parallel/mesh.py`` ``zero_shardings``) and
lets GSPMD place the collectives. Here the same per-leaf partition
(``mesh.zero_partition_dim``: a leaf's first dim of size >= dp that dp
divides; a leaf with none stays replicated) is held by ``ZeroPartition``
and the collectives are explicit (``parallel/comm.py``):

- Stage 1: each rank keeps the fp32 master and the optimizer moments of
  its shards only. The module's parameters hold the compute-dtype copy.
  At the accumulation boundary the full fp32 gradients are all-reduced;
  each rank updates its shards, then the compute-dtype parameters are
  all-gathered.
- Stage 2: in addition, the gradients are reduce-scattered in the
  backward: a post-accumulate hook on each parameter takes its gradient as
  soon as it is final and frees it. Between boundaries it adds into an fp32
  accumulator; in the boundary's backward the accumulated gradient goes
  into a bucket that is reduce-scattered when it holds
  ``reduce_bucket_size`` elements (and at the end of the backward), and
  only the rank's shard is kept.
- Stage 3: in addition, the parameters are partitioned: the module holds
  an empty tensor for each partitioned leaf except while a unit uses it.
  A unit is one of the model's blocks (``model.blocks()`` or the elements
  of its ModuleLists); the root unit is every other parameter. A forward
  pre-hook gathers a unit and a forward hook frees it again; the block's
  output passes through an identity autograd function whose backward
  gathers the unit again before the block's backward runs, and the unit is
  freed once each of its parameters' gradients has been taken. The root
  unit stays gathered from the forward to the end of the backward.
  ``gathers`` counts the unit gathers.

Under tensor parallelism the leaves are the rank's model shards, and a
leaf's ZeRO dim skips the dim a rule put on 'model' (``skip_dims``; the
JAX ``zero_shardings`` composition): ZeRO-3 x TP leaves each rank
1/(mp dp) of a sharded leaf.

Replicated leaves are all-reduced whole, kept whole on every rank and
updated alike everywhere. A partitioned leaf's shard on a dim other than
0 is strided: it is moved to dim 0 (a copy) before it enters a flat
bucket, so the per-rank ownership stays the JAX package's and its elastic
checkpoints load across the packages.

The gradients of the leaves in ``sparse`` (embedding tables under
``sparse_gradients``) are not reduced in the backward: the engine
exchanges them as (row, value) pairs at the boundary (``take_sparse``).
"""

import weakref

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel import comm
from deepspeed_tpu_torch.parallel.mesh import shard_slice, zero_partition_dim


def _blocks(module):
    """The stage-3 units of ``module`` other than its root: ``blocks()``
    where the model has it, else the elements of its ModuleLists."""
    if callable(getattr(module, "blocks", None)):
        return module.blocks()
    return [m for lst in module.modules()
            if isinstance(lst, torch.nn.ModuleList) for m in lst]


class _Regather(torch.autograd.Function):
    """Identity on a block's output; its backward gathers the block's
    parameters before the block's own backward runs."""

    @staticmethod
    def forward(ctx, part, unit, x):
        ctx.part, ctx.unit = part, unit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.part.gather(ctx.unit)
        return None, None, grad


def _pack(grads, idx, dims, rows, seq_group):
    """One fp32 buffer [rows, n] of the gradients ``grads[i]``, ``i`` in
    ``idx`` (with ``rows`` > 1 each leaf's partition dim moved to the
    front, rank r's shard in row r), widened by the copy; each entry of
    ``grads`` is set to None (freed) once copied. Under sequence
    parallelism (``seq_group``) the mean over the token shards first."""
    sizes = [grads[i].numel() // rows for i in idx]
    flat = torch.empty(rows, sum(sizes), dtype=torch.float32,
                       device=grads[idx[0]].device)
    off = 0
    for i, n in zip(idx, sizes):
        d = dims[i] if rows > 1 else None
        flat[:, off:off + n].copy_(
            ZeroPartition._rows(grads[i], d).reshape(rows, -1))
        grads[i] = None
        off += n
    if seq_group is not None:
        comm.all_reduce(flat, seq_group, mean=True)
    return flat


def reduce_mean(grads, idx, dims, shapes, group, seq_group=None):
    """{i: the group's fp32 mean of ``grads[i]``} for the leaves ``idx`` of
    full ``shapes``: one reduce-scatter of those partitioned on ``dims``
    (their shards moved to dim 0 and packed rank by rank; the rank's shard
    is kept), one all-reduce of those whose dim is None (kept whole).
    ``seq_group`` and the freeing of ``grads`` as ``_pack``."""
    dp = dist.get_world_size(group)
    out = {}
    shard_idx = [i for i in idx if dims[i] is not None]
    whole_idx = [i for i in idx if dims[i] is None]
    if shard_idx:
        flat = _pack(grads, shard_idx, dims, dp, seq_group)
        red = comm.reduce_scatter(flat.view(-1), group, mean=True)
        del flat
        off = 0
        for i in shard_idx:
            shape = list(shapes[i])
            d = dims[i]
            shape[d] //= dp
            moved = [shape[d]] + shape[:d] + shape[d + 1:]
            n = torch.Size(shape).numel()
            out[i] = red[off:off + n].reshape(moved).movedim(
                0, d).contiguous()
            off += n
    if whole_idx:
        red = comm.all_reduce(
            _pack(grads, whole_idx, dims, 1, seq_group).view(-1), group,
            mean=True)
        off = 0
        for i in whole_idx:
            n = torch.Size(shapes[i]).numel()
            out[i] = red[off:off + n].view(shapes[i])
            off += n
    return out


def gather_full(shards, idx, dims, shapes, group, bucket):
    """{i: the full tensor of leaf i} for the partitioned leaves ``idx`` (of
    full ``shapes``, partitioned on ``dims``) from every rank's ``shards``:
    each shard's partition dim moved to the front, one all-gather per
    bucket of ``bucket`` elements."""
    dp = dist.get_world_size(group)
    out = {}
    for start, end in comm.buckets([shards[i].numel() * dp for i in idx],
                                   bucket):
        chunk = idx[start:end]
        parts = [ZeroPartition._rows(shards[i], dims[i]).reshape(-1)
                 for i in chunk]
        flat = comm.all_gather(torch.cat(parts), group).view(dp, -1)
        off = 0
        for i, part in zip(chunk, parts):
            n = part.numel()
            d = dims[i]
            shape = list(shapes[i])
            moved = [shape[d]] + shape[:d] + shape[d + 1:]
            out[i] = flat[:, off:off + n].reshape(moved).movedim(0, d)
            off += n
    return out


class ZeroPartition(object):
    """The partitioned state of one engine (module docstring). ``params``
    are the module's parameters (fp32 on entry); ``sparse`` the indices of
    the leaves the engine exchanges as (row, value) pairs; ``skip_dims``
    per leaf the dim its ZeRO partition must not take (or None);
    ``seq_group`` the seq line whose mean the gradients take before their
    reduction over the data group (sequence parallelism)."""

    def __init__(self, module, params, stage, group, compute_dtype,
                 reduce_bucket_size, allgather_bucket_size, sparse=(),
                 skip_dims=None, seq_group=None):
        self.module = module
        self.seq_group = seq_group
        self.params = list(params)
        self.stage = stage
        self.group = group
        self.dp = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.compute_dtype = compute_dtype
        self.reduce_bucket = int(reduce_bucket_size)
        self.gather_bucket = int(allgather_bucket_size)
        self.sparse = set(sparse)
        self.shapes = [tuple(p.shape) for p in self.params]
        skip_dims = skip_dims or [None] * len(self.params)
        self.dims = [zero_partition_dim(s, self.dp, skip)
                     for s, skip in zip(self.shapes, skip_dims)]
        self.master = [shard_slice(p.detach().float(), d, self.rank,
                                   self.dp).clone()
                       for p, d in zip(self.params, self.dims)]
        # The local gradient: fp32 across an accumulation window, the
        # compute dtype for a window's only micro-step.
        self.acc = [None] * len(self.params)
        self.grad = [None] * len(self.params)  # reduced: shard or whole
        self._bucket = []
        self.boundary = False
        self.gathers = 0
        self.suspended = False  # hooks off (the engine's reference run)
        self.param_shards = None
        self._gathered = set()
        self._pending = {}
        with torch.no_grad():
            if stage >= 3:
                self.param_shards = [m.to(compute_dtype) for m in self.master]
                for p, d, m in zip(self.params, self.dims, self.master):
                    p.data = self._empty(p) if d is not None else \
                        m.to(compute_dtype)
            else:
                for p in self.params:
                    p.data = p.data.to(compute_dtype)
        for i, p in enumerate(self.params):
            p.register_post_accumulate_grad_hook(self._hook(i))
        self._unit_of = {}
        self.units = []
        if stage >= 3:
            self._setup_units()

    # ------------------------------------------------------------ layout

    def _empty(self, p):
        return torch.empty(0, dtype=self.compute_dtype, device=p.device)

    def owned(self, i):
        """True when leaf ``i`` is partitioned (this rank holds a shard)."""
        return self.dims[i] is not None

    @staticmethod
    def _rows(t, d):
        """``t`` with dim ``d`` moved to the front, contiguous."""
        return t.movedim(d, 0).contiguous() if d else t.contiguous()

    # ---------------------------------------------------------- gradients

    def _hook(self, i):
        # Through a weak reference: a parameter's hook lives in C++, where
        # the cycle collector cannot see a cycle back to the parameters, so
        # a strong one would keep a dropped engine's partition alive.
        ref = weakref.ref(self)

        def hook(p):
            self = ref()
            if self is None:
                return
            g, p.grad = p.grad, None
            if self.acc[i] is not None:
                self.acc[i].add_(g)
            elif self.boundary:
                # The window's only or last gradient: kept in the compute
                # dtype until its bucket widens it (exactly) into fp32.
                self.acc[i] = g
            else:
                self.acc[i] = g.float()
            if self.stage >= 2 and self.boundary and i not in self.sparse:
                self._bucket.append(i)
                if sum(self.acc[j].numel() for j in self._bucket) >= \
                        self.reduce_bucket:
                    self.flush()
            if self.stage >= 3:
                unit = self._unit_of.get(i)
                if unit is not None:
                    self._pending[unit] -= 1
                    if self._pending[unit] == 0:
                        self.release(unit)
        return hook

    def flush(self):
        """Reduce the bucketed gradients (``reduce_mean``): one
        reduce-scatter of the partitioned leaves, one all-reduce of the
        replicated ones; the mean over the group is kept (the shard, or the
        whole replicated leaf)."""
        idx, self._bucket = self._bucket, []
        for i, g in reduce_mean(self.acc, idx, self.dims, self.shapes,
                                self.group, self.seq_group).items():
            self.grad[i] = g

    def end_backward(self):
        """After a backward: at the boundary (stage >= 2) reduce what the
        bucket still holds and any accumulated gradient whose leaf got none
        in this backward; free every unit still gathered (stage 3)."""
        if self.stage >= 2 and self.boundary:
            self._bucket += [i for i, a in enumerate(self.acc)
                             if a is not None and i not in self.sparse and
                             i not in self._bucket]
        if self._bucket:
            self.flush()
        if self.stage >= 3:
            for unit in list(self._gathered):
                self.release(unit)

    def reduce_all(self):
        """At the boundary, stage 1: all-reduce the accumulated full
        gradients (buckets of ``reduce_bucket_size`` elements) and keep
        the mean."""
        idx = [i for i in range(len(self.params))
               if i not in self.sparse and self.grad[i] is None]
        whole = [None] * len(self.params)
        for start, end in comm.buckets([self._acc(i).numel() for i in idx],
                                       self.reduce_bucket):
            for i, g in reduce_mean(self.acc, idx[start:end], whole,
                                    self.shapes, self.group,
                                    self.seq_group).items():
                self.grad[i] = g

    def _acc(self, i):
        """The local accumulated gradient of leaf ``i`` (zeros for a leaf
        that got none)."""
        if self.acc[i] is None:
            self.acc[i] = torch.zeros(self.shapes[i], dtype=torch.float32,
                                      device=self.master[i].device)
        return self.acc[i]

    def take_sparse(self, i):
        """The local accumulated (unreduced) gradient of sparse leaf ``i``;
        the engine exchanges it and hands the mean to ``set_reduced``."""
        g = self._acc(i).float()
        self.acc[i] = None
        return g

    def set_reduced(self, i, full):
        """Keep the group mean ``full`` of leaf ``i``: its shard from stage
        2, whole at stage 1."""
        self.grad[i] = shard_slice(full, self.dims[i], self.rank,
                                   self.dp).contiguous() \
            if self.stage >= 2 else full

    def grad_shards(self):
        """Each leaf's reduced gradient as the rank's shard (fp32); a leaf
        that got no gradient gives zeros."""
        out = []
        for i in range(len(self.params)):
            g = self.grad[i]
            if g is None:
                g = torch.zeros_like(self.master[i])
            elif tuple(g.shape) == self.shapes[i]:
                g = shard_slice(g, self.dims[i], self.rank, self.dp)
            out.append(g)
        return out

    def clear_grads(self):
        self.grad = [None] * len(self.params)
        self.acc = [None] * len(self.params)
        self._bucket = []

    # --------------------------------------------------------- parameters

    def _gather_full(self, idx, shards):
        """Full tensors of the partitioned leaves ``idx`` from every rank's
        ``shards`` (one all-gather per bucket of ``allgather_bucket_size``
        elements)."""
        return gather_full(shards, idx, self.dims, self.shapes, self.group,
                           self.gather_bucket)

    @torch.no_grad()
    def publish(self):
        """After an update: the module's parameters from the masters (an
        all-gather of the compute-dtype shards at stages 1-2; stage 3 keeps
        its shards)."""
        if self.stage >= 3:
            for i, m in enumerate(self.master):
                self.param_shards[i].copy_(m)
                if not self.owned(i):
                    self.params[i].data.copy_(m)
            return
        shards = [m.to(self.compute_dtype) for m in self.master]
        idx = [i for i in range(len(self.params)) if self.owned(i)]
        full = self._gather_full(idx, shards)
        for i, p in enumerate(self.params):
            p.data.copy_(full[i] if i in full else shards[i])

    def full_masters(self):
        """Every leaf's full fp32 master (all ranks must call it)."""
        idx = [i for i in range(len(self.params)) if self.owned(i)]
        full = self._gather_full(idx, self.master)
        return [full[i].contiguous() if i in full else m
                for i, m in enumerate(self.master)]

    def gather_states(self, states):
        """Full tensors from per-leaf shards ``states`` (fp32, e.g. a
        moment list)."""
        idx = [i for i in range(len(self.params)) if self.owned(i)]
        full = self._gather_full(idx, states)
        return [full[i].contiguous() if i in full else s
                for i, s in enumerate(states)]

    @torch.no_grad()
    def load_full(self, fulls):
        """Set masters (and the module's parameters) from full fp32
        tensors, each rank slicing its shards."""
        for i, full in enumerate(fulls):
            full = full.to(self.master[i].device, torch.float32)
            self.master[i].copy_(shard_slice(full, self.dims[i], self.rank,
                                             self.dp))
        if self.stage >= 3:
            self.publish()
        else:
            for p, full in zip(self.params, fulls):
                p.data.copy_(full.to(p.device, self.compute_dtype))

    def shard_of(self, i, full):
        """Leaf ``i``'s shard of the full tensor ``full`` (a copy)."""
        return shard_slice(full, self.dims[i], self.rank, self.dp).clone()

    # ----------------------------------------------------- stage-3 units

    def _setup_units(self):
        index = {id(p): i for i, p in enumerate(self.params)}
        in_block = set()
        for block in _blocks(self.module):
            unit = [index[id(p)] for p in block.parameters()
                    if id(p) in index]
            u = len(self.units)
            self.units.append(unit)
            for i in unit:
                self._unit_of[i] = u
                in_block.add(i)
            block.register_forward_pre_hook(self._pre(u))
            block.register_forward_hook(self._post(u))
        self.root = len(self.units)
        self.units.append([i for i in range(len(self.params))
                           if i not in in_block])
        self.module.register_forward_pre_hook(self._pre(self.root))
        self.module.register_forward_hook(self._root_post)

    def _pre(self, unit):
        def hook(module, args):
            if not self.suspended:
                self.gather(unit)
        return hook

    def _post(self, unit):
        def hook(module, args, out):
            if self.suspended:
                return out
            self.release(unit)
            if torch.is_grad_enabled() and isinstance(out, torch.Tensor) \
                    and out.requires_grad:
                return _Regather.apply(self, unit, out)
            return out
        return hook

    def _root_post(self, module, args, out):
        if not torch.is_grad_enabled() and not self.suspended:
            self.release(self.root)

    @torch.no_grad()
    def gather(self, unit):
        """Gather ``unit``'s partitioned parameters into the module (a
        no-op when they are gathered)."""
        if unit in self._gathered:
            return
        idx = [i for i in self.units[unit] if self.owned(i)]
        full = self._gather_full(idx, self.param_shards)
        for i in idx:
            self.params[i].data = full[i].contiguous()
        self._gathered.add(unit)
        self._pending[unit] = sum(1 for i in self.units[unit]
                                  if self.params[i].requires_grad)
        self.gathers += 1

    def release(self, unit):
        """Free ``unit``'s gathered parameters."""
        if unit not in self._gathered:
            return
        for i in self.units[unit]:
            if self.owned(i):
                self.params[i].data = self._empty(self.params[i])
        self._gathered.discard(unit)
