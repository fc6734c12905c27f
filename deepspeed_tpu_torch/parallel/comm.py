"""The collectives ZeRO runs over a data group.

Calls over ``torch.distributed``: ``all_reduce`` (sum or mean),
``reduce_scatter`` (sum or mean of a flat buffer laid out as dp equal
chunks, rank r keeps chunk r), ``all_gather`` (every rank's equal flat
chunk, concatenated in rank order; any dtype, the 1-bit exchange's packed
uint8 signs among them), ``broadcast`` (from one rank, in place),
``all_to_all`` (the tiled exchange of ``jax.lax.all_to_all(...,
tiled=True)``: split along one dim, chunk j to rank j, the received chunks
concatenated along another) and ``ring_shift`` (``jax.lax.ppermute`` over
a ring: rank r's tensor to rank r + offset). Each takes and returns
contiguous tensors; ``runtime/zero/partition.py`` packs the leaves. The
tensor-parallel, sequence-parallel and pipeline collectives
(``parallel/tensor_parallel.py``, ``parallel/sequence_parallel.py``,
``runtime/pipe/engine.py``) and the 1-bit exchange
(``runtime/custom_collectives.py``) run over the same calls.

The backend decides the route, by name, never by a caught failure:

- ``nccl``: the native collectives on the tensors where they lie.
- ``gloo``: the tensors are staged through host memory by an explicit
  copy (gloo's collectives are host algorithms; the card runs two ranks on
  one device over gloo, since NCCL refuses two ranks on one device), and
  reduce-scatter is composed: an all-reduce of the whole buffer, then the
  rank's slice. All-gather uses gloo's list form. All-to-all is composed
  of an irecv from and an isend to every other rank (gloo has no
  all-to-all in every torch release), the ring shift of an irecv from the
  previous rank and an isend to the next.

``all_reduce_exchange`` sums a small tensor by point-to-point exchange
on gloo (counted as an all-reduce): the serving mesh's partials.

``stats`` counts the calls (in all and by kind) and the bytes each rank
hands to them, in all and by kind (the smoke's collective bytes per
step).
"""

import torch
import torch.distributed as dist

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast",
         "all_to_all", "ring_shift")
stats = {}


def reset_stats():
    stats.update(calls=0, bytes=0, **{k: 0 for k in KINDS})
    stats.update({k + "_bytes": 0 for k in KINDS})


reset_stats()


def _note(t, kind):
    n = t.numel() * t.element_size()
    stats["calls"] += 1
    stats[kind] += 1
    stats["bytes"] += n
    stats[kind + "_bytes"] += n


def buckets(sizes, cap):
    """Consecutive (start, end) runs over ``sizes`` (elements per item),
    each closed once it holds at least ``cap`` elements (and never empty):
    the flat buffers of ``reduce_bucket_size`` / ``allgather_bucket_size``
    / the engine's all-reduce bucket."""
    start = 0
    while start < len(sizes):
        end, total = start, 0
        while end < len(sizes) and (end == start or total < cap):
            total += sizes[end]
            end += 1
        yield start, end
        start = end


def _host(group, t):
    """True when ``t`` must be staged through the host for ``group``."""
    return dist.get_backend(group) == "gloo" and t.device.type != "cpu"


def _staged(t):
    """A copy of device tensor ``t`` in pinned host memory (PyTorch's
    caching host allocator keeps the buffers from call to call)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t, group, mean=False):
    """Sum (or mean) ``t`` over ``group`` in place; returns ``t``."""
    _note(t, "all_reduce")
    if _host(group, t):
        h = _staged(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    if mean:
        t.div_(dist.get_world_size(group))
    return t


def all_reduce_exchange(t, group):
    """Sum ``t`` over ``group`` in place by point-to-point exchange; returns
    ``t``. On gloo every rank sends its tensor to every other and adds what
    it holds in group-rank order, so every rank holds the same bits; the
    result goes back to a device tensor without a second wait (its staging
    buffer is pinned). For the latency-bound sums of serving over a model
    group: gloo's all-reduce of a small tensor costs several times one
    exchange. On nccl it is ``all_reduce``."""
    if dist.get_backend(group) != "gloo":
        return all_reduce(t, group)
    _note(t, "all_reduce")
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    host = _host(group, t)
    mine = _staged(t) if host else t
    parts = [mine if j == rank else torch.empty_like(mine)
             for j in range(world)]
    peers = [dist.get_global_rank(group, j) if group is not None else j
             for j in range(world)]
    works = [dist.irecv(parts[j], peers[j], group=group)
             for j in range(world) if j != rank]
    works += [dist.isend(mine, peers[j], group=group)
              for j in range(world) if j != rank]
    for work in works:
        work.wait()
    total = torch.empty(mine.shape, dtype=mine.dtype, pin_memory=host)
    total.copy_(parts[0])
    for part in parts[1:]:
        total.add_(part)
    t.copy_(total, non_blocking=host)
    return t


def reduce_scatter(flat, group, mean=False):
    """Chunk ``rank`` of the sum (or mean) of ``flat`` over ``group``;
    ``flat`` holds ``world`` equal chunks in rank order."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    per = flat.numel() // world
    _note(flat, "reduce_scatter")
    if dist.get_backend(group) == "gloo":
        h = _staged(flat) if flat.device.type != "cpu" else flat.clone()
        dist.all_reduce(h, group=group)
        out = h[rank * per:(rank + 1) * per].to(flat.device)
    else:
        out = torch.empty(per, dtype=flat.dtype, device=flat.device)
        dist.reduce_scatter_tensor(out, flat, group=group)
    if mean:
        out.div_(world)
    return out


def all_gather(chunk, group):
    """Every rank's ``chunk`` (equal sizes), concatenated in rank order."""
    world = dist.get_world_size(group)
    _note(chunk, "all_gather")
    if dist.get_backend(group) == "gloo":
        h = _staged(chunk) if chunk.device.type != "cpu" else chunk
        parts = [torch.empty_like(h) for _ in range(world)]
        dist.all_gather(parts, h, group=group)
        return torch.cat(parts).to(chunk.device)
    out = torch.empty(world * chunk.numel(), dtype=chunk.dtype,
                      device=chunk.device)
    dist.all_gather_into_tensor(out, chunk, group=group)
    return out


def broadcast(t, src, group):
    """``t`` on every rank of ``group`` from global rank ``src``, in place;
    returns ``t``."""
    _note(t, "broadcast")
    if _host(group, t):
        h = _staged(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_to_all(t, group, split_dim, concat_dim):
    """The tiled all-to-all over ``group``: ``t`` split into ``world``
    equal chunks along ``split_dim``, chunk j sent to group rank j, and the
    chunks received concatenated along ``concat_dim`` in rank order."""
    world = dist.get_world_size(group)
    if t.shape[split_dim] % world:
        raise ValueError("all_to_all: dim {} of shape {} is not divisible "
                         "by {} ranks".format(split_dim, tuple(t.shape),
                                              world))
    _note(t, "all_to_all")
    host = _host(group, t)
    sends = [_staged(c) if host else c.contiguous()
             for c in t.chunk(world, dim=split_dim)]
    recvs = [torch.empty_like(c) for c in sends]
    if dist.get_backend(group) == "gloo":
        rank = dist.get_rank(group)
        recvs[rank] = sends[rank]
        peers = [dist.get_global_rank(group, j) for j in range(world)]
        works = [dist.irecv(recvs[j], peers[j], group=group)
                 for j in range(world) if j != rank]
        works += [dist.isend(sends[j], peers[j], group=group)
                  for j in range(world) if j != rank]
        for work in works:
            work.wait()
    else:
        dist.all_to_all(recvs, sends, group=group)
    return torch.cat([r.to(t.device) for r in recvs], dim=concat_dim)


def ring_shift(t, group, offset=1):
    """``t`` of group rank r delivered to group rank (r + offset) mod world;
    returns what this rank receives (from rank - offset). At one rank it
    returns ``t``."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    rank = dist.get_rank(group)
    _note(t, "ring_shift")
    dst = dist.get_global_rank(group, (rank + offset) % world)
    src = dist.get_global_rank(group, (rank - offset) % world)
    host = _host(group, t)
    send = _staged(t) if host else t.contiguous()
    recv = torch.empty_like(send)
    if dist.get_backend(group) == "nccl":
        for work in dist.batch_isend_irecv(
                [dist.P2POp(dist.irecv, recv, src, group),
                 dist.P2POp(dist.isend, send, dst, group)]):
            work.wait()
    else:
        works = [dist.irecv(recv, src, group=group),
                 dist.isend(send, dst, group=group)]
        for work in works:
            work.wait()
    return recv.to(t.device) if host else recv


def all_gather_object(obj, group):
    """Every rank's picklable ``obj``, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
