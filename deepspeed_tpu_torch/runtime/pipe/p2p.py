"""Point-to-point transfers between adjacent pipeline stages.

Counterpart of the JAX package's ``runtime/pipe/p2p.py``, with its call
surface (``init_process_groups(grid)``, ``send``, ``recv``, ``barrier``)
and its adjacency check. The JAX module moves arrays between one
controller's devices; here each stage is its own process, and a transfer
is a ``torch.distributed`` send and receive between the two ranks, in the
grid's process group of the pair (``PipelineParallelGrid.p2p_group``).

The backend decides the route, by name: on ``gloo`` a CUDA tensor is
staged through pinned host memory (gloo sends host buffers; the card's
two-ranks-on-one-device runs use gloo), on ``nccl`` it is sent where it
lies. ``send_meta`` / ``recv_meta`` carry a list of shapes and dtypes as
one small int64 message, so the receiver can allocate its buffers.
``stats`` counts the sends, the receives and their bytes, and the sends
by edge (``edges``: {(source stage, destination stage): sends}).
"""

import torch
import torch.distributed as dist

_grid = None
stats = {}

# dtypes a meta message can name, by code.
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool, torch.uint8)


def reset_stats():
    stats.update(sends=0, recvs=0, send_bytes=0, recv_bytes=0, edges={})


reset_stats()


def init_process_groups(grid):
    """Register the pipeline grid (whose pair groups the transfers use)."""
    global _grid
    _grid = grid
    assert _grid.pipe_parallel_size > 1, "There is no pipeline parallelism"


def _is_valid_send_recv(src_stage, dest_stage):
    first_stage = 0
    last_stage = _grid.pipe_parallel_size - 1
    assert abs(src_stage - dest_stage) == 1 or \
        (src_stage == first_stage and dest_stage == last_stage) or \
        (src_stage == last_stage and dest_stage == first_stage), \
        "Functionality currently limited to send and receive between " \
        "adjacent ranks only"


def _peer(stage):
    """(global rank of ``stage`` on this rank's pipe line, pair group)."""
    rank = _grid.stage_to_global(stage_id=stage)
    return rank, _grid.p2p_group(rank)


def _staged(group, t):
    return dist.get_backend(group) == "gloo" and t.device.type != "cpu"


def send(tensor, dest_stage, async_op=False):
    """Send ``tensor`` to ``dest_stage`` (an adjacent stage); blocks until
    it is handed over."""
    src_stage = _grid.get_stage_id()
    _is_valid_send_recv(src_stage, dest_stage)
    rank, group = _peer(dest_stage)
    t = tensor.contiguous()
    if _staged(group, t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        t = h
    stats["sends"] += 1
    stats["send_bytes"] += t.numel() * t.element_size()
    edge = (src_stage, dest_stage)
    stats["edges"][edge] = stats["edges"].get(edge, 0) + 1
    dist.send(t, rank, group=group)


def recv(tensor, src_stage, async_op=False):
    """Receive into ``tensor`` (the preallocated buffer) from
    ``src_stage`` (an adjacent stage); returns it."""
    dest_stage = _grid.get_stage_id()
    _is_valid_send_recv(src_stage, dest_stage)
    rank, group = _peer(src_stage)
    if _staged(group, tensor):
        h = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        dist.recv(h, rank, group=group)
        tensor.copy_(h)
    else:
        dist.recv(tensor, rank, group=group)
    stats["recvs"] += 1
    stats["recv_bytes"] += tensor.numel() * tensor.element_size()
    return tensor


def barrier(stage_id):
    """Wait for ``stage_id``'s rank (the pair's group barrier)."""
    _is_valid_send_recv(_grid.get_stage_id(), stage_id)
    dist.barrier(group=_peer(stage_id)[1])


def _meta_device(stage):
    group = _peer(stage)[1]
    return torch.device("cpu") if dist.get_backend(group) == "gloo" else \
        torch.device("cuda", torch.cuda.current_device())


def send_meta(tensors, dest_stage):
    """Send the shapes and dtypes of ``tensors`` (a list) to
    ``dest_stage``: a length, then the message [n, (dtype, ndim, *shape)
    per tensor]."""
    msg = [len(tensors)]
    for t in tensors:
        msg += [_DTYPES.index(t.dtype), t.dim()] + list(t.shape)
    dev = _meta_device(dest_stage)
    send(torch.tensor([len(msg)], dtype=torch.int64, device=dev), dest_stage)
    send(torch.tensor(msg, dtype=torch.int64, device=dev), dest_stage)


def recv_meta(src_stage):
    """The [(shape, dtype), ...] that ``send_meta`` sent from
    ``src_stage``."""
    dev = _meta_device(src_stage)
    n = recv(torch.empty(1, dtype=torch.int64, device=dev), src_stage)
    msg = recv(torch.empty(int(n), dtype=torch.int64, device=dev),
               src_stage).tolist()
    out, pos = [], 1
    for _ in range(msg[0]):
        dtype, ndim = _DTYPES[msg[pos]], msg[pos + 1]
        out.append((tuple(msg[pos + 2:pos + 2 + ndim]), dtype))
        pos += 2 + ndim
    return out
