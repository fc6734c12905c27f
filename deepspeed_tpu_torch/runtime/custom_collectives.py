"""The compressed collectives of 1-bit Adam.

Counterpart of ``deepspeed_tpu/runtime/custom_collectives.py``: the same
error-compensated 1-bit all-reduce (the reference's Compressed_Allreduce),
over ``torch.distributed`` through ``parallel/comm.py``. Signs are packed
eight to a uint8 word (``pack_signs``, big-endian in the byte as numpy's
``packbits``), so a worker hands n/8 bytes and one fp32 scale per phase:

- phase 1: each worker's compensated buffer is quantized to (scale,
  signs); an all-to-all of the packed signs leaves worker r holding chunk r
  of every worker, and an all-gather gives everyone every worker's scale;
- the server step: worker r averages its chunk over the workers, adds its
  server error, and quantizes the result again;
- phase 2: an all-gather of the server chunks' packed signs and scales
  rebuilds the averaged buffer, the same on every worker.

``compressed_allreduce_many`` runs the exchange for several buffers at
once: each buffer is quantized and averaged on its own (the JAX function,
leaf by leaf), but their packed signs and scales travel in one all-to-all
and three all-gathers. ``quantize_error_feedback`` is the one-party form
(the exchange of identical workers).
"""

import math

import torch

from deepspeed_tpu_torch.parallel import comm

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_signs(x):
    """The sign bits of ``x`` (>= 0 -> 1, < 0 -> 0) packed into uint8 words:
    ``[n]`` float with n % 8 == 0 -> uint8 ``[n / 8]``, the first element
    in the high bit (numpy ``packbits``)."""
    bits = (x >= 0).to(torch.uint8).view(-1, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=x.device)
    return (bits * weights).sum(dim=1, dtype=torch.uint8)


def unpack_signs(packed):
    """uint8 ``[..., m]`` -> float32 ``[..., m * 8]`` of +-1."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    return (bits.float() * 2.0 - 1.0).reshape(*packed.shape[:-1], -1)


def corrected_size(n, world_size):
    """``n`` rounded up to a multiple of 8 x ``world_size`` (each worker's
    chunk a whole number of packed bytes): the JAX package's minimal
    padding."""
    block = world_size * 8
    if n % block:
        n += block - (n % block)
    return n


def _quantize(x):
    """(scale, sign) of ``x``: scale = ||x|| / sqrt(n), sign in {-1, +1}."""
    scale = torch.linalg.vector_norm(x) / math.sqrt(x.numel())
    return scale, torch.where(x >= 0, 1.0, -1.0)


def quantize_error_feedback(buffer, error):
    """One-party 1-bit quantization with error feedback: (scale * sign of
    ``buffer + error``, the new error)."""
    compensated = buffer + error
    scale, sign = _quantize(compensated)
    return scale * sign, compensated - scale * sign


def compressed_allreduce_many(buffers, worker_errors, server_errors, group):
    """The exchange (module docstring) of each flat fp32 buffer over
    ``group``: ``buffers[i]`` ``[n_i]`` with n_i a multiple of 8 x world,
    ``worker_errors[i]`` ``[n_i]``, ``server_errors[i]`` ``[n_i / world]``.
    Returns (averaged buffers, new worker errors, new server errors), the
    averages the same on every rank."""
    w = torch.distributed.get_world_size(group)
    chunks = [b.numel() // w for b in buffers]
    signs, scales, new_we = [], [], []
    for b, we in zip(buffers, worker_errors):
        comp = b + we
        scale, sign = _quantize(comp)
        new_we.append(comp - scale * sign)
        signs.append(pack_signs(sign).view(w, -1))
        scales.append(scale)
    # Phase 1: worker r receives chunk r of every worker, and every scale.
    recv = comm.all_to_all(torch.cat(signs, dim=1), group, 0, 0)
    all_scales = comm.all_gather(torch.stack(scales).float(), group).view(
        w, -1)
    server_signs, server_scales, new_se = [], [], []
    off = 0
    for i, (c, se) in enumerate(zip(chunks, server_errors)):
        got = unpack_signs(recv[:, off:off + c // 8])  # [w, c]
        off += c // 8
        server_m = (got * all_scales[:, i:i + 1]).mean(dim=0) + se
        scale, sign = _quantize(server_m)
        new_se.append(server_m - scale * sign)
        server_signs.append(pack_signs(sign))
        server_scales.append(scale)
    # Phase 2: every worker's server chunk, signs and scale.
    gathered = comm.all_gather(torch.cat(server_signs), group).view(w, -1)
    gscales = comm.all_gather(torch.stack(server_scales).float(),
                              group).view(w, -1)
    outs, off = [], 0
    for i, c in enumerate(chunks):
        part = unpack_signs(gathered[:, off:off + c // 8])
        off += c // 8
        outs.append((part * gscales[:, i:i + 1]).reshape(-1))
    return outs, new_we, new_se


def compressed_allreduce(buffer, worker_error, server_error, group):
    """``compressed_allreduce_many`` of one buffer: (averaged ``[n]``, new
    worker error ``[n]``, new server error ``[n / world]``)."""
    out, we, se = compressed_allreduce_many([buffer], [worker_error],
                                            [server_error], group)
    return out[0], we[0], se[0]
