"""Slotted KV-cache pool: fixed-shape state for continuous batching.

Counterpart of ``deepspeed_tpu/inference/kv_pool.py``: the dense and the
paged layouts, with fp or int8 planes. Per-slot state, all on the device:

- ``pos``        row frontier (int32): where the next k/v write lands;
- ``last_tok``   the token sitting at the frontier (the decode input);
- ``active``     slot is mid-generation; inactive slots still flow through
                 the decode lane but are frozen (pos pinned, emissions
                 masked);
- ``remaining``  new tokens the request may still emit;
- ``eos``        per-request EOS id (-1: none);
- ``temp`` / ``top_k`` / ``seed``  per-request sampling parameters.

The DENSE layout holds one ``[layers, slots, heads, plane_len, head_dim]``
k/v pair. The PAGED layout (``page_len > 0``) holds a shared page arena
``[layers, P, heads, page_len, head_dim]`` (physical page 0 is the trash
page, ``inference/paging.py``) and an int32 ``block_tbl`` ``[slots,
plane_len / page_len]`` naming the arena page behind each slot's logical
page; the table is host-owned (``PageAllocator``) and the device only reads
it. Under an int8 hierarchy (``hier.int8``) the k/v planes or arenas hold
int8 codes and the pool gains fp32 ``k_scale``/``v_scale`` planes of the
same shape without the head dimension, written by the same frontier writes
as the codes.

Stale-cache rule: a freed slot's k/v are never cleared. A later request
writes position ``p`` before any query's mask (``k_pos <= q_pos``) can
reach it, so stale keys are overwritten or masked, never attended. In the
paged layout a freed row's table points at the trash page, so its frozen
frontier writes land there.

``plane_len`` is ``max_len`` plus ``slack`` (the engine passes
``prefill_chunk``): an append of up to ``prefill_chunk`` positions from any
admissible frontier stays in bounds, so the frontier write never has to
clamp. Unlike the TPU pool, the plane is not padded to a block quantum: the
CUDA kernels take any length. A paged row's logical plane is that length
rounded up to whole pages.

In torch the views below alias the pool's own planes: the forward writes
k/v in place, so folding a cache back into the pool only rebinds names.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.device import resolve_device

# Per-slot fields: (name, dtype, initial value).
_SLOT_FIELDS = (
    ("pos", torch.int32, 0),
    ("last_tok", torch.int64, 0),
    ("active", torch.bool, False),
    ("remaining", torch.int32, 0),
    ("eos", torch.int64, -1),
    ("temp", torch.float32, 0.0),
    ("top_k", torch.int32, 0),
    ("seed", torch.int64, 0),
)

# Fields the host reads at every harvest.
_HARVEST = ("pos", "active", "last_tok")


def plane_len_for(max_len, slack=0):
    """Cache-plane length serving ``max_len`` positions with ``slack``
    inert positions past the last admissible frontier."""
    return max_len + slack


def paged_plane_len(max_len, slack, page_len):
    """Logical plane length of one paged row: the dense plane length
    rounded UP to a whole number of pages, so the gathered logical plane
    covers every dense position (the round-up tail is inert, like the
    slack)."""
    plane_len = plane_len_for(max_len, slack)
    return -(-plane_len // page_len) * page_len


def init_pool(gcfg, num_slots, max_len, dtype=None, slack=0, device=None,
              hier=None, page_len=0, num_pages=None):
    """Zeroed pool dict for ``num_slots`` sequences of up to ``max_len``
    positions under generation config ``gcfg``
    (``models.generation.as_gencfg``), on ``device`` (default ``cuda``;
    without a GPU it raises unless ``device="cpu"`` is passed).

    ``hier`` (a ``kv_hierarchy.HierarchySpec``, or None for the flat pool):
    under ``hier.int8`` the planes hold int8 codes and the pool gains fp32
    ``k_scale``/``v_scale`` planes. ``page_len > 0`` selects the paged
    layout: an arena of ``num_pages`` usable pages (None: as many as
    ``num_slots`` full rows need) plus the trash page, and a zeroed
    ``block_tbl`` (every row on the trash page)."""
    dtype = dtype or gcfg.dtype
    device = resolve_device(device)
    hd = gcfg.n_embd // gcfg.n_head
    int8 = hier is not None and hier.int8
    kv_dtype = torch.int8 if int8 else dtype
    pool = {}
    if page_len:
        n_lp = paged_plane_len(max_len, slack, page_len) // page_len
        usable = num_pages if num_pages is not None else num_slots * n_lp
        shape = (gcfg.n_layer, usable + 1, gcfg.n_head, page_len, hd)
        pool["block_tbl"] = torch.zeros((num_slots, n_lp), dtype=torch.int32,
                                        device=device)
    else:
        shape = (gcfg.n_layer, num_slots, gcfg.n_head,
                 plane_len_for(max_len, slack), hd)
    pool["k"] = torch.zeros(shape, dtype=kv_dtype, device=device)
    pool["v"] = torch.zeros(shape, dtype=kv_dtype, device=device)
    if int8:
        pool["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    for name, dt, fill in _SLOT_FIELDS:
        pool[name] = torch.full((num_slots,), fill, dtype=dt, device=device)
    return pool


def harvest_snapshot(pool, **extra):
    """ONE device-to-host transfer of the per-slot fields the host reads
    (``pos`` / ``active`` / ``last_tok``) plus any ``extra`` integer or
    bool tensors (the engine passes the step's tokens and validity). All
    are packed into one int64 buffer and copied once. Returns a dict of
    numpy arrays in their original shapes (bool stays bool)."""
    named = [(n, pool[n]) for n in _HARVEST] + list(extra.items())
    flat = torch.cat([t.reshape(-1).to(torch.int64) for _, t in named])
    host = flat.cpu().numpy()
    snap, at = {}, 0
    for name, t in named:
        n = t.numel()
        arr = host[at:at + n].reshape(tuple(t.shape))
        snap[name] = arr.astype(bool) if t.dtype == torch.bool else arr
        at += n
    return snap


def max_active_frontier(snap):
    """Largest frontier among active slots, from a ``harvest_snapshot``."""
    pos, active = snap["pos"], snap["active"]
    return int((pos * active).max()) if pos.size else 0


def free_slots(snap):
    """Indices of inactive slots, from a ``harvest_snapshot``."""
    return [int(i) for i in np.flatnonzero(~snap["active"])]


def pool_nbytes(pool):
    """Device bytes held by the pool: the k/v planes dominate; the scale
    planes, the block table and the per-slot fields count too."""
    return int(sum(t.numel() * t.element_size() for t in pool.values()))


_SCALES = ("k_scale", "v_scale")


def cache_view(pool):
    """The pool as a ``models.generation`` cache dict: every slot is a
    batch row. ``k``/``v`` (and the scale planes) are the pool's own
    tensors; a paged pool passes its arenas whole with the block table."""
    cache = {"k": pool["k"], "v": pool["v"], "pos": pool["pos"]}
    for name in _SCALES + ("block_tbl",):
        if name in pool:
            cache[name] = pool[name]
    return cache


def slot_cache_view(pool, slot, pos):
    """One slot as a batch-1 cache dict for the prefill lane. ``slot`` is a
    host int; ``pos`` is the [1]-shaped int32 frontier. Dense: ``k``/``v``
    (and scales) are VIEWS of the pool along the slot axis (``[layers, 1,
    heads, T, head_dim]``), so the forward's frontier write updates the
    pool in place. Paged: the arenas whole and the slot's row of the block
    table (``[1, n_lp]``), through which the forward scatters its
    writes."""
    if "block_tbl" in pool:
        cache = {"k": pool["k"], "v": pool["v"], "pos": pos,
                 "block_tbl": pool["block_tbl"][slot:slot + 1]}
        for name in _SCALES:
            if name in pool:
                cache[name] = pool[name]
        return cache
    cache = {"pos": pos}
    for name in ("k", "v") + _SCALES:
        if name in pool:
            cache[name] = pool[name][:, slot:slot + 1]
    return cache


def write_slot_cache(pool, slot, cache):
    """Fold a ``slot_cache_view`` cache back into the pool. Its planes (or
    arenas) are the pool's own, already written in place, so nothing is
    copied; the function checks that and returns the pool."""
    want = pool["k"] if "block_tbl" in pool else pool["k"][:, slot:slot + 1]
    if cache["k"].data_ptr() != want.data_ptr():
        raise ValueError("cache is not a view of slot {}".format(slot))
    return pool


def fold_cache(pool, cache):
    """Fold a full-batch ``cache_view`` cache back into the pool after a
    decode step: the planes and scale planes (written in place) rebind;
    ``pos`` stays with the caller, which pins frozen slots, and the block
    table stays host-owned."""
    upd = {"k": cache["k"], "v": cache["v"]}
    for name in _SCALES:
        if name in pool:
            upd[name] = cache[name]
    return dict(pool, **upd)
