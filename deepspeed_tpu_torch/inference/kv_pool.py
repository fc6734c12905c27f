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
- ``temp`` / ``top_k`` / ``seed``  per-request sampling parameters;
- ``spec``       the request speculates (on an engine that does: the
                 accept rule vetoes draft agreement where False, so
                 requests that opt out ride the same program).

A speculating engine's pool adds the TOKEN RING ``toks`` [slots,
plane_len] int64: position p holds the token the row placed there (prompt
tokens as the prefill lane appends them, then every emitted token). It
obeys the stale rule below: entries up to ``pos[b]`` are valid
(``toks[b, pos[b]]`` is the frontier token ``last_tok[b]``), entries past
it are garbage that a later write covers before the frontier reaches them,
and the drafter matches only n-grams ending strictly below the frontier.

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

Over a mesh's 'model' axis (``tp``) each rank's planes hold its heads
only (``parallel/mesh.kv_heads``: H/mp of them where mp divides H, else
all): the k/v planes or arenas, the int8 codes and their scale planes
(which carry the heads dim here), and the prefix rows; ``pool_nbytes``
counts this rank's bytes.

An adapter's own state (``ModelAdapter.aux_state``: the MoE adapter's
expert-load counters) joins the pool under ``aux_`` keys: global, not per
slot, so no slot record carries it (``kv_hierarchy.offload``), threaded
through every step program (``cache_view``, ``slot_cache_view``), copied
into the step's one harvest read (``step_harvest``) and zeroed in place
by ``reset_pool``.

Under the shared-prefix tier (``hier.prefix``) a dense pool also holds
the prefix rows ``pk``/``pv`` (and their scales under int8): at a prefix
hit the hierarchy copies a row's span into the admitted slot's own plane,
so no step program reads them. A paged pool shares the row's arena pages
instead.

Stale-cache rule: a freed slot's k/v are never cleared. A later request
writes position ``p`` before any query's mask (``k_pos <= q_pos``) can
reach it, so stale keys are overwritten or masked, never attended. In the
paged layout a freed row's table points at the trash page, so its frozen
frontier writes land there.

``plane_len`` is ``max_len`` plus ``slack`` (the engine passes
``max(prefill_chunk, spec_k + 1)``, ``prefill_chunk`` without speculation):
an append of up to ``prefill_chunk`` positions, and a verify's ``spec_k +
1`` k/v writes and ring writes one past them, from any admissible frontier
(as deep as ``max_len - 1``) stay in bounds, so no write has to clamp: an
index past the plane raises. Unlike the TPU pool, the plane is not padded
to a block quantum: the CUDA kernels take any length. A paged row's
logical plane is that length rounded up to whole pages.

STATIC ADDRESSES. Every tensor of the pool is allocated once and updated
in place, never rebound (crash recovery too: ``reset_pool``): the forward writes k/v (and scales) into the
planes, and the step program writes the per-slot fields with ``copy_`` /
``index_copy_``. A step program captured as a CUDA graph on the card
replays against these addresses. The views below alias the pool's own
planes, and the step's inputs and harvest live in ``PackedBuffer``s of
their own fixed addresses (``step_inputs``, ``step_harvest``).
"""

import numpy as np
import torch

from deepspeed_tpu_torch.analysis.annotations import hot_path
from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.parallel.mesh import kv_heads

# Per-slot fields: (name, dtype, initial value). Every other tensor of the
# pool (planes, scales, prefix rows, block table, token ring) starts at
# zero.
_SLOT_FIELDS = (
    ("pos", torch.int32, 0),
    ("last_tok", torch.int64, 0),
    ("active", torch.bool, False),
    ("remaining", torch.int32, 0),
    ("eos", torch.int64, -1),
    ("temp", torch.float32, 0.0),
    ("top_k", torch.int32, 0),
    ("seed", torch.int64, 0),
    ("spec", torch.bool, False),
)

_FILLS = {name: fill for name, _, fill in _SLOT_FIELDS}

# Fields the host reads at every harvest.
HARVEST_FIELDS = ("pos", "active", "last_tok")


def aux_names(pool):
    """The pool's adapter-state keys (``aux_`` prefix), in order."""
    return tuple(name for name in pool if name.startswith("aux_"))


def harvest_names(pool):
    """The pool entries the step program copies into the harvest: the
    per-slot ``HARVEST_FIELDS`` and the adapter's ``aux_`` state."""
    return HARVEST_FIELDS + aux_names(pool)


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
              hier=None, page_len=0, num_pages=None, ring=False, aux=None,
              tp=None):
    """Zeroed pool dict for ``num_slots`` sequences of up to ``max_len``
    positions under generation config ``gcfg``
    (``models.generation.as_gencfg``), on ``device`` (default ``cuda``;
    without a GPU it raises unless ``device="cpu"`` is passed).

    ``hier`` (a ``kv_hierarchy.HierarchySpec``, or None for the flat pool):
    under ``hier.int8`` the planes hold int8 codes and the pool gains fp32
    ``k_scale``/``v_scale`` planes; under ``hier.prefix`` a dense pool
    gains the shared-prefix rows ``pk``/``pv`` ``[layers, prefix_slots,
    heads, prefix_len, head_dim]`` (and ``pk_scale``/``pv_scale`` under
    int8), read and written only by the hierarchy's eager copies
    (``kv_hierarchy.hierarchy``). ``page_len > 0`` selects the paged
    layout: an arena of ``num_pages`` usable pages (None: as many as
    ``num_slots`` full rows need) plus the trash page, and a zeroed
    ``block_tbl`` (every row on the trash page). ``ring`` adds the token
    ring ``toks`` of a speculating engine, as long as a row's plane (the
    logical plane when paged). ``aux``: an adapter's ``aux_state()``
    ({name: (shape, dtype)}), allocated on ``device`` and zeroed. ``tp``
    (a ``TPContext``): this model rank's heads only (module docstring)."""
    dtype = dtype or gcfg.dtype
    device = resolve_device(device)
    hd = gcfg.n_embd // gcfg.n_head
    _, heads = kv_heads(gcfg.n_head, tp.size, tp.rank) if tp is not None \
        else (0, gcfg.n_head)
    int8 = hier is not None and hier.int8
    kv_dtype = torch.int8 if int8 else dtype
    pool = {}
    if page_len:
        n_lp = paged_plane_len(max_len, slack, page_len) // page_len
        usable = num_pages if num_pages is not None else num_slots * n_lp
        shape = (gcfg.n_layer, usable + 1, heads, page_len, hd)
        pool["block_tbl"] = torch.empty((num_slots, n_lp), dtype=torch.int32,
                                        device=device)
    else:
        shape = (gcfg.n_layer, num_slots, heads,
                 plane_len_for(max_len, slack), hd)
    pool["k"] = torch.empty(shape, dtype=kv_dtype, device=device)
    pool["v"] = torch.empty(shape, dtype=kv_dtype, device=device)
    if int8:
        pool["k_scale"] = torch.empty(shape[:-1], dtype=torch.float32,
                                      device=device)
        pool["v_scale"] = torch.empty(shape[:-1], dtype=torch.float32,
                                      device=device)
    if hier is not None and hier.prefix and not page_len:
        # The shared-prefix rows of a dense pool (the JAX layout); a paged
        # pool's prefix rows are refcounted arena pages instead.
        p_shape = (gcfg.n_layer, hier.prefix_slots, heads,
                   hier.prefix_len, hd)
        pool["pk"] = torch.empty(p_shape, dtype=kv_dtype, device=device)
        pool["pv"] = torch.empty(p_shape, dtype=kv_dtype, device=device)
        if int8:
            pool["pk_scale"] = torch.empty(p_shape[:-1], dtype=torch.float32,
                                           device=device)
            pool["pv_scale"] = torch.empty(p_shape[:-1], dtype=torch.float32,
                                           device=device)
    if ring:
        pool["toks"] = torch.empty(
            (num_slots, n_lp * page_len if page_len else shape[3]),
            dtype=torch.int64, device=device)
    for name, dt, _ in _SLOT_FIELDS:
        pool[name] = torch.empty((num_slots,), dtype=dt, device=device)
    for name, (shape, dt) in (aux or {}).items():
        if not name.startswith("aux_"):
            raise ValueError("adapter state {!r} must carry the aux_ "
                             "prefix".format(name))
        pool[name] = torch.empty(shape, dtype=dt, device=device)
    reset_pool(pool, hier)
    return pool


def reset_pool(pool, hier=None):
    """Refill every tensor of ``pool`` IN PLACE with the values
    ``init_pool`` gives it: planes, scale planes, prefix rows, block
    table and token ring zero, the per-slot fields their ``_SLOT_FIELDS`` fills. Nothing
    is rebound, so every address a captured step program holds stays
    valid (the engine's crash recovery; ``init_pool`` allocates, then
    calls this, so the two cannot drift). On the card each fill is a
    kernel on the current stream. ``hier``: the ``HierarchySpec`` the
    pool was built under, checked against its layout (int8 planes carry
    scale planes)."""
    if hier is not None and bool(hier.int8) != ("k_scale" in pool):
        raise ValueError("reset_pool: the pool {} scale planes but the "
                         "hierarchy spec has int8={}".format(
                             "has" if "k_scale" in pool else "lacks",
                             hier.int8))
    for name, t in pool.items():
        t.fill_(_FILLS.get(name, 0))


class PackedBuffer:
    """Named tensors packed into ONE byte buffer on the device and one on
    the host, each field at an 8-byte aligned offset, so that moving all of
    them between the two is a single copy. The host buffer is pinned when
    the device is a GPU. ``fields``: (name, torch dtype, shape) triples.

    ``dev[name]`` are views of the device buffer at fixed addresses (a
    captured step program reads and writes them); ``host[name]`` are numpy
    views of the host buffer. ``upload`` copies host to device on the
    current stream without waiting: the caller must not write the host
    buffer again until the stream has passed the copy (the engine writes it
    only after the step's blocking ``read``). ``read`` copies device to host,
    waits for it and returns copies of the fields as numpy arrays."""

    def __init__(self, fields, device):
        device = torch.device(device)
        layout, at = [], 0
        for name, dtype, shape in fields:
            shape = tuple(int(n) for n in shape)
            nbytes = int(np.prod(shape, dtype=np.int64)) * \
                torch.empty((), dtype=dtype).element_size()
            layout.append((name, at, nbytes, dtype, shape))
            at += -(-nbytes // 8) * 8
        self._host = torch.zeros(max(at, 8), dtype=torch.uint8,
                                 pin_memory=device.type == "cuda")
        self._dev = torch.zeros(max(at, 8), dtype=torch.uint8, device=device)
        host_np = self._host.numpy()
        self.dev, self.host = {}, {}
        for name, off, nbytes, dtype, shape in layout:
            self.dev[name] = self._dev[off:off + nbytes].view(dtype).view(
                shape)
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            self.host[name] = host_np[off:off + nbytes].view(
                np_dtype).reshape(shape)

    def upload(self):
        self._dev.copy_(self._host, non_blocking=True)

    def read(self):
        self._host.copy_(self._dev)
        return {name: self.host[name].copy() for name in self.host}


def step_inputs(num_slots, prefill_chunk, device):
    """The mixed step's inputs (the JAX program's traced arguments) as a
    ``PackedBuffer``: the prefill slice ``ids`` [1, C] and the lane's
    ``slot``, ``frontier``, ``n_valid``, ``done``, ``max_new``, ``eos``,
    ``temp``, ``top_k``, ``seed`` and ``spec`` ([1] each, in the dtype of
    the pool field they feed), plus ``pin`` [slots] int32: the frontier
    each slot admitted this step is pinned to (-1: none; paged pools and
    pools with the prefix tier). Filled with the idle lane's values."""
    buf = PackedBuffer(
        [("ids", torch.int64, (1, prefill_chunk)),
         ("slot", torch.int64, (1,)), ("frontier", torch.int32, (1,)),
         ("n_valid", torch.int32, (1,)), ("done", torch.bool, (1,)),
         ("max_new", torch.int32, (1,)), ("eos", torch.int64, (1,)),
         ("temp", torch.float32, (1,)), ("top_k", torch.int32, (1,)),
         ("seed", torch.int64, (1,)), ("spec", torch.bool, (1,)),
         ("pin", torch.int32, (num_slots,))],
        device)
    clear_step_inputs(buf)
    return buf


def clear_step_inputs(buf):
    """Host side: the idle lane, no pins."""
    for name in buf.host:
        buf.host[name][...] = 0
    buf.host["max_new"][0] = 1
    buf.host["eos"][0] = -1
    buf.host["pin"][:] = -1


def step_harvest(num_slots, chunk, device, lanes=1, aux=None):
    """What the host reads after a step, as a ``PackedBuffer`` the step
    program fills and the host copies back in ONE device-to-host transfer:
    the per-slot ``pos`` / ``active`` / ``last_tok`` [slots] (the pool
    fields of the same names), the decode lane's ``toks`` and ``valid``
    [chunk, slots, lanes] (``valid[t, s, i]`` marks ``toks[t, s, i]`` an
    emission of slot s at step t, so row-major (step, lane) order is
    emission order; lanes is 1 for the plain lane, spec_k + 1 on a
    speculating engine) and the prefill lane's ``first`` token [1] (-1
    unless the lane finished a prompt), and the adapter's ``aux`` state
    ({name: (shape, dtype)}, as ``init_pool`` takes it)."""
    fields = [(name, dt, (num_slots,)) for name, dt, _ in _SLOT_FIELDS
              if name in HARVEST_FIELDS]
    fields += [(name, dt, shape) for name, (shape, dt) in
               (aux or {}).items()]
    emit = (chunk, num_slots, lanes)
    fields += [("toks", torch.int64, emit), ("valid", torch.bool, emit),
               ("first", torch.int64, (1,))]
    return PackedBuffer(fields, device)


def max_active_frontier(snap):
    """Largest frontier among active slots, from a ``step_harvest`` read."""
    pos, active = snap["pos"], snap["active"]
    return int((pos * active).max()) if pos.size else 0


def free_slots(snap):
    """Indices of inactive slots, from a ``step_harvest`` read."""
    return [int(i) for i in np.flatnonzero(~snap["active"])]


def pool_nbytes(pool):
    """Device bytes held by the pool: the k/v planes dominate; the scale
    planes, the prefix rows, the block table, the token ring and the
    per-slot fields count too."""
    return int(sum(t.numel() * t.element_size() for t in pool.values()))


_SCALES = ("k_scale", "v_scale")


@hot_path
def cache_view(pool):
    """The pool as a ``models.generation`` cache dict: every slot is a
    batch row. ``k``/``v`` (and the scale planes) are the pool's own
    tensors; a paged pool passes its arenas whole with the block table."""
    cache = {"k": pool["k"], "v": pool["v"], "pos": pool["pos"]}
    for name in _SCALES + ("block_tbl",) + aux_names(pool):
        if name in pool:
            cache[name] = pool[name]
    return cache


@hot_path
def slot_cache_view(pool, slot, pos):
    """One slot as a batch-1 cache dict for the prefill lane, as the JAX
    ``slot_cache_view(pool, p_slot, pos)``. ``slot`` is a [1] (or 0-d)
    integer tensor on the pool's device, so the step program does not
    depend on its value (a host int is taken too); ``pos`` is the
    [1]-shaped int32 frontier. Both layouts pass their planes (and scale
    planes) whole with a ``[1, n_lp]`` int32 block table through which the
    forward scatters its writes and the paged kernels read: paged, the
    slot's row of the pool's table; dense, the table ``[[slot]]`` over the
    planes seen as an arena of ``slots`` pages of ``plane_len`` positions
    (``[layers, slots, heads, plane_len, head_dim]`` is that arena's
    layout), so no view is cut at a host-known slot."""
    slot = torch.as_tensor(slot, device=pool["pos"].device).reshape(1)
    if "block_tbl" in pool:
        tbl = pool["block_tbl"].index_select(0, slot)
    else:
        tbl = slot.to(torch.int32).view(1, 1)
    cache = {"k": pool["k"], "v": pool["v"], "pos": pos, "block_tbl": tbl}
    for name in _SCALES + aux_names(pool):
        if name in pool:
            cache[name] = pool[name]
    return cache

