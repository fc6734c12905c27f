"""Host offload: slot capture/restore and the host swap store.

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/offload.py``. A
swap-out captures ONE slot's device footprint -- its k/v plane slices (or,
paged, its live arena pages), the int8 scale slices when present, the
token-ring row, and every per-slot field, with ``active`` captured
*before* the engine deactivates the slot so restore reactivates it -- into
host memory: CPU tensors, pinned when the pool lies on the card. Every
copy of a capture is issued without waiting, and the capture then waits
ONCE on the stream, so a record costs one synchronization however many
fields it holds. The shared prefix planes (``pk``/``pv``) and the block
table never ship.

Restore writes a record back IN PLACE (slice ``copy_`` or ``index_copy_``
into the pool's existing tensors, on the current stream) into whatever
slot the scheduler hands out: every positional fact (``pos``, the ring
row) travels in the record. No pool tensor is ever rebound, so a step
program captured as a CUDA graph keeps reading the restored values at the
addresses it holds (``kv_pool`` docstring, STATIC ADDRESSES). The copies
are issued without waiting: the caller keeps the record alive until the
stream has passed them (the engine holds it until the step's harvest).
A restored plane is the captured one, byte for byte, so the resumed
stream continues where it paused.

The serving fleet's transports (``inference/fleet.py``) are the same
moves: ``capture_slots`` / ``capture_slots_paged`` take every slot a
prefill-role step hands off in one synchronization (one gather per pool
entry, split on the host), and ``capture_prefix_row`` /
``restore_prefix_row`` (dense) and ``capture_prefix_pages`` /
``restore_prefix_pages`` (paged) ship a shared-prefix row between
replicas. int8 codes and their scales ship as stored. On one card a
record goes device -> host -> device: it is captured on the donor
engine's stream and restored on the acceptor's.
"""

import time

import torch

# Plane-like pool entries sliced along the slot (dense) or page (paged)
# axis, axis 1.
_PLANE_KEYS = ("k", "v", "k_scale", "v_scale")

# Pool entries no slot record carries: the shared prefix planes stay
# resident, and a paged row's table is rebuilt by the allocator.
_RESIDENT_KEYS = ("pk", "pv", "pk_scale", "pv_scale", "block_tbl")


def _resident(name):
    """Pool entries no slot record carries: the prefix rows, the block
    table and an adapter's ``aux_`` state (global, not per slot)."""
    return name in _RESIDENT_KEYS or name.startswith("aux_")

# Swap-victim blend: one second since a session's last emitted token
# counts like this many tokens of remaining budget. An idle session
# (a stalled client, a long think-time gap) becomes the preferred
# victim well before the largest-budget active session does.
IDLE_WEIGHT_TOKENS_PER_S = 32.0


def host_copy(t):
    """A host copy of tensor ``t``: pinned and issued without waiting when
    ``t`` lies on the card (the caller synchronizes once for all of its
    copies), a plain clone on the CPU."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def to_device(values, device):
    """``values`` (a sequence of ints, or a host tensor) as a tensor on
    ``device``: staged through pinned memory and copied without waiting
    when ``device`` is the card, so the host does not block on the
    stream. Pinned blocks are held by PyTorch's caching host allocator
    until the copy has run."""
    t = values if torch.is_tensor(values) else torch.tensor(values)
    if torch.device(device).type != "cuda":
        return t.to(device)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _wait(pool):
    """The one synchronization of a capture: wait for the copies issued
    on the current stream of the pool's device (the engine makes its own
    stream current around every hierarchy call)."""
    dev = pool["pos"].device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def capture_slot(pool, slot):
    """Snapshot slot ``slot`` of a dense pool to host memory; returns
    {name: CPU tensor} after one synchronization."""
    slot = int(slot)
    record = {}
    for name, t in pool.items():
        if _resident(name):
            continue
        record[name] = host_copy(t[:, slot] if name in _PLANE_KEYS
                                 else t[slot])
    _wait(pool)
    return record


def restore_slot(pool, slot, record):
    """Write a captured record into slot ``slot`` of a dense pool, in
    place, on the current stream, without waiting (module docstring)."""
    slot = int(slot)
    for name, val in record.items():
        dst = pool[name][:, slot] if name in _PLANE_KEYS else pool[name][slot]
        dst.copy_(val, non_blocking=True)


def capture_slots(pool, slots):
    """Snapshot SEVERAL slots of a dense pool in one synchronization: one
    gather along the slot axis per pool entry, then the per-slot split on
    the host. Returns one ``restore_slot``-compatible record per slot."""
    idx = to_device([int(s) for s in slots], pool["pos"].device)
    host = {}
    for name, t in pool.items():
        if _resident(name):
            continue
        host[name] = host_copy(t.index_select(
            1 if name in _PLANE_KEYS else 0, idx))
    _wait(pool)
    return [{name: (val[:, i] if name in _PLANE_KEYS else val[i])
             for name, val in host.items()} for i in range(len(slots))]


# ------------------------------------------------------- paged variants
#
# A PAGED pool keeps k/v as page arenas [L, P, H, page_len, D]: a slot's
# footprint is the set of physical pages its block-table row names, so
# capture and restore take the explicit page list from the PageAllocator.
# Records ship ONLY LIVE PAGES, as [L, n_pages, H, page_len, D] stacks (in
# the row's logical order) plus the same per-slot fields as the dense
# record.


def capture_slot_paged(pool, slot, pages):
    """Snapshot one paged slot -- its ``pages`` (logical order) gathered
    from the arenas, plus its per-slot fields and ring row -- to host
    memory after one synchronization."""
    slot = int(slot)
    idx = to_device([int(p) for p in pages], pool["k"].device)
    record = {}
    for name, t in pool.items():
        if _resident(name):
            continue
        record[name] = host_copy(t.index_select(1, idx)
                                 if name in _PLANE_KEYS else t[slot])
    _wait(pool)
    return record


def capture_slots_paged(pool, slots, page_lists):
    """Snapshot several paged slots in one synchronization: every slot's
    pages in one gather, the per-slot fields in another, split on the
    host (``capture_slots``' paged twin)."""
    counts = [len(p) for p in page_lists]
    dev = pool["k"].device
    pidx = to_device([int(p) for lst in page_lists for p in lst], dev)
    sidx = to_device([int(s) for s in slots], dev)
    host = {}
    for name, t in pool.items():
        if _resident(name):
            continue
        host[name] = host_copy(t.index_select(1, pidx)
                               if name in _PLANE_KEYS
                               else t.index_select(0, sidx))
    _wait(pool)
    records, off = [], 0
    for i, n in enumerate(counts):
        records.append({name: (val[:, off:off + n] if name in _PLANE_KEYS
                               else val[i])
                        for name, val in host.items()})
        off += n
    return records


def restore_slot_paged(pool, slot, record, pages):
    """Write a paged record back in place: the plane stacks into the FRESH
    physical ``pages`` (as many as the record holds; the caller's
    allocator owns them and points the slot's table row at them), the
    per-slot fields into ``slot``. The pages need not be the captured
    ones: every positional fact travels in the record."""
    slot = int(slot)
    dev = pool["k"].device
    idx = to_device([int(p) for p in pages], dev)
    for name, val in record.items():
        if name in _PLANE_KEYS:
            pool[name].index_copy_(1, idx, to_device(val, dev))
        else:
            pool[name][slot].copy_(val, non_blocking=True)


def pick_swap_victim(candidates, now=None,
                     idle_weight=IDLE_WEIGHT_TOKENS_PER_S,
                     live_pages=None, page_len=0):
    """The decoding session that can best afford to wait: reclaim value
    BLENDED with last-touch age, not budget order alone.

    Dense pools reclaim a fixed-size slot whoever the victim is, so the
    reclaim term is the CONFIGURED residual budget (max_new_tokens -
    emitted). A PAGED pool reclaims exactly the victim's live pages: pass
    ``live_pages`` (rid -> pages held) and ``page_len`` and the reclaim
    term becomes pages * page_len, the token capacity the eviction frees.

    Score = reclaim + idle_weight * seconds-since-last-token; highest
    score is the victim, oldest rid on exact ties. Requests without a
    ``last_touch`` stamp score age 0."""
    if not candidates:
        return None
    if now is None:
        now = time.time()

    def _key(r):
        if live_pages is not None:
            reclaim = live_pages.get(r.rid, 0) * page_len
        else:
            reclaim = r.max_new_tokens - len(r.tokens)
        touched = getattr(r, "last_touch", None)
        age = 0.0 if touched is None else max(0.0, now - touched)
        return (reclaim + idle_weight * age, -r.rid)

    return max(candidates, key=_key)


# ----------------------------------------------- prefix-row transports
#
# A record holds a prefix row's first ``span`` positions in the dense
# row layout, planes [L, H, span, D] and scales [L, H, span], under the
# prefix-row names, whichever layout the donor and the acceptor pool
# have.

# Slot plane -> prefix-row plane (the hierarchy's dense copies use it too).
_PREFIX_OF = (("k", "pk"), ("v", "pv"), ("k_scale", "pk_scale"),
              ("v_scale", "pv_scale"))


def capture_prefix_row(pool, row, span):
    """Snapshot dense prefix row ``row``'s first ``span`` positions to
    host memory after one synchronization."""
    row, span = int(row), int(span)
    record = {prefix: host_copy(pool[prefix][:, row, :, :span])
              for _, prefix in _PREFIX_OF if prefix in pool}
    _wait(pool)
    return record


def restore_prefix_row(pool, row, record):
    """Write a prefix record into dense row ``row``, in place, on the
    current stream, without waiting (the caller holds the record until
    the stream has passed the copies). Positions past the record's span
    keep what the row held: a hit reads only its matched span."""
    row = int(row)
    dev = pool["pos"].device
    for name, val in record.items():
        span = val.shape[2]
        pool[name][:, row, :, :span].copy_(to_device(val, dev),
                                           non_blocking=True)


def capture_prefix_pages(pool, pages, span):
    """Snapshot the prefix held by arena ``pages`` (logical order) to host
    memory in the dense row layout, after one synchronization: gather the
    pages, lay them out [L, H, n * page_len, ...] and cut at ``span``."""
    dev = pool["k"].device
    idx = to_device([int(p) for p in pages], dev)
    record = {}
    for plane, prefix in _PREFIX_OF:
        if plane not in pool:
            continue
        g = pool[plane].index_select(1, idx).movedim(2, 1)
        g = g.reshape(g.shape[:2] + (-1,) + g.shape[4:])
        record[prefix] = host_copy(g[:, :, :int(span)])
    _wait(pool)
    return record


def restore_prefix_pages(pool, pages, record):
    """Write a prefix record (dense row layout) into the arena ``pages``
    (as many as its span needs), in place, without waiting; positions
    past the span in the last page are zero."""
    dev = pool["k"].device
    idx = to_device([int(p) for p in pages], dev)
    for plane, prefix in _PREFIX_OF:
        if prefix not in record:
            continue
        arena = pool[plane]
        page_len = arena.shape[3]
        val = to_device(record[prefix], dev)
        L, H, span = val.shape[:3]
        buf = torch.zeros((L, H, len(pages) * page_len) + val.shape[3:],
                          dtype=arena.dtype, device=dev)
        buf[:, :, :span] = val
        buf = buf.reshape((L, H, len(pages), page_len) + val.shape[3:])
        arena.index_copy_(1, idx, buf.movedim(2, 1))


def record_nbytes(record):
    """Host bytes one captured record occupies."""
    return int(sum(v.nbytes for v in record.values()))


class HostSwapStore:
    """rid -> captured record, bounded by the configured swap slots."""

    def __init__(self, capacity):
        self.capacity = int(capacity)
        self.records = {}

    def capacity_left(self):
        return len(self.records) < self.capacity

    def put(self, rid, record):
        if not self.capacity_left():
            raise RuntimeError("host swap store full "
                               "({} records)".format(self.capacity))
        self.records[rid] = record

    def pop(self, rid):
        return self.records.pop(rid, None)

    def __len__(self):
        return len(self.records)

    def nbytes(self):
        return sum(v.nbytes for rec in self.records.values()
                   for v in rec.values())

    def clear(self):
        self.records.clear()
