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

The fleet's transports (``capture_slots``, ``capture_slots_paged``,
``capture_prefix_row``, ``restore_prefix_row``) come with the fleet
slice.
"""

import time

import torch

# Plane-like pool entries sliced along the slot (dense) or page (paged)
# axis, axis 1.
_PLANE_KEYS = ("k", "v", "k_scale", "v_scale")

# Pool entries no slot record carries: the shared prefix planes stay
# resident, and a paged row's table is rebuilt by the allocator.
_RESIDENT_KEYS = ("pk", "pv", "pk_scale", "pv_scale", "block_tbl")

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
    on the current stream of the pool's device."""
    dev = pool["pos"].device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def capture_slot(pool, slot):
    """Snapshot slot ``slot`` of a dense pool to host memory; returns
    {name: CPU tensor} after one synchronization."""
    slot = int(slot)
    record = {}
    for name, t in pool.items():
        if name in _RESIDENT_KEYS:
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
        if name in _RESIDENT_KEYS:
            continue
        record[name] = host_copy(t.index_select(1, idx)
                                 if name in _PLANE_KEYS else t[slot])
    _wait(pool)
    return record


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
