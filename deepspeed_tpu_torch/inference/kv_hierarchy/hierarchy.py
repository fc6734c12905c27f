"""The hierarchy facade: spec, config plumbing, and the engine's driver.

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/hierarchy.py``.
``HierarchySpec`` is the frozen shape contract ``kv_pool.init_pool``
consumes (which planes exist, their dtypes, the prefix store geometry).
``KVHierarchy`` is the host-side driver the engine calls at four points --
admission, prefill completion, release, recovery -- plus the swap store
and the byte accounting behind the ``effective_slots`` gauge.

Every device write here is an eager op on the current stream (the step
programs' stream), issued between steps and outside any captured graph,
into the pool's existing tensors: nothing is rebound and no program key
changes.

DENSE prefix aliasing differs from the JAX package in mechanism, not in
result. The JAX decode step selects, per position, between the prefix row
and the slot's own plane (``pid``/``pbase``). Here ``on_admit`` copies the
row's ``[:span]`` codes (and scales) into the slot's own plane once, so
the plane every kernel reads is elementwise what the JAX select gives,
and no per-step select touches the whole plane. The engine pins an
admitted slot's frontier to its cursor (the step's ``pin`` input), so the
frozen slot's decode-lane write while it waits for the prefill lane lands
past the copied span, never inside it. Host bookkeeping (pins,
attachments, eviction) and the accounting are the JAX package's.

Accounting model (KV planes only; the ring and per-slot fields are the
same across configurations and orders of magnitude smaller):

- ``flat_bytes_per_slot``: one fp plane pair, the flat-pool baseline.
- ``bytes_per_slot``: the hierarchy slot -- int8 codes plus fp32
  per-(head, position) scales when quantizing.
- ``prefix_store_bytes``: the resident shared planes, charged once (paged:
  the arena pages the stored rows pin).
- ``mean_aliased_bytes``: average bytes per admission a slot did NOT have
  to fill by its own prefill (cumulative aliased span / admissions).
- ``effective_slots(budget)``: ``(budget - prefix_store) / (bytes_per_slot
  - mean_aliased)``, the budget defaulting to the flat pool's footprint
  (``hbm_budget_bytes`` overrides it).
"""

import dataclasses

from deepspeed_tpu_torch.inference.kv_hierarchy.offload import (_PREFIX_OF,
                                                                HostSwapStore,
                                                                to_device)
from deepspeed_tpu_torch.inference.kv_hierarchy.prefix_cache import \
    PrefixStore


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """Which tiers are on, and the prefix-store geometry. Frozen and
    hashable: the pool shapes it implies are fixed for an engine's
    life."""

    int8: bool = False
    prefix: bool = False
    prefix_slots: int = 8
    prefix_len: int = 64
    min_prefix_len: int = 8
    offload: bool = False
    swap_slots: int = 8

    @property
    def enabled(self):
        return self.int8 or self.prefix or self.offload


def spec_from_config(config):
    """InferenceConfig -> HierarchySpec (the config validated the
    fields)."""
    return HierarchySpec(
        int8=bool(config.int8_kv),
        prefix=bool(config.prefix_cache),
        prefix_slots=int(config.prefix_slots),
        prefix_len=int(config.prefix_len),
        min_prefix_len=int(config.min_prefix_len),
        offload=bool(config.host_offload),
        swap_slots=int(config.swap_slots))


class _LocalCounters(dict):
    """Stand-in until the engine hands over its counter bank: the same
    ``c[name] += n`` surface, plain ints underneath."""

    def __missing__(self, key):
        return 0


class KVHierarchy(object):
    """Host-side driver for the three tiers over a pool whose rows are
    ``plane_len`` positions long, under ``spec`` and generation config
    ``gcfg``. All state here is derived and disposable: ``reset()`` after
    a pool reset restores the zero-knowledge start and replay re-earns
    everything. ``counters``: the engine's counter bank (hits, misses,
    inserts, evictions land there); ``pager``: the ``PageAllocator`` of a
    paged pool, whose refcounted pages then hold the prefix rows."""

    def __init__(self, spec, gcfg, plane_len, max_slots,
                 hbm_budget_bytes=None, counters=None, pager=None):
        self.spec = spec
        self.plane_len = int(plane_len)
        self.max_slots = int(max_slots)
        self.hbm_budget_bytes = hbm_budget_bytes
        self.counters = _LocalCounters() if counters is None else counters
        self.pager = pager
        hd = gcfg.n_embd // gcfg.n_head
        fp_itemsize = gcfg.dtype.itemsize
        kv_itemsize = 1 if spec.int8 else fp_itemsize
        # Bytes one cached position costs across all layers: k+v codes,
        # plus one fp32 scale each for k and v when quantizing.
        self._per_pos_bytes = gcfg.n_layer * gcfg.n_head * (
            hd * kv_itemsize * 2 + (8 if spec.int8 else 0))
        self._flat_per_pos_bytes = (gcfg.n_layer * gcfg.n_head * hd
                                    * fp_itemsize * 2)
        self.store = PrefixStore(spec.prefix_slots) if spec.prefix else None
        if self.store is not None and pager is not None:
            self.store.on_evict = self._drop_prefix_pages
        self.swap_store = HostSwapStore(spec.swap_slots) if spec.offload \
            else None
        # Set by the engine when a QueueFull caller was told a swap would
        # free capacity; the next step's swap policy honours it even if
        # the queue has drained by then.
        self.swap_requested = False
        self._attach_len = {}      # rid -> aliased span (live attachments)
        self._pending_insert = {}  # rid -> span to publish at prefill end
        self._aliased_total = 0    # cumulative aliased bytes, all time

    # ------------------------------------------------------ engine hooks

    def _drop_prefix_pages(self, row, payload):
        """PrefixStore ``on_evict`` hook (paged): a row's contents were
        dropped, so release its pages' store pin. Pages still shared into
        live slots keep those slots' references."""
        pages, _span = payload
        self.pager.decref(pages)

    def _write_ring(self, pool, slot, tokens):
        """The n-gram drafter reads the token ring; an aliased span was
        never prefilled by THIS slot, so write it by hand."""
        if "toks" in pool:
            pool["toks"][slot, :len(tokens)].copy_(
                to_device(tokens, pool["toks"].device), non_blocking=True)

    def _on_admit_paged(self, pool, req, slot):
        """Paged admission: a trie hit shares the stored row's FULL pages
        into the slot's block-table row (refcounted, no bytes move) and
        copies the straddle page (copy-on-write), so partial-prefix hits
        are safe: the slot's own prefill overwrites the straddle's
        positions past the span before its frontier reaches them. No
        ``prefix_len`` cap applies: the shared bytes live in the arena."""
        prompt = [int(t) for t in req.prompt]
        row, depth = self.store.lookup(prompt)
        payload = self.store.payload.get(row) if row is not None else None
        # The lane must still prefill >= 1 token to sample the first
        # output, so never alias the entire prompt.
        span = min(depth, len(prompt) - 1)
        if payload is not None:
            pages, stored_span = payload
            span = min(span, int(stored_span))
        if payload is None or span < self.spec.min_prefix_len:
            self.counters["prefix_misses"] += 1
            ins = len(prompt) - 1
            if ins >= self.spec.min_prefix_len:
                self._pending_insert[req.rid] = ins
            return
        pager = self.pager
        n_full = min(span // pager.page_len, len(pages))
        self.store.acquire(row, req.rid)
        self._attach_len[req.rid] = span
        self._aliased_total += span * self._per_pos_bytes
        self.counters["prefix_hits"] += 1
        pager.install_shared(slot, pages[:n_full])
        if span > n_full * pager.page_len and n_full < len(pages):
            # Straddle page: a private copy of every plane (codes AND
            # scales). Positions past ``span`` in it are the donor's,
            # which the slot's own prefill overwrites.
            src = int(pages[n_full])
            dst = pager.cow_page(slot, src)
            for name in ("k", "v", "k_scale", "v_scale"):
                if name in pool:
                    pool[name][:, dst].copy_(pool[name][:, src])
        req.cursor = span  # prefill starts past the aliased span
        self._write_ring(pool, slot, prompt[:span])

    def on_admit(self, pool, req, slot):
        """Admission hook: probe the trie; on a hit attach the row, copy
        its span into the slot's plane (dense) or share its pages (paged)
        and advance the request's cursor past the span; on a miss record
        an insert intent. Eager in-place writes only."""
        if self.store is None:
            return
        if self.pager is not None:
            return self._on_admit_paged(pool, req, slot)
        prompt = [int(t) for t in req.prompt]
        row, depth = self.store.lookup(prompt)
        # The lane must still prefill >= 1 token to sample the first
        # output, so never alias the entire prompt.
        span = min(depth, len(prompt) - 1, self.spec.prefix_len)
        if row is not None and span >= self.spec.min_prefix_len:
            self.store.acquire(row, req.rid)
            self._attach_len[req.rid] = span
            self._aliased_total += span * self._per_pos_bytes
            self.counters["prefix_hits"] += 1
            req.cursor = span  # prefill starts past the aliased span
            for plane, prefix in _PREFIX_OF:
                if prefix in pool:
                    pool[plane][:, slot, :, :span].copy_(
                        pool[prefix][:, row, :, :span])
            self._write_ring(pool, slot, prompt[:span])
            return
        self.counters["prefix_misses"] += 1
        ins = min(len(prompt) - 1, self.spec.prefix_len)
        if ins >= self.spec.min_prefix_len:
            self._pending_insert[req.rid] = ins

    def on_prefill_done(self, pool, req):
        """Publish a missed prefix: the slot's plane now holds the prompt's
        k/v from position 0, so copy ``[:span]`` into a prefix row (dense)
        or pin the slot's own pages as the row (paged), and index it in
        the trie."""
        span = self._pending_insert.pop(req.rid, None)
        if self.store is None or span is None:
            return
        before = self.store.evictions
        row = self.store.insert(tuple(int(t) for t in req.prompt[:span]))
        self.counters["prefix_evictions"] += self.store.evictions - before
        if row is None:  # every row pinned by live aliasers
            return
        slot = req.slot
        if self.pager is not None:
            # No copy: the slot's pages covering [:span] BECOME the stored
            # row (incref is the store's pin; they outlive the donor).
            # Donor writes >= span touch only the straddle page, which
            # sharers copy.
            n = -(-span // self.pager.page_len)
            pages = self.pager.row_pages(slot)[:n]
            if len(pages) < n:
                return  # prefill never mapped that far
            self.pager.incref(pages)
            self.store.payload[row] = (tuple(int(p) for p in pages),
                                       int(span))
            self.counters["prefix_inserts"] += 1
            return
        for plane, prefix in _PREFIX_OF:
            if prefix in pool:
                pool[prefix][:, row, :, :span].copy_(
                    pool[plane][:, slot, :, :span])
        self.counters["prefix_inserts"] += 1

    def on_release(self, req):
        """Completion / cancel hook: drop the row pin, any pending insert
        and any host swap record."""
        rid = req.rid
        if self.store is not None:
            self.store.release(rid)
            self._attach_len.pop(rid, None)
            self._pending_insert.pop(rid, None)
        if self.swap_store is not None:
            self.swap_store.pop(rid)

    def reset(self):
        """Crash recovery: the pool was just reset, so every device plane
        this bookkeeping described is gone. Drop it all; replayed requests
        re-probe, re-insert and re-earn their hits. Counters are
        cumulative telemetry and keep counting."""
        if self.store is not None:
            self.store.reset()
        if self.swap_store is not None:
            self.swap_store.clear()
        self._attach_len.clear()
        self._pending_insert.clear()
        self.swap_requested = False

    def swap_capacity_left(self):
        return self.swap_store is not None and self.swap_store.capacity_left()

    # ------------------------------------------------- byte accounting

    def bytes_per_slot(self):
        return self._per_pos_bytes * self.plane_len

    def flat_bytes_per_slot(self):
        return self._flat_per_pos_bytes * self.plane_len

    def prefix_store_bytes(self):
        if self.store is None:
            return 0
        if self.pager is not None:
            # Paged: no dedicated prefix planes; the store costs the arena
            # pages its rows pin, live.
            pages = sum(len(p) for p, _ in self.store.payload.values())
            return pages * self.pager.page_len * self._per_pos_bytes
        return (self.spec.prefix_slots * self.spec.prefix_len
                * self._per_pos_bytes)

    def bytes_aliased_live(self):
        return sum(self._attach_len.values()) * self._per_pos_bytes

    def bytes_aliased_total(self):
        return self._aliased_total

    def hit_rate(self):
        hits = self.counters["prefix_hits"]
        total = hits + self.counters["prefix_misses"]
        return hits / total if total else 0.0

    def mean_aliased_bytes(self):
        total = (self.counters["prefix_hits"]
                 + self.counters["prefix_misses"])
        return self._aliased_total / total if total else 0.0

    def effective_slots(self, budget=None):
        if budget is None:
            budget = self.hbm_budget_bytes
        if budget is None:
            budget = self.flat_bytes_per_slot() * self.max_slots
        usable = budget - self.prefix_store_bytes()
        net = max(1.0, self.bytes_per_slot() - self.mean_aliased_bytes())
        return int(usable // net)
