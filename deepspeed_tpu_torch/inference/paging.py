"""Host-side page allocator for the paged KV cache.

Counterpart of ``deepspeed_tpu/inference/paging.py``, kept near-verbatim:
it is framework-free numpy, and the port keeps its own copy rather than
import the JAX package. The device truth is a fixed page ARENA ``[L, P, H,
page_len, D]`` plus a per-slot int32 block table ``[slots, plane_len /
page_len]`` (see inference/kv_pool.py). Everything HERE is the host-side
brain that decides which physical page backs which (slot, logical-page)
pair:

- a free-list stack over physical pages ``1..total`` -- page 0 is the
  reserved TRASH page: a freed slot's table row is zeroed, so the frozen
  slot's pinned-frontier writes (the mixed step keeps running every slot)
  land in a page nothing ever reads unmasked;
- per-page REFCOUNTS: the shared-prefix cache installs the same physical
  page into several slots' rows (``install_shared``; the straddle page
  copied on write, ``cow_page``) and pins its rows' pages (``incref``), and
  a page returns to the free list only when its last reference drops; a
  swap-in claims pages outside any reservation (``alloc_pages``,
  ``install_row``);
- a RESERVATION ledger: admission reserves ``ceil((prompt + max_new +
  slack) / page_len)`` pages per request up front, so ``ensure_mapped`` can
  never fail mid-decode -- the page-aware admission gate is
  ``can_reserve``, and pages_free minus outstanding reservations is the
  only capacity number that is safe to promise.

The state is DERIVED and disposable: ``reset()`` restores the
zero-knowledge start of a freshly built pool.
"""

import collections
import time

import numpy as np

# Floor/cap for the page-aware retry hint a pages-bound QueueFull
# carries (seconds). The cap matches scheduler.RETRY_AFTER_CAP_S.
PAGE_RETRY_MIN_S = 0.05
PAGE_RETRY_CAP_S = 60.0

# Reserved physical page no live mapping may use: freed rows point here.
TRASH_PAGE = 0


class PageAllocator(object):
    """Free list + refcounts + block table + reservation ledger."""

    def __init__(self, num_slots, pages_per_slot, total_pages, page_len):
        self.num_slots = int(num_slots)
        self.pages_per_slot = int(pages_per_slot)   # logical pages per row
        self.total_pages = int(total_pages)         # usable (trash excluded)
        self.page_len = int(page_len)
        self.reset()

    def reset(self):
        """Zero-knowledge start (pool rebuild / crash recovery): every
        page free, every row pointing at trash, no reservations."""
        self.table = np.zeros((self.num_slots, self.pages_per_slot),
                              np.int32)
        self.mapped = np.zeros((self.num_slots,), np.int32)
        # LIFO free list: physical pages 1..total (0 is trash).
        self.free = list(range(self.total_pages, 0, -1))
        self.refcount = np.zeros((self.total_pages + 1,), np.int32)
        self.reserved = {}          # rid -> remaining reservation balance
        self.slot_rid = {}          # slot -> rid drawing down on mapping
        self.dirty = True           # block table needs a device rebind
        self._freed_log = collections.deque(maxlen=256)  # free timestamps

    # --------------------------------------------------- reservations

    def pages_for(self, tokens):
        """Pages covering ``tokens`` positions."""
        return -(-int(tokens) // self.page_len)

    def outstanding(self):
        """Reservation balance not yet drawn down into mappings."""
        return int(sum(self.reserved.values()))

    def available(self):
        """Pages free AND unpromised — the only number admission may
        spend."""
        return len(self.free) - self.outstanding()

    def can_reserve(self, n):
        return self.available() >= int(n)

    def reserve(self, rid, n):
        n = int(n)
        if not self.can_reserve(n):
            raise RuntimeError(
                "page reservation of {} exceeds available {} "
                "(free={}, outstanding={})".format(
                    n, self.available(), len(self.free), self.outstanding()))
        self.reserved[rid] = self.reserved.get(rid, 0) + n

    def release_reservation(self, rid):
        """Drop any undrawn balance (completion / cancel / swap-out)."""
        self.reserved.pop(rid, None)

    def bind_slot(self, slot, rid):
        """Mappings into ``slot`` draw down ``rid``'s reservation."""
        self.slot_rid[int(slot)] = rid

    # -------------------------------------------------------- mapping

    def _draw(self, slot):
        rid = self.slot_rid.get(int(slot))
        if rid is not None and rid in self.reserved:
            self.reserved[rid] = max(0, self.reserved[rid] - 1)

    def _alloc(self):
        if not self.free:
            raise RuntimeError(
                "page arena exhausted with reservations outstanding — "
                "admission gate invariant broken")
        return self.free.pop()

    def ensure_mapped(self, slot, upto_tokens):
        """Map fresh pages so positions ``< upto_tokens`` are backed.
        Reservation-covered by construction — the admission gate sized
        every live request's reservation at its full frontier bound."""
        slot = int(slot)
        want = min(self.pages_for(upto_tokens), self.pages_per_slot)
        while self.mapped[slot] < want:
            lp = int(self.mapped[slot])
            page = self._alloc()
            self.refcount[page] = 1
            self.table[slot, lp] = page
            self.mapped[slot] += 1
            self._draw(slot)
            self.dirty = True

    def install_shared(self, slot, pages):
        """Prefix-cache share: install already-live physical ``pages``
        at the row's leading logical pages, increffing each. The caller
        guarantees the row is empty (fresh admission)."""
        slot = int(slot)
        assert self.mapped[slot] == 0, "shared install into a mapped row"
        for lp, page in enumerate(pages):
            self.refcount[page] += 1
            self.table[slot, lp] = page
            self.mapped[slot] += 1
            self._draw(slot)
        self.dirty = True

    def cow_page(self, slot, src_page):
        """Copy-on-write: claim a fresh page for the row's NEXT logical
        page (the partial straddle page of a prefix hit). Returns the
        destination physical page — the engine copies the arena bytes
        ``src -> dst`` eagerly."""
        slot = int(slot)
        lp = int(self.mapped[slot])
        page = self._alloc()
        self.refcount[page] = 1
        self.table[slot, lp] = page
        self.mapped[slot] += 1
        self._draw(slot)
        self.dirty = True
        return page

    def alloc_pages(self, n, now=None):
        """Claim ``n`` pages OUTSIDE any reservation (swap-in restore of
        an adopted record, cross-replica prefix adoption). Returns the
        page list, or None when granting them would eat into promised
        capacity."""
        n = int(n)
        if self.available() < n:
            return None
        pages = [self._alloc() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        return pages

    def install_row(self, slot, pages):
        """Point ``slot``'s row at ``pages`` (already refcounted — the
        restore path after ``alloc_pages``)."""
        slot = int(slot)
        assert self.mapped[slot] == 0, "row install into a mapped row"
        for lp, page in enumerate(pages):
            self.table[slot, lp] = page
        self.mapped[slot] = len(pages)
        self.dirty = True

    def incref(self, pages):
        for p in pages:
            self.refcount[p] += 1

    def decref(self, pages, now=None):
        """Drop one reference per page; zero-ref pages return to the
        free list (timestamped for the page-release-rate retry hint)."""
        if now is None:
            now = time.time()
        freed = 0
        for p in pages:
            p = int(p)
            # Skip trash AND already-free pages: a decref racing a
            # reset() (recovery tears the allocator down before the
            # hierarchy drops its payload pins) must not double-insert
            # into the free list.
            if p == TRASH_PAGE or self.refcount[p] <= 0:
                continue
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free.append(p)
                self._freed_log.append(now)
                freed += 1
        return freed

    def row_pages(self, slot):
        """The row's mapped physical pages in logical order."""
        slot = int(slot)
        return [int(p) for p in self.table[slot, :int(self.mapped[slot])]]

    def free_slot(self, slot, now=None):
        """Release a row: deref every mapped page, point the row at
        trash (frozen-slot frontier writes land harmlessly), unbind."""
        slot = int(slot)
        self.decref(self.row_pages(slot), now=now)
        self.table[slot, :] = TRASH_PAGE
        self.mapped[slot] = 0
        self.slot_rid.pop(slot, None)
        self.dirty = True

    # --------------------------------------------------------- gauges

    def pages_in_use(self):
        return self.total_pages - len(self.free)

    def pages_free(self):
        return len(self.free)

    def fragmentation(self, live_tokens):
        """Fraction of allocated page capacity NOT holding live tokens —
        the paged pool's (bounded-by-one-page-per-row) internal waste,
        vs the dense pool's (plane_len - length) per slot."""
        cap = self.pages_in_use() * self.page_len
        return max(0.0, (cap - int(live_tokens)) / cap) if cap else 0.0

    def retry_after_s(self, pages_needed, now=None):
        """Page-aware backpressure hint: pages_needed over the observed
        page-release rate, clamped. With no release history yet the
        floor applies — capacity usually appears on the next harvest."""
        if now is None:
            now = time.time()
        log = self._freed_log
        if len(log) >= 2 and now > log[0]:
            rate = len(log) / max(now - log[0], 1e-6)
            hint = pages_needed / rate
        else:
            hint = PAGE_RETRY_MIN_S
        return min(max(hint, PAGE_RETRY_MIN_S), PAGE_RETRY_CAP_S)
