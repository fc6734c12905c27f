"""Shared-prefix cache bookkeeping: radix trie + prefix-row manager.

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/prefix_cache.py``,
kept near-verbatim: it is framework-free host bookkeeping, and the port
keeps its own copy rather than import the JAX package.

Everything here is HOST-side and derived: the device truth is the pool's
``pk``/``pv`` prefix planes (dense pools) or the refcounted arena pages a
row's ``payload`` names (paged pools), and even those are disposable:
after a crash the engine resets the pool and calls ``KVHierarchy.reset()``,
which empties the trie and the row table; replayed requests re-insert.

The trie annotates EVERY node on an inserted path with a row id, not just
the terminal: a node reached by walking ``prompt[:d]`` certifies that the
annotated row stores tokens matching ``prompt[:d]``, and causality makes
any *prefix* of a stored row a valid alias (position p's k/v depend only
on tokens at positions <= p). So the deepest annotated node gives the
longest usable match even when the prompt diverges mid-row. Eviction
rebuilds the trie from the surviving rows: rows number at most
``prefix_slots``, so the rebuild is noise next to a forward pass.
"""


class RadixTrie:
    """Token-id trie; lookup returns (row, depth) of the deepest match."""

    def __init__(self):
        # node = {token_id: child_node}; annotations live in a parallel
        # dict keyed by the node's path depth — simplest is to store the
        # row on the node itself under a reserved key.
        self.root = {}

    _ROW = object()  # reserved node key for the row annotation

    def insert(self, tokens, row):
        node = self.root
        for tok in tokens:
            node = node.setdefault(int(tok), {})
            node[RadixTrie._ROW] = row
        return row

    def lookup(self, tokens):
        """Longest stored prefix of ``tokens`` -> (row, depth); (None, 0)
        when no annotated node is reachable."""
        node = self.root
        row, depth = None, 0
        for d, tok in enumerate(tokens):
            node = node.get(int(tok))
            if node is None:
                break
            if RadixTrie._ROW in node:
                row, depth = node[RadixTrie._ROW], d + 1
        return row, depth

    def rebuild(self, rows):
        """Rebuild from {row: token_tuple} after an eviction. Later rows
        overwrite shared-path annotations, which is harmless: a shared
        node means shared tokens, so either row aliases correctly."""
        self.root = {}
        for row, tokens in rows.items():
            self.insert(tokens, row)


class PrefixStore:
    """Row table for the pool's prefix planes: tokens, refcounts, LRU.

    A row is *pinned* while any live request aliases it (refcount > 0) —
    the device plane is read-only to aliasers, so overwriting a pinned
    row would corrupt their attention. Eviction picks the
    least-recently-used unpinned row.
    """

    def __init__(self, num_rows, on_evict=None):
        self.num_rows = int(num_rows)
        self.tokens = {}      # row -> stored token tuple
        self.refcount = {}    # row -> live aliasing requests
        self.last_use = {}    # row -> monotonic tick of last acquire
        self.attached = {}    # rid -> row (for release by rid)
        self.trie = RadixTrie()
        self._tick = 0
        self.evictions = 0
        # Bumped whenever the ROW CONTENTS change (insert / reset) — a
        # cheap change detector for observers that mirror the row table
        # (the fleet's prefix directory syncs only when this moves;
        # acquire/release touch refcounts, not contents, and don't bump).
        self.version = 0
        # Backing-storage attachment per row. The DENSE prefix pool
        # needs none (row id IS the pk/pv plane row); the PAGED pool
        # hangs (pages tuple, span) here — the refcounted arena pages
        # holding the row's k/v and how many positions they certify.
        # ``on_evict(row, payload)`` fires whenever a payload-bearing
        # row's contents are dropped (eviction-reuse or reset) so the
        # owner can release the backing pages; settable post-init.
        self.payload = {}
        self.on_evict = on_evict

    def _drop_payload(self, row):
        payload = self.payload.pop(row, None)
        if payload is not None and self.on_evict is not None:
            self.on_evict(row, payload)

    def _touch(self, row):
        self._tick += 1
        self.last_use[row] = self._tick

    def lookup(self, tokens):
        return self.trie.lookup(tokens)

    def acquire(self, row, rid):
        self.refcount[row] = self.refcount.get(row, 0) + 1
        self.attached[rid] = row
        self._touch(row)

    def release(self, rid):
        row = self.attached.pop(rid, None)
        if row is not None and row in self.refcount:
            self.refcount[row] = max(0, self.refcount[row] - 1)
        return row

    def insert(self, tokens):
        """Claim a row for ``tokens``: a free row if any, else evict the
        LRU unpinned row (rebuilding the trie). Returns the row id, or
        None when every row is pinned."""
        tokens = tuple(int(t) for t in tokens)
        free = [r for r in range(self.num_rows) if r not in self.tokens]
        if free:
            row = free[0]
        else:
            unpinned = [r for r in self.tokens if not self.refcount.get(r)]
            if not unpinned:
                return None
            row = min(unpinned, key=lambda r: self.last_use.get(r, 0))
            del self.tokens[row]
            self._drop_payload(row)
            self.evictions += 1
        self.tokens[row] = tokens
        self.refcount.setdefault(row, 0)
        self._touch(row)
        self.trie.rebuild(self.tokens)
        self.version += 1
        return row

    def reset(self):
        for row in list(self.payload):
            self._drop_payload(row)
        self.tokens.clear()
        self.refcount.clear()
        self.last_use.clear()
        self.attached.clear()
        self.trie = RadixTrie()
        self.version += 1
