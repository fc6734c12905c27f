"""Fleet-global prefix directory — who holds which shared prefix.

Counterpart of ``deepspeed_tpu/inference/kv_hierarchy/prefix_directory.py``
(host code, kept near-verbatim). The radix prefix cache is strictly per-replica: each engine's
``PrefixStore`` knows only its own pool's rows, so an N-replica fleet
re-prefills the same system-prompt template up to N times. This module
is the fleet-level view that breaks that: a host-side directory mapping
published prefix token tuples -> the replicas whose prefix planes hold
them, consulted by the router (prefix-affinity scoring) and by the
adoption path (ship a hot row to a cold replica instead of recomputing).

COHERENCE RULES (the whole correctness story):

- The directory is DERIVED state, never authoritative. Device truth is
  each replica's pool planes; host truth is each replica's PrefixStore.
  The fleet re-syncs a replica's published set from its store after
  steps (cheap: the store's ``version`` counter gates the walk), so a
  directory entry can be at most one step stale.
- Staleness is SAFE in both directions. A stale-positive entry (row
  evicted since publish) only mis-scores routing by one request — the
  acceptor's own ``on_admit`` probe is the authority and simply misses;
  adoption re-validates against the donor's live store under the
  donor's lock before any bytes move. A stale-negative entry (row
  inserted, not yet synced) only costs an affinity opportunity.
- A replica that DIES or RECOVERS drops out wholesale
  (``invalidate``): failover marks it dead, and a recovery rebuilt its
  pool (``KVHierarchy.reset``), so every plane the directory described
  is gone. Replayed requests re-earn and re-publish — the
  zero-lost + bit-identical invariant never depends on this directory.

Lock discipline: every attribute write outside ``__init__`` holds
``self._lock``. The lock is a LEAF: nothing is called under it that
takes any other lock, so it is safe to use while holding a replica
lock or the fleet lock.
"""

import threading

from deepspeed_tpu_torch.inference.kv_hierarchy.prefix_cache import RadixTrie


class PrefixDirectory(object):
    """Published prefix rows per replica, with longest-match lookup.

    One ``RadixTrie`` per replica (rows number at most ``prefix_slots``
    each — single digits to low tens — so rebuilds are noise), plus the
    published token tuples. ``match()`` returns per-replica longest-
    match depths; the fleet turns those into router affinity and
    adoption decisions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rows = {}    # replica_id -> frozenset of token tuples
        self._tries = {}   # replica_id -> RadixTrie over those tuples
        self.publishes = 0
        self.invalidations = 0

    def sync(self, replica_id, rows):
        """Replace ``replica_id``'s published set with ``rows`` (an
        iterable of token tuples — typically its PrefixStore's live
        ``tokens.values()``). Rebuilds that replica's trie only when
        the set actually changed; returns True when it did."""
        new = frozenset(tuple(int(t) for t in toks) for toks in rows)
        with self._lock:
            if self._rows.get(replica_id) == new:
                return False
            self._rows[replica_id] = new
            trie = RadixTrie()
            for toks in new:
                trie.insert(toks, True)
            self._tries[replica_id] = trie
            self.publishes += 1
            return True

    def add(self, replica_id, tokens):
        """Publish one tuple immediately (the adoption path's fast
        publish — the next ``sync`` from the replica's store agrees)."""
        tokens = tuple(int(t) for t in tokens)
        with self._lock:
            cur = self._rows.get(replica_id, frozenset())
            if tokens in cur:
                return
            self._rows[replica_id] = cur | {tokens}
            self._tries.setdefault(replica_id, RadixTrie()).insert(
                tokens, True)
            self.publishes += 1

    def invalidate(self, replica_id):
        """Drop every entry a dead/recovered replica published — its
        pool (and thus every plane the directory described) is gone."""
        with self._lock:
            had = bool(self._rows.pop(replica_id, None))
            self._tries.pop(replica_id, None)
            if had:
                self.invalidations += 1
            return had

    def match(self, prompt):
        """Per-replica longest published prefix of ``prompt``:
        {replica_id: depth} for every replica with a non-zero match."""
        prompt = [int(t) for t in prompt]
        out = {}
        with self._lock:
            for rid, trie in self._tries.items():
                _, depth = trie.lookup(prompt)
                if depth > 0:
                    out[rid] = depth
        return out

    def holders(self, tokens, depth=None):
        """Replicas whose published set covers ``tokens`` (or its first
        ``depth`` tokens) — the adoption path's donor candidates."""
        tokens = [int(t) for t in tokens]
        if depth is not None:
            tokens = tokens[:depth]
        out = []
        with self._lock:
            for rid, trie in self._tries.items():
                _, d = trie.lookup(tokens)
                if d >= len(tokens):
                    out.append(rid)
        return out

    def snapshot(self):
        """Observability: per-replica published row counts plus the
        cumulative publish/invalidate tallies."""
        with self._lock:
            return {
                "rows": {rid: len(rows)
                         for rid, rows in self._rows.items() if rows},
                "publishes": self.publishes,
                "invalidations": self.invalidations,
            }

    def __len__(self):
        with self._lock:
            return sum(len(r) for r in self._rows.values())
