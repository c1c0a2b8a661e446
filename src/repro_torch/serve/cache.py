"""Version-keyed LRU result cache for the serving path.

Keys are ``(collection, index_version, radius, query_fingerprint)``:
the index bumps its monotonic ``version`` on every mutation that could
change a reported set (insert, delete, freeze, merge swap, sharded
rebalance, restore), so a repeated query hits only while the index is
bit-for-bit the one the cached result was computed against.  Staleness
is therefore impossible by construction — no TTLs, no invalidation
callbacks; a mutation simply makes every old key unreachable.  Dead
entries are reclaimed two ways: ``purge_stale`` drops them eagerly the
first time a new version is seen, and the byte-budget LRU sweep evicts
whatever survives.

Multi-tenant serving (docs/serving.md "Collections") shares ONE cache
across every collection: the collection name leads the key, versions
are tracked per collection (each tenant's index has its own monotonic
counter), and ``drop_collection`` purges a dropped tenant eagerly —
required for correctness, since a re-created collection's fresh index
restarts at version 0 and would otherwise alias the old corpus.  The
default (single-tenant) corpus uses the reserved empty name ``""``.

Values are per-query-row ``(ids, dists)`` host numpy pairs, as
``QueryResult.reported`` returns them, stored read-only so hits can be
served zero-copy; no entry holds device memory.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY

__all__ = ["ResultCache"]

# accounting overhead per entry (key tuple, OrderedDict node, list
# headers) — keeps many tiny results from reading as "free"
_ENTRY_OVERHEAD = 256


class ResultCache:
    """Byte-budgeted LRU over ``(collection, version, radius,
    fingerprint)`` keys.

    ``max_bytes <= 0`` disables caching entirely: ``get`` always
    misses and ``put`` is a no-op, so callers never need a second code
    path.  Not thread-safe by itself — the serving contract is
    control-thread-only, same as the index.
    """

    def __init__(self, max_bytes: int, registry=None):
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._nbytes: Dict[tuple, int] = {}
        self._bytes = 0
        # per-collection: each tenant's index versions independently
        self._version_seen: Dict[str, int] = {}
        self._hits = 0
        self._misses = 0
        self._puts = 0
        self._evictions = 0
        self._stale_drops = 0
        reg = registry if registry is not None else NULL_REGISTRY
        self._m_hits = reg.counter(
            "repro_cache_hits_total", help="Result-cache hits")
        self._m_misses = reg.counter(
            "repro_cache_misses_total", help="Result-cache misses")
        self._m_evictions = reg.counter(
            "repro_cache_evictions_total",
            help="Entries evicted by the byte-budget LRU sweep")
        self._m_stale = reg.counter(
            "repro_cache_stale_drops_total",
            help="Entries dropped because the index version moved on")
        self._g_bytes = reg.gauge(
            "repro_cache_bytes", help="Bytes held by the result cache")

    # --------------------------------------------------------------- keys
    @staticmethod
    def fingerprint(tokens: np.ndarray) -> str:
        """Content hash of one request's token rows (shape + dtype
        salted: a (1, 8) int32 row and its int64 twin must not
        collide)."""
        a = np.ascontiguousarray(tokens)
        h = hashlib.blake2b(digest_size=16)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
        return h.hexdigest()

    def key(self, version: int, radius: float, tokens: np.ndarray,
            collection: str = "") -> tuple:
        """``(collection, version, radius, fingerprint)`` — the
        collection leads so a tenant's entries are a contiguous notion,
        never shared across names; ``""`` is the default corpus."""
        return (str(collection), int(version), float(radius),
                self.fingerprint(tokens))

    # ------------------------------------------------------------ get/put
    def get(self, key: tuple):
        """The cached (ids_list, dists_list) for ``key``, or None."""
        entry = self._entries.get(key)
        if entry is None:
            self._misses += 1
            self._m_misses.inc()
            return None
        self._entries.move_to_end(key)
        self._hits += 1
        self._m_hits.inc()
        return entry

    def put(self, key: tuple, ids: List[np.ndarray],
            dists: List[np.ndarray]) -> bool:
        """Insert a result; returns False when it cannot fit (cache
        disabled, or the single entry exceeds the whole budget)."""
        nbytes = _ENTRY_OVERHEAD + sum(
            a.nbytes for a in ids) + sum(a.nbytes for a in dists)
        if self.max_bytes <= 0 or nbytes > self.max_bytes:
            return False
        if key in self._entries:        # same version+query resubmitted
            self._drop(key, stale=False, count_evict=False)
        for a in ids:
            a.flags.writeable = False   # zero-copy hits stay immutable
        for a in dists:
            a.flags.writeable = False
        self._entries[key] = (ids, dists)
        self._nbytes[key] = nbytes
        self._bytes += nbytes
        self._puts += 1
        while self._bytes > self.max_bytes:
            old = next(iter(self._entries))
            self._drop(old, stale=False, count_evict=True)
        self._g_bytes.set(self._bytes)
        return True

    def purge_stale(self, version: int, collection: str = "") -> int:
        """Drop every entry of ``collection`` keyed to an older index
        version.

        O(entries), but only does work the first time each new version
        is seen per collection — the usual call site (once per served
        batch) is a single dict lookup + int compare.  Returns the
        number dropped.
        """
        collection = str(collection)
        if self._version_seen.get(collection) == version:
            return 0
        self._version_seen[collection] = version
        stale = [k for k in self._entries
                 if k[0] == collection and k[1] != version]
        for k in stale:
            self._drop(k, stale=True, count_evict=False)
        self._g_bytes.set(self._bytes)
        return len(stale)

    def drop_collection(self, collection: str) -> int:
        """Drop ALL of one collection's entries (counted as stale
        drops) and forget its version watermark.  MUST run when a
        collection is dropped: a later re-create restarts the index
        version at 0, and surviving entries would alias the old corpus
        bit-for-bit.  Returns the number dropped."""
        collection = str(collection)
        self._version_seen.pop(collection, None)
        dead = [k for k in self._entries if k[0] == collection]
        for k in dead:
            self._drop(k, stale=True, count_evict=False)
        self._g_bytes.set(self._bytes)
        return len(dead)

    def _drop(self, key: tuple, *, stale: bool, count_evict: bool) -> None:
        del self._entries[key]
        self._bytes -= self._nbytes.pop(key)
        if stale:
            self._stale_drops += 1
            self._m_stale.inc()
        if count_evict:
            self._evictions += 1
            self._m_evictions.inc()

    # --------------------------------------------------------------- view
    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, float]:
        """Host-side counters snapshot (schema: CACHE_STATS_KEYS)."""
        lookups = self._hits + self._misses
        return {
            "hits": self._hits,
            "misses": self._misses,
            "puts": self._puts,
            "evictions": self._evictions,
            "stale_drops": self._stale_drops,
            "entries": len(self._entries),
            "bytes": self._bytes,
            "max_bytes": self.max_bytes,
            "hit_rate": self._hits / lookups if lookups else 0.0,
        }
