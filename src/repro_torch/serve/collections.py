"""Multi-tenant collections: one engine, many corpora.

A ``CollectionManager`` maps *named collections* — independent tenant
corpora — onto per-tenant streaming indexes while everything expensive
stays shared, once per process:

  * **one QueryEngine and one LSH family** — the caller's
    ``index_factory`` closes over them, so every collection's index
    shares the family's parameters on the device, the bucket function
    and the engine's routing and kernels, however many tenants exist;
  * **one CompactionDriver worker** — each created collection is
    ``attach``-ed to the shared driver, whose worker round-robins
    one bounded op at a time over the collections with pending merge
    work (fairness counters in ``driver.stats()["fairness"]``);
  * **one Observability bundle** — collection lifecycle and index
    events carry a ``collection`` field (the manager wraps the shared
    ``EventLog`` per tenant), and per-collection serving counters are
    labeled registry series (``repro_collection_*{collection=...}``);
  * **one ResultCache / one ShapeBucketScheduler** — keys and requests
    carry the collection id; the manager wires per-tenant token-bucket
    quotas into the scheduler and purges a dropped tenant's cache
    entries (required: a re-created collection restarts at version 0).

The default (single-tenant) corpus keeps the reserved empty name
``""`` and does NOT live in the manager.

Checkpointing: ``state_dict()`` nests every tenant under
``collections/<name>/...`` (index state + quota) once the caller puts
it under ``"collections"``; the ``CheckpointManager`` flattens that into
per-collection manifest subtrees (``CheckpointManager.collection_names``
lists them without loading arrays); ``load_state_dict`` rebuilds the
full tree through the same index factory.  The layout is the
reference's (``repro.serve.collections``), so a tree saved by either
package restores into the other.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs import Observability
from repro_torch.serve.scheduler import TenantQuota

__all__ = ["Collection", "CollectionManager"]

# names become event labels, metric label values, and checkpoint leaf
# path segments — so no "/", no whitespace, never empty ("" is the
# reserved default-corpus id)
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]*$")


class _CollectionEvents:
    """EventLog facade that stamps ``collection=<name>`` on every
    event an index emits (freeze, merge_scheduled, swap, ...), so one
    shared ring buffer stays attributable per tenant."""

    __slots__ = ("_log", "_name")

    def __init__(self, log, name: str):
        self._log = log
        self._name = name

    def emit(self, kind: str, **fields) -> None:
        self._log.emit(kind, collection=self._name, **fields)

    def __getattr__(self, attr):
        return getattr(self._log, attr)


@dataclasses.dataclass
class Collection:
    """One tenant: a name, its index, its quota, and serving counters."""

    name: str
    index: object
    quota: TenantQuota
    queries: int = 0
    linear_served: int = 0

    def stats(self) -> Dict[str, object]:
        """This collection's view (schema: COLLECTION_STATS_KEYS)."""
        ist = self.index.index_stats()
        return {
            "n_live": ist["n_live"],
            "version": int(self.index.version),
            "segments": ist["segments"],
            "pending_merges": ist["pending_merges"],
            "delta_live": ist["delta_live"],
            "queries": self.queries,
            "linear_served": self.linear_served,
            "inserts": ist["inserts"],
            "deletes": ist["deletes"],
            "quota_rate": self.quota.rate,
            "quota_burst": self.quota.burst,
            "quota_weight": self.quota.weight,
        }


class CollectionManager:
    """Named tenant corpora over shared serving machinery.

    Args:
      index_factory: ``(obs) -> index`` — builds one fresh, empty
        streaming index wired to the given observability bundle (the
        manager passes a per-collection event facade).  The caller
        supplies a factory that closes over the shared family, engine,
        and config, e.g. ``lambda obs: DynamicHybridIndex(fam,
        params=params, engine=engine, obs=obs, ...)``.
      obs: the shared ``Observability`` bundle.
      scheduler: the shared ``ShapeBucketScheduler`` (quota wiring
        + request dropping on ``drop``); optional for bare use.
      cache: the shared ``ResultCache`` (purged on ``drop``);
        optional.
      driver: the shared ``CompactionDriver`` — may also be set later
        via the ``driver`` attribute; created collections attach to
        it, dropped ones detach.

    Control-thread-only, like the indexes it owns.
    """

    def __init__(self, index_factory: Callable[[Observability], object],
                 *, obs: Optional[Observability] = None,
                 scheduler=None, cache=None, driver=None):
        self._factory = index_factory
        self.obs = obs if obs is not None else Observability.disabled()
        self.scheduler = scheduler
        self.cache = cache
        self.driver = driver
        self._collections: Dict[str, Collection] = {}
        self._created = 0
        self._dropped = 0
        reg = self.obs.registry
        self._m_created = reg.counter(
            "repro_collections_created_total", help="Collections created")
        self._m_dropped = reg.counter(
            "repro_collections_dropped_total", help="Collections dropped")

    # -------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self._collections)

    def __contains__(self, name: str) -> bool:
        return str(name) in self._collections

    def names(self) -> List[str]:
        """Creation-ordered collection names."""
        return list(self._collections)

    def get(self, name: str) -> Collection:
        col = self._collections.get(str(name))
        if col is None:
            raise KeyError(
                f"no collection {name!r} (have: {self.names()})")
        return col

    # ---------------------------------------------------------- lifecycle
    def create(self, name: str,
               quota: Optional[TenantQuota] = None,
               attach: bool = True) -> Collection:
        """Create an empty named collection; raises on duplicates and
        invalid names.  ``quota`` (a ``TenantQuota``) installs the
        tenant's token bucket + drain weight on the shared scheduler;
        omitted = unlimited, weight 1.  ``attach=False`` defers the
        driver attach (``attach_driver``) — callers that seed the new
        index with a wholesale ``build`` must do so before the worker
        can see it."""
        name = str(name)
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid collection name {name!r} (want "
                f"{_NAME_RE.pattern}; '' is the default corpus)")
        if name in self._collections:
            raise ValueError(f"collection {name!r} already exists")
        quota = quota if quota is not None else TenantQuota()
        col_obs = dataclasses.replace(
            self.obs, events=_CollectionEvents(self.obs.events, name))
        index = self._factory(col_obs)
        col = Collection(name=name, index=index, quota=quota)
        self._collections[name] = col
        self._created += 1
        self._m_created.inc()
        if self.scheduler is not None:
            self.scheduler.set_quota(name, rate=quota.rate,
                                     burst=quota.burst,
                                     weight=quota.weight)
        if attach and self.driver is not None:
            self.driver.attach(name, index)
        self.obs.events.emit("collection_create", collection=name,
                             quota_rate=quota.rate,
                             quota_weight=quota.weight)
        return col

    def attach_driver(self, name: str) -> None:
        """Attach an existing collection's index to the shared driver
        (no-op without one) — the deferred half of
        ``create(attach=False)``."""
        if self.driver is not None:
            self.driver.attach(str(name), self.get(name).index)

    def drop(self, name: str) -> Collection:
        """Drop a collection: detach it from the driver, discard its
        queued requests, purge its cache entries (a re-created name
        restarts at version 0 — stale hits must be impossible), and
        forget it.  Returns the removed ``Collection``."""
        col = self.get(name)
        name = col.name
        if self.driver is not None:
            self.driver.detach(name)
        dropped_reqs = 0
        if self.scheduler is not None:
            dropped_reqs = self.scheduler.drop_collection(name)
        purged = 0
        if self.cache is not None:
            purged = self.cache.drop_collection(name)
        del self._collections[name]
        self._dropped += 1
        self._m_dropped.inc()
        self.obs.events.emit("collection_drop", collection=name,
                             n_live=int(col.index.n),
                             dropped_requests=dropped_reqs,
                             purged_cache_entries=purged)
        return col

    def note_query(self, name: str, n_queries: int, n_linear: int) -> None:
        """Fold one served batch into the tenant's counters + labeled
        registry series."""
        col = self.get(name)
        col.queries += n_queries
        col.linear_served += n_linear
        reg = self.obs.registry
        reg.counter("repro_collection_queries_total",
                    help="Queries served, by collection",
                    labels={"collection": col.name}).inc(n_queries)
        reg.counter("repro_collection_linear_total",
                    help="Linear-route queries, by collection",
                    labels={"collection": col.name}).inc(n_linear)

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, object]:
        """Pinned snapshot (COLLECTION_MANAGER_KEYS at the top level,
        COLLECTION_STATS_KEYS per collection)."""
        reg = self.obs.registry
        for col in self._collections.values():
            reg.gauge("repro_collection_live_docs",
                      help="Live documents, by collection",
                      labels={"collection": col.name}).set(int(col.index.n))
        return {
            "n_collections": len(self._collections),
            "created_total": self._created,
            "dropped_total": self._dropped,
            "collections": {name: col.stats()
                            for name, col in self._collections.items()},
        }

    # --------------------------------------------------------- checkpoint
    def state_dict(self) -> Dict[str, Dict[str, object]]:
        """``{name: {"index": <index state>, "quota": {...}}}`` — the
        subtree a checkpoint nests under ``"collections"``, giving each
        tenant its own manifest namespace (``collections/<name>/...``).
        Index states are host copies (``DynamicHybridIndex.state_dict``)."""
        out = {}
        for name, col in self._collections.items():
            out[name] = {
                "index": col.index.state_dict(),
                "quota": {
                    "rate": np.float64(col.quota.rate),
                    "burst": np.float64(col.quota.burst),
                    "weight": np.float64(col.quota.weight),
                },
            }
        return out

    def state_digests(self) -> Dict[str, str]:
        """Content-address hints for every tenant's immutable leaves,
        namespaced to match the ``state_dict`` layout — lets
        ``save_incremental`` skip re-hashing frozen segments across the
        whole collection tree."""
        out: Dict[str, str] = {}
        for name, col in self._collections.items():
            digests = getattr(col.index, "state_digests", None)
            if digests is None:
                continue
            for path, dg in digests().items():
                out[f"{name}/index/{path}"] = dg
        return out

    def load_state_dict(self, state: Dict[str, Dict[str, object]]) -> None:
        """Rebuild the full collection tree from a checkpoint subtree:
        existing collections are dropped, each saved tenant is
        re-created through the factory (same shared family/engine) with
        its saved quota, and its index state is restored."""
        for name in list(self._collections):
            self.drop(name)
        for name, sub in state.items():
            q = sub["quota"]
            quota = TenantQuota(rate=float(q["rate"]),
                                burst=float(q["burst"]),
                                weight=float(q["weight"]))
            # attach only after the state lands: a wholesale
            # load_state_dict must never race the driver worker
            col = self.create(name, quota=quota, attach=False)
            col.index.load_state_dict(sub["index"])
            self.attach_driver(name)
