"""Retrieval-augmented serving: the paper's index as a first-class
feature of the serving path.

An LM (any of the 10 archs) encodes requests to normalized embeddings
(models.transformer.forward_embed); the corpus embeddings live in a
streaming index (cosine/SimHash by default), so a serving corpus
mutates live via ``add_documents`` / ``remove_documents`` instead of
full rebuilds.  With ``RetrievalConfig.mesh`` set (a
``core.distributed.ShardMesh``) the corpus is row-sharded over the
mesh's shards (``ShardedDynamicHybridIndex``); otherwise the
single-device ``DynamicHybridIndex`` serves.  Every retrieval request goes through the
paper's Algorithm 2 via the shared segment engine, with the
tombstone-corrected estimate.  ``stats`` exposes routing decisions and
compaction counters.

The service runs on ``device`` (None: the GPU), where the model's
weights live; the embeddings stay there from the encoder to the index.

Compaction modes (docs/compaction.md): synchronous drain (default),
budgeted ticks (``compact_step_rows`` set; ``compaction_tick`` between
batches), or fully async (``async_compaction=True``; the service owns
a ``CompactionDriver`` whose worker thread stages merges while the
serving thread only drains staged swaps).

The closed-loop fast path (docs/serving.md): ``submit`` enqueues
requests on the service's coalescing ``ShapeBucketScheduler``;
``drain_batches`` forms pow2 shape buckets across requests, serves
repeats straight from the version-keyed ``ResultCache``, embeds the
misses ONCE per formed bucket, runs the paper's cost estimate over the
whole coalesced batch, splits by route, and scatters per-request
``RequestResult``s back by uid.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import CostModel
from repro_torch.core.distributed import ShardMesh
from repro_torch.core.engine import QueryEngine, _pad_size
from repro_torch.core.index import resolve_device
from repro_torch.core.lsh import make_family
from repro_torch.models.parallel import ParallelConfig
from repro_torch.models.transformer import forward_embed
from repro_torch.obs import Observability, to_prometheus
from repro_torch.obs.schema import ENGINE_STATS_KEYS
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.collections import Collection, CollectionManager
from repro_torch.serve.scheduler import ShapeBucketScheduler, TenantQuota
from repro_torch.streaming import (CompactionDriver, CompactionPolicy,
                                   DynamicHybridIndex,
                                   ShardedDynamicHybridIndex)


@dataclasses.dataclass
class RetrievalConfig:
    radius: float = 0.3            # cosine distance threshold
    tables: int = 20               # L
    num_buckets: int = 4096
    hll_m: int = 64
    cap: int = 128
    beta_over_alpha: float = 10.0
    delta: float = 0.1
    # Streaming-index knobs.
    delta_capacity: int = 4096
    compact_delta_fill: float = 1.0
    compact_tombstone_ratio: float = 0.25
    # LSM level-stack knobs: fanout bounds segments per level; step_rows
    # switches merges from synchronous drain to bounded off-query-path
    # steps (RetrievalService ticks them between batches).
    compact_fanout: int = 4
    compact_step_rows: Optional[int] = None
    # Async compaction: a CompactionDriver worker thread runs the merge
    # staging gathers continuously; the serving thread's tick becomes a
    # cheap drain() that only applies fully-staged atomic swaps (plus
    # their loc rewrites), so no gather ever lands on the serving
    # thread.  compact_step_rows doubles as the worker's per-gather
    # budget (default delta_capacity // 2 when unset and async is on).
    async_compaction: bool = False
    # Mesh sharding: set to a ShardMesh (core.distributed.make_mesh) to
    # shard the corpus over its `mesh_axis`.
    mesh: Optional[ShardMesh] = None
    mesh_axis: str = "data"
    shard_routing: str = "global"  # or "per_shard" (density-adaptive)
    shard_max_out: int = 512       # reported neighbors per (shard, query)
    # Merge-time placement of surviving rows across shards: "keep_local"
    # (never move), "round_robin", or "load_balance" (water-fill the
    # per-shard live counts).  `stats` then reports `shard_skew` (max /
    # mean live load) and cumulative `rows_moved`.
    shard_placement: str = "keep_local"
    # Closed-loop serving (docs/serving.md): the submit/drain_batches
    # path coalesces cross-request queries into pow2 shape buckets.
    # max_wait_s is the coalescing deadline (0 drains greedily);
    # max_queue bounds admission (None = unbounded; beyond it submit
    # returns None and counts a reject); result_cache_bytes budgets the
    # version-keyed query result cache (0 disables it).
    coalesce_max_batch: int = 64
    coalesce_min_bucket: int = 8
    coalesce_max_wait_s: float = 0.0
    max_queue: Optional[int] = 4096
    result_cache_bytes: int = 8 << 20
    # Observability (repro_torch.obs; docs/observability.md): one bundle —
    # metrics registry + per-query route tracer + compaction event log —
    # shared by the service, the index, and the driver.  obs_enabled
    # False builds the no-op variant (the query path short-circuits on
    # it).
    obs_enabled: bool = True
    obs_trace_capacity: int = 256       # retained per-query spans
    obs_events_capacity: int = 512      # event-log ring size
    obs_trace_sample_every: int = 16    # trace every Nth batch (1 = all)
    obs_dump_path: Optional[str] = None  # shutdown() metrics dump target


@dataclasses.dataclass
class RequestResult:
    """One request's scattered share of a coalesced batch.

    ``ids[i]`` / ``dists[i]`` are the reported r-near neighbors of the
    request's i-th query row (external doc ids; arrays are read-only
    when served from the cache).  ``cached`` marks a cache hit;
    ``queue_wait_s`` is the scheduler queue time (0 for hits served at
    submit-batch formation).
    """

    uid: int
    ids: List[np.ndarray]
    dists: List[np.ndarray]
    n_queries: int
    cached: bool
    queue_wait_s: float

    def neighbor_sets(self):
        return {i: set(self.ids[i].tolist())
                for i in range(self.n_queries)}


class RetrievalService:
    """Embed-and-report-near-neighbors service.

    Wraps an LM encoder (any arch config) over a streaming index:
    ``index_corpus`` builds, ``add_documents``/``remove_documents``
    mutate live, ``query`` reports r-near neighbors for an embedded
    request batch, ``compaction_tick`` advances merge work off the
    query path, and ``stats`` exposes routing + compaction +
    rebalancing counters.

    With ``RetrievalConfig.async_compaction`` the service owns a
    ``CompactionDriver``: merge staging runs on the driver's worker
    thread, ``compaction_tick`` degenerates to the driver's cheap
    ``drain()`` (apply any fully-staged atomic swap), and
    ``checkpoint`` flushes the driver first so a snapshot never
    captures a half-staged merge.  All ``RetrievalService`` methods are
    control-thread-only — the only concurrency is the driver's worker,
    which the service manages (``shutdown`` stops it).
    """

    def __init__(self, cfg: ArchConfig, par: ParallelConfig, params,
                 rcfg: Optional[RetrievalConfig] = None, *,
                 index_params: Optional[Dict[str, torch.Tensor]] = None,
                 device=None):
        """``params`` is the encoder (``models.init_params`` or
        ``interop.model_params_from_numpy``) on ``device`` (None: the
        GPU).  ``index_params`` are the SimHash draws every index of the
        service is built with (a dict of tensors, e.g. a reference
        index's through ``repro_torch.interop``); None draws them from
        the indexes' default seed."""
        # default must be constructed per instance: a dataclass default
        # in the signature is ONE shared object, and anything mutating
        # it (tests tweaking radius, a caller setting mesh) would leak
        # into every service built afterwards
        rcfg = rcfg if rcfg is not None else RetrievalConfig()
        if rcfg.mesh is not None and not isinstance(rcfg.mesh, ShardMesh):
            raise TypeError(f"RetrievalConfig.mesh must be a ShardMesh "
                            f"(core.distributed.make_mesh), got "
                            f"{type(rcfg.mesh).__name__}")
        self.device = resolve_device(device)
        if params.device.type != self.device.type:
            raise ValueError(f"the encoder lives on {params.device}, not "
                             f"on {self.device}")
        self.cfg, self.par, self.params, self.rcfg = cfg, par, params, rcfg
        self._index_params = index_params
        self.index: Optional[DynamicHybridIndex] = None
        self.driver: Optional[CompactionDriver] = None
        self._queries_served = 0
        self._linear_served = 0
        self._compaction_ticks = 0
        self._idle_ticks = 0
        self.obs = Observability.create(
            enabled=rcfg.obs_enabled,
            trace_capacity=rcfg.obs_trace_capacity,
            events_capacity=rcfg.obs_events_capacity,
            trace_sample_every=rcfg.obs_trace_sample_every)
        reg = self.obs.registry
        self._m_queries = reg.counter(
            "repro_service_queries_total", help="Queries served")
        self._m_linear = reg.counter(
            "repro_service_linear_total",
            help="Queries served by the linear route")
        self._m_ticks = reg.counter(
            "repro_service_compaction_ticks_total",
            help="Maintenance ticks that ran compaction work")
        self._m_idle = reg.counter(
            "repro_service_idle_ticks_total",
            help="Maintenance ticks with nothing to do")
        self._g_size = reg.gauge(
            "repro_index_live_docs", help="Live documents in the index")
        # The closed-loop fast path: one coalescing scheduler + one
        # version-keyed result cache per service, built unconditionally
        # so the stats schema never varies with traffic shape.  The
        # scheduler's background tick is the compaction hook — every
        # drain advances merge work between batches.
        self.scheduler = ShapeBucketScheduler(
            max_batch=rcfg.coalesce_max_batch,
            min_bucket=rcfg.coalesce_min_bucket,
            background_tick=self.compaction_tick,
            registry=reg,
            max_wait_s=rcfg.coalesce_max_wait_s,
            max_queue=rcfg.max_queue)
        self.cache = ResultCache(rcfg.result_cache_bytes, registry=reg)
        # Multi-tenant collections (docs/serving.md "Collections"):
        # named per-tenant indexes built through one factory that
        # shares the family (one cached hash function), one
        # QueryEngine, the scheduler's per-tenant token buckets, the
        # collection-keyed cache, and — in async mode — one
        # CompactionDriver pool.  The default corpus (index_corpus)
        # keeps the reserved name "" and never lives in the manager.
        self._family = None             # shared LSH family, built lazily
        self._shared_engine: Optional[QueryEngine] = None
        self._tick_rr = 0               # budgeted-tick round-robin cursor
        self.collections = CollectionManager(
            index_factory=self._make_index,
            obs=self.obs, scheduler=self.scheduler, cache=self.cache)

    def embed(self, batch) -> torch.Tensor:
        """Normalized (B, d_model) float32 embeddings of one token batch
        (``{"tokens": (B, S)}``, numpy or a tensor), on the device."""
        with torch.no_grad():
            return forward_embed(self.params, batch, self.cfg, self.par)

    def _embed_corpus(self, batches: Iterable) -> torch.Tensor:
        return torch.cat([self.embed(b) for b in batches], dim=0)

    def _step_rows(self) -> Optional[int]:
        """Merge-step budget: the configured step_rows; async mode must
        not fall back to the synchronous drain (step_rows=None), so it
        defaults to half the delta capacity."""
        r = self.rcfg
        if r.compact_step_rows is None and r.async_compaction:
            return max(r.delta_capacity // 2, 1)
        return r.compact_step_rows

    def _lsh_family(self, d: int):
        """The ONE LSH family (and shared ``QueryEngine``) every index
        this service builds is constructed around — frozen + hashable,
        so ``bucket_fn_for``'s cache hands all collections the same
        hash function."""
        if self._family is None or self._family.d != d:
            r = self.rcfg
            self._family = make_family("cosine", d=d, L=r.tables,
                                       r=r.radius, delta=r.delta)
            self._shared_engine = QueryEngine(
                CostModel(alpha=1.0, beta=r.beta_over_alpha),
                tracer=self.obs.tracer)
        return self._family

    def _make_index(self, obs: Optional[Observability] = None,
                    d: Optional[int] = None):
        """Build one fresh, empty streaming index per ``RetrievalConfig``
        (the collection factory; ``index_corpus`` reuses it for the
        default corpus).  All indexes share the family, the engine, and
        the service's obs bundle (the manager passes a per-collection
        event facade as ``obs``)."""
        r = self.rcfg
        d = int(d) if d is not None else int(self.cfg.d_model)
        fam = self._lsh_family(d)
        common = dict(
            num_buckets=r.num_buckets, m=r.hll_m, cap=r.cap,
            delta_capacity=r.delta_capacity,
            cost_model=CostModel(alpha=1.0, beta=r.beta_over_alpha),
            policy=CompactionPolicy(
                delta_fill=r.compact_delta_fill,
                tombstone_ratio=r.compact_tombstone_ratio,
                fanout=r.compact_fanout,
                step_rows=self._step_rows()),
            obs=obs if obs is not None else self.obs,
            engine=self._shared_engine)
        if r.mesh is not None:
            index = ShardedDynamicHybridIndex(
                fam, mesh=r.mesh, data_axis=r.mesh_axis,
                routing=r.shard_routing, max_out=r.shard_max_out,
                placement=r.shard_placement, params=self._index_params,
                **common)
        else:
            index = DynamicHybridIndex(fam, params=self._index_params,
                                       device=self.device, **common)
        index.build(torch.zeros((0, d), dtype=torch.float32,
                                device=self.device))
        return index

    def _ensure_driver(self) -> CompactionDriver:
        """The ONE async-compaction driver (created + started on first
        need); its worker round-robins over every attached index —
        default corpus and collections alike."""
        if self.driver is None:
            self.driver = CompactionDriver(
                budget_rows=self._step_rows(), obs=self.obs).start()
            self.collections.driver = self.driver
        return self.driver

    def index_corpus(self, batches: Iterable):
        """Embed + build the default corpus index per
        ``RetrievalConfig`` (mesh set -> sharded index with the
        configured routing / placement); returns the corpus size.  With
        ``async_compaction`` the index is attached to the service's
        shared ``CompactionDriver`` under the reserved name ``""``
        (detached first on a rebuild — collections stay attached)."""
        if self.driver is not None:
            self.driver.detach("")
        corpus = self._embed_corpus(batches)
        self.index = self._make_index(d=corpus.shape[1])
        self.index.build(corpus)
        if self.rcfg.async_compaction:
            self._ensure_driver().attach("", self.index)
        return corpus.shape[0]

    # ------------------------------------------------- collection lifecycle
    def create_collection(self, name: str,
                          batches: Optional[Iterable] = None, *,
                          quota: Optional[TenantQuota] = None) -> int:
        """Create a named collection (docs/serving.md "Collections");
        returns its initial corpus size.

        ``batches`` (optional) embeds + builds the tenant's initial
        corpus exactly like ``index_corpus`` does for the default one;
        omitted = empty collection, ready for ``add_documents``.
        ``quota`` installs the tenant's scheduler token bucket + drain
        weight.  In async mode the new index attaches to the shared
        driver — after the build, so the worker never races it.
        """
        if self.rcfg.async_compaction:
            self.collections.driver = self._ensure_driver()
        col = self.collections.create(name, quota=quota, attach=False)
        n = 0
        if batches is not None:
            corpus = self._embed_corpus(batches)
            col.index.build(corpus)
            n = int(corpus.shape[0])
        self.collections.attach_driver(name)
        if self.driver is not None:
            self.driver.notify()
        return n

    def drop_collection(self, name: str) -> "Collection":
        """Drop a named collection: detached from the driver, queued
        requests discarded, cache entries purged.  Returns the removed
        ``Collection`` (its index is still queryable by the caller)."""
        return self.collections.drop(name)

    def _index_for(self, collection: str):
        """Resolve a collection id to its index ("" = default corpus)."""
        if not collection:
            assert self.index is not None, "call index_corpus first"
            return self.index
        return self.collections.get(collection).index

    # ------------------------------------------------------- live mutation
    def add_documents(self, batches: Iterable,
                      collection: str = "") -> np.ndarray:
        """Embed + insert new documents; returns their doc ids.

        Inserts land in the delta segment(s) (no rebuild); compaction
        folds them into the main segment per the configured policy.
        ``collection`` targets a named collection ("" = default corpus).
        """
        ids = self._index_for(collection).insert(
            self._embed_corpus(batches))
        if self.driver is not None:
            self.driver.notify()      # a freeze may have queued a merge
        return ids

    def remove_documents(self, doc_ids: Sequence[int],
                         collection: str = "") -> int:
        """Tombstone documents by id; returns #removed."""
        removed = self._index_for(collection).delete(doc_ids)
        if self.driver is not None:
            self.driver.notify()      # tombstone pressure may queue work
        return removed

    def query(self, batch, radius: Optional[float] = None,
              collection: str = ""):
        """Returns (QueryResult, embeddings).

        Deliberately does NOT advance compaction: with
        ``compact_step_rows`` set, merge steps belong between batches —
        wire ``compaction_tick`` as the scheduler's ``background_tick``
        (or call it from the serving loop), never inside a request.
        """
        index = self._index_for(collection)
        q = self.embed(batch)
        res = self._routed_query(index, q, radius or self.rcfg.radius,
                                 collection)
        return res, q

    def _routed_query(self, index, emb, radius: float, collection: str):
        """One index query with per-tenant attribution: spans recorded
        while this runs carry the collection (shared tracer context),
        and counts land in both the service-wide totals and — for named
        collections — the per-tenant labeled series."""
        tracer = self.obs.tracer
        tracer.set_context(collection=collection or None)
        try:
            res = index.query(emb, radius)
        finally:
            tracer.set_context()
        self._queries_served += res.n_queries
        # exact per-query linear count from the route partition (the
        # frac_linear*n round-trip drifts under rounding)
        self._linear_served += res.n_linear
        self._m_queries.inc(res.n_queries)
        self._m_linear.inc(res.n_linear)
        if collection:
            self.collections.note_query(collection, res.n_queries,
                                        res.n_linear)
        return res

    # ------------------------------------------- coalesced serving path
    def submit(self, batch, radius: Optional[float] = None,
               collection: str = "") -> Optional[int]:
        """Enqueue one retrieval request for coalesced dispatch.

        ``batch`` is a token batch dict (or a bare token array); a 1-D
        row is treated as a single query.  ``collection`` routes to a
        named collection ("" = default corpus; unknown names raise at
        the door, not at drain time).  Returns the request uid, or
        None when admission control sheds it — the tenant's own token
        bucket, or the global queue bound (both counted in
        ``repro_scheduler_rejects_total``, per-collection labeled).
        Results come back from ``drain_batches`` keyed by this uid.
        """
        collection = str(collection)
        if collection:
            self.collections.get(collection)   # raise early on unknown
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        tokens = (tokens.cpu().numpy() if isinstance(tokens, torch.Tensor)
                  else np.asarray(tokens))
        if tokens.ndim == 1:
            tokens = tokens[None, :]
        r = float(radius if radius is not None else self.rcfg.radius)
        return self.scheduler.submit({"tokens": tokens, "radius": r},
                                     collection=collection)

    def drain_batches(self, max_batches: Optional[int] = None,
                      force: bool = False) -> Dict[int, "RequestResult"]:
        """Form and serve coalesced batches until the scheduler yields
        nothing (deadline not reached, or queue empty).

        ``force=True`` flushes requests still inside the coalescing
        deadline (shutdown, test barriers); ``max_batches`` bounds the
        work per call so a serving loop can interleave drains with
        other duties.  Returns uid -> ``RequestResult`` for every
        request served this call.
        """
        assert self.index is not None or len(self.collections), \
            "call index_corpus or create_collection first"
        out: Dict[int, RequestResult] = {}
        served = 0
        while max_batches is None or served < max_batches:
            reqs, _bucket = self.scheduler.next_batch(force=force)
            if not reqs:
                break
            out.update(self._serve_batch(reqs))
            served += 1
        return out

    def _serve_batch(self, reqs) -> Dict[int, "RequestResult"]:
        """Serve one formed batch: cache lookups first, then one embed +
        one routed index query per (collection, radius, seq) miss
        group, scattered back per request by uid.  A formed batch may
        span tenants (the scheduler drains weighted-fair across them);
        each tenant's requests dispatch against its own index at its
        own version."""
        versions: Dict[str, int] = {}
        out: Dict[int, RequestResult] = {}
        # (collection, radius, seq_len) -> [(req, key)]; rows of one
        # group share one index and one embed + query shape, so they
        # coalesce into one dense pow2 dispatch through the fused
        # kernels
        groups: Dict[tuple, list] = {}
        for req in reqs:
            col = req.collection
            version = versions.get(col)
            if version is None:
                version = self._index_for(col).version
                self.cache.purge_stale(version, collection=col)
                versions[col] = version
            tokens = req.payload["tokens"]
            radius = req.payload["radius"]
            key = self.cache.key(version, radius, tokens, collection=col)
            hit = self.cache.get(key)
            if hit is not None:
                ids, dists = hit
                out[req.uid] = RequestResult(
                    uid=req.uid, ids=list(ids), dists=list(dists),
                    n_queries=len(ids), cached=True,
                    queue_wait_s=req.wait_s)
                continue
            groups.setdefault((col, radius, tokens.shape[1]), []).append(
                (req, key))
        for (col, radius, _seq), members in groups.items():
            self._serve_miss_group(col, radius, members, out)
        return out

    def _serve_miss_group(self, collection: str, radius: float,
                          members, out) -> None:
        index = self._index_for(collection)
        rows = np.concatenate([req.payload["tokens"]
                               for req, _ in members], axis=0)
        nq = rows.shape[0]
        n_pad = _pad_size(nq, minimum=self.rcfg.coalesce_min_bucket)
        if n_pad > nq:      # repeat the last row; pad results dropped
            rows = np.concatenate(
                [rows, np.repeat(rows[-1:], n_pad - nq, axis=0)], axis=0)
        emb = self.embed({"tokens": rows})
        tracer = self.obs.tracer
        tracer.set_context(collection=collection or None)
        try:
            res = index.query(emb, radius)
        finally:
            tracer.set_context()
        self._queries_served += nq
        n_linear = self._count_linear(res, nq)
        self._linear_served += n_linear
        self._m_queries.inc(nq)
        self._m_linear.inc(n_linear)
        if collection:
            self.collections.note_query(collection, nq, n_linear)
        off = 0
        for req, key in members:
            k = req.payload["tokens"].shape[0]
            pairs = [res.reported(off + j) for j in range(k)]
            ids = [np.asarray(p[0]) for p in pairs]
            dists = [np.asarray(p[1]) for p in pairs]
            self.cache.put(key, ids, dists)
            out[req.uid] = RequestResult(
                uid=req.uid, ids=ids, dists=dists, n_queries=k,
                cached=False, queue_wait_s=req.wait_s)
            off += k

    @staticmethod
    def _count_linear(res, nq: int) -> int:
        """Linear-route count over the REAL rows of a padded batch.

        Single-host results carry the route partition (pad rows land at
        indices >= nq and are excluded exactly); the sharded per-batch
        vote only supports the fractional reconstruction."""
        if hasattr(res, "lin_idx"):
            return len({int(i) for i in np.asarray(res.lin_idx).tolist()
                        if i < nq})
        return round(nq * res.frac_linear)

    def compaction_tick(self) -> bool:
        """The between-batches maintenance hook (wire it as
        ``ShapeBucketScheduler``'s ``background_tick``).  Budgeted mode:
        advance pending merge work by one bounded ``compact_step``.
        Async mode: the driver's cheap ``drain()`` — apply any
        fully-staged atomic swap; the gathers live on the worker.
        Returns True while more compaction work remains.

        ``stats["compaction_ticks"]`` counts only ticks that actually
        ran work (a step that advanced a merge, or a drain that applied
        a swap); no-op ticks land in ``stats["idle_ticks"]``.

        Multi-tenant: the driver's ``drain`` sweeps every attached
        collection; in budgeted mode each tick advances ONE collection
        with pending work, round-robin — the inline mirror of the
        driver worker's fairness.
        """
        indexes = self._all_indexes()
        if not indexes:
            return False
        if self.driver is not None:
            if self.driver.drain() > 0:
                self._compaction_ticks += 1
                self._m_ticks.inc()
            else:
                self._idle_ticks += 1
                self._m_idle.inc()
            return any(bool(i.has_compaction_work) for i in indexes)
        pending = [i for i in indexes if i.has_compaction_work]
        if not pending:
            self._idle_ticks += 1
            self._m_idle.inc()
            return False
        self._compaction_ticks += 1
        self._m_ticks.inc()
        self._tick_rr += 1
        index = pending[self._tick_rr % len(pending)]
        more = bool(index.compact_step(self._step_rows()))
        return more or len(pending) > 1

    def _all_indexes(self) -> List:
        """Default index (if built) + every collection's, in order."""
        out = [self.index] if self.index is not None else []
        out.extend(self.collections.get(n).index
                   for n in self.collections.names())
        return out

    # ------------------------------------------------- driver lifecycle
    def checkpoint(self, manager, step: int,
                   barrier: str = "cut") -> None:
        """Snapshot the FULL collection tree: the default corpus index
        at the top level (the pre-collections layout, so old
        checkpoints stay readable) plus every named collection — index
        state and quota — nested under ``collections/<name>/...`` (a
        per-collection manifest subtree;
        ``CheckpointManager.collection_names`` lists them).

        ``barrier`` selects the async-mode consistency barrier:

        * ``"cut"`` (default): a consistent-cut snapshot — state is
          captured under the driver lock WITHOUT draining queued
          merges (``CompactionDriver.consistent_cut``), and saved
          incrementally: frozen levels are content-addressed via the
          index's cached ``state_digests`` hints, so the snapshot
          writes only the delta, tombstones, and manifest.  Valid
          because staged merge progress is volatile by contract.
          Checkpoint stall is O(delta + manifest), not O(pending
          compaction), in all three compaction modes.
        * ``"flush"``: the legacy barrier — every queued merge
          finishes inline (stage remainder + swap) across ALL attached
          collections, then a full (non-incremental) save runs.

        ``manager`` is a ``CheckpointManager``.
        """
        assert self.index is not None or len(self.collections), \
            "call index_corpus or create_collection first"
        assert barrier in ("cut", "flush"), barrier
        t0 = time.perf_counter()

        def _capture():
            st: Dict[str, object] = {}
            dg: Dict[str, str] = {}
            if self.index is not None:
                st = self.index.state_dict()
                sd = getattr(self.index, "state_digests", None)
                if sd is not None:
                    dg.update(sd())
            cols = self.collections.state_dict()
            if cols:
                st = {**st, "collections": cols}
                dg.update({f"collections/{p}": d for p, d in
                           self.collections.state_digests().items()})
            return st, dg

        if barrier == "flush":
            if self.driver is not None:
                self.driver.flush()
            state, _ = _capture()
            manager.save(step, state, blocking=True)
        else:
            if self.driver is not None:
                state, digests = self.driver.consistent_cut(_capture)
            else:
                state, digests = _capture()
            manager.save_incremental(step, state, digests=digests,
                                     blocking=True)
        self.obs.events.emit(
            "snapshot", step=int(step), barrier=barrier,
            seconds=time.perf_counter() - t0)

    def restore(self, manager, step: Optional[int] = None):
        """Restore the full collection tree from a committed checkpoint
        (the service must be configured the same as the one that
        saved).  The driver worker is stopped around the state swap —
        staging must never run against a stack being replaced — and
        restarted after; staged progress is volatile by contract, so
        nothing is lost.  Named collections are rebuilt exactly:
        current ones dropped, saved ones re-created (with their saved
        quotas) through the shared factory and loaded.  A fresh service
        may restore directly — the default index is built on demand
        when the checkpoint carries top-level corpus state.  Returns
        the restored step (None: no committed checkpoint)."""
        t0 = time.perf_counter()
        if self.driver is not None:
            self.driver.stop()
        state, restored = manager.restore_tree(step=step)
        if state is None:
            if self.driver is not None:
                self.driver.start()
            return None
        cols = state.pop("collections", None) or {}
        if self.rcfg.async_compaction:
            self._ensure_driver()
            self.driver.stop()
        if state:
            if self.index is None:
                self.index = self._make_index()
            self.index.load_state_dict(state)
        self.collections.load_state_dict(cols)
        if self.driver is not None:
            self.driver.start()
            if self.index is not None and "" not in self.driver.indexes():
                self.driver.attach("", self.index)
        self.obs.events.emit(
            "restore", step=int(restored),
            collections=len(cols),
            seconds=time.perf_counter() - t0)
        return restored

    def shutdown(self, flush: bool = True,
                 dump_path: Optional[str] = None) -> None:
        """Stop the driver worker; ``flush=True`` (default) completes
        pending merges inline first so no staging is orphaned.  Safe to
        call with no driver or repeatedly.

        When ``dump_path`` (or ``RetrievalConfig.obs_dump_path``) is
        set and observability is enabled, the final ``metrics()``
        snapshot is written there as JSON — the post-mortem record of
        a serving run.
        """
        if self.driver is not None:
            self.driver.stop(flush=flush)
        self.obs.events.emit("shutdown", flush=flush,
                             queries=self._queries_served)
        path = dump_path or self.rcfg.obs_dump_path
        if path and self.obs.enabled:
            with open(path, "w") as f:
                json.dump(self.metrics(), f, indent=2, sort_keys=True)

    # --------------------------------------------------- export surfaces
    def _sync_gauges(self) -> None:
        self._g_size.set(self.index.n if self.index else 0)

    def metrics(self) -> Dict[str, object]:
        """One JSON-ready observability snapshot: the registry dump,
        the tracer's routing/misroute summary, the event-log tail +
        per-kind counts, and the ``stats`` dict — everything a scrape
        or a shutdown dump needs in one call."""
        self._sync_gauges()
        return _jsonable({
            "registry": self.obs.registry.snapshot(),
            "tracing": self.obs.tracer.summary(),
            "events": {
                "counts_by_kind": self.obs.events.counts_by_kind(),
                "dropped": self.obs.events.dropped,
                "tail": self.obs.events.events(limit=50),
            },
            "stats": self.stats,
        })

    def metrics_text(self) -> str:
        """The registry in Prometheus text exposition format."""
        self._sync_gauges()
        return to_prometheus(self.obs.registry)

    @property
    def stats(self) -> Dict[str, float]:
        """Serving counters merged with the index's ``index_stats()``.

        Includes the per-level LSM counters (segments, levels,
        pending_merges, merges_per_level, compact_steps, freezes, ...)
        and, when the corpus is mesh-sharded, the rebalancing view:
        ``live_per_shard`` / ``delta_per_shard`` loads, ``shard_skew``
        (max / mean live load; 1.0 = balanced), the active ``placement``
        policy, and cumulative ``rows_moved`` across shards.

        The coalesced serving path adds three pinned sub-dicts:
        ``scheduler`` (queue depth, submits/rejects/batches, queue-wait
        aggregates, per-tenant quota views — SCHEDULER_STATS_KEYS /
        SCHEDULER_TENANT_KEYS), ``cache`` (hit/miss/evict/stale
        counters + byte budget — CACHE_STATS_KEYS), and
        ``collections`` (the multi-tenant view —
        COLLECTION_MANAGER_KEYS / COLLECTION_STATS_KEYS per tenant;
        empty manager when only the default corpus is in use).

        ``compaction_ticks`` counts only ticks that ran work;
        ``idle_ticks`` the no-ops.  In async mode a ``driver`` sub-dict
        carries the ``CompactionDriver`` state (``worker_alive``,
        ``pending_gathers``, ``staged_rows``, ``stage_calls``,
        ``drains``/``applied``, ...).
        """
        served = max(self._queries_served, 1)
        out = {"queries": self._queries_served,
               "linear_served": self._linear_served,
               "frac_linear": self._linear_served / served,
               "compaction_ticks": self._compaction_ticks,
               "idle_ticks": self._idle_ticks,
               "index_size": self.index.n if self.index else 0,
               "scheduler": self.scheduler.stats(),
               "cache": self.cache.stats(),
               "collections": self.collections.stats()}
        if self.index is not None:
            out.update((k, v) for k, v in self.index.index_stats().items()
                       if k not in ENGINE_STATS_KEYS)
        if self.driver is not None:
            out["driver"] = self.driver.stats()
        return out


def _jsonable(obj):
    """Recursively coerce numpy scalars/arrays (and tuple/dict-int keys)
    to plain JSON types so ``json.dumps`` round-trips a metrics dump."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonable(obj.tolist())
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if isinstance(obj, (np.floating, float)):
        return float(obj)
    return obj
