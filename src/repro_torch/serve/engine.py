"""Graph-analytics serving: PPM queries over one resident layout.

Counterpart of the graph half of :mod:`repro.serve.engine`
(:class:`GraphQuery`, :class:`GraphQueryServer`), on the port's engines:

  * **Batched multi-source execution**: queued BFS / SSSP /
    SSSP-with-parents queries that differ only in their source vertex are
    drained into one per-app batch and answered by one
    :meth:`repro_torch.core.engine.Engine.run_batched` call, so every DC
    kernel launch (the lane forms, one launch for all lanes on a card) is
    amortized across the batch.
  * **Power-of-two padding**: batches are padded up to the next power of
    two by repeating the first source (padded lanes are discarded), as in
    the reference, so a batch's shapes come from a set of log2(max_batch)
    + 1 widths.
  * **Result memoization and semantic caching**: every cache entry lives in
    one :class:`repro_torch.serve.cache.CacheBackend` under the key space
    of :mod:`repro_torch.serve.cache`: exact-match results under ``res|``
    and converged per-partition *landmark* state under ``sem|``.  A BFS or
    SSSP miss whose source a cached landmark reaches runs landmark-seeded
    on symmetric graphs: BFS through the packed
    :func:`repro_torch.apps.bfs.bfs_seeded_program` (exact), SSSP through
    ``sssp_multi``'s warm start (exact in real arithmetic; in f32 the seed
    ``fl(d_L(v) + d_L(s))`` can round below the cold run's path sum, which
    leaves the answer up to a few ulps below the cold one, as in the
    reference).  A :class:`CacheWarmer` turns repeated sources into
    landmarks after every scheduler tick.

Invalidation is the reference's: entries are keyed by the layout's content
tag; :meth:`GraphQueryServer.clear_cache` is the only wholesale
invalidation; :meth:`GraphQueryServer.swap_layout` starts a new epoch, and
with the graph delta that produced the new layout (``delta=``) evicts the
old tag's entries but for the landmarks it can migrate
(:meth:`GraphQueryServer._scoped_invalidate`).  Cached results are returned
by reference and must be treated as read-only.

Distributed batching: constructed with ``sharded=`` (a
:func:`repro_torch.graph.shard.shard_layout` of the resident layout) and
``mesh=`` (this rank's :class:`repro_torch.dist.Mesh`), the shared engines
become :class:`repro_torch.dist.engine.DistEngine` instances and each
drained batch advances across the ranks through their ``run_batched``.
Every rank runs the same server and is given the same queries in the same
order.  A sharded server seeds no lane from landmarks (exact-match caching
only), as in the reference.

The server runs on ``device`` (a CUDA device by default, which must exist;
``device="cpu"`` runs the kernels' plain versions); a sharded server's
shared engines run on the mesh's device.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np

from .. import obs
from ..apps.bfs import (bfs, bfs_multi, bfs_program, bfs_seeded_multi,
                        bfs_seeded_program)
from ..apps.cc import cc_program, connected_components
from ..apps.nibble import nibble, nibble_program
from ..apps.pagerank import pagerank, pagerank_program
from ..apps.sssp import sssp, sssp_multi, sssp_program
from ..apps.sssp_parents import (sssp_parents_multi, sssp_parents_program,
                                 sssp_with_parents)
from ..core.engine import Engine, _next_pow2, resolve_device
from ..dist.engine import DistEngine
from . import ServeConfig
from . import cache as cache_lib

#: the reference's backend names the port's engines take: None runs the
#: kernels (CUDA on a card), "ref" their plain PyTorch versions
PLAIN_BACKENDS = {None: False, "ref": True}


def _check_sharding(sharded, mesh):
    if (sharded is None) != (mesh is None):
        raise ValueError("distributed serving needs BOTH sharded and mesh "
                         "(or neither)")


def _plain(backend) -> bool:
    if backend not in PLAIN_BACKENDS:
        raise ValueError(f"repro_torch engines take backend None (the "
                         f"kernels) or 'ref' (their plain versions), not "
                         f"{backend!r}")
    return PLAIN_BACKENDS[backend]


@dataclasses.dataclass
class GraphQuery:
    qid: int
    app: str        # bfs | sssp | sssp_parents | cc | pagerank | nibble
    params: dict = dataclasses.field(default_factory=dict)
    result: Optional[dict] = None


class GraphQueryServer:
    """Serve repeated graph-analytics queries over one resident layout.

    The layout is built once, and the parameter-free vertex programs (BFS,
    SSSP, SSSP with parents, CC, and the seeded BFS) share one port
    :class:`Engine` each across queries, so a second query from another
    source pays only its iterations.

    :meth:`step` is one scheduler tick: it drains every queued query that
    is batchable with the head of the queue (same app, same non-source
    params, every param within the ``*_multi`` signature; engine overrides
    opt out) into one per-app batch, pads the distinct sources to the next
    power of two, and answers the batch with one
    :meth:`~repro_torch.core.engine.Engine.run_batched` call.  Repeated
    ``(app, params)`` queries are memoized as exact-match entries; BFS and
    SSSP misses near a cached landmark run landmark-seeded.  After every
    tick the warmer gets ``ServeConfig.warm_budget`` jobs.  Queries
    overriding ``mode`` / ``backend`` / ``bw_ratio`` run on an engine of
    their own and never touch the shared ones.
    """

    #: apps whose queries differ only in ``source`` and can share a batch
    BATCHED_APPS = ("bfs", "sssp", "sssp_parents")
    #: the full param set the ``*_multi`` entry points accept; a query
    #: carrying anything else takes the single-query path
    BATCH_PARAMS = frozenset({"source", "max_iters"})
    #: engine-construction params: a query overriding any of these cannot
    #: share the server's engine
    ENGINE_KEYS = frozenset({"mode", "backend", "bw_ratio"})
    #: apps the semantic cache can seed: the landmark-proximity distance
    #: field, the converged state fields captured per landmark, and each
    #: field's fill value on untouched partitions.  ``sssp_parents`` is
    #: absent, as in the reference: exact-match caching only.
    SEEDED_FIELDS = {
        "bfs": ("level", ("level", "parent"),
                {"level": -1.0, "parent": -1.0}),
        "sssp": ("dist", ("dist",), {"dist": float("inf")}),
    }

    def __init__(self, layout, config: Optional[ServeConfig] = None,
                 device="cuda"):
        config = config or ServeConfig()
        _check_sharding(config.sharded, config.mesh)
        self.device = resolve_device(device)
        self.config = config
        self.layout = layout
        self.backend = config.backend
        self.plain = _plain(config.backend)
        self.mode = config.mode
        self.max_batch = config.max_batch
        self.cache_size = config.cache_size
        #: when set (with ``mesh``), the shared engines are DistEngines over
        #: the sharded layout and batches fan out across the ranks
        self.sharded = config.sharded
        self.mesh = config.mesh
        self._engines = {}            # app name -> shared (Dist)Engine
        self.queue = collections.deque()
        self.done = []
        #: the CacheBackend every entry lives in (exact results AND
        #: semantic landmark state: one shared namespace)
        self.cache = cache_lib.make_backend(config.cache_backend,
                                            config.cache_size)
        self.cache_hits = 0
        self.cache_misses = 0
        self.semantic_hits = 0        # lanes answered landmark-seeded
        self.semantic_misses = 0      # seedable lanes with no landmark
        # metric series are labeled by layout identity, as are cache keys
        self._layout_tag = cache_lib.layout_tag(layout)
        #: monotone swap counter
        self.epoch = 0
        self._bind_layout()

    def _bind_layout(self):
        """(Re)build the layout-scoped cache clients: the semantic view,
        the warmer, and the lazily computed symmetry flags."""
        lay, cfg = self.layout, self.config
        self.semantic = (cache_lib.SemanticCache(
            self.cache, self._layout_tag, lay.k, lay.q, lay.n_pad)
            if cfg.semantic else None)
        self.warmer = (cache_lib.CacheWarmer(
            self.semantic, threshold=cfg.warm_threshold,
            budget=cfg.warm_budget) if self.semantic is not None else None)
        self._sym = {}                # weights-flag -> bool (lazy)

    def _symmetric(self, need_weights: bool) -> bool:
        """Seeding precondition, computed once per layout (BFS needs
        structural symmetry, SSSP structure and weights)."""
        flag = self._sym.get(need_weights)
        if flag is None:
            flag = cache_lib.layout_is_symmetric(self.layout,
                                                 weights=need_weights)
            self._sym[need_weights] = flag
        return flag

    def _seedable(self, app: str) -> bool:
        return (self.semantic is not None and app in self.SEEDED_FIELDS
                and self.sharded is None
                and self._symmetric(need_weights=(app == "sssp")))

    # ---- engines -------------------------------------------------------
    def _engine(self, program, mode=None, backend=None, bw_ratio=None):
        kw = {} if bw_ratio is None else {"bw_ratio": bw_ratio}
        return Engine(self.layout, program, mode=mode or self.mode,
                      device=self.device,
                      plain=self.plain if backend is None
                      else _plain(backend), **kw)

    def _shared_engine(self, app: str, make_program):
        eng = self._engines.get(app)
        if eng is None:
            if self.sharded is not None:
                # D*nv == layout.n_pad: the sharded global vertex space is
                # the single-device one, so the *_multi state construction
                # drives the ranks unchanged
                cfg = self.config
                eng = DistEngine(self.sharded, make_program(), self.mesh,
                                 mode=self.mode, wire_bf16=cfg.wire_bf16,
                                 wire_bitmap=cfg.wire_bitmap,
                                 plain=self.plain)
            else:
                eng = self._engine(make_program())
            self._engines[app] = eng
        return eng

    # ---- cache clients (exact results + semantic state) ----------------
    def _result_key(self, q: GraphQuery) -> Optional[str]:
        """The exact-match entry key (``res|...``), or None when a param
        value defies canonicalization (such a query is not memoized)."""
        return cache_lib.result_key(self._layout_tag, q.app, q.params)

    def _result_get(self, q: GraphQuery):
        key = self._result_key(q)
        return self.cache.get(key) if key is not None else None

    def _note_cache(self, hit: bool, app: str):
        if hit:
            self.cache_hits += 1
        else:
            self.cache_misses += 1
        if obs.enabled():
            obs.inc("serve.cache_hits" if hit else "serve.cache_misses",
                    layout=self._layout_tag, app=app)

    def _reset_layout_metrics(self):
        """Drop this layout's metric series along with the hit/miss ints."""
        self.cache_hits = 0
        self.cache_misses = 0
        self.semantic_hits = 0
        self.semantic_misses = 0
        if obs.enabled():
            reg = obs.registry()
            for name in ("serve.cache_hits", "serve.cache_misses",
                         "serve.semantic_hits", "serve.semantic_misses",
                         "serve.seed_iters_saved", "serve.source_freq",
                         "serve.warmed_landmarks",
                         "serve.query_wall_s", "serve.batch_wall_s"):
                reg.reset_metric(name, layout=self._layout_tag)

    def clear_cache(self):
        """Invalidate everything: one :meth:`CacheBackend.clear` drops exact
        results and semantic landmark state, and the warmer forgets its
        statistics."""
        self.cache.clear()
        if self.warmer is not None:
            self.warmer.reset()
        self._reset_layout_metrics()
        if obs.enabled():
            obs.event("cache_clear", layout=self._layout_tag)

    def _scoped_invalidate(self, old_layout, old_tag, new_layout, new_tag,
                           delta):
        """Delta-swap garbage collection, scoped by per-partition content
        tags.  Returns ``(evicted, migrated, changed_parts)``.

        The old tag's ``res|`` entries are always evicted (an exact global
        answer is stale under any edge edit).  A ``sem|`` landmark entry is
        judged by the partitions it stores: if the delta is insertion-only
        and none of them changed tag, the entry is *migrated*, re-keyed
        under the new tag, where its state is still a pointwise upper bound
        of every new fixpoint (insertions only lower min-monoid distances),
        which is what a seed needs.  Everything else under
        ``sem|<old>|`` is evicted."""
        old_ptags = cache_lib.partition_tags(old_layout)
        new_ptags = cache_lib.partition_tags(new_layout)
        changed = {p for p, (a, b) in enumerate(zip(old_ptags, new_ptags))
                   if a != b}
        evicted = cache_lib.evict_prefix(self.cache, f"res|{old_tag}|")
        migratable = delta.insertions_only
        sem_prefix = f"sem|{old_tag}|"
        migrated = 0
        for key in list(self.cache.keys()):
            if not isinstance(key, str) or not key.startswith(sem_prefix):
                continue
            entry = self.cache.get(key) if migratable else None
            if entry is not None:
                parts = set(np.asarray(entry.get("parts", ())).tolist())
                if not (parts & changed):
                    new_key = f"sem|{new_tag}|" + key[len(sem_prefix):]
                    self.cache.put(new_key, entry)
                    self.cache.evict(key)
                    migrated += 1
                    continue
            if self.cache.evict(key):
                evicted += 1
        return evicted, migrated, changed

    def swap_layout(self, layout, sharded=None, mesh=None, delta=None):
        """Re-point the server at a new resident layout (a new epoch).

        Queued queries drain on the old layout first; then the epoch bumps,
        the shared engines are dropped, and the warmer statistics and
        old-tag metric series reset.  With ``delta=None`` nothing is
        evicted: entries are keyed by content tag, so another layout's
        entries are merely invisible until it returns.  With ``delta=`` the
        :class:`repro_torch.graph.delta.DeltaBuffer` that produced
        ``layout`` (usually through
        :func:`repro_torch.graph.delta.apply_delta`), the old tag's
        superseded entries are garbage-collected and clean-partition
        landmarks of an insertion-only delta migrate to the new tag
        (:meth:`_scoped_invalidate`).  ``sharded`` / ``mesh`` (both or
        neither) put the new layout's shared engines on the ranks."""
        _check_sharding(sharded, mesh)
        if delta is not None and (delta.k != layout.k
                                  or delta.q != layout.q
                                  or delta.n != layout.n):
            raise ValueError("delta partitioning does not match the new "
                             "layout (deltas never change k/q/n)")
        if self.queue:
            self.run()                 # drain epoch N on the old layout
        old_layout, old_tag = self.layout, self._layout_tag
        new_tag = cache_lib.layout_tag(layout)
        evicted = migrated = 0
        changed = set()
        if delta is not None:
            evicted, migrated, changed = self._scoped_invalidate(
                old_layout, old_tag, layout, new_tag, delta)
        self._engines = {}
        if self.warmer is not None:
            self.warmer.reset()
        self._reset_layout_metrics()
        self.layout = layout
        self.sharded = sharded
        self.mesh = mesh
        self.config = dataclasses.replace(self.config, sharded=sharded,
                                          mesh=mesh)
        self._layout_tag = new_tag
        self._bind_layout()
        self.epoch += 1
        if obs.enabled():
            obs.event("layout_swap", old=old_tag, new=new_tag)
            obs.event("epoch_swap", old=old_tag, new=new_tag,
                      epoch=self.epoch, delta=delta is not None,
                      changed_parts=len(changed), evicted=evicted,
                      migrated=migrated)

    # ---- batching ------------------------------------------------------
    def _batch_sig(self, q: GraphQuery):
        """Queries with equal signatures can ride one batch."""
        if q.app not in self.BATCHED_APPS or "source" not in q.params \
                or not (q.params.keys() <= self.BATCH_PARAMS):
            return None
        rest = {k: v for k, v in q.params.items() if k != "source"}
        try:
            return (q.app, tuple(sorted(rest.items())))
        except TypeError:
            return None

    # ---- landmark seeding ----------------------------------------------
    def _lookup_landmarks(self, app, extra, sources):
        """Best landmark per distinct source: ``(lm, entry, d_ls)`` or
        None.  Counts semantic hits and misses per lane."""
        dist_field = self.SEEDED_FIELDS[app][0]
        picks = []
        for s in sources:
            pick = self.semantic.best_landmark(
                app, extra, int(s), dist_field,
                max_distance=self.config.seed_max_distance)
            picks.append(pick)
            hit = pick is not None
            if hit:
                self.semantic_hits += 1
            else:
                self.semantic_misses += 1
            if obs.enabled():
                obs.inc("serve.semantic_hits" if hit
                        else "serve.semantic_misses",
                        app=app, layout=self._layout_tag)
        return picks

    def _sssp_seed_arrays(self, sources, picks):
        """Per-lane warm SSSP init: ``dist0[v] = d_L(v) + d_L(s)`` (an upper
        bound on symmetric graphs), ``dist0[s] = 0``, and a frontier over
        every finite seed.  Unseeded lanes get the cold one-hot init."""
        n_pad = self.layout.n_pad
        dist0 = np.full((len(sources), n_pad), np.inf, np.float32)
        for i, (s, pick) in enumerate(zip(sources, picks)):
            if pick is not None:
                _, entry, d_ls = pick
                dist0[i] = self.semantic.expand(entry, "dist", np.inf)
                dist0[i] += np.float32(d_ls)
            dist0[i, s] = 0.0
        return dist0, np.isfinite(dist0)

    def _bfs_seed_arrays(self, sources, picks):
        """Per-lane warm BFS init: level upper bounds ``level_L + d_ls``
        with parent-unknown payloads (the sentinel loses every packed tie,
        so the seed stays an upper bound in the lexicographic order)."""
        n_pad = self.layout.n_pad
        levels = np.full((len(sources), n_pad), -1, np.int64)
        parents = np.full((len(sources), n_pad), -1, np.int64)
        for i, (s, pick) in enumerate(zip(sources, picks)):
            if pick is not None:
                _, entry, d_ls = pick
                lv = self.semantic.expand(entry, "level", -1).astype(
                    np.int64)
                lv[lv >= 0] += int(d_ls)
                levels[i] = lv
            levels[i, s] = 0
            parents[i, s] = s
        return levels, parents, levels >= 0

    def _capture_landmarks(self, app, extra, sources, res, iters):
        """Store each computed lane's converged state as a landmark."""
        dist_field, fields, fills = self.SEEDED_FIELDS[app]
        n, n_pad = self.layout.n, self.layout.n_pad
        for i, s in enumerate(sources):
            if self.semantic.get_state(app, extra, int(s)) is not None:
                continue
            fvecs = {}
            for name in fields:
                row = np.asarray(res[name][i])
                full = np.full(n_pad, fills[name], dtype=row.dtype)
                full[:n] = row
                fvecs[name] = full
            anchor = fvecs[dist_field]
            touched = (np.isfinite(anchor) if app == "sssp"
                       else anchor >= 0)
            self.semantic.put_state(app, extra, int(s), fvecs, touched,
                                    fills, iters)

    def _run_batch(self, batch):
        """Answer a same-signature batch with one ``run_batched`` call,
        landmark-seeding the lanes that cached semantic state reaches."""
        multi = {"bfs": (bfs_multi, bfs_program),
                 "sssp": (sssp_multi, sssp_program),
                 "sssp_parents": (sssp_parents_multi, sssp_parents_program)}
        run = []                       # queries that actually need a lane
        for q in batch:
            cached = self._result_get(q)
            if cached is not None:
                self._note_cache(True, q.app)
                if obs.enabled():
                    obs.event("serve_query", app=q.app,
                              layout=self._layout_tag, cached=True,
                              wall_s=0.0)
                q.result = cached
                self.done.append(q)
            else:
                run.append(q)
        if not run:
            return
        app = run[0].app
        multi_fn, make_program = multi[app]
        # duplicate sources share a lane; pad to the next power of two by
        # repeating the first source (padded lanes are discarded below)
        lane_of = {}
        for q in run:
            lane_of.setdefault(int(q.params["source"]), len(lane_of))
        distinct = list(lane_of)
        extra = {k: v for k, v in run[0].params.items() if k != "source"}
        picks = None
        if self._seedable(app):
            picks = self._lookup_landmarks(app, extra, distinct)
            if not any(p is not None for p in picks):
                picks = None           # nothing to seed: cold fast path
        pad = _next_pow2(len(distinct)) - len(distinct)
        sources = distinct + [distinct[0]] * pad
        t0 = time.perf_counter()
        if picks is not None:
            padded_picks = picks + [picks[0]] * pad
            if app == "sssp":
                dist0, frontier0 = self._sssp_seed_arrays(sources,
                                                          padded_picks)
                eng = self._shared_engine("sssp", sssp_program)
                res = multi_fn(self.layout, sources, engine=eng,
                               dist0=dist0, frontier0=frontier0, **extra)
            else:                      # bfs: the warm-startable program
                levels, parents, frontier0 = self._bfs_seed_arrays(
                    sources, padded_picks)
                eng = self._shared_engine("bfs_seeded", bfs_seeded_program)
                res = bfs_seeded_multi(self.layout, sources, engine=eng,
                                       seed_levels=levels,
                                       seed_parents=parents,
                                       frontiers=frontier0, **extra)
        else:
            eng = self._shared_engine(app, make_program)
            res = multi_fn(self.layout, sources, engine=eng, **extra)
        wall = time.perf_counter() - t0
        iters = len(res["stats"])
        if picks is not None:
            # iterations saved against the landmark's own cold convergence
            lm_iters = max(int(p[1]["meta"]["iters"])
                           for p in picks if p is not None)
            saved = max(0, lm_iters - iters)
            if obs.enabled():
                obs.event("seeded_batch", app=app, layout=self._layout_tag,
                          batch=len(run),
                          seeded=sum(p is not None for p in picks),
                          iters=iters, saved_iters=saved)
                obs.inc("serve.seed_iters_saved", saved, app=app,
                        layout=self._layout_tag)
        if self.config.capture_landmarks and self._seedable(app):
            self._capture_landmarks(app, extra, distinct, res, iters)
        if obs.enabled():
            obs.event("serve_batch", app=app, layout=self._layout_tag,
                      batch=len(run), distinct_sources=len(lane_of),
                      width=len(sources), wall_s=wall)
            obs.observe("serve.batch_wall_s", wall, app=app,
                        layout=self._layout_tag)
            # a batched query's latency is the batch wall: every lane
            # waits for the union frontier to drain
            for _ in run:
                obs.observe("serve.query_wall_s", wall, app=app,
                            layout=self._layout_tag)
        for q in run:
            i = lane_of[int(q.params["source"])]
            # a copy of the row (a view would pin the whole batch result);
            # 'stats' is the batch's, one list copy per query
            out = {k: (np.array(v[i]) if k != "stats" else list(v))
                   for k, v in res.items()}
            self._note_cache(False, q.app)
            key = self._result_key(q)
            if key is not None:
                self.cache.put(key, out)
            q.result = out
            self.done.append(q)

    # ---- single-query path (overrides + non-batchable apps) -----------
    def _run_query(self, q: GraphQuery) -> dict:
        p = dict(q.params)
        custom = bool(self.ENGINE_KEYS & p.keys())
        mode = p.pop("mode", self.mode)
        backend = p.pop("backend", self.backend)
        bw_ratio = p.pop("bw_ratio", None)
        shared = {"bfs": (bfs, bfs_program), "sssp": (sssp, sssp_program),
                  "cc": (connected_components, cc_program),
                  "sssp_parents": (sssp_with_parents,
                                   sssp_parents_program)}
        if q.app in shared:
            app_fn, make_program = shared[q.app]
            if custom:
                eng = self._engine(make_program(), mode=mode,
                                   backend=backend, bw_ratio=bw_ratio)
                return app_fn(self.layout, engine=eng, **p)
            return app_fn(self.layout, engine=self._shared_engine(
                q.app, make_program), **p)
        if q.app == "pagerank":
            # damping is baked into the program: no engine sharing
            program = pagerank_program(self.layout.n,
                                       p.get("damping", 0.85))
            eng = self._engine(program, mode="dc" if mode == "hybrid"
                               else mode, backend=backend)
            return pagerank(self.layout, engine=eng, **p)
        if q.app == "nibble":
            eng = self._engine(nibble_program(p.get("eps", 1e-4)),
                               mode=mode, backend=backend)
            return nibble(self.layout, engine=eng, **p)
        raise ValueError(f"unknown graph app {q.app!r}")

    # ---- async warming -------------------------------------------------
    def _warm_compute(self, app, extra, source):
        """Warmer callback: converge ``source`` cold on the shared engine,
        store its state as a landmark and its exact result."""
        multi = {"bfs": (bfs_multi, bfs_program),
                 "sssp": (sssp_multi, sssp_program)}
        if app not in multi or not self._seedable(app):
            return
        multi_fn, make_program = multi[app]
        eng = self._shared_engine(app, make_program)
        res = multi_fn(self.layout, [int(source)], engine=eng, **extra)
        self._capture_landmarks(app, extra, [int(source)], res,
                                len(res["stats"]))
        row = {k: (np.array(v[0]) if k != "stats" else list(v))
               for k, v in res.items()}
        key = cache_lib.result_key(self._layout_tag, app,
                                   dict(extra, source=int(source)))
        if key is not None:
            self.cache.put(key, row)

    def _maybe_warm(self):
        """Give the warmer its per-tick budget after every :meth:`step`."""
        if self.warmer is None:
            return
        self.warmer.scan()
        if self.warmer.pending:
            self.warmer.drain(self._warm_compute)

    def submit(self, q: GraphQuery):
        self.queue.append(q)
        if self.warmer is not None and q.app in self.SEEDED_FIELDS \
                and self._batch_sig(q) is not None:
            extra = {k: v for k, v in q.params.items() if k != "source"}
            self.warmer.note_query(q.app, extra, int(q.params["source"]))
        if obs.enabled():
            obs.set_gauge("serve.queue_depth", len(self.queue),
                          layout=self._layout_tag)

    def step(self) -> bool:
        """One scheduler tick: answer the head query, with every queued
        query batchable with it when its app batches, consulting the result
        cache first; every tick ends with the warmer's budget."""
        if not self.queue:
            return False
        q = self.queue.popleft()
        sig = self._batch_sig(q)
        if sig is not None:
            batch, rest = [q], []
            for other in self.queue:
                if len(batch) < self.max_batch \
                        and self._batch_sig(other) == sig:
                    batch.append(other)
                else:
                    rest.append(other)
            self.queue = collections.deque(rest)
            if obs.enabled():
                obs.set_gauge("serve.queue_depth", len(self.queue),
                              layout=self._layout_tag)
            self._run_batch(batch)
            self._maybe_warm()
            return True
        cached = self._result_get(q)
        if cached is not None:
            self._note_cache(True, q.app)
            if obs.enabled():
                obs.event("serve_query", app=q.app,
                          layout=self._layout_tag, cached=True, wall_s=0.0)
            q.result = cached
        else:
            self._note_cache(False, q.app)
            t0 = time.perf_counter()
            q.result = self._run_query(q)
            wall = time.perf_counter() - t0
            if obs.enabled():
                obs.event("serve_query", app=q.app,
                          layout=self._layout_tag, cached=False,
                          wall_s=wall)
                obs.observe("serve.query_wall_s", wall, app=q.app,
                            layout=self._layout_tag)
            key = self._result_key(q)
            if key is not None:
                self.cache.put(key, q.result)
        if obs.enabled():
            obs.set_gauge("serve.queue_depth", len(self.queue),
                          layout=self._layout_tag)
        self.done.append(q)
        self._maybe_warm()
        return True

    def run(self):
        while self.step():
            pass
        return self.done
