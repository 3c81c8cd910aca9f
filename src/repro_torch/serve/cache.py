"""Partition-level semantic caching for the graph-analytics serving tier.

A copy of :mod:`repro.serve.cache` (host NumPy, no JAX in it), rewired to
:mod:`repro_torch.obs`: the same key space, the same on-disk format of
:class:`DiskCache`, and the same :func:`layout_tag` of a layout, so the
port's server and the reference's name and store their entries alike.

An exact-match result cache only hits on an exact ``(layout, app,
params)`` match.  This module generalizes it in two directions:

1. **A formal cache-backend protocol.**  :class:`CacheBackend` is the
   storage contract every serve-tier cache speaks — the exact-match
   result cache and the semantic state cache are both *clients* of the
   same protocol, so in-memory LRU (:class:`MemoryLRU`) and disk-backed
   (:class:`DiskCache`, JSONL index + ``.npz`` payloads) storage are
   interchangeable behind either.

2. **Partition-level semantic entries.**  :class:`SemanticCache` stores
   *converged per-partition state* — BFS level/parent vectors per source,
   SSSP distance vectors per source, PageRank vectors per damping factor
   — chunked by the partitions the query actually touched (GPOP's thesis
   that partitions are the right locality granularity, applied *across*
   queries).  A cached source is a **landmark**: a new query whose source
   is within reach of a landmark is *seeded* from the cached state
   instead of a cold frontier, and converges in fewer or equal
   iterations while remaining exactly correct.

Key space (documented contract; both clients share one namespace so a
single backend instance may serve both):

  ``res|<layout>|<app>|<canon params>``
      an exact-match query result;
  ``sem|<layout>|<app>|<canon extra params>|src=<landmark>``
      converged per-partition state from landmark source ``<landmark>``
      (``extra params`` = everything except the source, e.g. SSSP with a
      custom ``max_iters``, or ``damping`` for PageRank vectors).

``<layout>`` is the server's *content-derived* layout tag
(:func:`layout_tag`), so the invalidation rule is **scoped, not
wholesale**:

* a plain ``swap_layout(new)`` evicts *nothing* — entries are invisible
  under the new tag's key namespace but stay resident, so swapping back
  to a layout the backend has seen (A -> B -> A) revalidates its entries
  for free;
* a delta swap (``swap_layout(new, delta=...)``) evicts only what the
  delta actually invalidated: the old tag's exact-match ``res|`` entries
  (a global answer is stale under any edge edit) and the ``sem|``
  entries whose stored partitions intersect a partition whose content
  tag (:func:`partition_tags`) changed; clean-partition entries of an
  insertion-only delta are *migrated* to the new tag (still-sound
  upper-bound seeds — see ``serve/engine.py``);
* wholesale :meth:`CacheBackend.clear` remains the contract of
  ``clear_cache()`` only.

Prefix-scoped eviction is part of the protocol
(:meth:`CacheBackend.evict_prefix`, with a ``keys()``-scan default), so
backends can specialize it without the serve tier caring.

Why landmark seeding is exactly correct (monotone min-monoids)
--------------------------------------------------------------

For a min-monoid vertex program (BFS, SSSP) the converged state from
source ``s`` is the least fixpoint ``d_s``.  Relaxation from ANY initial
state that is a pointwise *upper bound* of ``d_s`` (with ``d_s(s) = 0``)
converges to exactly ``d_s``: the fixpoint of Bellman-Ford relaxation
from ``init`` is ``min_u (init[u] + dist(u, v))``, which the upper-bound
property squeezes to ``d_s(v)`` from both sides.  A landmark ``L`` with
converged state ``d_L`` supplies such a bound on *symmetric* graphs via
the triangle inequality::

    d_s(v)  <=  d_s(L) + d_L(v)  =  d_L(s) + d_L(v)

so seeding ``init[v] = d_L(v) + d_L(s)`` (and ``init[s] = 0``) with the
initial frontier set to every vertex the landmark reached is safe: stale
upper bounds are *corrected*, never believed.  Symmetry is required
twice — it turns ``d_s(L)`` into the known ``d_L(s)``, and it makes
"unreached by L" imply "unreached by s" (so untouched partitions keep
the identity/unreachable value exactly).  The serve tier auto-detects
symmetry from the layout's CSR (cached per layout) and silently skips
seeding on directed graphs.

BFS needs one extra care: the stock first-visit program derives levels
from the iteration counter, which a warm start breaks.  Seeded BFS
therefore runs the packed lexicographic ``(level, parent)`` min-monoid
relaxation (:func:`repro_torch.apps.bfs.bfs_seeded_program`), whose cold run
is bit-identical to stock BFS — see the proof sketch in that docstring.

Async warming
-------------

:class:`CacheWarmer` turns query-log statistics (per-app source
frequencies, mirrored into :mod:`repro_torch.obs` as the ``serve.source_freq``
counter) into landmark precomputation jobs.  The serve tier drains a
small fixed budget of jobs at the end of *every*
:meth:`GraphQueryServer.step` tick — bounded, so the latency tax per
tick is capped, but unconditional, so sustained traffic (exactly the
regime that produces hot sources) cannot starve warming.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, Optional, Protocol, runtime_checkable

import numpy as np

from .. import obs

# ----------------------------------------------------------------------
# key construction (the documented, shared key space)
# ----------------------------------------------------------------------


def canon_params(params: dict) -> Optional[str]:
    """Canonical, deterministic string for a query's param dict, or None
    when a value defies canonicalization (such a query is not cacheable).
    Arrays / lists / tuples flatten to tuples; dict order is irrelevant."""
    def canon(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return tuple(np.asarray(v).reshape(-1).tolist())
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        return v
    try:
        items = tuple(sorted((k, canon(v)) for k, v in params.items()))
        hash(items)
    except TypeError:
        return None
    return repr(items)


def result_key(layout_tag: str, app: str, params: dict) -> Optional[str]:
    """Exact-match result entry: ``res|<layout>|<app>|<canon params>``."""
    canon = canon_params(params)
    if canon is None:
        return None
    return f"res|{layout_tag}|{app}|{canon}"


def semantic_key(layout_tag: str, app: str, extra_params: dict,
                 source: int) -> Optional[str]:
    """Converged-state entry from landmark ``source``:
    ``sem|<layout>|<app>|<canon extra>|src=<source>``."""
    canon = canon_params(extra_params)
    if canon is None:
        return None
    return f"sem|{layout_tag}|{app}|{canon}|src={int(source)}"


def semantic_prefix(layout_tag: str, app: str, extra_params: dict) -> str:
    canon = canon_params(extra_params)
    return f"sem|{layout_tag}|{app}|{canon}|src="


# ----------------------------------------------------------------------
# the backend protocol
# ----------------------------------------------------------------------


@runtime_checkable
class CacheBackend(Protocol):
    """Storage contract of every serve-tier cache.

    Values are dicts whose leaves are ``np.ndarray`` or JSON-able
    scalars / lists / nested dicts (the :class:`DiskCache` round-trip
    preserves arrays bit-exactly and everything else as plain JSON).
    Returned values must be treated as read-only by callers.

    Implementations must provide:

    * ``get(key) -> value | None`` — also refreshes LRU recency;
    * ``put(key, value)`` — inserts/overwrites, evicting least-recently
      -used entries beyond ``capacity``;
    * ``evict(key) -> bool`` — targeted drop, True when present;
    * ``evict_prefix(prefix) -> int`` — drop every key under a prefix,
      returning the count.  **This is the serve tier's invalidation
      primitive**: ``swap_layout(delta=...)`` evicts only the old layout
      tag's superseded prefixes (see the module docstring) instead of
      clearing the backend;
    * ``clear()`` — drop everything.  The contract of ``clear_cache()``
      *only*: layout swaps must never call it, because entries keyed
      under other layout tags stay valid for those layouts;
    * ``keys() -> list[str]`` — snapshot in LRU order (oldest first);
    * ``stats() -> dict`` — at least ``hits / misses / puts / evictions
      / entries``;
    * ``__len__``.
    """

    def get(self, key: str) -> Optional[dict]: ...
    def put(self, key: str, value: dict) -> None: ...
    def evict(self, key: str) -> bool: ...
    def evict_prefix(self, prefix: str) -> int: ...
    def clear(self) -> None: ...
    def keys(self) -> list: ...
    def stats(self) -> dict: ...
    def __len__(self) -> int: ...


def evict_prefix(backend, prefix: str) -> int:
    """Prefix eviction against any backend: dispatches to the backend's
    own ``evict_prefix`` when it has one, otherwise falls back to a
    ``keys()`` scan — so structural third-party backends that predate the
    protocol method still work under scoped invalidation."""
    fn = getattr(backend, "evict_prefix", None)
    if fn is not None:
        return int(fn(prefix))
    return sum(1 for key in list(backend.keys())
               if isinstance(key, str) and key.startswith(prefix)
               and backend.evict(key))


class _StatsBase:
    """Shared hit/miss/put/eviction accounting."""

    def __init__(self):
        self._hits = 0
        self._misses = 0
        self._puts = 0
        self._evictions = 0
        self._lock = threading.Lock()

    def stats(self) -> dict:
        return {"hits": self._hits, "misses": self._misses,
                "puts": self._puts, "evictions": self._evictions,
                "entries": len(self)}

    def evict_prefix(self, prefix: str) -> int:
        """Default ``keys()``-scan implementation of the protocol's
        prefix eviction; backends with an indexed key space may
        override."""
        return sum(1 for key in list(self.keys())
                   if isinstance(key, str) and key.startswith(prefix)
                   and self.evict(key))


class MemoryLRU(_StatsBase):
    """In-memory LRU :class:`CacheBackend`.  ``capacity`` counts entries;
    values are held by reference, so callers must treat them as
    read-only."""

    def __init__(self, capacity: int = 128):
        super().__init__()
        self.capacity = int(capacity)
        self._d: "collections.OrderedDict[str, dict]" = \
            collections.OrderedDict()

    def get(self, key):
        with self._lock:
            if key is None or key not in self._d:
                self._misses += 1
                return None
            self._d.move_to_end(key)
            self._hits += 1
            return self._d[key]

    def put(self, key, value):
        if key is None:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            self._puts += 1
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)
                self._evictions += 1

    def evict(self, key) -> bool:
        with self._lock:
            if key in self._d:
                del self._d[key]
                self._evictions += 1
                return True
            return False

    def clear(self):
        with self._lock:
            self._d.clear()

    def keys(self):
        with self._lock:
            return list(self._d)

    def __len__(self):
        return len(self._d)


class DiskCache(_StatsBase):
    """Disk-backed :class:`CacheBackend`: one ``.npz`` payload per entry
    plus an append-only JSONL operation log (``index.jsonl``) that is
    replayed on construction, so a warm cache survives process restarts.

    The op-log is *compacted* on open whenever it has grown well past the
    live entry count (heavy put/evict churn appends one record per op and
    never rewrites): the replayed state is rewritten atomically as one
    ``put`` record per live entry, and any ``.npz`` payload in the
    directory that no live entry references (crashed writes, records
    dropped by a ``clear``) is unlinked.  Steady-state disk usage is
    therefore O(live entries), not O(operation history).

    Array leaves of the value dict are stored in the npz (bit-exact
    round-trip, no pickling); every other leaf goes through JSON —
    dataclasses and tuples come back as plain dicts / lists, which is
    the documented metadata contract.  Nested dicts are flattened with
    ``/`` separators on the npz side."""

    _ARRAY = "a/"          # npz member prefix for array leaves
    # compact when the op-log is both non-trivial and dominated by dead
    # records: ops > max(COMPACT_MIN_OPS, COMPACT_FACTOR * live entries)
    COMPACT_MIN_OPS = 16
    COMPACT_FACTOR = 4

    def __init__(self, path, capacity: int = 64):
        super().__init__()
        self.path = str(path)
        self.capacity = int(capacity)
        os.makedirs(self.path, exist_ok=True)
        self._index = os.path.join(self.path, "index.jsonl")
        self._d: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()        # key -> npz filename
        n_ops = self._replay()
        if n_ops > max(self.COMPACT_MIN_OPS,
                       self.COMPACT_FACTOR * len(self._d)):
            self._compact()

    # ---- op-log persistence ----
    def _replay(self) -> int:
        """Rebuild the index from the op-log; returns the op count."""
        if not os.path.exists(self._index):
            return 0
        n_ops = 0
        with open(self._index) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue                  # torn tail write
                n_ops += 1
                op = rec.get("op")
                if op == "put":
                    self._d[rec["key"]] = rec["file"]
                    self._d.move_to_end(rec["key"])
                elif op == "evict":
                    self._d.pop(rec.get("key"), None)
                elif op == "clear":
                    self._d.clear()
        # drop index entries whose payload vanished out from under us
        for k in [k for k, fn in self._d.items()
                  if not os.path.exists(os.path.join(self.path, fn))]:
            del self._d[k]
        return n_ops

    def _compact(self):
        """Rewrite the op-log as one ``put`` per live entry (atomically,
        via a tmp file + rename) and unlink payloads no entry references."""
        now = time.time()
        tmp = self._index + ".tmp"
        with open(tmp, "w") as f:
            for key, fname in self._d.items():     # LRU order preserved
                f.write(json.dumps({"op": "put", "key": key,
                                    "file": fname, "ts": now}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._index)
        live = set(self._d.values())
        for fname in os.listdir(self.path):
            if fname.endswith(".npz") and fname not in live:
                self._unlink(fname)

    def _log(self, rec: dict):
        with open(self._index, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()

    def _fname(self, key: str) -> str:
        return hashlib.sha1(key.encode()).hexdigest()[:20] + ".npz"

    # ---- value (de)serialization ----
    def _flatten(self, value: dict, prefix=""):
        arrays, meta = {}, {}
        for k, v in value.items():
            name = f"{prefix}{k}"
            if isinstance(v, np.ndarray):
                arrays[self._ARRAY + name] = v
            elif isinstance(v, dict):
                sub_a, sub_m = self._flatten(v, prefix=name + "/")
                arrays.update(sub_a)
                if sub_m:
                    meta[k] = sub_m
            else:
                if dataclasses.is_dataclass(v):
                    v = dataclasses.asdict(v)
                elif isinstance(v, (list, tuple)):
                    v = [dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                         else x for x in v]
                meta[k] = v
        return arrays, meta

    def _write(self, fname: str, value: dict):
        arrays, meta = self._flatten(value)
        buf = io.BytesIO()
        np.savez(buf, __meta__=np.frombuffer(
            json.dumps(meta, default=str).encode(), dtype=np.uint8),
            **arrays)
        with open(os.path.join(self.path, fname), "wb") as f:
            f.write(buf.getvalue())

    def _read(self, fname: str) -> Optional[dict]:
        fp = os.path.join(self.path, fname)
        if not os.path.exists(fp):
            return None
        with np.load(fp, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            out = dict(meta)
            for name in z.files:
                if not name.startswith(self._ARRAY):
                    continue
                node, parts = out, name[len(self._ARRAY):].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = z[name]
        return out

    # ---- protocol ----
    def get(self, key):
        with self._lock:
            if key is None or key not in self._d:
                self._misses += 1
                return None
            value = self._read(self._d[key])
            if value is None:                 # payload vanished on disk
                del self._d[key]
                self._misses += 1
                return None
            self._d.move_to_end(key)
            self._hits += 1
            return value

    def put(self, key, value):
        if key is None:
            return
        with self._lock:
            fname = self._fname(key)
            self._write(fname, value)
            self._d[key] = fname
            self._d.move_to_end(key)
            self._log({"op": "put", "key": key, "file": fname,
                       "ts": time.time()})
            self._puts += 1
            while len(self._d) > self.capacity:
                old_key, old_fname = self._d.popitem(last=False)
                self._unlink(old_fname)
                self._log({"op": "evict", "key": old_key})
                self._evictions += 1

    def evict(self, key) -> bool:
        with self._lock:
            fname = self._d.pop(key, None)
            if fname is None:
                return False
            self._unlink(fname)
            self._log({"op": "evict", "key": key})
            self._evictions += 1
            return True

    def clear(self):
        with self._lock:
            for fname in self._d.values():
                self._unlink(fname)
            self._d.clear()
            self._log({"op": "clear"})

    def _unlink(self, fname: str):
        try:
            os.unlink(os.path.join(self.path, fname))
        except OSError:
            pass

    def keys(self):
        with self._lock:
            return list(self._d)

    def __len__(self):
        return len(self._d)


def make_backend(spec, capacity: int) -> CacheBackend:
    """Resolve a backend spec: an instance passes through; ``None`` ->
    :class:`MemoryLRU`; a path string -> :class:`DiskCache` at it."""
    if spec is None:
        return MemoryLRU(capacity)
    if isinstance(spec, str):
        return DiskCache(spec, capacity=capacity)
    return spec


# ----------------------------------------------------------------------
# partition-level semantic entries
# ----------------------------------------------------------------------


class SemanticCache:
    """Converged per-partition state, keyed by landmark source.

    One entry stores, for every partition the landmark's computation
    touched, the ``[q]`` slice of each converged state field — plus the
    landmark's own convergence metadata (iteration count, touched-vertex
    count).  Vertices in untouched partitions are implicit (the field's
    ``fill`` identity), which is what makes the entries partition-level:
    a BFS from a well-connected landmark stores nearly everything, a
    Nibble-style local query stores a handful of ``[q]`` blocks.
    """

    def __init__(self, backend: CacheBackend, layout_tag: str,
                 k: int, q: int, n_pad: int):
        self.backend = backend
        self.layout_tag = layout_tag
        self.k, self.q, self.n_pad = int(k), int(q), int(n_pad)

    # ---- store ----
    def put_state(self, app: str, extra_params: dict, source: int,
                  fields: Dict[str, np.ndarray], touched: np.ndarray,
                  fills: Dict[str, Any], iters: int) -> Optional[str]:
        """Store converged ``fields`` (each ``[n_pad]``) from ``source``.

        ``touched`` is a ``[n_pad]`` bool mask of vertices the query
        reached; only partitions containing a touched vertex are stored.
        ``fills`` gives the per-field identity value reconstructed into
        untouched partitions on expansion."""
        key = semantic_key(self.layout_tag, app, extra_params, source)
        if key is None:
            return None
        touched = np.asarray(touched, bool)
        parts = np.unique(
            np.nonzero(touched)[0].astype(np.int64) // self.q)
        parts = parts.astype(np.int32)
        entry = {
            "parts": parts,
            "meta": {"source": int(source), "app": app,
                     "iters": int(iters),
                     "touched": int(touched.sum()),
                     "fills": {k: (None if v is None else float(v))
                               for k, v in fills.items()},
                     "fields": sorted(fields)},
        }
        for name, vec in fields.items():
            vec = np.asarray(vec)
            assert vec.shape == (self.n_pad,), (name, vec.shape)
            entry[f"f_{name}"] = \
                vec.reshape(self.k, self.q)[parts].copy()
        self.backend.put(key, entry)
        return key

    # ---- read ----
    def landmarks(self, app: str, extra_params: dict) -> list:
        """Landmark sources with a cached entry for (app, extra)."""
        prefix = semantic_prefix(self.layout_tag, app, extra_params)
        out = []
        for key in self.backend.keys():
            if key.startswith(prefix):
                try:
                    out.append(int(key[len(prefix):]))
                except ValueError:
                    pass
        return out

    def get_state(self, app: str, extra_params: dict,
                  source: int) -> Optional[dict]:
        key = semantic_key(self.layout_tag, app, extra_params, source)
        return self.backend.get(key) if key is not None else None

    def value_at(self, entry: dict, field: str, vertex: int):
        """One field value at one vertex, or the fill for untouched
        partitions (no full-vector materialization)."""
        parts = np.asarray(entry["parts"])
        p = int(vertex) // self.q
        hit = np.nonzero(parts == p)[0]
        if len(hit) == 0:
            return entry["meta"]["fills"].get(field)
        return entry[f"f_{field}"][int(hit[0]), int(vertex) % self.q]

    def expand(self, entry: dict, field: str, fill) -> np.ndarray:
        """Full ``[n_pad]`` vector: ``fill`` in untouched partitions,
        the stored per-partition slices elsewhere."""
        stored = np.asarray(entry[f"f_{field}"])
        full = np.full((self.k, self.q), fill, dtype=stored.dtype)
        parts = np.asarray(entry["parts"], np.int64)
        if len(parts):
            full[parts] = stored
        return full.reshape(self.n_pad)

    def best_landmark(self, app: str, extra_params: dict, source: int,
                      dist_field: str,
                      max_distance: Optional[float] = None):
        """The cached landmark nearest to ``source`` (by the landmark's
        own converged ``dist_field`` value at ``source``), or None when
        no landmark reaches it (or none is within ``max_distance``).

        Returns ``(landmark_source, entry, d_ls)``."""
        best = None
        for lm in self.landmarks(app, extra_params):
            entry = self.get_state(app, extra_params, lm)
            if entry is None:
                continue
            d = self.value_at(entry, dist_field, source)
            if d is None or not np.isfinite(d) or d < 0:
                continue
            d = float(d)
            if max_distance is not None and d > max_distance:
                continue
            if best is None or d < best[2]:
                best = (lm, entry, d)
        return best


# ----------------------------------------------------------------------
# async cache warmer
# ----------------------------------------------------------------------


class CacheWarmer:
    """Queue-driven landmark precomputation from query-log statistics.

    The serve tier mirrors every submitted source into the
    ``serve.source_freq`` obs counter (labeled by app + layout) *and*
    into this warmer's local frequency table (so warming still works at
    ``REPRO_OBS=0``).  :meth:`scan` promotes sources whose frequency
    reached ``threshold`` and which are not yet landmarks into a pending
    deque; :meth:`drain` pops up to ``budget`` jobs and runs the cold
    computation through a caller-supplied ``compute(app, extra, source)``
    callback that converges the state and stores it into the semantic
    cache.  The serve tier calls ``scan() + drain()`` at the end of
    every :meth:`GraphQueryServer.step` tick — the small fixed budget
    bounds the per-tick latency tax, and running it unconditionally
    (instead of only on idle ticks) keeps sustained traffic from
    starving the warmer forever."""

    def __init__(self, semantic: SemanticCache, threshold: int = 3,
                 budget: int = 1, max_pending: int = 64):
        self.semantic = semantic
        self.threshold = int(threshold)
        self.budget = int(budget)
        self.max_pending = int(max_pending)
        self.pending = collections.deque()
        self._freq = collections.Counter()     # (app, canon extra, src)
        self._extra = {}                       # (app, canon) -> extra dict
        self._done = set()

    # ---- query-log statistics ----
    def note_query(self, app: str, extra_params: dict, source: int):
        canon = canon_params(extra_params)
        if canon is None:
            return
        self._freq[(app, canon, int(source))] += 1
        self._extra[(app, canon)] = dict(extra_params)
        if obs.enabled():
            obs.inc("serve.source_freq", app=app,
                    layout=self.semantic.layout_tag, source=int(source))

    def frequencies(self, app: str, extra_params: dict) -> dict:
        canon = canon_params(extra_params)
        return {s: c for (a, x, s), c in self._freq.items()
                if a == app and x == canon}

    # ---- job management ----
    def scan(self):
        """Promote hot non-landmark sources into the pending queue."""
        for (app, canon, src), count in self._freq.items():
            if count < self.threshold:
                continue
            job = (app, canon, src)
            if job in self._done or job in self.pending:
                continue
            if len(self.pending) >= self.max_pending:
                break
            extra = self._extra[(app, canon)]
            if semantic_key(self.semantic.layout_tag, app, extra,
                            src) in self.semantic.backend.keys():
                self._done.add(job)
                continue
            self.pending.append(job)

    def drain(self, compute, budget: Optional[int] = None) -> int:
        """Run up to ``budget`` pending precomputations through
        ``compute(app, extra_params, source)`` (which stores the result
        into the semantic cache).  Returns the number of jobs run."""
        n = 0
        budget = self.budget if budget is None else budget
        while self.pending and n < budget:
            app, canon, src = self.pending.popleft()
            extra = self._extra.get((app, canon), {})
            t0 = time.perf_counter()
            try:
                compute(app, extra, src)
            finally:
                self._done.add((app, canon, src))
            if obs.enabled():
                obs.event("cache_warm", app=app,
                          layout=self.semantic.layout_tag,
                          source=int(src),
                          wall_s=time.perf_counter() - t0)
                obs.inc("serve.warmed_landmarks", app=app,
                        layout=self.semantic.layout_tag)
            n += 1
        return n

    def reset(self):
        self.pending.clear()
        self._freq.clear()
        self._extra.clear()
        self._done.clear()


# ----------------------------------------------------------------------
# symmetry detection (seeding precondition)
# ----------------------------------------------------------------------


def layout_is_symmetric(layout, weights: bool = True) -> bool:
    """True when the layout's CSR (restricted to the real ``n`` vertices)
    is symmetric — the precondition for landmark seeding (see the module
    docstring).  ``weights=True`` (the SSSP requirement) checks structure
    AND edge weights; ``weights=False`` (the BFS requirement — hop
    distance ignores weights) checks structure only.  O(m log m),
    computed once per layout by the serve tier and cached there."""
    import scipy.sparse as sp
    n = layout.n
    indptr = np.asarray(layout.csr_indptr)[:n + 1]
    lo, hi = int(indptr[0]), int(indptr[-1])
    indices = np.asarray(layout.csr_indices)[lo:hi]
    if np.any(indices >= n):          # edges into padding never exist,
        return False                  # but be safe about sentinels
    data = (np.asarray(layout.csr_w)[lo:hi]
            if weights and layout.csr_w is not None
            else np.ones(hi - lo, np.float32))
    a = sp.csr_matrix((data, indices, indptr - lo), shape=(n, n))
    return (a != a.T).nnz == 0


def layout_tag(layout) -> str:
    """Content-derived layout identity for cache keys and metric labels.

    Unlike ``id(layout)``, two layouts built from the same graph with the
    same partitioning share a tag — which is what lets a
    :class:`DiskCache` survive process restarts and still hit."""
    h = hashlib.sha1()
    h.update(np.asarray([layout.n, layout.k, layout.q],
                        np.int64).tobytes())
    h.update(np.ascontiguousarray(layout.csr_indptr).tobytes())
    h.update(np.ascontiguousarray(layout.csr_indices).tobytes())
    if layout.csr_w is not None:
        h.update(np.ascontiguousarray(layout.csr_w).tobytes())
    return h.hexdigest()[:16]


def partition_tags(layout) -> list:
    """Per-partition content tags: ``tags[p]`` changes iff partition
    ``p``'s out-edges *or* in-edges (with weights) changed.

    This is the scope of delta invalidation: a partition's converged
    state can only be perturbed directly through its own adjacency, so a
    semantic-cache entry whose stored partitions all kept their tags
    survives the swap (as a still-sound upper bound for insertion-only
    deltas — the migration rule in ``serve/engine.py``).  ``apply_delta``
    reuses clean partitions' CSR slices verbatim, which is what makes
    these tags stable across small deltas by construction."""
    n, k, q = layout.n, layout.k, layout.q
    indptr = np.asarray(layout.csr_indptr)[:n + 1]
    indices = np.asarray(layout.csr_indices)
    w = None if layout.csr_w is None else np.asarray(layout.csr_w)
    degs = np.diff(indptr)
    src = np.repeat(np.arange(n, dtype=np.int64), degs)
    dp = (indices.astype(np.int64) // q if q
          else np.zeros(len(indices), np.int64))
    in_order = np.argsort(dp, kind="stable")
    in_start = np.searchsorted(dp[in_order], np.arange(k + 1))
    tags = []
    for p in range(k):
        vs, ve = min(p * q, n), min((p + 1) * q, n)
        e0, e1 = int(indptr[vs]), int(indptr[ve])
        h = hashlib.sha1()
        h.update(np.ascontiguousarray(degs[vs:ve]).tobytes())
        h.update(np.ascontiguousarray(indices[e0:e1]).tobytes())
        if w is not None:
            h.update(np.ascontiguousarray(w[e0:e1]).tobytes())
        sel = in_order[in_start[p]:in_start[p + 1]]
        h.update(np.ascontiguousarray(src[sel]).tobytes())
        h.update(np.ascontiguousarray(indices[sel]).tobytes())
        if w is not None:
            h.update(np.ascontiguousarray(w[sel]).tobytes())
        tags.append(h.hexdigest()[:16])
    return tags
