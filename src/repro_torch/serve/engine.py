"""Serving: LM continuous batching, and PPM queries over one resident layout.

Counterpart of :mod:`repro.serve.engine`.  The LM half (:func:`init_cache`,
:func:`prefill`, :func:`decode_step`, :class:`Request`, :class:`Server`)
runs a :class:`repro_torch.models.LM` eagerly on its device, with the
reference's cache layouts (layer-stacked, as the reference scans layers):

  attention archs: k/v [L, B, W, KV, dh]  (W = window for SWA else max_len),
                   pos [B, W] absolute positions (-1 empty), len [B]
  ssm archs:       h [L, B, H, N, P] f32, conv [L, B, K-1, di+2N], len [B]
  hybrid:          ssm fields + shared-attn caches sk/sv
                   [n_inv, B, W, KV, dh] and pos

Prefill and decode update a cache in place.  The graph half
(:class:`GraphQuery`, :class:`GraphQueryServer`) runs on the port's
engines:

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
import torch

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
from ..models.config import ModelConfig
from ..models.transformer import LM
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


# ----------------------------------------------------------------------
# LM serving: caches, prefill, decode, and the slot server
# ----------------------------------------------------------------------

#: cache entries stacked by layer (or by shared-block group), which carry
#: the batch on axis 1; the others carry it on axis 0
LAYER_STACKED = ("k", "v", "h", "conv", "sk", "sv")


def cache_width(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.swa_window) if cfg.swa_window else max_len


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """An empty cache of ``B`` rows (the reference's layout, on ``device``):
    ``k``/``v`` [L, B, W, KV, dh] with ``pos`` [B, W] (absolute positions,
    -1 empty) for attention; ``h`` [L, B, H, N, P] f32 and ``conv`` [L, B,
    K - 1, di + 2N] for SSMs, plus ``sk``/``sv`` [groups, B, W, KV, dh] and
    ``pos`` for the hybrid's shared block; ``len`` [B]."""
    dev = resolve_device(device)
    L = cfg.n_layers
    c = {"len": torch.zeros(B, dtype=torch.int32, device=dev)}

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    W = cache_width(cfg, max_len)
    if cfg.is_ssm:
        H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
        ch = cfg.d_inner + 2 * cfg.ssm_state
        c["h"] = zeros(L, B, H, N, P, dt=torch.float32)
        c["conv"] = zeros(L, B, cfg.ssm_conv - 1, ch)
        if cfg.family == "hybrid" and cfg.attn_every:
            n_inv = -(-L // cfg.attn_every)
            c["sk"] = zeros(n_inv, B, W, cfg.n_kv, cfg.d_head)
            c["sv"] = zeros(n_inv, B, W, cfg.n_kv, cfg.d_head)
            c["pos"] = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    else:
        c["k"] = zeros(L, B, W, cfg.n_kv, cfg.d_head)
        c["v"] = zeros(L, B, W, cfg.n_kv, cfg.d_head)
        c["pos"] = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    return c


def _ring_slots(S: int, W: int, device):
    """The positions a prompt of S tokens leaves in a ring of W slots, and
    their slots.  When S > W only the last W positions are written: they
    are what the reference's scatter with repeated slots keeps (last wins;
    torch's ``index_put_`` leaves repeated indices undefined)."""
    pos = torch.arange(max(S - W, 0), S, device=device, dtype=torch.int32)
    return pos, (pos % W).to(torch.int64)


def prefill(model: LM, batch: dict, cache: dict):
    """Fill ``cache`` (in place) from a full prompt, in the model's compute
    dtype; returns (logits [B, V] f32 of the last position, cache).
    ``batch``: ``{"tokens": [B, S]}`` or, for a frontend, ``{"embeds": [B,
    S, d]}``; all B rows share length S (the server prefills one row at a
    time)."""
    cfg = model.cfg
    if cfg.frontend is not None and "embeds" in batch:
        h = model.embed_frontend(batch["embeds"])
    else:
        h = model.embed_tokens(batch["tokens"])
    B, S = h.shape[:2]
    positions = torch.arange(S, device=h.device)
    x, states = model.backbone(h, positions, collect_cache=True)
    logits = model.lm_logits_last(x)
    if cfg.is_ssm:
        cache["h"].copy_(torch.stack(states["ssm_h"]))
        cache["conv"].copy_(torch.stack(states["ssm_conv"]))
        k_c, v_c, kvs = cache.get("sk"), cache.get("sv"), states["shared_kv"]
    else:
        k_c, v_c = cache["k"], cache["v"]
        kvs = list(zip(states["k"], states["v"]))
    if k_c is not None:
        pos, slots = _ring_slots(S, k_c.shape[2], h.device)
        keep = slice(S - pos.numel(), S)
        for i, kv in enumerate(kvs):
            if kv is None:      # a hybrid group without its attention layer
                k_c[i][:, slots] = 0
                v_c[i][:, slots] = 0
            else:
                k_c[i][:, slots] = kv[0][:, keep].to(k_c.dtype)
                v_c[i][:, slots] = kv[1][:, keep].to(v_c.dtype)
        cache["pos"][:, slots] = pos
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
    return logits[:, 0], cache


def decode_step(model: LM, tokens, cache: dict):
    """One token for every slot, in the model's compute dtype.  tokens: [B]
    int.  Updates ``cache`` in place (``len`` is replaced) and returns
    (logits [B, V] f32, cache)."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = model.embed_tokens(tokens[:, None])
    q_pos = cache["len"]
    step = None
    if "pos" in cache:
        pos = cache["pos"]
        pos[torch.arange(B, device=x.device), q_pos % pos.shape[1]] = q_pos
        step = model.decode_step_context(q_pos, pos)
    if cfg.is_ssm:
        ae = cfg.attn_every
        x0 = x
        for i, blk in enumerate(model.blocks):
            x, h, conv = blk.decode(x, cache["h"][i], cache["conv"][i])
            cache["h"][i] = h
            cache["conv"][i] = conv
            if step is not None and i % ae == ae - 1:
                x = model.shared.decode(x, x0, cache["sk"][i // ae],
                                        cache["sv"][i // ae], step)
    else:
        for i, blk in enumerate(model.blocks):
            x = blk.decode(x, cache["k"][i], cache["v"][i], step)
    cache["len"] = q_pos + 1
    return model.lm_logits_last(x)[:, 0], cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    #: number of DECODE steps; ``out`` ends up ``max_new + 1`` tokens long
    #: (the prefill-produced token plus one per decode step)
    max_new: int = 32
    out: Optional[list] = None
    #: with ``Server(keep_logits=True)``: the [V] f32 logits (on the
    #: device) each token of ``out`` was chosen from
    logits: Optional[list] = None


class Server:
    """Continuous batching over B fixed slots (greedy decoding).

    ``Server(model, n_slots=4, max_len=512, dtype=torch.bfloat16)`` serves
    on the model's device and casts the model's weights to ``dtype`` once,
    in place (:meth:`repro_torch.models.LM.to_compute`).  Each tick admits
    queued requests into free slots (a one-row prefill spliced into the
    batched cache), then decodes one token for every slot; a request
    finishes after ``max_new`` decode steps.

    Each prefill and each decode tick is timed on the host, both ending in
    the argmax's copy to the host: ``obs`` records them (when enabled) as
    ``serve.lm_prefill_wall_s`` and ``serve.lm_decode_wall_s``, and
    ``on_wall(kind, seconds)`` (``kind`` "prefill" or "decode"), when
    given, receives each one.  ``keep_logits`` keeps every token's logits
    on its request (:attr:`Request.logits`), for checking.
    """

    def __init__(self, model: LM, n_slots: int = 4, max_len: int = 512,
                 dtype=torch.bfloat16, *, on_wall=None,
                 keep_logits: bool = False):
        self.model = model.to_compute(dtype)
        self.on_wall = on_wall
        self.keep_logits = keep_logits
        self.cfg = model.cfg
        self.device = model.device
        self.B, self.max_len = n_slots, max_len
        self.dtype = dtype
        self.cache = init_cache(self.cfg, n_slots, max_len, dtype,
                                self.device)
        self.free = list(range(n_slots))
        self.active = {}                       # slot -> Request
        self.queue = collections.deque()
        self.done = []
        self._next_tok = np.zeros(n_slots, np.int64)

    def submit(self, req: Request):
        req.out = []
        req.logits = [] if self.keep_logits else None
        self.queue.append(req)

    def _timed(self, kind: str, t0: float):
        dt = time.perf_counter() - t0
        if obs.enabled():
            obs.observe(f"serve.lm_{kind}_wall_s", dt)
        if self.on_wall is not None:
            self.on_wall(kind, dt)

    @torch.no_grad()
    def _prefill_into_slot(self, slot: int, req: Request):
        # one-row prefill, then splice the row into the batched cache
        row = init_cache(self.cfg, 1, self.max_len, self.dtype, self.device)
        toks = torch.as_tensor(np.asarray(req.prompt)[None, :],
                               dtype=torch.int64, device=self.device)
        logits, row = prefill(self.model, {"tokens": toks}, row)
        tok = int(torch.argmax(logits[0]))
        req.out.append(tok)
        if self.keep_logits:
            req.logits.append(logits[0])
        self._next_tok[slot] = tok
        for key, entry in self.cache.items():
            if key in LAYER_STACKED:
                entry[:, slot] = row[key][:, 0]
            else:
                entry[slot] = row[key][0]
        self.active[slot] = req

    @torch.no_grad()
    def _decode(self, toks):
        """One decode step of every slot: its logits, and the greedy tokens
        on the host."""
        logits, self.cache = decode_step(self.model, toks, self.cache)
        return logits, torch.argmax(logits, dim=-1).cpu().numpy()

    def step(self):
        """One scheduler tick: admit new requests, then decode one token."""
        admitted = 0
        while self.free and self.queue:
            slot = self.free.pop()
            t0 = time.perf_counter()
            self._prefill_into_slot(slot, self.queue.popleft())
            self._timed("prefill", t0)
            admitted += 1
        if obs.enabled():
            obs.set_gauge("serve.lm_queue_depth", len(self.queue))
            obs.set_gauge("serve.lm_active_slots", len(self.active))
            if admitted:
                obs.inc("serve.lm_admitted", admitted)
        # max_new counts DECODE steps: the prefill-produced token is not
        # one of them, so a max_new<=0 request finishes right after prefill
        for slot, req in list(self.active.items()):
            if len(req.out) - 1 >= req.max_new:
                self.done.append(self.active.pop(slot))
                self.free.append(slot)
        if not self.active:
            return False
        toks = torch.as_tensor(self._next_tok, device=self.device)
        t0 = time.perf_counter()
        logits, nxt = self._decode(toks)
        self._timed("decode", t0)
        if obs.enabled():
            # one token per *active* slot this tick
            obs.inc("serve.lm_tokens", len(self.active))
        finished = []
        for slot, req in list(self.active.items()):
            req.out.append(int(nxt[slot]))
            if self.keep_logits:
                req.logits.append(logits[slot])
            self._next_tok[slot] = int(nxt[slot])
            if len(req.out) - 1 >= req.max_new:
                finished.append(slot)
        for slot in finished:
            self.done.append(self.active.pop(slot))
            self.free.append(slot)
        return True

    def run(self, max_ticks: int = 10_000):
        t = 0
        while (self.queue or self.active) and t < max_ticks:
            self.step()
            t += 1
        return self.done


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
