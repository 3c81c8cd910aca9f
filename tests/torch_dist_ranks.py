"""Run the port's distributed engine on gloo ranks on the CPU, for the tests.

:class:`Ranks` (or :func:`run_ranks`) starts one process per rank
(``python tests/torch_dist_ranks.py <scenario> <rank> <world> <dir>``),
each of which joins a gloo process group through a file store in ``dir``,
builds its :class:`repro_torch.dist.Mesh`, runs the named scenario of
:data:`SCENARIOS` and pickles what the scenario returns to
``dir/rank<r>.pkl``.  The scenario
and its arguments (``dir/args.pkl``) come from the test; every rank gets the
same ones and must make the same calls in the same order.

Nothing hangs the suite: the group waits at most 60 s for a collective, and
each rank has its own wall limit, past which every rank is killed and the
test fails.  This module imports neither JAX nor the reference package, so
the ranks load torch only.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Ranks:
    """``scenario`` started on ``world`` gloo ranks (one process each);
    :meth:`results` waits for them."""

    def __init__(self, scenario: str, world: int, workdir, args: dict):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        (self.workdir / "args.pkl").write_bytes(pickle.dumps(args))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, scenario, str(r), str(world),
             str(self.workdir)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(world)]

    def results(self, timeout: float = 150.0) -> list:
        """Each rank's result, in rank order.  Raises ``AssertionError``
        with the ranks' output when one fails or outlives ``timeout``
        seconds (then every rank is killed)."""
        failed = []
        try:
            for r, p in enumerate(self.procs):
                out, _ = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    failed.append(f"rank {r} exited {p.returncode}:\n{out}")
        except subprocess.TimeoutExpired:
            failed.append(f"a rank outlived {timeout} s")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        assert not failed, "\n".join(failed)
        return [pickle.loads((self.workdir / f"rank{r}.pkl").read_bytes())
                for r in range(len(self.procs))]


def run_ranks(scenario: str, world: int, workdir, args: dict,
              timeout: float = 150.0) -> list:
    """Run ``scenario`` on ``world`` gloo ranks and return each rank's
    result (:class:`Ranks`)."""
    return Ranks(scenario, world, workdir, args).results(timeout)


# ----------------------------------------------------------------------
# the ranks' side
# ----------------------------------------------------------------------

def _layouts(args):
    """The scenario's layout(s), built alike on every rank from the seed."""
    from repro_torch.graph import build_layout, rmat, symmetrize
    from repro_torch.graph.shard import shard_layout
    g = rmat(args["scale"], 8, seed=args["seed"], weighted=True)
    tiles = dict(k=args["k"], edge_tile=64, msg_tile=32)
    out = {"directed": build_layout(g, **tiles),
           "symmetric": build_layout(symmetrize(g), **tiles)}
    return {name: (L, shard_layout(L, args["D"]))
            for name, L in out.items()}


def apps(mesh, args):
    """BFS, SSSP, SSSP with parents and CC in every mode, PageRank in 'dc'
    (``run`` and ``run_fused``, on the bf16 wire, and with the
    ``dense_frontier`` DC step), the batched apps, and one SC step in both
    forms: each app's result and stats."""
    import functools

    import numpy as np
    import torch

    import repro_torch as rt
    from repro_torch.apps import (bfs_program, cc_program, pagerank_program,
                                  sssp_parents_program, sssp_program)
    from repro_torch.dist import engine as de
    from repro_torch.dist.engine import DistEngine, build_sc_step

    lay = _layouts(args)
    L, SL = lay["directed"]
    LS, SLS = lay["symmetric"]
    src = args["source"]
    out = {}
    for mode in args["modes"]:
        def eng(sl, prog):
            return DistEngine(sl, prog, mesh, mode=mode)
        out[("bfs", mode)] = rt.bfs(L, src, engine=eng(SL, bfs_program()))
        out[("sssp", mode)] = rt.sssp(L, src, engine=eng(SL, sssp_program()))
        out[("sssp_parents", mode)] = rt.sssp_with_parents(
            L, src, engine=eng(SL, sssp_parents_program()))
        out[("cc", mode)] = rt.connected_components(
            LS, engine=eng(SLS, cc_program()))
    pr = DistEngine(SL, pagerank_program(L.n), mesh, mode="dc")
    out[("pagerank", "run")] = rt.pagerank(L, iters=10, engine=pr,
                                           fused=False)
    out[("pagerank", "run_fused")] = rt.pagerank(L, iters=10, engine=pr)
    out[("pagerank", "bf16")] = rt.pagerank(
        L, iters=10, fused=False, engine=DistEngine(
            SL, pagerank_program(L.n), mesh, mode="dc", wire_bf16=True))
    # the DC step without the flag exchange (dense_frontier: every vertex
    # stays active), built into an engine through the step builder
    build = de.build_dc_step
    de.build_dc_step = functools.partial(build, dense_frontier=True)
    try:
        dense = DistEngine(SL, pagerank_program(L.n), mesh, mode="dc")
    finally:
        de.build_dc_step = build
    out[("pagerank", "dense")] = rt.pagerank(L, iters=10, fused=False,
                                             engine=dense)
    sources = args["sources"]
    for name, multi, program in (
            ("bfs_multi", rt.bfs_multi, bfs_program),
            ("sssp_multi", rt.sssp_multi, sssp_program),
            ("sssp_parents_multi", rt.sssp_parents_multi,
             sssp_parents_program)):
        out[(name, "dc")] = multi(L, sources, engine=DistEngine(
            SL, program(), mesh, mode="dc"))

    # one SC step from a random frontier, in the dense and the ragged form
    eng = DistEngine(SL, sssp_program(), mesh, mode="sc")
    rng = np.random.default_rng(args["seed"])
    n_glob = SL.D * SL.nv
    dist0 = torch.from_numpy(np.where(rng.random(n_glob) < 0.5,
                                      rng.integers(0, 9, n_glob),
                                      np.inf).astype(np.float32))
    front = torch.from_numpy(rng.random(n_glob) < 0.3)
    lo = mesh.rank * SL.nv
    sc = {}
    for ragged in (False, True):
        step = build_sc_step(eng.program, eng.meta, mesh, ragged=ragged)
        st, act = step({"dist": dist0[lo:lo + SL.nv]},
                       front[lo:lo + SL.nv], eng.arrays, 0)
        sc[ragged] = (eng._unshard(st["dist"]).numpy(),
                      eng._unshard(act).numpy())
    out["sc_step"] = sc
    return out


def serve_queries(args, round_no: int):
    """The scenario's queries of one round, as ``(qid, app, params)``."""
    bfs_s, sssp_s, par_s = args["sources"][round_no]
    qs = [("bfs", {"source": s}) for s in bfs_s]
    qs += [("sssp", {"source": s}) for s in sssp_s]
    qs += [("sssp_parents", {"source": s}) for s in par_s]
    qs += [("cc", {}), ("pagerank", {"iters": 5})]
    return [(100 * round_no + i, app, p) for i, (app, p) in enumerate(qs)]


def _serve_round(server, queries):
    from repro_torch.serve import GraphQuery
    for qid, app, params in queries:
        server.submit(GraphQuery(qid, app, dict(params)))
    return {q.qid: {k: v for k, v in q.result.items() if k != "stats"}
            for q in server.run() if q.qid in {qid for qid, _, _ in queries}}


def serve(mesh, args):
    """A sharded ``GraphQueryServer`` on the symmetrized graph: a round of
    queries, one repeated query (an exact-cache hit), then a swap to the
    layout of an insertion-only delta (``swap_layout(sharded=, mesh=,
    delta=)``) and a second round.  Returns the answers by query id, the
    server's counters, and what the swap left."""
    from repro_torch.graph import apply_delta
    from repro_torch.graph.delta import DeltaBuffer
    from repro_torch.graph.shard import shard_layout
    from repro_torch.serve import ServeConfig, GraphQueryServer

    L, SL = _layouts(args)["symmetric"]
    srv = GraphQueryServer(L, ServeConfig(sharded=SL, mesh=mesh),
                           device="cpu")
    answers = _serve_round(srv, serve_queries(args, 0))
    first = serve_queries(args, 0)[0]
    answers.update(_serve_round(srv, [(99, first[1], first[2])]))
    engines = sorted((app, type(e).__name__)
                     for app, e in srv._engines.items())
    hits = srv.cache_hits
    src, dst, w = args["inserts"]
    delta = DeltaBuffer.for_layout(L).insert(src, dst, w)
    L2 = apply_delta(L, delta)
    srv.swap_layout(L2, sharded=shard_layout(L2, args["D"]), mesh=mesh,
                    delta=delta)
    swapped = dict(epoch=srv.epoch, engines=len(srv._engines),
                   sharded_d=srv.config.sharded.D,
                   mesh_is_ours=srv.config.mesh is mesh)
    answers.update(_serve_round(srv, serve_queries(args, 1)))
    return dict(answers=answers, engines=engines, cache_hits=hits,
                semantic_hits=srv.semantic_hits, swapped=swapped,
                n=L.n, k=L.k, q=L.q)


def unflatten(flat: dict) -> dict:
    """``{"layers/moe/w1": a, ...}`` as the nested dicts of a reference
    parameter tree."""
    tree = {}
    for path, a in flat.items():
        *head, last = path.split("/")
        node = tree
        for key in head:
            node = node.setdefault(key, {})
        node[last] = a
    return tree


def moe_ep(mesh, args):
    """The MoE layer and the smoke LM under LM meshes: each case of
    ``args["cases"]`` (arch, config overrides, mesh shape) whose mesh has
    this world's ranks, its model placed on the mesh by the config's rules
    and, without overrides, loaded from the reference's weights
    (``args["dir"]/<arch>.npz``).  By (arch, mesh shape): layer 0's MoE in
    f32 and bf16 (with the calls' path counts), this rank's coordinates and
    experts, its block's drop mask and slots, what a batch of one row
    raised, and for the cases of ``args["lm_cases"]`` the logits of a
    prefill and of decode steps with the counts of each.  A mesh of three
    dimensions is over (pod, data, model), of two over (data, model); a
    rank's coordinates are its batch block (pod major) and its ``model``
    coordinate."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.dist import sharding
    from repro_torch.interop import lm_params_from_reference
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models import LM
    from repro_torch.models import moe as M
    from repro_torch.serve import decode_step, init_cache, prefill

    x = torch.from_numpy(args["x"])
    out = {}

    def counted(fn):
        M.reset_counts()
        with torch.no_grad():
            y = fn()
        return y, dict(M.COUNTS)

    for arch, overrides, shape in args["cases"]:
        if int(np.prod(shape)) != mesh.size:
            continue
        cfg = dataclasses.replace(get_smoke_config(arch), **args["variant"],
                                  **overrides)
        axes = ("pod", "data", "model")[-len(shape):]
        lm = make_lm_mesh(shape, axes, "cpu")
        model = LM(cfg, device="cpu")
        sharding.set_activation_mesh(lm)
        try:
            sharding.shard_model(model, lm)
            if not overrides:
                with np.load(Path(args["dir"]) / f"{arch}.npz") as z:
                    params = unflatten(dict(z))
                model.load_state_dict(lm_params_from_reference(
                    params, cfg, model=model))
            moe = model.blocks[0].moe
            b = 0           # the batch block: pod major, as local_block
            for a, n in zip(axes[:-1], shape[:-1]):
                b = b * n + lm.get_local_rank(a)
            rec = {"coords": (b, lm.get_local_rank("model")),
                   "local_experts": moe.local_experts}
            rec["f32"] = counted(lambda: M.moe_fwd(moe, x))
            moe16 = copy.deepcopy(moe).to(torch.bfloat16)
            y, n = counted(lambda: M.moe_fwd(moe16, x.bfloat16()))
            rec["bf16"] = (y.float(), n)
            xb = M.local_block(x, lm)
            slot, keep, _ = M.dispatch(moe, xb, M.capacity(cfg, xb.shape[1]))
            rec["keep"], rec["slot"] = keep, slot
            if int(np.prod(shape)) > shape[-1]:       # data axes past 1
                try:
                    M.moe_fwd(moe, x[:1])
                    rec["one_row"] = None
                except ValueError as e:
                    rec["one_row"] = str(e)
            if (arch, shape) in args["lm_cases"] and not overrides:
                toks = torch.from_numpy(args["tokens"]).long()
                cache = init_cache(cfg, toks.shape[0], 32, torch.float32,
                                   "cpu")
                (lg, cache), n = counted(lambda: prefill(
                    model, {"tokens": toks}, cache))
                steps = [(lg, n)]
                for t in args["next"].T:
                    (lg, cache), n = counted(lambda: decode_step(
                        model, torch.from_numpy(t).long(), cache))
                    steps.append((lg, n))
                rec["lm"] = steps
            out[(arch, tuple(sorted(overrides.items())), shape)] = rec
        finally:
            sharding.set_activation_mesh(None)
    return out


def placements(mesh, args):
    """``args["tensor"]`` distributed on an LM mesh of ``args["shape"]``
    over ``args["axes"]`` at each spec of ``args["specs"]``
    (``sharding.placements``): this rank's coordinates and its local block
    by spec."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_lm_mesh

    lm = make_lm_mesh(args["shape"], args["axes"], "cpu")
    t = torch.from_numpy(args["tensor"])
    return {"coords": tuple(lm.get_local_rank(a) for a in args["axes"]),
            "local": {spec: distribute_tensor(
                t, lm, sharding.placements(spec, lm)).to_local().numpy()
                for spec in args["specs"]}}


SCENARIOS = {"apps": apps, "serve": serve, "moe_ep": moe_ep,
             "placements": placements}


def _main(scenario: str, rank: int, world: int, workdir: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.dist import make_mesh

    work = Path(workdir)
    args = pickle.loads((work / "args.pkl").read_bytes())
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        result = SCENARIOS[scenario](make_mesh("cpu"), args)
        (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
