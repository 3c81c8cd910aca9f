"""The port stands alone: it never imports JAX or the reference package,
and its entry points do not fall back to the CPU when no card is present."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.backend import tuning
from repro_torch.dist import Mesh
from repro_torch.dist.engine import DistEngine
from repro_torch.graph.shard import shard_layout
from repro_torch.graph import build_layout, rmat
from repro_torch.interop import state_to_torch, to_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                       r"from repro[. ]|import repro\s*$)", re.MULTILINE)


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, prefix="repro_torch."))


def test_import_leaves_jax_unloaded():
    mods = _submodules()
    assert {"repro_torch.core.engine", "repro_torch.backend.tuning",
            "repro_torch.kernels.segment_combine", "repro_torch.graph.delta",
            "repro_torch.obs.export", "repro_torch.obs.tracing",
            "repro_torch.dist", "repro_torch.dist.engine",
            "repro_torch.graph.shard"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {['repro_torch'] + mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.')))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_reference(path):
    assert not FORBIDDEN.search(path.read_text()), path


@pytest.mark.parametrize("entry", ["engine", "bfs", "cc", "sssp",
                                   "pagerank", "to_torch", "state_to_torch",
                                   "tuned_layout", "dist_engine"])
def test_default_device_raises_without_a_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat(6, 4, seed=0, weighted=True)
    L = build_layout(g, k=4, edge_tile=16, msg_tile=8)
    calls = {
        "engine": lambda: repro_torch.Engine(L, repro_torch.apps.bfs_program()),
        "bfs": lambda: repro_torch.bfs(L, source=0),
        "cc": lambda: repro_torch.connected_components(L),
        "sssp": lambda: repro_torch.sssp(L, source=0),
        "pagerank": lambda: repro_torch.pagerank(L),
        "to_torch": lambda: to_torch(np.arange(3)),
        "state_to_torch": lambda: state_to_torch({"x": np.arange(3)}),
        "tuned_layout": lambda: tuning.tuned_layout(g, k=4),
        "dist_engine": lambda: DistEngine(
            shard_layout(L, 1), repro_torch.apps.bfs_program(),
            Mesh(group=None, rank=0, size=1, device=torch.device("cuda"))),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_cpu_run_matches_scipy_levels():
    import scipy.sparse.csgraph as csg
    from repro_torch.graph import to_scipy
    g = rmat(6, 4, seed=0)
    L = build_layout(g, k=4, edge_tile=16, msg_tile=8)
    res = repro_torch.bfs(L, source=0, device="cpu")
    d = csg.shortest_path(to_scipy(g), unweighted=True, indices=0)
    want = np.where(np.isinf(d), -1, d).astype(np.int32)
    assert np.array_equal(res["level"], want)


def test_serving_tier_imports_without_jax():
    """``repro_torch.serve`` (and the obs copies it records into) load
    neither JAX nor the reference, and expose the server."""
    code = ("import sys\n"
            "from repro_torch.serve import GraphQueryServer, ServeConfig\n"
            "from repro_torch.serve import cache\n"
            "from repro_torch import obs\n"
            "assert ServeConfig().mode == 'hybrid'\n"
            "print(sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_dist_imports_without_jax():
    """``repro_torch.dist`` (the mesh and the distributed engine) and the
    sharded layout load neither JAX nor the reference."""
    code = ("import sys\n"
            "import repro_torch.dist\n"
            "from repro_torch.dist.engine import DistEngine\n"
            "from repro_torch.graph.shard import shard_layout\n"
            "print(sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("entry", ["sssp_with_parents", "sssp_parents_multi",
                                   "bfs_seeded_multi", "server"])
def test_payload_entries_raise_without_a_card(entry, monkeypatch):
    from repro_torch.serve import GraphQueryServer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L = build_layout(rmat(6, 4, seed=0, weighted=True), k=4, edge_tile=16,
                     msg_tile=8)
    calls = {
        "sssp_with_parents": lambda: repro_torch.sssp_with_parents(L, 0),
        "sssp_parents_multi": lambda: repro_torch.sssp_parents_multi(L, [0]),
        "bfs_seeded_multi": lambda: repro_torch.bfs_seeded_multi(L, [0]),
        "server": lambda: GraphQueryServer(L),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_lm_stack_and_baselines_import_without_jax():
    """The LM stack, its serving and launcher, and the baselines load
    neither JAX nor the reference."""
    code = ("import sys\n"
            "import repro_torch.baselines.vc, repro_torch.configs\n"
            "import repro_torch.models.transformer, repro_torch.launch.serve\n"
            "from repro_torch.serve import Request, Server\n"
            "from repro_torch.interop import lm_params_from_reference\n"
            "print(sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'repro.'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("entry", ["lm", "init_cache", "bfs_push",
                                   "pagerank_spmv", "cc_ec", "launcher"])
def test_lm_and_baseline_entries_raise_without_a_card(entry, monkeypatch):
    from repro_torch.baselines import vc
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import LM
    from repro_torch.serve import init_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen2-0.5b")
    g = rmat(6, 4, seed=0, weighted=True)
    calls = {
        "lm": lambda: LM(cfg),
        "init_cache": lambda: init_cache(cfg, 2, 16),
        "bfs_push": lambda: vc.bfs_push(g, 0),
        "pagerank_spmv": lambda: vc.pagerank_spmv(g),
        "cc_ec": lambda: vc.cc_ec(g),
        "launcher": lambda: launcher.main(["--arch", "qwen2-0.5b",
                                           "--smoke"]),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
