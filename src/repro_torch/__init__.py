"""PyTorch and CUDA port of the GPOP partition-centric graph engine.

Beside the engine and its apps: the paper's vertex-centric baselines
(:mod:`repro_torch.baselines`) and the LM serving stack
(:mod:`repro_torch.models`, :mod:`repro_torch.configs`, the LM ``Server`` of
:mod:`repro_torch.serve`).  The JAX package ``repro`` is the reference;
this package imports nothing of it and nothing of JAX.  The entry points run on a CUDA device unless the
caller passes ``device="cpu"``, which runs the plain PyTorch versions of the
kernels.
"""
from .apps import (bfs, bfs_multi, bfs_seeded_multi, connected_components,
                   heat_kernel_pr, nibble, pagerank, pagerank_nibble, sssp,
                   sssp_multi, sssp_parents_multi, sssp_with_parents)
from .core.engine import Engine
from .graph import DeltaBuffer, apply_delta, build_layout

__all__ = ["DeltaBuffer", "Engine", "apply_delta", "bfs", "bfs_multi",
           "bfs_seeded_multi", "build_layout", "connected_components",
           "heat_kernel_pr", "nibble", "pagerank", "pagerank_nibble", "sssp",
           "sssp_multi", "sssp_parents_multi", "sssp_with_parents"]
