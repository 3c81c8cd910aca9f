"""PyTorch and CUDA port of the GPOP partition-centric graph engine.

The JAX package ``repro`` is the reference; this package imports nothing of
it and nothing of JAX.  The entry points run on a CUDA device unless the
caller passes ``device="cpu"``, which runs the plain PyTorch versions of the
kernels.
"""
from .apps import bfs, connected_components, pagerank, sssp
from .core.engine import Engine
from .graph import build_layout

__all__ = ["Engine", "bfs", "build_layout", "connected_components",
           "pagerank", "sssp"]
