from .csr import (Graph, from_edges, rmat, uniform_random, ring, star,
                  grid2d, symmetrize, to_scipy)
from .delta import DeltaBuffer, apply_delta
from .layout import Layout, build_layout

__all__ = ["Graph", "from_edges", "rmat", "uniform_random", "ring", "star",
           "grid2d", "symmetrize", "to_scipy", "DeltaBuffer", "apply_delta",
           "Layout", "build_layout"]
