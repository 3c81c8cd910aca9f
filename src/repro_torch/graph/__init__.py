from .csr import (Graph, from_edges, rmat, uniform_random, ring, star,
                  grid2d, symmetrize, to_scipy)
from .layout import Layout, build_layout

__all__ = ["Graph", "from_edges", "rmat", "uniform_random", "ring", "star",
           "grid2d", "symmetrize", "to_scipy", "Layout", "build_layout"]
