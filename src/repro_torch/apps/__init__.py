from .bfs import bfs, bfs_program
from .cc import cc_program, connected_components
from .pagerank import pagerank, pagerank_program
from .sssp import sssp, sssp_program

__all__ = ["bfs", "bfs_program", "connected_components", "cc_program",
           "pagerank", "pagerank_program", "sssp", "sssp_program"]
