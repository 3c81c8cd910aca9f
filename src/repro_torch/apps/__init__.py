from .bfs import (PARENT_SENTINEL, bfs, bfs_multi, bfs_program,
                  bfs_seeded_multi, bfs_seeded_pack, bfs_seeded_program)
from .cc import cc_program, connected_components
from .heat_kernel import heat_kernel_pr, heat_kernel_program
from .nibble import nibble, nibble_program
from .pagerank import pagerank, pagerank_program
from .pagerank_nibble import pagerank_nibble, pagerank_nibble_program
from .sssp import sssp, sssp_multi, sssp_program
from .sssp_parents import (sssp_parents_multi, sssp_parents_program,
                           sssp_with_parents)

__all__ = ["PARENT_SENTINEL", "bfs", "bfs_multi", "bfs_program",
           "bfs_seeded_multi", "bfs_seeded_pack", "bfs_seeded_program",
           "connected_components", "cc_program", "heat_kernel_pr",
           "heat_kernel_program", "nibble", "nibble_program", "pagerank",
           "pagerank_program", "pagerank_nibble", "pagerank_nibble_program",
           "sssp", "sssp_multi", "sssp_parents_multi", "sssp_parents_program",
           "sssp_program", "sssp_with_parents"]
