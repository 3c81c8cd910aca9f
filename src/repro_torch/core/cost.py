"""Eq. 1 dual-mode communication cost model (paper §3.3).

A partition is scattered destination-centric iff

    (E^p((r+1)d_i + 2r d_v) + k d_i) / BW_DC
        <=  (2r E_a^p d_v + 3 E_a^p d_i) / BW_SC

The DC side is a per-partition constant; the SC side is linear in the active
edges E_a^p.  ``BW_DC / BW_SC`` is a user-configurable ratio, default 2 as in
the paper.  On the TPU mapping, DC traffic is dense contiguous all_to_all +
streamed static adjacency, SC traffic is ragged (value, id) pairs — the same
two expressions price both (see DESIGN.md §2).

A NumPy copy of :mod:`repro.core.cost`; ``bw_ratio`` keeps the paper's
default of 2, which has not been calibrated for the H100.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    dc_cost: np.ndarray       # float64[k] bytes, per-partition constant
    sc_coeff: np.ndarray      # float64[k] bytes per active edge
    bw_ratio: float = 2.0     # BW_DC / BW_SC

    @classmethod
    def from_layout(cls, layout, d_i: int = 4, d_v: int = 4,
                    bw_ratio: float = 2.0) -> "CostModel":
        return cls(dc_cost=layout.dc_cost_bytes(d_i, d_v).astype(np.float64),
                   sc_coeff=layout.sc_cost_coeff(d_i, d_v),
                   bw_ratio=bw_ratio)

    def choose_dc(self, active_edges: np.ndarray,
                  has_active: np.ndarray) -> np.ndarray:
        """Per-partition mode decision. True -> DC. Inactive partitions are
        excluded from both modes by the 2-level active list (gPartList)."""
        sc_cost = active_edges.astype(np.float64) * self.sc_coeff
        return (self.dc_cost <= self.bw_ratio * sc_cost) & has_active

    def bytes_for(self, dc_mask: np.ndarray, active_edges: np.ndarray,
                  has_active: np.ndarray) -> dict:
        dc = float(self.dc_cost[dc_mask & has_active].sum())
        sc_sel = (~dc_mask) & has_active
        sc = float((active_edges * self.sc_coeff)[sc_sel].sum())
        return {"dc_bytes": dc, "sc_bytes": sc, "total_bytes": dc + sc}
