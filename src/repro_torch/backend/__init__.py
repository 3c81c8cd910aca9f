"""Tile-geometry tuning for the port's layouts.

Counterpart of :mod:`repro.backend`, without its kernel registry: the port
chooses each kernel's version by the device of the tensors.  What remains is
:mod:`repro_torch.backend.tuning`, the sweep of ``edge_tile`` / ``msg_tile``
(and the fold knobs) that times the kernels per candidate and caches the
winner for :func:`repro_torch.graph.build_layout`.
"""
from .tuning import (DEFAULT_GEOMETRY, TileGeometry, autotune,
                     resolve_geometry, tuned_layout)

__all__ = ["DEFAULT_GEOMETRY", "TileGeometry", "autotune",
           "resolve_geometry", "tuned_layout"]
