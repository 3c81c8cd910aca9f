"""Segmented fold past 4096 segments.

Counterpart of :func:`repro.kernels.fold_two_level.two_level_segment_fold`.
On the TPU the two-level split into ``fold_q``-wide buckets exists because a
flat one-hot block outgrows VMEM past 4096 segments.  The CUDA segment fold
(``csrc/segment_fold.cu``) has no such cap, so this fold is the same
function as :func:`repro_torch.kernels.fold_block.blocked_segment_fold`,
chosen by device the same way.  ``fold_q`` stays a layout field so that the
port's layouts match the reference's.
"""
from __future__ import annotations

import os

from .fold_block import blocked_segment_fold

DEFAULT_FOLD_Q = 256
ENV_FOLD_Q = "REPRO_FOLD_Q"


def default_fold_q() -> int:
    """``REPRO_FOLD_Q`` if set, else the static default (layout field)."""
    env = os.environ.get(ENV_FOLD_Q)
    return int(env) if env else DEFAULT_FOLD_Q


def two_level_segment_fold(vals, valid, ids, num_segments: int, *,
                           monoid: str = "add"):
    """Same contract as :func:`blocked_segment_fold`, at any segment count."""
    return blocked_segment_fold(vals, valid, ids, num_segments, monoid=monoid)
