"""The DC scatter of the composed path: write the message bins.

Counterpart of :func:`repro.kernels.dc_gather.dc_gather`: slot ``s`` of the
``[NM]`` PNG message bins gets ``x[p, png_src_local[s]]``, with ``p =
png_tile_part[s // msg_tile]`` its source partition, when ``png_valid[s]``
and that source is active, and the monoid identity otherwise (the paper's
"scatter the whole partition" with exact no-op slots, §3.3, Alg. 2).

Two versions of one function, chosen by the device of the tensors:

  * :func:`ref_dc_gather`, the plain PyTorch version (CPU tensors; also the
    oracle that ``chip_smoke.py`` holds the kernel against on the card);
  * :func:`dc_gather_cuda`, the CUDA kernel ``csrc/dc_gather.cu`` (CUDA
    tensors), which moves 4-byte words (8-byte ones for the ``int64``
    packed words of ``min_with_payload``) in one of two regimes that its C
    entry chooses by shape: **staged**, where each block copies one source
    partition's rows of ``x`` and ``active`` into shared memory and streams
    that partition's slots against them (the TPU kernel's VMEM-resident
    BlockSpec), and **L2**, where every slot reads its source through L2.
    The staged regime needs the ``pieces`` of :func:`dc_pieces` (built once
    per layout by :class:`repro_torch.kernels.ops.ScatterKernel`): for
    4-byte words ``q % 16 == 0`` and ``q <= 46,480`` (``kMaxStagedQ``);
    8-byte rows do not fit a block, so two blocks take a piece, each
    staging half of the rows and writing the slots whose source lies in its
    half (``q % 32 == 0``, ``q <= 51,648``: ``kMaxHalvesQ``).  A call
    without pieces takes the L2 regime.  ``_build.DC_GATHER.regimes``
    counts the launches of each.

A slot whose source lies outside ``[0, k*q)`` gets the identity in both.

``[B, k, q]`` values and activity write ``B`` lanes of bins, ``[B, NM]``
(the batched engine's queries): the reference's vmapped scatter.  On a card
that is the kernel's lane form, ``dc_gather_lanes``: one launch, in the
regime its C entry chooses for every lane
(``_build.DC_GATHER_LANES.regimes``); staging also needs each lane's rows
16-byte aligned, which ``q % 16 == 0`` gives a contiguous input.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..core import monoid as M
from . import _build

# A slot streams its png_src_local and png_valid (5 bytes) and its value;
# staging a partition's rows copies a value and an activity byte a vertex.
SLOT_BYTES, ROW_BYTES_PER_VERTEX = 9, 5   # of 4-byte values


def dc_pieces(png_tile_part: np.ndarray, *, q: int, msg_tile: int,
              blocks: int, value_bytes: int = 4) -> Optional[np.ndarray]:
    """The staged regime's pieces of a layout's slot tiles, or None where the
    L2 regime is the better one.

    Returns ``int64[n_pieces + 1]`` ascending tile offsets from 0 to
    ``len(png_tile_part)``: piece ``i`` is tiles ``[off[i], off[i+1])``, and
    every tile of a piece has the same ``png_tile_part`` entry.  The pieces
    are the runs of equal entries (one per source partition on a layout),
    cut until there are ``max(blocks, runs)`` of them or every piece is one
    tile: each cut goes to the run whose pieces are largest, and a run's
    pieces differ by at most a tile.  With ``blocks`` the card's SM count, a
    staged block takes a whole SM (163,848 B of shared memory at q =
    32,768), so the pieces fill the card in one wave, no SM stages two rows
    one after the other, and the largest piece, which sets the time, is as
    small as that allows.

    None where the runs are short: the mean run's slot stream
    (``SLOT_BYTES`` a slot for 4-byte values, ``value_bytes + 5`` in
    general) under its row's ``ROW_BYTES_PER_VERTEX * q`` bytes
    (``value_bytes + 1`` a vertex), as on a layout whose tiles are not in
    source-partition order.  Eight-byte values launch two blocks a piece
    (each stages half the row), so the pieces fill the card in two waves."""
    tp = np.asarray(png_tile_part)
    ntm = len(tp)
    if ntm == 0:
        return None
    starts = np.flatnonzero(np.r_[True, tp[1:] != tp[:-1]])
    runs = np.diff(np.r_[starts, ntm])
    extra = value_bytes - 4
    if ntm * msg_tile * (SLOT_BYTES + extra) < \
            len(runs) * q * (ROW_BYTES_PER_VERTEX + extra):
        return None
    cuts = np.ones_like(runs)
    for _ in range(min(blocks, ntm) - len(runs)):
        cuts[np.argmax(runs / cuts)] += 1
    run = np.repeat(np.arange(len(runs)), cuts)
    j = np.arange(len(run)) - np.repeat(np.cumsum(cuts) - cuts, cuts)
    off = starts[run] + runs[run] * j // cuts[run]
    return np.r_[off, ntm].astype(np.int64)


@functools.lru_cache(maxsize=None)
def identity_bits(monoid: str, dtype: torch.dtype) -> int:
    """The identity's bit pattern, 4 or 8 bytes as ``dtype``, as an unsigned
    int (built once per monoid and dtype: the composed engine calls the
    kernel every DC step)."""
    ident = M.full((1,), M.identity_value(monoid, dtype), dtype, "cpu")
    if dtype.itemsize == 8:
        return int(ident.view(torch.int64)) & 0xFFFFFFFFFFFFFFFF
    return int(ident.view(torch.int32)) & 0xFFFFFFFF


def ref_dc_gather(x, active, png_src_local, png_valid, png_tile_part, *,
                  k: int, q: int, msg_tile: int, monoid: str = "add"):
    """Plain PyTorch version with :func:`dc_gather`'s contract, lanes
    included."""
    part = png_tile_part.to(torch.int64).repeat_interleave(msg_tile)
    local = png_src_local.to(torch.int64)
    inside = (local >= 0) & (local < q) & (part >= 0) & (part < k)
    src = torch.where(inside, part * q + local, 0)
    flat = x.shape[:-2] + (-1,)
    ok = png_valid.to(torch.bool) & inside \
        & active.reshape(flat).to(torch.bool).index_select(-1, src)
    vals = M.as_bits(x.reshape(flat)).index_select(-1, src)
    ident = M.full((1,), M.identity_value(monoid, x.dtype), x.dtype,
                   x.device)
    return M.from_bits(torch.where(ok, vals, M.as_bits(ident)), x.dtype)


def dc_gather_cuda(x, active, png_src_local, png_valid, png_tile_part, *,
                   k: int, q: int, msg_tile: int, monoid: str = "add",
                   pieces=None):
    """Launch ``csrc/dc_gather.cu`` on the current stream: ``dc_gather``
    for ``[k, q]`` inputs, its lane form ``dc_gather_lanes`` for ``[B, k,
    q]``.

    ``pieces`` (``int64[n + 1]`` on the device, from :func:`dc_pieces` on
    this ``png_tile_part``, or any ascending offsets that cover its tiles
    once) lets the kernel take the staged regime where the shape allows;
    without them it takes the L2 regime."""
    nm, dev = png_src_local.shape[0], x.device
    lead = tuple(x.shape[:-2])
    if len(lead) > 1 or 0 in lead:
        raise ValueError(f"x must be [k, q] or [B, k, q] with B >= 1, got "
                         f"{tuple(x.shape)}")
    _build.check_cuda(x, "x", shape=lead + (k, q))
    _build.dtype_code(x.dtype, monoid)
    _build.check_cuda(active, "active", torch.bool, lead + (k, q), dev)
    _build.check_cuda(png_src_local, "png_src_local", torch.int32, (nm,), dev)
    _build.check_cuda(png_valid, "png_valid", torch.bool, (nm,), dev)
    if msg_tile < 1 or nm % msg_tile:
        raise ValueError(f"{nm} slots are not whole tiles of {msg_tile}")
    _build.check_cuda(png_tile_part, "png_tile_part", torch.int32,
                      (nm // msg_tile,), dev)
    n_pieces = 0
    if pieces is not None:
        _build.check_cuda(pieces, "pieces", torch.int64, device=dev)
        if pieces.dim() != 1 or pieces.shape[0] < 2:
            raise ValueError("pieces must be 1-D tile offsets, at least 2")
        n_pieces = pieces.shape[0] - 1
    out = torch.empty(lead + (nm,), dtype=x.dtype, device=dev)
    if nm:
        regime = ctypes.c_int(-1)
        args = (x.data_ptr(), active.data_ptr(), png_src_local.data_ptr(),
                png_valid.data_ptr(), png_tile_part.data_ptr(),
                pieces.data_ptr() if n_pieces else None, n_pieces, nm, k, q,
                msg_tile)
        rest = (identity_bits(monoid, x.dtype), x.dtype.itemsize,
                out.data_ptr(), dev.index,
                ctypes.byref(regime), _build.stream_handle(dev.index))
        kern = _build.DC_GATHER_LANES if lead else _build.DC_GATHER
        lanes = (lead[0], k * q, nm) if lead else ()
        kern.launch(*args, *lanes, *rest)
        kern.count_regime(regime.value)
    return out


def dc_gather(x, active, png_src_local, png_valid, png_tile_part, *,
              k: int, q: int, msg_tile: int, monoid: str = "add",
              pieces=None):
    """Materialize the DC message bins: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (staged with ``pieces``, see
    :func:`dc_gather_cuda`; the plain version needs none).

    Args:
      x:             [k, q] per-vertex scatter values (float32, int32 or
                     uint32; int64 with min), or [B, k, q]: B lanes of bins.
      active:        x's shape, bool per-vertex activity.
      png_src_local: [NM] int32 source id within its partition.
      png_valid:     [NM] bool slot validity (False on pads).
      png_tile_part: [NM / msg_tile] int32 source partition per slot tile.
    Returns:
      [NM] (or [B, NM]) message values, the identity on invalid and inactive
      slots.
    """
    if monoid not in _build.MONOID_CODES:
        raise ValueError(f"unknown monoid {monoid!r}")
    kind = x.device.type
    if kind == "cpu":
        return ref_dc_gather(x, active, png_src_local, png_valid,
                             png_tile_part, k=k, q=q, msg_tile=msg_tile,
                             monoid=monoid)
    if kind == "cuda":
        return dc_gather_cuda(x, active, png_src_local, png_valid,
                              png_tile_part, k=k, q=q, msg_tile=msg_tile,
                              monoid=monoid, pieces=pieces)
    raise ValueError(f"no DC scatter for device {x.device}")
