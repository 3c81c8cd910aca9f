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
    tensors), one thread per slot moving 4-byte words.

A slot whose source lies outside ``[0, k*q)`` gets the identity in both.
"""
from __future__ import annotations

import torch

from ..core import monoid as M
from . import _build


def _identity_bits(monoid: str, dtype: torch.dtype) -> int:
    """The identity's 4-byte pattern as an unsigned int."""
    ident = M.full((1,), M.identity_value(monoid, dtype), dtype, "cpu")
    return int(ident.view(torch.int32)) & 0xFFFFFFFF


def ref_dc_gather(x, active, png_src_local, png_valid, png_tile_part, *,
                  k: int, q: int, msg_tile: int, monoid: str = "add"):
    """Plain PyTorch version with :func:`dc_gather`'s contract."""
    part = png_tile_part.to(torch.int64).repeat_interleave(msg_tile)
    local = png_src_local.to(torch.int64)
    inside = (local >= 0) & (local < q) & (part >= 0) & (part < k)
    src = torch.where(inside, part * q + local, 0)
    ok = png_valid.to(torch.bool) & inside \
        & active.reshape(-1).to(torch.bool)[src]
    vals = M.as_bits(x.reshape(-1))[src]
    ident = M.full((1,), M.identity_value(monoid, x.dtype), x.dtype,
                   x.device)
    return M.from_bits(torch.where(ok, vals, M.as_bits(ident)), x.dtype)


def dc_gather_cuda(x, active, png_src_local, png_valid, png_tile_part, *,
                   k: int, q: int, msg_tile: int, monoid: str = "add"):
    """Launch ``csrc/dc_gather.cu`` on the current stream."""
    nm, dev = png_src_local.shape[0], x.device
    _build.check_cuda(x, "x", shape=(k, q))
    _build.dtype_code(x.dtype)
    _build.check_cuda(active, "active", torch.bool, (k, q), dev)
    _build.check_cuda(png_src_local, "png_src_local", torch.int32, (nm,), dev)
    _build.check_cuda(png_valid, "png_valid", torch.bool, (nm,), dev)
    if msg_tile < 1 or nm % msg_tile:
        raise ValueError(f"{nm} slots are not whole tiles of {msg_tile}")
    _build.check_cuda(png_tile_part, "png_tile_part", torch.int32,
                      (nm // msg_tile,), dev)
    out = torch.empty(nm, dtype=x.dtype, device=dev)
    if nm:
        _build.DC_GATHER.launch(
            x.data_ptr(), active.data_ptr(), png_src_local.data_ptr(),
            png_valid.data_ptr(), png_tile_part.data_ptr(), nm, k, q,
            msg_tile, _identity_bits(monoid, x.dtype), out.data_ptr(),
            _build.stream_handle())
    return out


def dc_gather(x, active, png_src_local, png_valid, png_tile_part, *,
              k: int, q: int, msg_tile: int, monoid: str = "add"):
    """Materialize the DC message bins: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors.

    Args:
      x:             [k, q] per-vertex scatter values (float32, int32 or
                     uint32).
      active:        [k, q] bool per-vertex activity.
      png_src_local: [NM] int32 source id within its partition.
      png_valid:     [NM] bool slot validity (False on pads).
      png_tile_part: [NM / msg_tile] int32 source partition per slot tile.
    Returns:
      [NM] message values, the identity on invalid and inactive slots.
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
                              monoid=monoid)
    raise ValueError(f"no DC scatter for device {x.device}")
