"""Build the port's CUDA sources with ``nvcc`` and bind them with ``ctypes``.

Each source under ``repro_torch/csrc/`` becomes a shared library with a plain
C interface, compiled for ``sm_90a`` at first use into the build directory
(``repro_torch/_build/`` unless ``REPRO_TORCH_BUILD_DIR`` names another).
A library's file name carries a hash of the sources and flags, so an edited
source is rebuilt.  :func:`build_all` compiles every source at once, one
``nvcc`` process each.  If ``nvcc`` is missing or a build fails, the build
raises with the compiler's output; nothing carries on without the kernel.

Every C entry point returns 0 or a ``cudaError_t``; :meth:`CudaKernel.launch`
raises on a non-zero code and otherwise adds one to the kernel's
``launches`` count, the evidence that a run went through the kernel.  A
kernel with regimes chosen by shape in its C entry (``dc_gather``) also
counts its launches by regime (``CudaKernel.regimes``); so does
``fused_stream``, whose regime its wrapper chooses (``parts`` or not).

The batched engine's lane forms (``fused_dc_interleave`` and
``fused_dc_lanes``, ``dc_gather_lanes``, ``segment_combine_lanes``) are
further C entries of the same sources: each is a :class:`CudaKernel` of its
own, with its own count, that ``shares`` the library of its single-lane
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build_dir() -> Path:
    return Path(os.environ.get(ENV_BUILD_DIR) or PACKAGE_DIR / "_build")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc")
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if nvcc is None and (home / "bin" / "nvcc").exists():
        nvcc = str(home / "bin" / "nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch are built from "
            "source at first use and need the CUDA toolkit (PATH or "
            "CUDA_HOME)")
    return nvcc


class CudaKernel:
    """One CUDA source, its shared library and the count of its launches."""

    def __init__(self, name: str, source: str, argtypes: tuple,
                 regimes: tuple = (), shares: "CudaKernel" = None):
        self.name = name
        self.source = CSRC / source
        self.argtypes = argtypes
        # another entry of a kernel's library: built and loaded through it
        self.shares = shares
        self.launches = 0
        # launches by regime, for a kernel whose C entry reports the regime
        # it chose (its code indexes ``regimes``); the wrapper counts them
        self.regimes = dict.fromkeys(regimes, 0)
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None
        self._fn = self._err = None   # the bound C entry and its error
                                      # strings, once loaded
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        if self.shares is not None:
            return self.shares.library_path()
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(self.source.parent.glob("*.cuh")) + [self.source]:
            h.update(f.read_bytes())
        return build_dir() / f"{self.name}-{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start ``nvcc`` unless the library is built.

        Returns ``(process, temporary path)`` for :meth:`finish_build`, or
        None when there is nothing to build."""
        out = self.library_path()
        if out.exists() or self.shares is not None:
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(self.source.parent), "-o",
               str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name} "
                               f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.library_path())

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                if self.shares is not None:
                    lib, owner = self.shares.lib(), self.shares.name
                else:
                    self.finish_build(self.start_build())
                    lib = ctypes.CDLL(str(self.library_path()))
                    owner = self.name
                fn = getattr(lib, self.name)
                fn.argtypes, fn.restype = list(self.argtypes), ctypes.c_int
                err = getattr(lib, f"{owner}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                self._lib, self._fn, self._err = lib, fn, err
            return self._lib

    def launch(self, *args) -> None:
        if self._fn is None:
            self.lib()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._err(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {rc} "
                               f"({msg})")
        self.launches += 1

    def count_regime(self, code: int) -> None:
        """Count one launch in the regime the C entry reported."""
        name = list(self.regimes)[code]
        self.regimes[name] += 1


FUSED_DC = CudaKernel("fused_dc", "fused_dc.cu", (
    P, P, I64,          # table, table_valid, table_len
    P, P, P, P,         # src_local, dst_local, edge_valid, w
    P, P,               # tile_src_part, part_tile_off
    I32, I32, I32, I32,  # k, q, edge_tile, chunk
    I64, I32, I32, I32,  # num_segments, monoid, dtype, edge_fn
    P, P, P))           # acc, touched, stream
FUSED_STREAM = CudaKernel("fused_stream", "fused_stream.cu", (
    P, P, I64,          # table, table_valid, table_len
    P, P, P, P, I64,    # idx, edge_valid, dst, w, n
    P, I32, I32, I32,   # part_off (null: the stream regime), parts, q, tile
    I64, I32, I32, I32,  # num_segments, monoid, dtype, edge_fn
    P, P, I32, P),      # acc, touched, device index, stream
    regimes=("stream", "parts"))
SEGMENT_FOLD = CudaKernel("segment_fold", "segment_fold.cu", (
    P, P, P,            # vals, valid, ids
    I64, I64, I32, I32,  # n, num_segments, monoid, dtype
    P, P, I32, P))      # acc, touched, device index, stream
DC_GATHER = CudaKernel("dc_gather", "dc_gather.cu", (
    P, P, P, P, P,      # x, active, png_src_local, png_valid, png_tile_part
    P, I64,             # piece_tiles, n_pieces
    I64, I32, I32, I32,  # nm, k, q, msg_tile
    ctypes.c_ulonglong, I32,  # ident_bits, value_bytes
    P, I32,             # out, device index
    ctypes.POINTER(ctypes.c_int), P),  # regime (set by the call), stream
    regimes=("l2", "staged"))
SEGMENT_COMBINE = CudaKernel("segment_combine", "segment_combine.cu", (
    P, P, P,            # vals, valid, dst_local
    P, P, P,            # tile_src_part, part_tile_off, part_active
    I32, I32, I32, I32,  # k, q, edge_tile, chunk
    I32, I32,           # monoid, dtype
    P, P, P))           # acc, touched, stream
# The lane forms: dc_gather's and segment_combine's take the single-lane
# arguments with the lane count and the 64-bit lane strides (entries) of the
# per-lane inputs and outputs; fused_dc's is two launches, the tables
# interleaved, then folded over the layout's destination-sorted edge copy
# (fused_step.LaneEdges).
FUSED_DC_INTERLEAVE = CudaKernel("fused_dc_interleave", "fused_dc.cu", (
    P, P, I64, I64,     # table, table_valid, table_len, table_stride
    I32, I32, P,        # lanes, value_bytes, rank
    P, P, P), shares=FUSED_DC)  # table_il, mask, stream
FUSED_DC_LANES = CudaKernel("fused_dc_lanes", "fused_dc.cu", (
    P, P, I64, I32,     # table_il, mask, table_len, lanes
    P, P, P, P,         # src, dst, w, off (the edge copy)
    I32, I32, I32, I32, I32,  # k, q, fine, width, group
    I64, I64,           # num_segments, out_stride
    I32, I32, I32,      # monoid, dtype, edge_fn
    P, P, P), shares=FUSED_DC)  # acc, touched, stream
DC_GATHER_LANES = CudaKernel("dc_gather_lanes", "dc_gather.cu", (
    P, P, P, P, P,      # x, active, png_src_local, png_valid, png_tile_part
    P, I64,             # piece_tiles, n_pieces
    I64, I32, I32, I32,  # nm, k, q, msg_tile
    I32, I64, I64,      # lanes, x_stride, out_stride
    ctypes.c_ulonglong, I32,  # ident_bits, value_bytes
    P, I32,             # out, device index
    ctypes.POINTER(ctypes.c_int), P),  # regime (set by the call), stream
    regimes=("l2", "staged"), shares=DC_GATHER)
SEGMENT_COMBINE_LANES = CudaKernel("segment_combine_lanes",
                                   "segment_combine.cu", (
    P, P, P,            # vals, valid, dst_local
    P, P, P,            # tile_src_part, part_tile_off, part_active
    I32, I32, I32, I32,  # k, q, edge_tile, chunk
    I32, I64, I64, I64,  # lanes, edge_stride, part_stride, out_stride
    I32, I32,           # monoid, dtype
    P, P, P), shares=SEGMENT_COMBINE)  # acc, touched, stream
SPMV_BLOCK = CudaKernel("spmv_block", "spmv_block.cu", (
    P, P, P, P, P,      # x, src_local, dst_local, valid, w
    P, P,               # tile_src_part, part_tile_off
    I32, I32, I32, I32, I32,  # k, q, edge_tile, chunk, weighted
    P, P))              # y, stream
KERNELS = (FUSED_DC, SEGMENT_FOLD, DC_GATHER, SEGMENT_COMBINE, SPMV_BLOCK,
           FUSED_DC_INTERLEAVE, FUSED_DC_LANES, DC_GATHER_LANES,
           SEGMENT_COMBINE_LANES, FUSED_STREAM)


def build_all() -> None:
    """Compile every kernel's source in parallel and load the libraries."""
    started = [k.start_build() for k in KERNELS]
    errors = []
    for k, st in zip(KERNELS, started):
        try:
            k.finish_build(st)
        except RuntimeError as e:   # collect every compiler's output first
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n\n".join(errors))
    for k in KERNELS:
        k.lib()


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.regimes = dict.fromkeys(k.regimes, 0)


# ``or`` folds as ``max`` (its reference fold is ``segment_max`` over
# uint32, whose identity 0 is also or's), so it takes max's code;
# ``min_with_payload`` is an int64 min (repro_torch.core.monoid)
MONOID_CODES = {"add": 0, "min": 1, "max": 2, "or": 2, "min_with_payload": 1}
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.uint32: 2,
               torch.int64: 3}
#: the 8-byte carrier folds with min only (the packed min_with_payload words)
WIDE_MONOIDS = ("min", "min_with_payload")


def dtype_code(dtype, monoid: str) -> int:
    """The kernels' code of ``dtype``; raises for a type they do not fold,
    and for ``int64`` under any monoid but min."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels fold float32, int32, uint32 and "
                        f"int64, not {dtype}")
    if dtype == torch.int64 and monoid not in WIDE_MONOIDS:
        raise TypeError(f"the CUDA kernels fold int64 with min only, not "
                        f"{monoid!r}")
    return DTYPE_CODES[dtype]


def check_cuda(t, name: str, dtype=None, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given kind."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_handle(device=None) -> int:
    """The raw handle of the current stream on ``device`` (a device or its
    index; default: the current device), without building a
    ``torch.cuda.Stream``."""
    index = device
    if device is not None and not isinstance(device, int):
        index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
