"""Gather-phase combine monoids over torch tensors.

The fold must be an associative and commutative monoid so that it can run as
a data-parallel segmented reduction; the paper's apps use min and add.  The
names, types and identities are those of :mod:`repro.core.monoid` (``or``
with its quirk: see :func:`or_`), but for the carrier of the 8-byte
``min_with_payload``: ``int64`` with identity ``INT64_MAX`` where the
reference has ``uint64`` and ``UINT64_MAX`` (see :func:`min_with_payload`).

``uint32`` (the BFS and CC fold type) stays 4 bytes wide on every device,
but torch implements few operations for it (on the CPU, torch 2.13 raises
``NotImplementedError`` for ``lt``, ``minimum``, ``arange`` and
``index_put_``).  So this module moves ``uint32`` data through same-width
``int32`` views (:func:`as_bits`, :func:`where`) and computes on it widened
to ``int64`` (:func:`widen`, :func:`narrow`); ``add`` wraps mod 2**32 as it
does in JAX.  The CUDA kernels fold ``uint32`` natively with ``unsigned``
atomics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_NUMPY = {torch.float32: np.float32, torch.int32: np.int32,
          torch.uint32: np.uint32, torch.int64: np.int64}
#: the fold each monoid's segmented reduction runs: ``or`` folds as max (see
#: :func:`or_`), ``min_with_payload`` as an ``int64`` min
FOLD = {"add": "add", "min": "min", "max": "max", "or": "max",
        "min_with_payload": "min"}


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """Same-width signed view of ``x`` for data movement (cat, index, where)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def from_bits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`as_bits`."""
    return x.view(torch.uint32) if dtype == torch.uint32 else x


def widen(x: torch.Tensor) -> torch.Tensor:
    """``uint32`` -> ``int64`` with the same values; other types unchanged."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return x


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`widen`: int64 -> uint32 keeps the low 32 bits."""
    if dtype == torch.uint32:
        return x.to(torch.int32).view(torch.uint32)
    return x.to(dtype)


def where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` for tensors of one dtype, ``uint32`` included."""
    return from_bits(torch.where(mask, as_bits(a), as_bits(b)), a.dtype)


def full(shape, value, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.full`` that also takes a ``uint32`` value above 2**31."""
    if dtype == torch.uint32:
        bits = int(np.array(value, np.uint32).view(np.int32))
        return torch.full(shape, bits, dtype=torch.int32,
                          device=device).view(torch.uint32)
    return torch.full(shape, value, dtype=dtype, device=device)


def identity_value(name: str, dtype: torch.dtype):
    """The monoid's identity as a Python scalar."""
    npd = _NUMPY[dtype]
    floating = np.issubdtype(npd, np.floating)
    if name == "or":
        return 0
    fold = FOLD.get(name)
    if fold == "add":
        return 0.0 if floating else 0
    if fold == "min":
        return float("inf") if floating else int(np.iinfo(npd).max)
    if fold == "max":
        return float("-inf") if floating else int(np.iinfo(npd).min)
    raise ValueError(f"unknown monoid {name!r}")


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    dtype: torch.dtype
    identity: object                      # Python scalar identity element

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise ``a * b`` (associative and commutative)."""
        wa, wb = widen(a), widen(b)
        if self.name == "add":
            out = wa + wb
        elif FOLD[self.name] == "min":
            out = torch.minimum(wa, wb)
        elif self.name == "or":
            out = wa | wb
        else:
            out = torch.maximum(wa, wb)
        return narrow(out, self.dtype)

    def identity_array(self, shape, device) -> torch.Tensor:
        return full(shape, self.identity, self.dtype, device)


def make(name: str, dtype: torch.dtype) -> Monoid:
    """The monoid ``name`` over ``dtype`` (the kernels' plain versions name
    a monoid and take its type from their inputs)."""
    return Monoid(name, dtype, identity_value(name, dtype))


def add(dtype=torch.float32) -> Monoid:
    return Monoid("add", dtype, identity_value("add", dtype))


def min_(dtype=torch.uint32) -> Monoid:
    return Monoid("min", dtype, identity_value("min", dtype))


def max_(dtype=torch.uint32) -> Monoid:
    return Monoid("max", dtype, identity_value("max", dtype))


def or_() -> Monoid:
    """``uint32`` or, identity 0, as the reference defines it: ``combine``
    is ``a | b``, but the fold is a segmented **max** (the reference's
    ``_seg(jax.ops.segment_max)``), so folding a segment whose values do
    not nest bitwise gives their max, not their or.  Copied, not fixed, so
    that the two registries agree; the kernels fold it through their max
    code.  No app uses it."""
    return Monoid("or", torch.uint32, identity_value("or", torch.uint32))


def min_with_payload() -> Monoid:
    """min over packed words ``(f32 key bits << 32) | uint32 payload``: a
    lexicographic ``(key, payload)`` min that keeps e.g. SSSP's distance
    *and* parent inside one pure ``min`` fold.

    The reference carries the words as ``uint64`` with identity
    ``UINT64_MAX``.  Here the carrier is ``torch.int64`` (torch and the CUDA
    atomics order signed 64-bit words natively) with identity
    ``INT64_MAX``, and the two orders agree on every word the apps make: a
    key with its sign bit clear (a distance >= 0, a level >= 0, +inf) puts
    its word below 2**63, where ``int64`` and ``uint64`` order the same bits
    alike, and the largest such word, the unvisited BFS word ``(inf,
    PARENT_SENTINEL)`` = ``0x7F800000_FFFFFFFF``, lies below ``INT64_MAX``.
    So ``touched & (acc < best)`` decides exactly as in the reference: a
    folded message is never the identity, and an identity ``acc`` (on an
    untouched vertex, or folded from identity messages) is above every
    state word in both carriers.  Keys with the sign bit set are outside
    the contract, as they are in the reference (they do not order as
    floats there either)."""
    return Monoid("min_with_payload", torch.int64,
                  int(np.iinfo(np.int64).max))


def pack_key_payload(key_f32: torch.Tensor,
                     payload_u32: torch.Tensor) -> torch.Tensor:
    """``int64`` words ``(bits(key) << 32) | payload``: ``key`` as float32,
    ``payload`` a ``uint32`` (or any integer tensor whose low 32 bits are
    the payload)."""
    # in place on fresh copies: the words of [B, NE] edge streams are large
    words = key_f32.to(torch.float32).view(torch.int32).to(torch.int64)
    words &= 0xFFFFFFFF
    words <<= 32
    payload = as_bits(payload_u32).to(torch.int64, copy=True)
    payload &= 0xFFFFFFFF
    words |= payload
    return words


def unpack_key_payload(packed: torch.Tensor):
    """``(key float32, payload uint32)`` of :func:`pack_key_payload`'s
    words."""
    key = (packed >> 32).to(torch.int32).view(torch.float32)
    payload = packed.to(torch.int32).view(torch.uint32)
    return key, payload


REGISTRY = {"add": add, "min": min_, "max": max_, "or": or_,
            "min_with_payload": min_with_payload}
