"""Test-side shims that let the reference package serve as the port's oracle.

``jax.experimental.enable_x64`` was removed in JAX 0.9; the reference's
8-byte apps (``sssp_with_parents``, ``sssp_parents_multi``,
``bfs_seeded_multi``) still call it.  ``jax.enable_x64(True)`` is the
context manager that took its place (it restores the flag on exit), so
the fixture below puts it back under the old name, for one test at a time:
a module-level patch would change, in the same worker, which reference
tests pass.  Nothing in the reference package changes.

The reference's multi-device engine fails JAX 0.9's ``check_vma`` check
(a ``pallas_call`` inside ``shard_map``); :func:`dist_check_vma_shim`
turns the check off for the engine's ``shard_map``, in the process that
runs the reference ``DistEngine`` (a subprocess of the tests, which fixes
its device count before JAX starts).
"""
import functools

import jax
import jax.experimental
import numpy as np
import pytest


def patch_x64(monkeypatch):
    """Put ``jax.experimental.enable_x64()`` back through ``monkeypatch``
    (a fixture's, or a ``pytest.MonkeyPatch.context()``'s), until it
    undoes its patches."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture
def x64(monkeypatch):
    """``jax.experimental.enable_x64()`` for the duration of one test."""
    patch_x64(monkeypatch)


def dist_check_vma_shim():
    """``repro.dist.engine.shard_map`` without the ``check_vma`` check."""
    import repro.dist.compat as compat
    import repro.dist.engine as engine
    engine.shard_map = functools.partial(compat.shard_map, check_vma=False)


def same_bits(a, b):
    """Equal dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def same_batch_stats(port, ref):
    """``BatchIterStats`` records equal but for ``wall_s``."""
    key = lambda s: (s.it, s.lanes_active, s.n_active)
    assert [key(s) for s in port] == [key(s) for s in ref]


def same_iter_stats(port, ref):
    """``IterStats`` records equal but for ``wall_s``."""
    key = lambda s: (s.it, s.n_active, s.e_active, s.dc_parts, s.sc_parts,
                     s.dc_bytes, s.sc_bytes, s.mode, s.program)
    assert [key(s) for s in port] == [key(s) for s in ref]
