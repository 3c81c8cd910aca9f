"""The port's kernels: plain PyTorch versions and CUDA kernels for Hopper.

Import no CUDA at module import: the sources under ``csrc/`` are compiled
by :mod:`repro_torch.kernels._build` on the first launch on a card.
"""
