"""Overlapping-patch extraction on the host (numpy; port of the numpy half of
``lshm_tpu/data/patches.py``).

Spectrograms are cut into ``patch_size x patch_size`` tiles with 50% overlap (stride =
patch_size // 2; reference: src/lofar_tools.py:157-173), emitted baseline-major: all
patches of baseline ``b`` are contiguous, row-major over the (patchx, patchy) grid.
"""

from __future__ import annotations

import numpy as np


def patch_grid_shape(T: int, F: int, patch_size: int) -> tuple[int, int]:
    """Number of overlapping patches along (time, freq) for stride = patch_size//2."""
    stride = patch_size // 2
    return (T - patch_size) // stride + 1, (F - patch_size) // stride + 1


def patchify(x: np.ndarray, patch_size: int) -> tuple[np.ndarray, tuple[int, int]]:
    """[n, T, F, C] -> ([n * px * py, ps, ps, C], (px, py)): a strided view gathered
    into one contiguous copy."""
    n, T, F, C = x.shape
    stride = patch_size // 2
    px, py = patch_grid_shape(T, F, patch_size)
    sN, sT, sF, sC = x.strides
    view = np.lib.stride_tricks.as_strided(
        x,
        shape=(n, px, py, patch_size, patch_size, C),
        strides=(sN, sT * stride, sF * stride, sT, sF, sC),
        writeable=False,
    )
    out = np.ascontiguousarray(view).reshape(n * px * py, patch_size, patch_size, C)
    return out, (px, py)
