"""Overlapping-patch extraction (port of ``lshm_tpu/data/patches.py``): ``patchify`` on
the host (numpy) and ``patchify_torch`` on a tensor, and its inverse
``unpatchify_mean``.

Spectrograms are cut into ``patch_size x patch_size`` tiles with 50% overlap (stride =
patch_size // 2; reference: src/lofar_tools.py:157-173), emitted baseline-major: all
patches of baseline ``b`` are contiguous, row-major over the (patchx, patchy) grid.
"""

from __future__ import annotations

import numpy as np
import torch


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


def patchify_torch(x: torch.Tensor, patch_size: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """``patchify`` on a tensor, on any device (the counterpart of JAX's
    ``patchify_jax``): pure data movement, bit-identical to it.  Two ``unfold``s give
    [n, px, py, C, ps_t, ps_f] (each appends its window last), and the permute puts
    time before frequency before channels."""
    n, T, F, C = x.shape
    stride = patch_size // 2
    px, py = patch_grid_shape(T, F, patch_size)
    grid = x.unfold(1, patch_size, stride).unfold(2, patch_size, stride)
    out = grid.permute(0, 1, 2, 4, 5, 3).reshape(n * px * py, patch_size, patch_size, C)
    return out, (px, py)


def unpatchify_mean(patches: torch.Tensor, n: int, px: int, py: int, T: int,
                    F: int) -> torch.Tensor:
    """Inverse of ``patchify_torch`` by averaging the overlaps:
    [n * px * py, ps, ps, C] -> [n, T, F, C], the patches added in JAX's order."""
    ps = patches.shape[1]
    stride = ps // 2
    C = patches.shape[-1]
    grid = patches.reshape(n, px, py, ps, ps, C)
    out = patches.new_zeros((n, T, F, C))
    cnt = patches.new_zeros((n, T, F, 1))
    for i in range(px):
        for j in range(py):
            rows, cols = slice(i * stride, i * stride + ps), slice(j * stride, j * stride + ps)
            out[:, rows, cols] += grid[:, i, j]
            cnt[:, rows, cols] += 1.0
    return out / torch.clamp_min(cnt, 1.0)
