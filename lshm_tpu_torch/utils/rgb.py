"""Pseudocolor rendering of 4-channel spectrograms + PNG montage export (a copy of
``lshm_tpu/utils/rgb.py``; PIL and matplotlib are imported inside the functions that
use them).

``channel_to_rgb`` reproduces the reference's channel-mixing pseudocolor
(reference: src/lofar_tools.py:33-48); montages replace torchvision.utils.save_image
with PIL (reference: src/evaluate_clustering.py:92-107).
"""

from __future__ import annotations

import numpy as np


def headless_matplotlib() -> None:
    """Switch matplotlib to Agg for headless figure export — UNLESS an inline/
    notebook backend is already active: library plot helpers run mid-notebook
    (e.g. ``evaluate_sap(out_dir=...)``), and a hard ``use("Agg")`` there silently
    kills every subsequent ``plt.show()`` in the user's session."""
    import matplotlib

    b = matplotlib.get_backend().lower()
    if "inline" not in b and "ipympl" not in b and "nbagg" not in b:
        matplotlib.use("Agg")


def channel_to_rgb(x: np.ndarray) -> np.ndarray:
    """[H, W, 4] (re/im of XX, YY) -> [H, W, 3] RGB mix, z-normalized first
    (reference: src/lofar_tools.py:33-48, channel-last here)."""
    assert x.shape[-1] == 4, x.shape
    x = np.asarray(x, np.float32)
    std = x.std()
    x = (x - x.mean()) / (std if std > 0 else 1.0)
    y = np.empty((*x.shape[:-1], 3), np.float32)
    y[..., 0] = (x[..., 0] + 0.3 * x[..., 1]) / 1.3
    y[..., 1] = (0.7 * x[..., 1] + 0.7 * x[..., 2]) / 1.4
    y[..., 2] = (0.3 * x[..., 2] + x[..., 3]) / 1.3
    return y


def _to_uint8(img: np.ndarray) -> np.ndarray:
    lo, hi = img.min(), img.max()
    if hi <= lo:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) / (hi - lo) * 255.0).astype(np.uint8)


def save_image_grid(images: list[np.ndarray], path: str, ncol: int | None = None) -> None:
    """Tile [H, W, 3] float images into a grid PNG (value range auto-normalized)."""
    from PIL import Image

    n = len(images)
    ncol = ncol or int(np.ceil(np.sqrt(n)))
    nrow = int(np.ceil(n / ncol))
    h, w = images[0].shape[:2]
    grid = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, ncol)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = _to_uint8(np.asarray(img))
    Image.fromarray(grid).save(path)
