"""Bytes and operations of the fused KHM loss (the port's K1 forward and K2 backward,
``lshm_tpu_torch/csrc/khm.cu``) on X [N, D] and centroids M [K, D], float32."""

from __future__ import annotations

from portbench.rooflines import bound_s

NAMES = {"fwd": ("khm_fwd_cluster_kernel",), "bwd": ("khm_bwd_cluster_kernel",)}


def fwd(n: int, k: int, d: int) -> tuple[float, float]:
    """X and M in, the per-row sums e [N] and the loss out; the N x K distances
    (difference, square, add per element)."""
    return 4.0 * (n * d + k * d + n + 1), 3.0 * n * k * d


def bwd(n: int, k: int, d: int) -> tuple[float, float]:
    """X, M, e and the cotangent in, dX and dM out; the distances again and the two
    products c @ M and c^T @ X."""
    return 4.0 * (2 * n * d + 2 * k * d + n + 1), 3.0 * n * k * d + 4.0 * n * k * d


def bound(op: str, n: int, k: int, d: int) -> float:
    return bound_s(*{"fwd": fwd, "bwd": bwd}[op](n, k, d))
