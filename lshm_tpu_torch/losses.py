"""Batched loss functions (port of ``lshm_tpu/losses.py``).

Every loss is a closed-form batched expression with the reference normalisations
(reference: src/lofar_models.py:199-229, src/kharmonic_lofar.py:97-110,154-172).  All of
them accumulate in float32 (``_f32``), as in the JAX package.  The fused KHM kernel with
its analytic backward lives in ``lshm_tpu_torch/kernels/khm.py``; ``khm_loss`` here is
the plain expression that ``model.khm_backend="xla"`` selects.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-9  # reference: src/lofar_models.py:195


def _f32(a: torch.Tensor) -> torch.Tensor:
    """Upcast to float32 for loss arithmetic (a no-op on the float32 path)."""
    return a.float() if a.dtype != torch.float32 else a


def pairwise_sq_dists(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """||x_i - m_k||^2 for X [N, D], M [K, D] -> [N, K] via one matrix product."""
    X, M = _f32(X), _f32(M)
    xx = torch.sum(X * X, dim=-1, keepdim=True)            # [N, 1]
    mm = torch.sum(M * M, dim=-1)[None, :]                 # [1, K]
    xm = X @ M.T                                           # [N, K]
    return torch.clamp_min(xx + mm - 2.0 * xm, 0.0)


def _dist_pow(d2: torch.Tensor, p: int) -> torch.Tensor:
    if p % 2 == 0:
        return d2 ** (p // 2)
    return torch.sqrt(d2 + 1e-30) ** p


def khm_loss(X: torch.Tensor, M: torch.Tensor, p: int = 4, eps: float = EPS) -> torch.Tensor:
    """K-harmonic-means clustering loss: sum over the batch of
    K / sum_k 1/(||x - m_k||^p + eps), normalised by N * K * D
    (reference: src/lofar_models.py:199-209)."""
    N, D = X.shape
    K = M.shape[0]
    dp = _dist_pow(pairwise_sq_dists(X, M), p)
    ek = torch.sum(1.0 / (dp + eps), dim=-1)               # [N]
    return torch.sum(K / (ek + eps)) / (N * K * D)


def khm_distances(X: torch.Tensor, M: torch.Tensor, p: int = 4) -> torch.Tensor:
    """Per-cluster mean p-th-power distance over a patch batch: [K]
    (reference: src/evaluate_clustering.py:111-115)."""
    return torch.mean(_dist_pow(pairwise_sq_dists(X, M), p), dim=0)


def cluster_similarity_loss(M: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Contrastive centroid-separation penalty (reference: src/lofar_models.py:214-229):
    sum_k [sum_{l != k} exp(cos-like(m_k, m_l))] / (exp(m_k.m_k/(|m_k|^2+eps)) + eps),
    normalised by K * latent."""
    K, D = M.shape
    M = _f32(M)
    G = M @ M.T                                            # [K, K]
    n = torch.sqrt(torch.diagonal(G))
    C = G / (n[:, None] * n[None, :] + eps)
    E = torch.exp(C)
    diag = torch.diagonal(E)
    num = torch.sum(E, dim=-1) - diag
    return torch.sum(num / (diag + eps)) / (K * D)


def augmentation_loss(Z: torch.Tensor, num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """Intra-baseline latent-agreement loss on baseline-major Z [N, D], N = groups * P:
    per group sum_{i<j} exp(-zhat_i . zhat_j) / P, summed and normalised by N
    (reference: src/kharmonic_lofar.py:97-110, grouping fixed to baseline-major)."""
    N, D = Z.shape
    P = N // num_groups
    Z = _f32(Z)
    nrm = torch.linalg.vector_norm(Z, dim=-1, keepdim=True)
    G = (Z / (nrm + eps)).reshape(num_groups, P, D)
    S = torch.einsum("bpd,bqd->bpq", G, G)                 # [B, P, P]
    mask = torch.triu(torch.ones((P, P), dtype=Z.dtype, device=Z.device), diagonal=1)
    per_group = torch.sum(torch.exp(-S) * mask[None], dim=(1, 2))
    return torch.sum(per_group / P) / (num_groups * P)


def log_cosh(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log(cosh(x)) = |x| + log1p(exp(-2|x|)) - log(2)."""
    a = torch.abs(x)
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


def rica_loss(*latents: torch.Tensor) -> torch.Tensor:
    """Sum over latents of mean log-cosh (reference: src/kharmonic_lofar.py:167-172)."""
    total = 0.0
    for mu in latents:
        total = total + torch.sum(log_cosh(_f32(mu))) / mu.numel()
    return total


def mse_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """nn.MSELoss(reduction='sum') with float32 accumulation."""
    d = _f32(a) - _f32(b)
    return torch.sum(d * d)


def admm_term(y: torch.Tensor, residual: torch.Tensor, rho: float) -> torch.Tensor:
    """Augmented-Lagrangian term y . vec(r) + rho/2 ||r||^2, un-normalised (the caller
    divides by numel; reference: src/kharmonic_lofar.py:156-158).  ``y`` may be flat
    [numel] or shaped like the residual."""
    y, r = _f32(y).reshape(-1), _f32(residual).reshape(-1)
    return torch.dot(y, r) + 0.5 * rho * torch.dot(r, r)
