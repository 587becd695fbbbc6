"""Deep K-harmonic-means clustering head (port of ``lshm_tpu/models/khm.py``).

Learnable centroids M [K, latent_dim], initialised uniform in [0, 1) like flax's
``uniform(scale=1.0)`` (reference: src/lofar_models.py:189-261), plus the generalised
K-harmonic-means centroid update (Zhang Eq. 7.1-7.5), which the reference left dead and
broken (``torch.linlag.norm`` typo at src/lofar_models.py:248).
"""

from __future__ import annotations

import torch
from torch import nn

from lshm_tpu_torch.losses import (
    EPS,
    cluster_similarity_loss,
    khm_distances,
    khm_loss,
    pairwise_sq_dists,
)


class KHarmonicMeans(nn.Module):
    def __init__(self, latent_dim: int = 256, num_clusters: int = 10, order: int = 4,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.order = order                 # p in 1 / ||.||^p
        self.M = nn.Parameter(torch.empty(num_clusters, latent_dim))
        with torch.no_grad():
            self.M.uniform_(0.0, 1.0, generator=generator)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return khm_loss(X, self.M, self.order)

    def cluster_similarity(self) -> torch.Tensor:
        return cluster_similarity_loss(self.M)

    def distances(self, X: torch.Tensor) -> torch.Tensor:
        """Per-cluster mean ||x - m_k||^p over the batch: [K] (eval statistic)."""
        return khm_distances(X, self.M, self.order)

    def assign(self, X: torch.Tensor) -> torch.Tensor:
        """Hard assignment: argmin_k ||x - m_k||."""
        return torch.argmin(pairwise_sq_dists(X, self.M), dim=-1)


def khm_offline_update(X: torch.Tensor, M: torch.Tensor, p: int = 4,
                       eps: float = EPS) -> torch.Tensor:
    """One generalised-KHM centroid update: alpha_i = 1 / (sum_k 1/d_ik^p)^2,
    Q_ik = alpha_i / d_ik^(p+2), P_ik = Q_ik / sum_i Q_ik, M_k <- sum_i P_ik x_i."""
    d = torch.sqrt(pairwise_sq_dists(X, M) + 1e-30)        # [N, K]
    ek = torch.sum(1.0 / (d ** p + eps), dim=-1)           # [N]
    alpha = 1.0 / (ek ** 2 + eps)
    Q = alpha[:, None] / (d ** (p + 2) + eps)
    P = Q / (torch.sum(Q, dim=0, keepdim=True) + eps)      # column-normalised
    return P.T @ X                                         # [K, D]
