"""The cascaded ADMM / augmented-Lagrangian training objective (port of the non-Fourier
branch of ``lshm_tpu/train/objective.py``; reference: src/kharmonic_lofar.py:132-202):

    loss0 = ||xrecon - x||^2 / numel                           total reconstruction
    loss1 = (y1 . (x - x1)   + rho/2 ||x - x1||^2) / numel     2D AE ADMM term
    loss2 = (y2 . (x11 - x2) + rho/2 ||x11 - x2||^2) / numel   time-axis 1D AE ADMM term
    loss3 = (y3 . (x11 - x3) + rho/2 ||x11 - x3||^2) / numel   freq-axis 1D AE ADMM term
    kdist = alpha * KHM clustering loss on Mu
    sim   = beta  * centroid contrastive penalty
    aug   = gamma * intra-baseline latent-agreement loss
    rica  = lambda * sum of mean log-cosh of the three sparse latents

with the Lagrange-multiplier update y_k <- y_k + rho * residual_k after each optimizer
step, from a fresh forward pass at the new parameters.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lshm_tpu_torch.kernels import khm_loss_fused
from lshm_tpu_torch.losses import (
    admm_term,
    augmentation_loss,
    cluster_similarity_loss,
    mse_sum,
    rica_loss,
)


@dataclass(frozen=True)
class LossWeights:
    alpha: float = 0.01
    beta: float = 0.01
    gamma: float = 0.01
    rho: float = 1.0
    rica_lambda: float = 0.01


@dataclass(frozen=True)
class Duals:
    """ADMM Lagrange multipliers, one per AE consistency constraint, shaped like the
    residual they multiply; reset to zero per minibatch (reference:
    src/kharmonic_lofar.py:128-130)."""

    y1: torch.Tensor
    y2: torch.Tensor
    y3: torch.Tensor

    @classmethod
    def zeros_like(cls, x: torch.Tensor) -> "Duals":
        z = torch.zeros_like(x)
        return cls(y1=z, y2=z, y3=z)


def cascade_objective(model, x: torch.Tensor, uv: torch.Tensor, duals: Duals,
                      w: LossWeights, num_groups: int, use_rica: bool = True,
                      khm_order: int = 4, khm_backend: str = "auto"):
    """Returns (total_loss, metrics).  ``num_groups`` = baselines in the minibatch
    (augmentation groups are baseline-major).  ``khm_backend`` "pallas"/"auto" takes
    the fused KHM kernel, "xla" the plain expression."""
    out = model(x, uv)
    M = model.khm.M
    numel = x.numel()
    metrics = {
        "loss0": mse_sum(out.xrecon, x) / numel,
        "loss1": admm_term(duals.y1, x - out.x1, w.rho) / numel,
        "loss2": admm_term(duals.y2, out.x11 - out.x2, w.rho) / numel,
        "loss3": admm_term(duals.y3, out.x11 - out.x3, w.rho) / numel,
        "kdist": w.alpha * khm_loss_fused(out.Mu, M, khm_order, backend=khm_backend),
        "sim": w.beta * cluster_similarity_loss(M),
        "aug": w.gamma * augmentation_loss(out.Mu, num_groups),
    }
    if use_rica:
        metrics["rica"] = w.rica_lambda * rica_loss(out.mu, out.muT, out.muF)
    total = sum(metrics.values())
    metrics["loss"] = total
    return total, metrics


@torch.no_grad()
def dual_update(model, x: torch.Tensor, uv: torch.Tensor, duals: Duals, rho: float) -> Duals:
    """y_k <- y_k + rho * residual_k with a fresh (post-step) forward pass
    (reference: src/kharmonic_lofar.py:186-202)."""
    out = model(x, uv)
    return Duals(
        y1=duals.y1 + rho * (x - out.x1),
        y2=duals.y2 + rho * (out.x11 - out.x2),
        y3=duals.y3 + rho * (out.x11 - out.x3),
    )
