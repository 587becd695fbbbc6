"""The cascaded ADMM / augmented-Lagrangian training objective (port of
``lshm_tpu/train/objective.py``; reference: src/kharmonic_lofar.py:132-202):

    loss0 = ||xrecon - x||^2 / numel                           total reconstruction
    loss1 = (y1 . (x - x1)   + rho/2 ||x - x1||^2) / numel     2D AE ADMM term
    loss2 = (y2 . (x11 - x2) + rho/2 ||x11 - x2||^2) / numel   time-axis 1D AE ADMM term
    loss3 = (y3 . (x11 - x3) + rho/2 ||x11 - x3||^2) / numel   freq-axis 1D AE ADMM term
    kdist = alpha * KHM clustering loss on Mu
    sim   = beta  * centroid contrastive penalty
    aug   = gamma * intra-baseline latent-agreement loss
    rica  = lambda * sum of mean log-cosh of the three sparse latents

with the Lagrange-multiplier update y_k <- y_k + rho * residual_k after each optimizer
step, from a fresh forward pass at the new parameters (``dual_update`` for the Adam
step; ``metrics_and_dual_update``, the port of the JAX function of that name, shares
that forward with the metrics for the L-BFGS step; the fused Adam step takes it from
the next objective's forward, ``dual_update_from_outputs``).

The Fourier variant (outputs with ``yf_in``) has two AEs: loss0 adds the Fourier
reconstruction ||yf_out - yf_in||^2 / numel(yf_in), loss2 is the ADMM term on the full
2C-channel Fourier residual yf_in - yf_out normalised by its own numel, loss3 is 0 and
RICA takes (mu, muT).  The reference notebooks never define ADMM for that pipeline;
this is the JAX package's specified deviation, kept as it is.
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
    src/kharmonic_lofar.py:128-130).  For the Fourier variant y2 is shaped like the
    Fourier residual [N, P, P, 2C] and y3 is empty."""

    y1: torch.Tensor
    y2: torch.Tensor
    y3: torch.Tensor

    @classmethod
    def zeros_like(cls, x: torch.Tensor, fourier: bool = False) -> "Duals":
        z = torch.zeros_like(x)
        if fourier:
            return cls(y1=z, y2=x.new_zeros((*x.shape[:-1], 2 * x.shape[-1])),
                       y3=x.new_zeros((0,)))
        return cls(y1=z, y2=z, y3=z)


def loss_from_outputs(out, M: torch.Tensor, x: torch.Tensor, duals: Duals, w: LossWeights,
                      num_groups: int, use_rica: bool = True, khm_order: int = 4,
                      khm_backend: str = "auto"):
    """The objective as a function of one forward's outputs and the centroids M:
    (total_loss, metrics).  ``num_groups`` = baselines in the minibatch (augmentation
    groups are baseline-major).  ``khm_backend`` "pallas"/"auto" takes the fused KHM
    kernel, "xla" the plain expression."""
    numel = x.numel()
    loss0 = mse_sum(out.xrecon, x) / numel
    if out.yf_in is not None:
        nf = out.yf_in.numel()
        loss0 = loss0 + mse_sum(out.yf_out, out.yf_in) / nf
        loss2 = admm_term(duals.y2, out.yf_in - out.yf_out, w.rho) / nf
        loss3 = torch.zeros((), device=x.device)
        latents = (out.mu, out.muT)
    else:
        loss2 = admm_term(duals.y2, out.x11 - out.x2, w.rho) / numel
        loss3 = admm_term(duals.y3, out.x11 - out.x3, w.rho) / numel
        latents = (out.mu, out.muT, out.muF)
    metrics = {
        "loss0": loss0,
        "loss1": admm_term(duals.y1, x - out.x1, w.rho) / numel,
        "loss2": loss2,
        "loss3": loss3,
        "kdist": w.alpha * khm_loss_fused(out.Mu, M, khm_order, backend=khm_backend),
        "sim": w.beta * cluster_similarity_loss(M),
        "aug": w.gamma * augmentation_loss(out.Mu, num_groups),
    }
    if use_rica:
        metrics["rica"] = w.rica_lambda * rica_loss(*latents)
    total = sum(metrics.values())
    metrics["loss"] = total
    return total, metrics


def cascade_objective(model, x: torch.Tensor, uv: torch.Tensor, duals: Duals,
                      w: LossWeights, num_groups: int, use_rica: bool = True,
                      khm_order: int = 4, khm_backend: str = "auto"):
    """Returns (total_loss, metrics) of one forward of ``model``."""
    return loss_from_outputs(model(x, uv), model.khm.M, x, duals, w, num_groups,
                             use_rica=use_rica, khm_order=khm_order,
                             khm_backend=khm_backend)


def _residuals(out, x: torch.Tensor):
    """The constraints' residuals, one per dual in order, computed as they are taken:
    x - x1, then x11 - x2 and x11 - x3, or for the Fourier outputs yf_in - yf_out (its
    empty y3 has none)."""
    yield x - out.x1
    if out.yf_in is not None:
        yield out.yf_in - out.yf_out
    else:
        yield out.x11 - out.x2
        yield out.x11 - out.x3


@torch.no_grad()
def dual_update_from_outputs(out, x: torch.Tensor, duals: Duals, rho: float) -> Duals:
    """y_k <- y_k + rho * residual_k computed from an existing forward's outputs
    (detached: the duals take no gradient)."""
    ys = (duals.y1, duals.y2, duals.y3)
    new = [y + rho * r for y, r in zip(ys, _residuals(out, x))]
    return Duals(*new, *ys[len(new):])


@torch.no_grad()
def dual_update(model, x: torch.Tensor, uv: torch.Tensor, duals: Duals, rho: float) -> Duals:
    """y_k <- y_k + rho * residual_k with a fresh (post-step) forward pass
    (reference: src/kharmonic_lofar.py:186-202)."""
    return dual_update_from_outputs(model(x, uv), x, duals, rho)


@torch.no_grad()
def dual_update_(model, x: torch.Tensor, uv: torch.Tensor, duals: Duals,
                 rho: float) -> None:
    """``dual_update`` written into ``duals``' own tensors, which must not alias one
    another: the same sums, each added in place (the CUDA-graph step's static duals)."""
    for y, r in zip((duals.y1, duals.y2, duals.y3), _residuals(model(x, uv), x)):
        y.add_(rho * r)


@torch.no_grad()
def metrics_and_dual_update(model, x: torch.Tensor, uv: torch.Tensor, duals: Duals,
                            w: LossWeights, num_groups: int, use_rica: bool = True,
                            khm_order: int = 4, khm_backend: str = "auto"):
    """One shared post-step forward producing BOTH the per-term metrics (at the
    post-step parameters, pre-update duals) and the dual update: (metrics, duals).
    The L-BFGS ADMM step uses it after each optimizer step."""
    out = model(x, uv)
    _, metrics = loss_from_outputs(out, model.khm.M, x, duals, w, num_groups,
                                   use_rica=use_rica, khm_order=khm_order,
                                   khm_backend=khm_backend)
    return metrics, dual_update_from_outputs(out, x, duals, w.rho)
