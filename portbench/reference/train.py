"""The reference's training trajectory: the same minibatches, from the same
parameters, through the ADMM loop of the reference (src/kharmonic_lofar.py:115-202):
per minibatch the duals start at zero, and each of the ``admm`` iterations takes one
Adam update on the augmented-Lagrangian objective and then the dual update from a
fresh forward at the new parameters.

``adam``: torch.optim.Adam's arithmetic (betas 0.9 / 0.999, eps 1e-8), written out, with
the step count running on across minibatches as one optimizer's does; the logged loss of
an iteration is the objective before its update.  It returns the per-iteration losses,
the first gradient the optimizer received, the final parameters and moments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from portbench.reference.model import Precision, Shape, Weights, cascade, dual_update, objective


@dataclass
class Trajectory:
    losses: torch.Tensor            # [steps, admm] float64, on the host
    first_grad: dict                # {name: tensor} of the active leaves
    params: dict                    # {name: tensor} after the last step
    moments: tuple                  # (exp_avg, exp_avg_sq, steps taken) after it


def _zeros(x):
    return (torch.zeros_like(x),) * 3


def adam(params0: dict, batches, active: list[str], s: Shape, w: Weights, groups: int,
         admm: int, lr: float, q: Precision, moments: tuple | None = None) -> Trajectory:
    """From fresh moments, or from ``moments`` = (exp_avg, exp_avg_sq, steps taken) of
    an optimizer that has already run."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = {k: v.detach().clone() for k, v in params0.items()}
    if moments is None:
        m = {k: torch.zeros_like(p[k]) for k in active}
        v2 = {k: torch.zeros_like(p[k]) for k in active}
        step = 0
    else:
        dev = p[active[0]].device
        m = {k: moments[0][k].to(dev, torch.float32, copy=True) for k in active}
        v2 = {k: moments[1][k].to(dev, torch.float32, copy=True) for k in active}
        step = int(moments[2])
    first, losses = None, []
    for x, uv in batches:
        duals, row = _zeros(x), []
        for _ in range(admm):
            leaves = {k: p[k].detach().requires_grad_() for k in active}
            full = {**p, **leaves}
            total, _ = objective(cascade(full, x, uv, s, q), full["khm.M"], x, duals, w,
                                 groups, s)
            grads = torch.autograd.grad(total, [leaves[k] for k in active])
            row.append(total.detach())
            with torch.no_grad():
                step += 1
                if first is None:
                    first = {k: g.detach().clone() for k, g in zip(active, grads)}
                bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
                for k, g in zip(active, grads):
                    m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(eps)
                    p[k] = p[k].detach().addcdiv(m[k], denom, value=-lr / bc1)
                duals = dual_update(cascade(p, x, uv, s, q), x, duals, w.rho)
        losses.append(torch.stack(row))
    return Trajectory(torch.stack(losses).double().cpu(), first, p, (m, v2, step))
