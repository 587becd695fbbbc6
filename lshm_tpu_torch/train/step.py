"""The Adam ADMM minibatch step (port of the unfused ``make_train_step`` of
``lshm_tpu/train/step.py``; reference: src/kharmonic_lofar.py:115-202).

One call = one minibatch = ``admm_iters`` inner iterations of {Adam update on the full
augmented-Lagrangian objective, then the Lagrange-multiplier update}.  PyTorch runs
eagerly, so the ADMM loop is a Python loop; metrics come back as stacked
[admm_iters] tensors per term, like the JAX step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from lshm_tpu_torch.config import Config
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.train.objective import Duals, LossWeights, cascade_objective, dual_update
from lshm_tpu_torch.train.schedule import group_mask


@dataclass
class TrainState:
    model: CascadedAE
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(cfg: Config, model: torch.nn.Module, group: str = "all") -> torch.optim.Adam:
    """Adam over the parameters of ``group`` only (optax.adam's defaults: betas 0.9 /
    0.999, eps 1e-8).  The JAX optimizer gives frozen groups ``set_to_zero`` updates;
    torch's Adam would still move a parameter whose gradient is zero through its
    moments, so frozen parameters are simply not handed to the optimizer."""
    named = dict(model.named_parameters())
    mask = group_mask(named, group)
    params = [p for n, p in named.items() if mask[n]]
    return torch.optim.Adam(params, lr=cfg.optim.adam_lr, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(cfg: Config, device: torch.device | str, group: str = "all") -> TrainState:
    """Model initialised from ``cfg.train.seed`` (drawn on the CPU, so the weights do
    not depend on the device), moved to ``device``, with its optimizer."""
    g = torch.Generator().manual_seed(cfg.train.seed)
    model = CascadedAE(cfg.model, generator=g).to(device)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model, group))


def make_train_step(cfg: Config, num_groups: int) -> Callable:
    """(state, x, uv, weights) -> (state, metrics); ``state`` is updated in place.
    ``num_groups`` = baselines per minibatch (the augmentation grouping)."""
    nadmm = cfg.train.admm_iters
    kw = dict(use_rica=cfg.model.rica, khm_order=cfg.model.khm_order,
              khm_backend=cfg.model.khm_backend)

    def train_step(state: TrainState, x: torch.Tensor, uv: torch.Tensor, w: LossWeights):
        model, opt = state.model, state.optimizer
        duals = Duals.zeros_like(x)
        history = []
        for _ in range(nadmm):
            model.zero_grad(set_to_none=True)
            loss, metrics = cascade_objective(model, x, uv, duals, w, num_groups, **kw)
            loss.backward()
            opt.step()
            duals = dual_update(model, x, uv, duals, w.rho)
            history.append({k: v.detach() for k, v in metrics.items()})
        state.step += 1
        stacked = {k: torch.stack([m[k] for m in history]) for k in history[0]} \
            if history else {}
        return state, stacked

    return train_step
