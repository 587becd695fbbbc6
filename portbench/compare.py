"""The numbers that decide ``correct``: each a widest relative gap between what the
program produced and what the reference works out, held against the cell's limit
(``limits/<cell>.json``).

Training, per leaf and by the worst leaf, over the checked minibatches (``loss_gap``,
``grad_gap``, ``step_gap``: the first ones, from the seeded parameters and a fresh
optimizer) and over the one minibatch after the window (``late_loss_gap``,
``late_step_gap``: from the program's own parameters and Adam moments there):
- ``*loss_gap``: every ADMM iteration's logged loss, |program - reference| / |reference|;
- ``grad_gap``: the first gradient the optimizer received, | ||g_p|| - ||g_r|| | over
  max(||g_r||, the median leaf's ||g_r||);
- ``*step_gap``: the parameters' change, the same measure, over the leaves whose
  reference first gradient is at least a thousandth of the median leaf's: a leaf whose
  gradient is nought to rounding moves under Adam by about the rate in a direction set
  by round-off.  The leaves it leaves out are reported beside the numbers.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

MOVED = 1e-3       # a leaf counts in a change when its reference gradient is this share
                   # of the median leaf's or more


def _norms(d: dict, keys) -> dict:
    return {k: float(d[k].double().norm()) for k in keys}


def _worst(p: dict, r: dict, keys) -> float:
    med = statistics.median(r[k] for k in keys)
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-300) for k in keys)


def loss_gap(losses_p, losses_r) -> float:
    lp, lr = np.asarray(losses_p, np.float64), np.asarray(losses_r, np.float64)
    if lp.shape != lr.shape or not np.all(np.isfinite(lp)):
        return float("inf")
    return float(np.max(np.abs(lp - lr) / np.abs(lr)))


def grad_gap(first_p: dict, first_r: dict, active: list[str]) -> float:
    return _worst(_norms(first_p, active), _norms(first_r, active), active)


def step_gap(params_p: dict, params_r: dict, params0: dict, first_r: dict,
             active: list[str]) -> tuple[float, list[str]]:
    """(the change's gap, the leaves left out)."""
    gr = _norms(first_r, active)
    med = statistics.median(gr.values())
    moved = [k for k in active if gr[k] >= MOVED * med]

    def change(params):
        return {k: float((params[k].double().cpu() - params0[k].double().cpu()).norm())
                for k in moved}
    return _worst(change(params_p), change(params_r), moved), [k for k in active
                                                               if k not in moved]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number is finite and
    within its limit; a number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(c["limit"] is not None and np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def to_host(d: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float64) for k, v in d.items()}
