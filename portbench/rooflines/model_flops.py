"""Model FLOPs of the cascade and its objective, counted once from the benchmark's own
reference on meta tensors (``torch.utils.flop_counter``: convolutions, transposed
convolutions, matrix products, their gradients; elementwise work is not counted).
Nothing recomputed is counted: a forward, and a backward to the active group's
parameters."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.model import Precision, Shape, Weights, cascade, objective, param_spec


def count(s: Shape, batch: int, patch: int, groups: int, active: list[str],
          loss: bool = True) -> dict:
    """{"fwd": FLOPs of one forward of the objective over ``batch`` patches (of the
    cascade alone without ``loss``), "bwd": its backward to ``active`` (an empty list:
    no backward)}."""
    meta = torch.device("meta")
    p = {n: torch.empty(shp, device=meta) for n, shp, _ in param_spec(s)}
    for n in active:
        p[n].requires_grad_()
    x = torch.empty((batch, patch, patch, s.channels), device=meta)
    uv = torch.empty((batch, 2), device=meta)
    duals = (torch.empty_like(x),) * 3
    with FlopCounterMode(display=False) as fwd:
        out = cascade(p, x, uv, s, Precision())
        if loss:
            total, _ = objective(out, p["khm.M"], x, duals, Weights(), groups, s)
    out = {"fwd": float(fwd.get_total_flops()), "bwd": 0.0}
    if active:
        with FlopCounterMode(display=False) as bwd:
            torch.autograd.grad(total, [p[n] for n in active])
        out["bwd"] = float(bwd.get_total_flops())
    return out
