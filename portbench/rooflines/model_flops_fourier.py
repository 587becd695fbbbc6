"""Model FLOPs of the Fourier cascade and its objective: the reference's convolutions,
transposed convolutions and matrix products counted once on meta tensors, as
``model_flops.py`` counts the 1D cascade's, and the shifted 2D transform at an FFT's
count (``torch.utils.flop_counter`` counts no FFT): 5 N log2 N a complex N-point
transform, N = P^2 points for each channel of a patch, once a forward and once more
for the backward through it when the backward reaches the 2D AE.  The port computes
the transform as six dense matrix products, 12 P^3 C a patch (``rooflines/dft.py``,
22 times the FFT's count at P = 128); model FLOPs count the work of the function, not
of the port's algorithm.  Nothing recomputed is counted."""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.fourier import (FourierShape, cascade, objective, param_spec,
                                         zero_duals)
from portbench.reference.model import Precision, Weights


def fft2(batch: int, patch: int, channels: int) -> float:
    """FLOPs of the 2D FFT of every channel of ``batch`` patches of patch x patch."""
    n = patch * patch
    return 5.0 * n * math.log2(n) * batch * channels


def count(s: FourierShape, batch: int, patch: int, groups: int, active: list[str],
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
    with FlopCounterMode(display=False) as fwd:
        out = cascade(p, x, uv, s, Precision())
        if loss:
            total, _ = objective(out, p["khm.M"], x, zero_duals(x), Weights(), groups, s)
    transform = fft2(batch, patch, s.channels)
    out = {"fwd": float(fwd.get_total_flops()) + transform, "bwd": 0.0}
    if active:
        with FlopCounterMode(display=False) as bwd:
            torch.autograd.grad(total, [p[n] for n in active])
        out["bwd"] = float(bwd.get_total_flops())
        if any(n.startswith("ae2d.") for n in active):
            out["bwd"] += transform
    return out
