"""The 1D AE's transposed convolutions in bfloat16: the port's matrix product
(``models.autoencoders._convt1d_taps``) against PyTorch's ``F.conv_transpose1d``.

For each of the six decoder layers (stride = kernel = 4) at the layer's own shape, it
computes the output and the gradients of input, weight and bias both ways in bf16 and
gives each one's largest error against ``F.conv_transpose1d`` in float32, relative to
the largest magnitude (``errors``, runs anywhere).  On the card it also times, with
CUDA events, one forward and backward of each: the taps and ``F.conv_transpose1d``
(cuDNN) in bf16, and ``F.conv_transpose1d`` in float32 (``timing``).  One JSON line
per layer, then the sums.

Usage (on the card):  python -m lshm_tpu_torch.tools.convt1d_probe [--batch 420]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from lshm_tpu_torch.device import resolve_device, use_exact_float32
from lshm_tpu_torch.models import AutoEncoder1D
from lshm_tpu_torch.models.autoencoders import CHANNEL_LADDER, _convt1d_taps
from lshm_tpu_torch.tools.measure import time_ms

BF16 = torch.bfloat16


def _layers(device, batch: int, seed: int):
    """(layer, input, output cotangent) of each decoder stage, float32 on ``device``."""
    ae = AutoEncoder1D(latent_dim=16, generator=torch.Generator().manual_seed(seed))
    ae = ae.to(device)
    rng = np.random.default_rng(seed)
    L, out = 4, []
    for i in range(len(CHANNEL_LADDER)):
        m = getattr(ae, f"tconv{i}")
        h = rng.normal(size=(batch, m.in_channels, L))
        g = rng.normal(size=(batch, m.out_channels, 4 * L))
        out.append((m, *(torch.tensor(a, dtype=torch.float32, device=device)
                         for a in (h, g))))
        L *= 4
    return out


def _fwd_bwd(how: str, m, h, g):
    """Output and (input, weight, bias) gradients; ``how`` in taps / library_bf16 /
    library_f32 (``F.conv_transpose1d``)."""
    dt = torch.float32 if how == "library_f32" else BF16
    hh = h.to(dt).requires_grad_()
    w, b = m.weight.to(dt), m.bias.to(dt)
    y = (_convt1d_taps(hh, w, b) if how == "taps"
         else F.conv_transpose1d(hh, w, b, m.stride))
    return (y, *torch.autograd.grad(y, (hh, m.weight, m.bias), g.to(dt)))


def _rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def errors(device, batch: int = 4, seed: int = 0) -> list[dict]:
    """Per layer, the largest relative error of the bf16 taps and of the bf16
    ``F.conv_transpose1d`` (output, dx, dw, db) against float32."""
    rows = []
    for i, (m, h, g) in enumerate(_layers(device, batch, seed)):
        want = _fwd_bwd("library_f32", m, h, g)
        row = {"layer": i, "x": list(h.shape), "out_channels": m.out_channels}
        for how in ("taps", "library_bf16"):
            row[f"{how}_rel_err"] = [_rel(a, b)
                                     for a, b in zip(_fwd_bwd(how, m, h, g), want)]
        rows.append(row)
    return rows


def timing(device, batch: int = 420, seed: int = 0) -> list[dict]:
    """CUDA-event medians (ms) of one forward and backward per layer, each way."""
    rows = []
    for i, (m, h, g) in enumerate(_layers(device, batch, seed)):
        row = {"layer": i, "x": list(h.shape)}
        for how in ("taps", "library_bf16", "library_f32"):
            row[f"{how}_ms"] = time_ms(lambda: _fwd_bwd(how, m, h, g))
        rows.append(row)
    return rows


def run(device, batch: int = 420) -> list[dict]:
    rows = [{**e, **t} for e, t in zip(errors(device, batch), timing(device, batch))]
    for row in rows:
        print(json.dumps(row), flush=True)
    total = {"layers": "all", "batch": batch}
    for how in ("taps", "library_bf16", "library_f32"):
        total[f"{how}_ms"] = sum(r[f"{how}_ms"] for r in rows)
    print(json.dumps(total), flush=True)
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=420)
    args = ap.parse_args(argv)
    device = resolve_device(None)          # the card, or raise
    use_exact_float32()
    return run(device, args.batch)


if __name__ == "__main__":
    main()
