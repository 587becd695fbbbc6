"""Standalone calibration of the 2D AE's first stage: kernel K6 against cuDNN.

The port's counterpart of ``benchmarks/pallas_conv_probe.py``: elu(conv0(x) + b),
k=4, s=2, p=1, 4 -> 8 channels on 128 x 128 patches.  It checks the kernel against its
plain version first (``parity``), then times, with CUDA events, the kernel
(``conv0_elu``), the plain version (``conv0_elu_plain``: permutes around cuDNN) and the
library yardstick (cuDNN's ``F.elu(F.conv2d(...))`` on NCHW-contiguous input), and
prints each as a JSON line with the bound.  float32 only: K6 in bfloat16, the JAX
probe's default dtype, is not ported yet.

Usage (on the card):  python -m lshm_tpu_torch.tools.conv0_probe [--batch 420]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from lshm_tpu_torch.device import resolve_device, use_exact_float32
from lshm_tpu_torch.kernels import conv0 as k6
from lshm_tpu_torch.tools import measure
from lshm_tpu_torch.tools.measure import time_ms

C, F0, P = 4, 8, 128


def _inputs(device, batch: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, P, P, C, generator=g).to(device)
    w = (torch.randn(F0, C, 4, 4, generator=g) * 0.1).to(device)
    b = (torch.randn(F0, generator=g) * 0.1).to(device)
    return x, w, b


def parity(device, batch: int = 8, seed: int = 3) -> dict:
    """Kernel against its plain version."""
    x, w, b = _inputs(device, batch, seed)
    got, want = k6.conv0_elu(x, w, b), k6.conv0_elu_plain(x, w, b)
    err = float((got - want).abs().max())
    return {"parity_batch": batch, "parity_max_abs_err": err,
            "parity_rel_err": err / float(want.abs().max())}


def bound(batch: int) -> tuple[float, str]:
    """Least time (ms) at ``batch`` on the H100.  Bytes: x read once, the output
    written once; operations: FP32 multiply-adds."""
    nbytes = 4.0 * (batch * P * P * C + batch * (P // 2) ** 2 * F0 + F0 * C * 16 + F0)
    flops = 2.0 * batch * (P // 2) ** 2 * F0 * 16 * C
    return measure.bound(nbytes, flops)


def timing(device, batch: int = 420, seed: int = 0) -> dict:
    """CUDA-event medians (ms) of kernel, plain version and cuDNN at ``batch``."""
    x, w, b = _inputs(device, batch, seed)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    out = {"batch": batch, "dtype": "float32"}
    out["kernel_ms"] = time_ms(lambda: k6.conv0_elu(x, w, b))
    out["plain_ms"] = time_ms(lambda: k6.conv0_elu_plain(x, w, b))
    out["cudnn_ms"] = time_ms(lambda: F.elu(F.conv2d(x_nchw, w, b, 2, 1)))
    out["bound_ms"], out["bound_by"] = bound(batch)
    return out


def run(device, batch: int = 420) -> dict:
    """Parity first (raises if the kernel disagrees), then the timings."""
    row = parity(device)
    print(json.dumps(row), flush=True)
    if row["parity_rel_err"] > 1e-5:
        raise AssertionError(f"conv0 kernel disagrees with its plain version: {row}")
    result = {**row, **timing(device, batch)}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=420)
    args = ap.parse_args(argv)
    device = resolve_device(None)          # the card, or raise
    use_exact_float32()
    return run(device, args.batch)


if __name__ == "__main__":
    main()
