"""Standalone calibration of the 2D AE's first stage: kernel K6 against cuDNN.

The port's counterpart of ``benchmarks/pallas_conv_probe.py``: elu(conv0(x) + b),
k=4, s=2, p=1, 4 -> 8 channels on 128 x 128 patches, in bfloat16 (the default, as in
the JAX probe) or float32.  It checks the kernel against its plain version first
(``parity``: float32 within 1e-5 relative, bfloat16 within one bf16 ulp of the largest
value), then times, with CUDA events, the kernel (``conv0_elu``), the plain version
(``conv0_elu_plain``: permutes around cuDNN, in float32 on upcast inputs for bf16) and
the library yardstick (cuDNN's ``F.elu(F.conv2d(...))``: float32 on NCHW-contiguous
input, bf16 on the channels-last view of the NHWC input), and prints each as a JSON
line with the bound.

Usage (on the card):
    python -m lshm_tpu_torch.tools.conv0_probe [--batch 420] [--dtype bfloat16|float32]
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
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def inputs(device, batch: int, seed: int, dtype: str):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, P, P, C, generator=g)
    w = torch.randn(F0, C, 4, 4, generator=g) * 0.1
    b = torch.randn(F0, generator=g) * 0.1
    return tuple(t.to(device=device, dtype=DTYPES[dtype]) for t in (x, w, b))


def parity(device, batch: int = 8, seed: int = 3, dtype: str = "bfloat16") -> dict:
    """Kernel against its plain version, with the tolerance of ``dtype``."""
    x, w, b = inputs(device, batch, seed, dtype)
    got, want = k6.conv0_elu(x, w, b).float(), k6.conv0_elu_plain(x, w, b).float()
    err, top = float((got - want).abs().max()), float(want.abs().max())
    tol = measure.bf16_ulp(top) if dtype == "bfloat16" else 1e-5 * top
    return {"parity_batch": batch, "parity_dtype": dtype, "parity_max_abs_err": err,
            "parity_rel_err": err / top, "parity_tol_abs": tol,
            "parity_differing_share": float((got != want).float().mean())}


def bound(batch: int, dtype: str = "bfloat16") -> tuple[float, str]:
    """Least time (ms) at ``batch`` on the H100.  Bytes: x read once, the output
    written once; operations: multiply-adds at FP32's peak for float32 inputs, at the
    bf16 tensor cores' for bf16 ones (bf16 products are exact in a float32 sum)."""
    size = DTYPES[dtype].itemsize
    nbytes = size * (batch * P * P * C + batch * (P // 2) ** 2 * F0 + F0 * C * 16 + F0)
    flops = 2.0 * batch * (P // 2) ** 2 * F0 * 16 * C
    peak = measure.PEAK_BF16_TC_FLOP_S if dtype == "bfloat16" else measure.PEAK_FP32_FLOP_S
    return measure.bound(nbytes, flops, peak)


def timing(device, batch: int = 420, seed: int = 0, dtype: str = "bfloat16") -> dict:
    """CUDA-event medians (ms) of kernel, plain version and cuDNN at ``batch``."""
    x, w, b = inputs(device, batch, seed, dtype)
    x_lib = x.permute(0, 3, 1, 2)                  # channels-last view of NHWC
    if dtype == "float32":
        x_lib = x_lib.contiguous()                 # cuDNN's float32 NCHW
    out = {"batch": batch, "dtype": dtype}
    out["kernel_ms"] = time_ms(lambda: k6.conv0_elu(x, w, b))
    out["plain_ms"] = time_ms(lambda: k6.conv0_elu_plain(x, w, b))
    out["cudnn_ms"] = time_ms(lambda: F.elu(F.conv2d(x_lib, w, b, 2, 1)))
    out["bound_ms"], out["bound_by"] = bound(batch, dtype)
    return out


def run(device, batch: int = 420, dtype: str = "bfloat16") -> dict:
    """Parity first (raises if the kernel disagrees), then the timings."""
    row = parity(device, dtype=dtype)
    print(json.dumps(row), flush=True)
    if row["parity_max_abs_err"] > row["parity_tol_abs"]:
        raise AssertionError(f"conv0 kernel disagrees with its plain version: {row}")
    result = {**row, **timing(device, batch, dtype=dtype)}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=420)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    args = ap.parse_args(argv)
    device = resolve_device(None)          # the card, or raise
    use_exact_float32()
    return run(device, args.batch, args.dtype)


if __name__ == "__main__":
    main()
