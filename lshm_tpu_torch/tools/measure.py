"""Timing and roofline helpers for the kernel measurements on the card (``tools/`` and
``chip_smoke.py``): one source for the H100's peak rates."""

from __future__ import annotations

import statistics

import torch

PEAK_BYTES_S = 3.35e12             # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12           # H100 SXM FP32 outside the tensor cores
REPEATS = 20


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median over ``repeats`` single calls, each bracketed by CUDA events, after
    3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """Least time (ms) on the H100 for moving ``nbytes`` and doing ``flops`` FP32
    operations, and which of the two sets it."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")
