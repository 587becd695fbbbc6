"""Timing and roofline helpers for the kernel measurements on the card (``tools/`` and
``chip_smoke.py``): one source for the H100's peak rates."""

from __future__ import annotations

import importlib
import math
import statistics
import subprocess
import sys
import time

import torch

PEAK_BYTES_S = 3.35e12             # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12           # H100 SXM FP32 outside the tensor cores
# H100 SXM dense bf16 on the tensor cores: the unit that may compute a function of
# bf16 inputs summed in float32, since the bf16 products are exact there
PEAK_BF16_TC_FLOP_S = 989e12
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


def queued_us(fn, calls: int = 200) -> float:
    """Device time of one call (us): CUDA events around ``calls`` calls queued without a
    synchronisation, divided by ``calls``, after 5 warm-up calls.  Where the host takes
    longer per call than the device, this reads the host's rate."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(calls):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) * 1e3 / calls


def host_us(fn, calls: int = 200) -> float:
    """Host time of one call (us): the host clock around ``calls`` calls without a
    synchronisation, divided by ``calls``, after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def kernel_name(name: str) -> str:
    """A profiler's kernel name without its parameters and anonymous namespace."""
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def profiler_us(fn, calls: int = 50) -> dict[str, float]:
    """{kernel name: device us per launch} over ``calls`` calls of ``fn`` under
    ``torch.profiler``, after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            d = per.setdefault(kernel_name(ev.name), [0, 0.0])
            d[0] += 1
            d[1] += ev.time_range.elapsed_us()
    return {name: us / n for name, (n, us) in per.items()}


def bound(nbytes: float, flops: float, peak_flop_s: float = PEAK_FP32_FLOP_S
          ) -> tuple[float, str]:
    """Least time (ms) on the H100 for moving ``nbytes`` and doing ``flops``
    operations at ``peak_flop_s`` (the peak of the unit that may compute them: FP32
    for float32 inputs, ``PEAK_BF16_TC_FLOP_S`` for bf16 ones), and which of the two
    sets it."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / peak_flop_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bf16_ulp(v: float) -> float:
    """The spacing of bfloat16 values at magnitude ``v`` (8 significant bits): the
    tolerance "one bf16 ulp of the largest value"."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def kernels_module(name: str, tree: str | None = None):
    """``lshm_tpu_torch.kernels.<name>`` of this checkout, or of the checkout at
    ``tree`` (for example the parent commit unpacked with ``git archive``), whose
    package then replaces this one in ``sys.modules``: two trees timed alike."""
    if tree:
        for mod in [m for m in sys.modules if m.split(".")[0] == "lshm_tpu_torch"]:
            del sys.modules[mod]
        sys.path.insert(0, tree)
    return importlib.import_module(f"lshm_tpu_torch.kernels.{name}")
