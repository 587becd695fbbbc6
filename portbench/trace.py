"""Reading a ``torch.profiler`` stretch: device busy time as the union of the device
operations' intervals, device time by kernel name and by category, and the idle gaps
by what the host was doing.  The interval union and the categories are copied from the
port's ``lshm_tpu_torch/tools/profile_step.py`` at commit 7ff9298 (``_union_us``,
``CATEGORIES``)."""

from __future__ import annotations

import time

import torch

CATEGORIES = (   # (category, substrings of the kernel name), first match wins
    ("port kernels", ("khm_fwd", "khm_bwd", "head_fwd_", "head_bwd_", "head_dx",
                      "dpre1", "reduce_partials_kernel")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop",
                     "winograd", "fft")),
    ("matrix product", ("gemm", "gemv", "cutlass", "dot", "nvjet")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise and reduction", ("elementwise", "reduce", "vectorized", "unrolled",
                                   "adam", "foreach", "multi_tensor", "cat", "index")),
)
GAP_FLOOR_US = 10.0          # gaps shorter than this are launch latency, not a stall
TOP = 10


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def kernel_name(name: str) -> str:
    """A kernel's name without its parameters, template arguments' namespaces and
    return type."""
    return name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


class Stretch:
    """A profiled stretch: ``start()`` and ``stop()`` synchronise the device, so the
    stretch holds whole units of work and its wall time is the host clock's.  On the
    card it traces the device's activity and the CUDA runtime's calls only: recording
    every host operator as well would slow the host that launches the work, and the
    stretch would read idle time that the untraced run does not have."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CUDA if self.cuda
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.wall_s = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> dict:
        """{"wall_s", "busy_s", "kernels": {name: [calls, seconds]}, "categories":
        {category: seconds}, "breakdown": {"device_ops", "idle_gaps"}}; ``kernels``
        empty off the card."""
        kern, host = [], []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if getattr(e, "is_user_annotation", False) or e.name.startswith(
                        ("Optimizer.", "ProfilerStep")):
                    continue
                kern.append((e.time_range.start, e.time_range.end, kernel_name(e.name)))
            else:
                host.append((e.time_range.start, e.time_range.end, e.name))
        per: dict[str, list] = {}
        for s, e, n in kern:
            d = per.setdefault(n, [0, 0.0])
            d[0] += 1
            d[1] += (e - s) * 1e-6
        cats: dict[str, float] = {}
        for n, (_, sec) in per.items():
            cats[category(n)] = cats.get(category(n), 0.0) + sec
        busy = union_us([(s, e) for s, e, _ in kern]) * 1e-6
        top = sorted(per.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"wall_s": self.wall_s, "busy_s": busy, "kernels": per, "categories": cats,
                "breakdown": {"device_ops": [[n, v[1]] for n, v in top],
                              "idle_gaps": idle_gaps(kern, host)}}


def idle_gaps(kern, host, limit: int = 5000) -> list:
    """[[host op, seconds]]: the device's idle gaps between its busy intervals, each
    named by the innermost host operation (on the card: CUDA runtime call) running at
    the gap's middle, summed by name, the longest sums first; "(no host op)" where the
    host ran Python and the framework between calls."""
    if not kern:
        return []
    merged = []
    for s, e, _ in sorted(kern):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
            for i in range(len(merged) - 1)]
    gaps = sorted((g for g in gaps if g[0] >= GAP_FLOOR_US), reverse=True)[:limit]
    host = sorted(host)
    by: dict[str, float] = {}
    stack, i = [], 0           # host ops begun by the current middle, latest on top
    for length, g0, g1 in sorted(gaps, key=lambda g: g[1] + g[2]):
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:    # ended: covers no later middle either
            stack.pop()
        name = stack[-1][2] if stack else "(no host op)"
        by[name] = by.get(name, 0.0) + length * 1e-6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
