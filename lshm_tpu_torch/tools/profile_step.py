"""Where the time of one full-width ADMM minibatch goes on the card.

    python -m lshm_tpu_torch.tools.profile_step [--out FILE]

Builds the ``full_khm`` flagship configuration with the kernels on (420 patches of
128 x 128 x 4 from a synthetic extract held in memory), warms up with one minibatch,
then:

1. profiles one minibatch with ``torch.profiler`` and reports the device time by
   kernel and by category (the port's CUDA kernels, cuDNN convolutions, matrix
   products, elementwise and reductions, copies), the device's busy and idle share of
   the minibatch's wall time (profiled, and against the unprofiled minibatches of
   step 2, since the profiler slows the host), and the top kernels;
2. times whole minibatches (host clock around a synchronised step) on the kernel path
   and on the plain path (``khm_backend="xla"``, ``pallas_head=False``) in turns:
   plain, kernels, kernels, plain.

Prints JSON lines and the card's name and power limit; with ``--out`` it also writes
the full kernel table to that file.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

ADMM_ITERS = 10                 # the full_khm preset's
CATEGORIES = (   # (category, substrings of the kernel name), first match wins
    ("port kernels", ("khm_fwd_kernel", "khm_bwd_kernel", "head_fwd_kernel",
                      "head_bwd_kernel", "reduce_partials_kernel")),
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop",
                     "winograd", "fft")),
    ("matrix product", ("gemm", "gemv", "cutlass", "dot")),
    ("copy", ("memcpy", "memset", "copy")),
    ("elementwise and reduction", ("elementwise", "reduce", "vectorized", "unrolled",
                                   "adam", "foreach", "cat", "index")),
)


def _category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def _config(kernels: bool, admm_iters: int):
    from lshm_tpu_torch.config import preset

    cfg = preset("full_khm")
    model = (dict(khm_backend="pallas", pallas_head=True) if kernels
             else dict(khm_backend="xla", pallas_head=False))
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, admm_iters=admm_iters))


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full kernel table to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")

    from lshm_tpu_torch.data import MinibatchSampler, synth_extract
    from lshm_tpu_torch.device import use_exact_float32
    from lshm_tpu_torch.train import LossWeights, init_train_state, make_train_step

    use_exact_float32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg_k = _config(True, ADMM_ITERS)
    tree = synth_extract(nstations=5, ntime=384, nfreq=512, seed=0)
    mb = MinibatchSampler([tree], ["0"], cfg_k.data, seed=0).sample()
    x, uv = torch.from_numpy(mb.x).to(dev), torch.from_numpy(mb.uv).to(dev)
    w = LossWeights()

    runs = {}
    for name in ("plain", "kernels"):
        cfg = cfg_k if name == "kernels" else _config(False, ADMM_ITERS)
        runs[name] = (init_train_state(cfg, dev), make_train_step(cfg, mb.num_baselines))
        state, step = runs[name]
        step(state, x, uv, w)                           # warm-up (cuDNN autotune, build)
    torch.cuda.synchronize()

    # 1. one profiled minibatch on the kernel path
    state, step = runs["kernels"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, x, uv, w)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events, without the GPU-side spans of user annotations (such as
    # "Optimizer.step#Adam.step"), which cover kernels and the gaps between them
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Optimizer.", "ProfilerStep"))]
    by_name: dict[str, list] = {}
    for e in kern:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in kern])
    by_cat: dict[str, float] = {}
    for n, (_, us) in by_name.items():
        by_cat[_category(n)] = by_cat.get(_category(n), 0.0) + us
    table = sorted(({"name": n, "calls": c, "us": us, "category": _category(n)}
                    for n, (c, us) in by_name.items()), key=lambda r: -r["us"])
    prof_row = {
        "phase": "profile", "admm_iters": ADMM_ITERS, "patches": int(x.shape[0]),
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share_profiled": (1.0 - busy_us / wall_us) if kern else None,
        "kernel_events": len(kern),
        "by_category_ms": {k: v / 1e3 for k, v in sorted(by_cat.items(),
                                                         key=lambda kv: -kv[1])},
        "top": table[:12],
    }
    print(json.dumps(prof_row), flush=True)

    # 2. whole minibatches in turns: plain, kernels, kernels, plain
    times: dict[str, list] = {"plain": [], "kernels": []}
    for name in ("plain", "kernels", "kernels", "plain"):
        state, step = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, uv, w)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3 / ADMM_ITERS)
    # the profiler slows the host: the idle share against unprofiled minibatches
    unprofiled_ms = sum(times["kernels"]) / len(times["kernels"]) * ADMM_ITERS
    prof_row["device_idle_share"] = (1.0 - busy_us / 1e3 / unprofiled_ms) if kern else None
    print(json.dumps({"phase": "ab", "ms_per_admm_iter": times,
                      "patches_per_s": {k: [x.shape[0] * 1e3 / t for t in v]
                                        for k, v in times.items()},
                      "device_idle_share": prof_row["device_idle_share"]}), flush=True)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "profile": {**prof_row, "top": table},
                       "ab_ms_per_admm_iter": times}, f, indent=1)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
