"""Run one cell of the port's benchmark and print its result as the last line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics (a profiled stretch after the window).  Every run
checks what the timed path produced against the plain reference and prints each
number compared beside its limit, on standard error and under ``checks`` in the result.
Needs as many CUDA devices as the cell asks for; exits non-zero and prints no result
otherwise, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lshm_tpu")


@dataclass
class Context:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    control: bool = False                    # also read the control and the faults
    overrides: dict = field(default_factory=dict)   # configuration overrides (tests)
    sizes: dict = field(default_factory=dict)       # extract sizes (tests)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the JAX
    package's, compared whole (``lshm_tpu_torch`` is not ``lshm_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def measure(ctx: Context) -> dict:
    """The cell's result line (without the device check and the module check)."""
    import torch

    from portbench import compare, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = spec.driver(ctx.cell.traffic).run(ctx)
    correct, checks = compare.judge(out["numbers"], ctx.cell.limits)
    if ctx.trace:
        metrics = {}
        for m in ctx.cell.per_layer:
            v = spec.reader(m["name"])(out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {"setup_s": {"value": out["setup_s"], "unit": "s"}}
        for m in ctx.cell.end_to_end:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
    dev = torch.device(ctx.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": ctx.cell.entry["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if ctx.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["trace_window_s"]
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if ctx.trace and out["breakdown"]:
        result["breakdown"] = out["breakdown"]
    result["setup_phases"] = out["setup_phases"]
    result["left_out"] = out["left_out"]
    if ctx.trace and out["trace_window_s"]:
        rec = out["record"]
        result["wall_per_unit_s"] = {
            "window": rec["window_s"] / rec["window_units"] if rec["window_units"] else None,
            "traced": out["trace_window_s"] / rec["profiled_units"]}
    if out["readings"]:
        result["readings"] = out["readings"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    # caches of compilers the program may call stay at fixed paths in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / ".portbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / ".portbench_cache" / "torch_extensions"))
    # one host thread for the library's own CPU work: idle OpenMP workers spin, and take
    # the host from the thread that launches the card's work, which sets the pace
    os.environ["OMP_NUM_THREADS"] = "1"

    from portbench import spec

    bench = spec.benchmark(root)
    cell = spec.cell(args.workload, bench)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device="cuda", t_start=T_START)
    result = measure(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
