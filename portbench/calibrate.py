"""Read the numbers that decide ``correct`` over many seeds in one process, for setting
a cell's limits: the program's (sound runs), the control's and the faults' (each put
in the program's place against the same reference; see the drivers' ``_readings``).

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... [--control N]
        [--seconds 2]

Prints one JSON line per seed, and a summary line: per number the largest program
reading (the lower reading) and the smallest control and fault readings.  Needs the
card; each seed runs a short window, so the readings come from the timed path as a
run makes them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3,
                    help="read the control and the faults on the first N seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import run, spec

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    bench = spec.benchmark()
    rows = []
    for i, seed in enumerate(args.seeds):
        cell = spec.cell(args.workload, bench)
        ctx = run.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                          device="cuda", t_start=time.perf_counter(),
                          control=i < args.control)
        r = run.measure(ctx)
        row = {"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()},
               **r.get("readings", {})}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"lower": {}, "least": {}}
    for k in rows[0]["program"]:
        summary["lower"][k] = max(r["program"][k] for r in rows)
        for src in rows[0]:
            if src not in ("seed", "program") and k in rows[0][src]:
                summary["least"].setdefault(src, {})[k] = min(r[src][k] for r in rows
                                                              if src in r)
    print(json.dumps({"summary": summary, "workload": args.workload, "seeds": args.seeds}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
