"""K1 and K2 timed at the main path's shapes, in this checkout or in another one.

    python -m lshm_tpu_torch.tools.khm_timing [--tree DIR]

For X [420, 256] and [420, 288] (the full_khm and fourier_cascade latents) and a larger
batch, X [2500, 256], with M [10, D] and p = 4: ``ms`` (median of 20 single calls
between CUDA events), ``device_us`` (events around 200 queued calls), ``host_us`` (the
host clock around 200 calls) and the profiler's device us per launch by kernel name (a
kernel and the fixed-order reduction after it, where there is one), beside
``launch_floor_us``, a one-element fill timed as ``device_us``.  ``--tree`` times the
kernels of another checkout (for example the parent commit unpacked with ``git
archive``) with this checkout's timing helpers (``tools/measure.py``), so that two
trees are timed alike.  Prints one JSON line and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from lshm_tpu_torch.tools.measure import host_us, profiler_us, queued_us, time_ms


def _khm_module(tree: str | None):
    """lshm_tpu_torch.kernels.khm of this checkout, or of the one at ``tree``."""
    if tree:
        for name in [m for m in sys.modules if m.split(".")[0] == "lshm_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, tree)
    from lshm_tpu_torch.kernels import khm

    return khm


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("khm_timing needs a CUDA device")
    K = _khm_module(args.tree)
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    out = {"kernels_from": K.__file__, "launch_floor_us": queued_us(lambda: one.fill_(1.0))}
    g = torch.Generator().manual_seed(0)
    for N, Kc, D in ((420, 10, 256), (420, 10, 288), (2500, 10, 256)):
        X = torch.randn(N, D, generator=g).to(dev)
        M = torch.rand(Kc, D, generator=g).to(dev)
        gg = torch.tensor(0.01, device=dev)
        _, e = K.khm_forward(X, M, 4)
        for name, fn in (("K1", lambda: K.khm_forward(X, M, 4)),
                         ("K2", lambda: K.khm_backward(X, M, e, gg, 4))):
            out[f"{name} N={N} D={D}"] = dict(
                ms=time_ms(fn), device_us=queued_us(fn), host_us=host_us(fn),
                profiler_us=profiler_us(fn))
    print(json.dumps(out), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
