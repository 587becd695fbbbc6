"""Port kernels timed alone at the main path's shapes, in this checkout or in another
one.

    python -m lshm_tpu_torch.tools.kernel_timing {khm,head_dx,conv0} [--tree DIR]

``khm``: K1 and K2 for X [420, 256] and [420, 288] (the full_khm and fourier_cascade
latents) and a larger batch, X [2500, 256], with M [10, D] and p = 4, each with
``device_us`` (CUDA events around 200 queued calls) and ``host_us`` (the host clock
around 200 calls) besides the fields below, beside ``launch_floor_us``, a one-element
fill timed as ``device_us``.  ``head_dx``: K5, the fused head's input gradient, for
x [420, 128, 128, 4], the weights and g1 [420, 32, 32, 12] of ``chip_smoke.py``'s
parity phase (seed 1), in float32 and in bf16 (the same values rounded).  ``conv0``:
K6, the standalone first stage, for x [420, 128, 128, C] at C = 4 (the probe's shape)
and C = 8, in float32 and bf16 (seed 0), each also with ``device_us``.  Every entry
has ``ms`` (median of 20 single calls between CUDA events) and the profiler's device
us per launch by kernel name.  ``--tree`` times the kernels of another checkout (for
example the parent commit unpacked with ``git archive``) with this checkout's timing
helpers (``tools/measure.py``), so that two trees are timed alike.  Prints one JSON
line and the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from lshm_tpu_torch.tools.measure import (card, host_us, kernels_module, profiler_us,
                                          queued_us, time_ms)


def khm(K, dev) -> dict:
    one = torch.zeros(1, device=dev)
    out = {"launch_floor_us": queued_us(lambda: one.fill_(1.0))}
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
    return out


def head_dx(H, dev) -> dict:
    B, P, C = 420, 128, 4
    g = torch.Generator().manual_seed(1)
    x = [torch.randn(B, P, P, C, generator=g), torch.randn(8, C, 4, 4, generator=g) * 0.2,
         torch.randn(8, generator=g) * 0.1, torch.randn(12, 8, 4, 4, generator=g) * 0.2,
         torch.randn(12, generator=g) * 0.1, torch.randn(B, P // 4, P // 4, 12, generator=g)]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        a = [t.to(dev, dtype) for t in x]
        fn = lambda: H.head_input_grad(*a)          # noqa: E731
        out[f"K5 {dtype}"] = dict(ms=time_ms(fn), profiler_us=profiler_us(fn))
    return out


def conv0(K6, dev) -> dict:
    B, P = 420, 128
    out = {}
    for C in (4, 8):
        g = torch.Generator().manual_seed(0)
        x = [torch.randn(B, P, P, C, generator=g), torch.randn(8, C, 4, 4, generator=g) * 0.1,
             torch.randn(8, generator=g) * 0.1]
        for dtype in (torch.float32, torch.bfloat16):
            a = [t.to(dev, dtype) for t in x]
            fn = lambda: K6.conv0_elu(*a)           # noqa: E731
            out[f"K6 C={C} {dtype}"] = dict(ms=time_ms(fn), device_us=queued_us(fn),
                                            profiler_us=profiler_us(fn))
    return out


# what to time: the kernels module it comes from and the function that times it
TIMED = {"khm": ("khm", khm), "head_dx": ("conv_head", head_dx), "conv0": ("conv0", conv0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("which", choices=sorted(TIMED), help="the kernels to time")
    ap.add_argument("--tree", help="root of another checkout whose kernels to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a CUDA device")
    module, timed = TIMED[args.which]
    mod = kernels_module(module, args.tree)
    out = {"kernels_from": mod.__file__, **timed(mod, torch.device("cuda"))}
    print(json.dumps(out), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
