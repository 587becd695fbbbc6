#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LSHM (``lshm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device   card name and power limit, torch and CUDA versions, TF32 flags
  2. build    compile the CUDA kernels from csrc/ (one nvcc per source, in parallel)
  3. parity   each kernel against its plain PyTorch version at the main path's shapes
              (relative max error 1e-5 forward, 2e-5 gradients), bit-identical
              repeats of the two backward kernels, and CUDA-event timings (median of
              20 after warm-up) of kernel, plain version and the library yardstick
  4. trainer  the full-width full_khm Adam trainer (12 baselines x 35 patches = 420
              patches of 128 x 128 x 4, 10 ADMM iterations x 3 minibatches) on a
              synthetic extract held in memory, with every kernel's launch count
  5. agree    one minibatch (2 ADMM iterations) through the kernels and through the
              plain path from the same state: per-term metrics within 1e-4; and the
              cascade forward on the card against the CPU on two patches
Then the kernels table as one JSON line, the card's name and power limit, and
{"ok": true, "device": {...}} as the last line.  Without a CUDA device it exits 2
before printing any result.  It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

PEAK_BYTES_S = 3.35e12         # H100 SXM HBM3
PEAK_FP32_FLOP_S = 67e12       # H100 SXM FP32 outside the tensor cores
REPEATS = 20


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median over ``repeats`` single calls, each bracketed by CUDA events."""
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
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FP32_FLOP_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# --------------------------------------------------------------------------- phase 3

def khm_phase(dev) -> list[dict]:
    from lshm_tpu_torch.kernels import khm as K

    g = torch.Generator().manual_seed(0)
    rows = []
    for N, Kc, D in ((420, 10, 256), (2500, 10, 256)):
        X = torch.randn(N, D, generator=g).to(dev)
        M = torch.rand(Kc, D, generator=g).to(dev)
        gg = torch.tensor(0.01, device=dev)          # the main path's alpha
        loss, e = K.khm_forward(X, M, 4)
        loss_p, e_p = K.khm_forward_plain(X, M, 4)
        dX, dM = K.khm_backward(X, M, e, gg, 4)
        dX_p, dM_p = K.khm_backward_plain(X, M, e_p, gg, 4)
        dX2, dM2 = K.khm_backward(X, M, e, gg, 4)
        torch.cuda.synchronize()
        fwd_rel = max(rel_err(loss, loss_p), rel_err(e, e_p))
        bwd_rel = max(rel_err(dX, dX_p), rel_err(dM, dM_p))
        row = {"phase": "parity", "kernel": "khm", "N": N, "K": Kc, "D": D,
               "fwd_rel_err": fwd_rel, "bwd_rel_err": bwd_rel,
               "bwd_bit_identical": bool(torch.equal(dX, dX2) and torch.equal(dM, dM2))}
        emit(row)
        if fwd_rel > 1e-5 or bwd_rel > 2e-5 or not row["bwd_bit_identical"]:
            raise AssertionError(f"KHM kernels disagree with their plain versions: {row}")
        if N != 420:
            continue
        flops_dist = 2.0 * N * Kc * D + 2.0 * N * D + 2.0 * Kc * D
        b1 = bound(4.0 * (N * D + Kc * D + N + 1), flops_dist + 6.0 * N * Kc)
        b2 = bound(4.0 * (2 * N * D + 2 * Kc * D + N + 1), flops_dist + 4.0 * N * Kc * D)
        rows += [
            dict(name="K1 khm_fwd", route="cuda", source="lshm_tpu_torch/csrc/khm.cu",
                 replaces="lshm_tpu/kernels/khm_pallas.py:71", counter="khm_fwd",
                 max_abs_err=max(abs_err(loss, loss_p), abs_err(e, e_p)),
                 ms=time_ms(lambda: K.khm_forward(X, M, 4)),
                 plain_ms=time_ms(lambda: K.khm_forward_plain(X, M, 4)),
                 bound_ms=b1[0], bound_by=b1[1], library_ms=None),
            dict(name="K2 khm_bwd", route="cuda", source="lshm_tpu_torch/csrc/khm.cu",
                 replaces="lshm_tpu/kernels/khm_pallas.py:92", counter="khm_bwd",
                 max_abs_err=max(abs_err(dX, dX_p), abs_err(dM, dM_p)),
                 ms=time_ms(lambda: K.khm_backward(X, M, e, gg, 4)),
                 plain_ms=time_ms(lambda: K.khm_backward_plain(X, M, e_p, gg, 4)),
                 bound_ms=b2[0], bound_by=b2[1], library_ms=None),
        ]
    return rows


def head_phase(dev) -> list[dict]:
    import torch.nn.functional as F

    from lshm_tpu_torch.kernels import conv_head as H

    B, P, C, F0, F1 = 420, 128, 4, 8, 12
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, P, P, C, generator=g).to(dev)
    w0 = (torch.randn(F0, C, 4, 4, generator=g) * 0.2).to(dev)
    b0 = (torch.randn(F0, generator=g) * 0.1).to(dev)
    w1 = (torch.randn(F1, F0, 4, 4, generator=g) * 0.2).to(dev)
    b1 = (torch.randn(F1, generator=g) * 0.1).to(dev)
    g1 = torch.randn(B, P // 4, P // 4, F1, generator=g).to(dev)
    y = H.head_forward(x, w0, b0, w1, b1)
    y_p = H.enc_head_plain(x, w0, b0, w1, b1)
    gr = H.head_weight_grads(x, w0, b0, w1, b1, g1)
    gr_p = H.head_grads_plain(x, w0, b0, w1, b1, g1)
    gr2 = H.head_weight_grads(x, w0, b0, w1, b1, g1)
    # float64 reference on the first 8 samples: cuDNN's NHWC convolutions may sum in
    # the kernel's own order, so agreement with the plain version can be bit-exact
    y64 = H.enc_head_plain(*(t.double() for t in (x[:8], w0, b0, w1, b1)))
    torch.cuda.synchronize()
    fwd_rel = rel_err(y, y_p)
    bwd_rel = max(rel_err(a, b) for a, b in zip(gr, gr_p))
    row = {"phase": "parity", "kernel": "conv_head", "x": [B, P, P, C],
           "fwd_rel_err": fwd_rel, "bwd_rel_err": bwd_rel,
           "fwd_rel_err_vs_f64": {"kernel": rel_err(y[:8].double(), y64),
                                  "plain": rel_err(y_p[:8].double(), y64)},
           "bwd_rel_err_each": [rel_err(a, b) for a, b in zip(gr, gr_p)],
           "bwd_bit_identical": all(torch.equal(a, b) for a, b in zip(gr, gr2))}
    emit(row)
    if (fwd_rel > 1e-5 or bwd_rel > 2e-5 or not row["bwd_bit_identical"]
            or row["fwd_rel_err_vs_f64"]["kernel"] > 1e-5):
        raise AssertionError(f"conv-head kernels disagree with their plain versions: {row}")

    # library yardsticks: cuDNN on NCHW-contiguous input (no layout copies)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()

    def cudnn_fwd():
        return F.elu(F.conv2d(F.elu(F.conv2d(x_nchw, w0, b0, 2, 1)), w1, b1, 2, 1))

    ws = [t.clone().requires_grad_() for t in (w0, b0, w1, b1)]
    y_graph = F.elu(F.conv2d(F.elu(F.conv2d(x_nchw, *ws[:2], 2, 1)), *ws[2:], 2, 1))
    g1_nchw = g1.permute(0, 3, 1, 2).contiguous()

    def cudnn_bwd():      # backward from saved activations, no recompute
        return torch.autograd.grad(y_graph, ws, g1_nchw, retain_graph=True)

    in_b, out_b = 4.0 * B * P * P * C, 4.0 * B * (P // 4) ** 2 * F1
    w_b = 4.0 * (w0.numel() + w1.numel() + F0 + F1)
    mac0 = B * (P // 2) ** 2 * F0 * 16 * C        # stage-0 multiply-adds
    mac1 = B * (P // 4) ** 2 * F1 * 16 * F0       # stage-1 multiply-adds
    b3 = bound(in_b + out_b + w_b, 2.0 * (mac0 + mac1))
    # backward: recompute both stages, dW1 and the stage-0 cotangent (mac1 each), dW0
    b4 = bound(in_b + out_b + 2 * w_b, 2.0 * (mac0 + mac1 + 2 * mac1 + mac0))
    return [
        dict(name="K3 head_fwd", route="cuda", source="lshm_tpu_torch/csrc/conv_head.cu",
             replaces="lshm_tpu/kernels/conv2d_outer.py:233", counter="head_fwd",
             max_abs_err=abs_err(y, y_p),
             ms=time_ms(lambda: H.head_forward(x, w0, b0, w1, b1)),
             plain_ms=time_ms(lambda: H.enc_head_plain(x, w0, b0, w1, b1)),
             bound_ms=b3[0], bound_by=b3[1], library_ms=time_ms(cudnn_fwd)),
        dict(name="K4 head_bwd", route="cuda", source="lshm_tpu_torch/csrc/conv_head.cu",
             replaces="lshm_tpu/kernels/conv2d_outer.py:334", counter="head_bwd",
             max_abs_err=max(abs_err(a, b) for a, b in zip(gr, gr_p)),
             ms=time_ms(lambda: H.head_weight_grads(x, w0, b0, w1, b1, g1)),
             plain_ms=time_ms(lambda: H.head_grads_plain(x, w0, b0, w1, b1, g1)),
             bound_ms=b4[0], bound_by=b4[1], library_ms=time_ms(cudnn_bwd)),
    ]


# --------------------------------------------------------------------- phases 4, 5

def flagship_config(tmpdir: str):
    import dataclasses

    from lshm_tpu_torch.config import preset

    cfg = preset("full_khm")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, khm_backend="pallas", pallas_head=True),
        train=dataclasses.replace(cfg.train, admm_iters=10, iters_per_epoch=3,
                                  num_epochs=1, checkpoint_dir=tmpdir),
    )


def trainer_phase(tree, tmpdir: str) -> dict:
    import math

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.utils import MetricLogger

    cfg = flagship_config(tmpdir)
    sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
    logger = MetricLogger(echo=False)
    trainer = Trainer(cfg, logger=logger)           # device=None: the card
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    summary = trainer.run(sampler)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    hist = logger.history
    patches = hist[-1]["patches"]
    # a minibatch's record is written when the next one is ready (the one-step-delayed
    # finite check, which synchronises); records 0 -> 2 bracket minibatches 1 and 2
    steady_s = (hist[-1]["t"] - hist[0]["t"]) / (len(hist) - 1)
    nadmm = cfg.train.admm_iters
    losses = {k: v for k, v in summary.items() if k != "t"}
    row = {"phase": "trainer", "preset": "full_khm", "patches": patches,
           "admm_iters": nadmm, "minibatches": len(hist), "losses": losses,
           "ms_per_admm_iter": steady_s / nadmm * 1e3,
           "patches_per_s": patches * nadmm / steady_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": wall, "launches": counts,
           "checkpoint": sorted(os.listdir(tmpdir))}
    emit(row)
    if len(hist) != 3 or patches != 420:
        raise AssertionError(f"expected 3 minibatches of 420 patches: {row}")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses: {losses}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return counts


def agree_phase(tree, tmpdir: str) -> None:
    import dataclasses

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.models import CascadedAE
    from lshm_tpu_torch.train import LossWeights, init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg_k = flagship_config(tmpdir)
    cfg_k = dataclasses.replace(cfg_k, train=dataclasses.replace(cfg_k.train, admm_iters=2))
    cfg_p = dataclasses.replace(cfg_k, model=dataclasses.replace(
        cfg_k.model, khm_backend="xla", pallas_head=False))
    mb = MinibatchSampler([tree], ["0"], cfg_k.data, seed=11).sample()
    x, uv = torch.from_numpy(mb.x).to(dev), torch.from_numpy(mb.uv).to(dev)
    w = LossWeights()
    metrics = {}
    for name, cfg in (("kernels", cfg_k), ("plain", cfg_p)):
        state = init_train_state(cfg, dev)           # same seed: same initial state
        _, m = make_train_step(cfg, mb.num_baselines)(state, x, uv, w)
        metrics[name] = {k: v.cpu() for k, v in m.items()}
    worst = {k: rel_err(metrics["kernels"][k], metrics["plain"][k]) for k in metrics["plain"]}

    # the cascade forward on the card (kernels) against the CPU (plain versions)
    model = CascadedAE(cfg_k.model, generator=torch.Generator().manual_seed(5))
    out_cpu = model(torch.from_numpy(mb.x[:2]), torch.from_numpy(mb.uv[:2]))
    model.to(dev)
    with torch.no_grad():
        out_gpu = model(x[:2], uv[:2])
    fwd = {k: rel_err(getattr(out_gpu, k).cpu(), getattr(out_cpu, k).detach())
           for k in ("xrecon", "Mu")}
    emit({"phase": "agree", "metric_rel_err": worst, "cascade_gpu_vs_cpu_rel_err": fwd,
          "kernels_metrics_last": {k: float(v[-1]) for k, v in metrics["kernels"].items()}})
    if max(worst.values()) > 1e-4 or max(fwd.values()) > 1e-4:
        raise AssertionError("kernel path and plain path disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lshm_tpu_torch.data import synth_extract
    from lshm_tpu_torch.device import use_exact_float32
    from lshm_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    use_exact_float32()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    per_source = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": per_source})

    kernels = khm_phase(dev) + head_phase(dev)

    t0 = time.perf_counter()
    tree = synth_extract(nstations=5, ntime=384, nfreq=512, seed=0)
    emit({"phase": "data", "baselines": int(tree["measurement"]["saps"]["0"]
                                            ["visibilities"].shape[0]),
          "seconds": time.perf_counter() - t0})
    with tempfile.TemporaryDirectory() as tmpdir:
        counts = trainer_phase(tree, tmpdir)
        agree_phase(tree, tmpdir)

    for k in kernels:
        k["launches"] = counts[k.pop("counter")]
        k["status"] = "ported, held against its plain version"
    emit({"kernels": kernels, "still_to_port": [
        {"name": "K5 head_dx", "replaces": "lshm_tpu/kernels/conv2d_outer.py:404",
         "status": "still to port (ROADMAP queue B); off the training path"},
        {"name": "K6 conv0 probe", "replaces": "benchmarks/pallas_conv_probe.py:56",
         "status": "still to port (ROADMAP queue B); a benchmark script's probe"},
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
