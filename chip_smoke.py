#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of LSHM (``lshm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:
  1. device     card name and power limit, torch and CUDA versions, TF32 flags
  2. build      compile the CUDA kernels from csrc/ (one nvcc per source, in parallel),
                then the native host decoder (native/patchio.cpp, the host's g++)
  3. parity     each kernel of K1-K5 against its plain PyTorch version at the main
                path's shapes (K1/K2 at D = 256 and at the Fourier cascade's 288, and at
                N = 2500, (5, 3, 128), a ragged D = 72, K = 21 and K = 200; relative max
                error 1e-5 forward, 2e-5 gradients, and no farther from float64 than
                twice the plain version; K1/K2 also timed as device_us (CUDA events
                around 200 queued calls), host_us (the host clock around 200 calls) and
                the profiler's us per launch, beside a launch_floor line, one queued
                fill), bit-identical repeats of K1-K5, K3-K5 also at C = 8 (B = 16)
                and, with their plain versions, against the head in float64 (on the
                first 8 samples at B = 420), a float32 g1 off its pair alignment
                refused by K5's wrapper, and CUDA-event timings (median of 20 after
                warm-up, tools/measure.py) of kernel, plain version and library
                yardstick, with the profiler's device time per launch for K5 (its other
                floors, computed from the shapes, in the parity row's dx_floors); then
                K3, K4 and K5 in bfloat16 the same way (K3's output 4e-3, at most 5e-4
                of its elements differing, within one bf16 ulp of the largest value;
                K5's dx one bf16 ulp, with the share of elements that differ; K4's
                float32 sums before the cast 1e-4; K3, K4 and K5 at C = 4 and at C = 8
                (B = 16), each also with its plain version's distance from the head in
                float64; bit-identical repeats; yardsticks in bf16, channels-last), with
                a SHA-256 digest of bf16 K3's, K4's and K5's outputs
  4. device_decode   the decode on the card (data/device_decode.py) at full width on
                the training extract, the numpy host path as the oracle with JAX's gates
                (2e-4 relative, 2e-5 absolute): device_decode_train on one sample_raw
                against sample() of a twin sampler (420 patches, 840 with augment; the
                same rng state after), bit for bit with the normalisation off;
                device_decode_patchify on a chunk of 8 baselines against
                read_baselines_patches_batch; two calls bit for bit; the
                DeviceDecodePrefetcher's minibatches bit for bit the same decode on the
                default stream while the consumer's stream is held busy (the
                record_stream check); host ms of sample() and sample_raw(), device ms of
                the decode, and the bytes each pipeline copies to the card a minibatch
  5. trainer    the full-width full_khm Adam trainer (12 baselines x 35 patches = 420
                patches of 128 x 128 x 4, 10 ADMM iterations x 3 minibatches) on a
                synthetic extract held in memory, with every kernel's launch count, run
                twice: decoding on the card (the default, as every trainer phase below)
                and on the host (data.device_decode=False; sample() through the native
                decoder, "host_decoder": "native"); K1-K4 launch 30, 30, 60, 30 in each,
                and the first minibatch's per-term losses agree within JAX's 5e-3
                relative gate
  6. agree      one minibatch (2 ADMM iterations) through the kernels and through the
                plain path from the same state: per-term metrics within 1e-4; and the
                cascade forward on the card against the CPU on two patches
  7. trainer_bf16     the same run of preset full_khm_bf16 (bfloat16_full): K1, K2 and
                the bf16 K3 and K4 launch 30, 30, 60 and 30 times; then the first ADMM
                iteration of the first minibatch from the same initial parameters
                in bfloat16_full and in float32, per-term losses within JAX's bf16 gate
                0.05 |f32| + 5e-3 (tests/test_bf16.py:101-120)
  8. trainer_fourier  the same run of preset fourier_cascade (the legacy Fourier
                pipeline, latent 224 + 64): K1, K2, K3 and K4 launch exactly 30, 30, 60
                and 30 times, K5 never; then agree_fourier (as 6) and its first ADMM
                iteration in bfloat16_full against float32 (as 7); the DFT kernels
                launch as often as dft_calls counts the transform (60 and 30)
  8b. dft       the Fourier cascade's DFT kernels (csrc/dft.cu) at [420, 128, 128, 4]
                and at C = 8: forward and adjoint against torch.fft in float64, against
                the dense path (fft2_dense and autograd through it) and the plain
                version (no farther from float64 than the dense path, 1e-5 from the
                plain version), bit-identical repeats and CUDA-graph replays, ms and the
                profiler's us a launch beside the dense path's; then dft_profile: one
                float32 Fourier minibatch under torch.profiler, every device operation
                inside a cascade.dft span or a DFT2Backward node a DFT kernel, 20 and
                10 launches, as dft_calls counts
  9. head_input_grad  enc_head on a CUDA x that needs its gradient, in float32 and in
                bf16: K3, K4 and K5 of each dtype launch; float32 dx against autograd
                through the plain version (2e-5), bf16 dx within one bf16 ulp and
                bit-identical over two calls
  10. conv0_probe     the port's probe tool at batch 420, at its default dtype (bf16)
                and in float32 (its parity check, then K6, its plain version and cuDNN
                timed), then K6's parity at 420 in each dtype (float32 1e-5, bf16 one
                ulp) and its gates at 420, at C = 8 and at P = 36 (float32 1e-5 and
                within twice the plain version's distance from float64; bf16 one ulp,
                at most 1e-4 of the outputs differing and the same float64 rule;
                bit-identical repeats), a SHA-256 digest of its outputs in each dtype
                and the profiler's device time per launch: K6's two rows of the
                kernels line
  11. lbfgs     the full-width Trainer through the published recipe's Adam -> L-BFGS
                switch (preset full_khm_lbfgs as published, bfloat16, its prefetch on):
                4 epochs x 1 minibatch x 2 ADMM iterations over the groups ae2d, ae1d,
                khm, ae2d, and its checkpoint; per epoch, timed around the step alone,
                its kind, group, ms and closure evaluations per ADMM iteration, host
                synchronisations, peak memory and K1-K4 launches
  12. agree_lbfgs     the L-BFGS closure in float32 (value, every gradient) through the
                kernels (K1-K4 launched) against the plain path (none launched), within
                1e-4 / 2e-4, and one L-BFGS ADMM iteration through each with both
                func_evals printed
  13. resume    float32 full_khm with Adam, 2 epochs x 2 minibatches x 10 ADMM
                iterations: the uninterrupted run twice (the card's run-to-run
                distance), then the same training cut at the epoch boundary and
                mid-epoch (save_every_iters=1) and resumed by a fresh Trainer.load:
                each resumed run bit-identical to the first run where the two
                uninterrupted runs are, else within twice their distance; K1-K4
                launch as often cut and resumed as uninterrupted
  14. eval      the clustering evaluation of a SAP from the resumed run's checkpoint
                (synthetic extract of 10 stations: 55 baselines x 35 patches, chunks of
                8): baseline_distance_matrix in float32 and bfloat16_full, through the
                kernels (K3 once a chunk) decoding on the card (the default) and on the
                host (device_decode=False: the native decoder, one call a baseline), and
                with pallas_head=False (never K3);
                latents 1e-5 and X 1e-4 from the plain path and between the two decodes
                in float32 with the same soft assignment (bf16: the distances and the
                share of equal assignments printed); wall seconds, patches/s,
                baselines/s, peak memory of each; the serial path (decode_lookahead=0)
                against the pipelined one (seconds; the same 1e-5 / 1e-4, bit-identity
                printed), the host decode alone (native and numpy), the raw reads alone,
                one chunk's
                device decode and forward; then evaluate_sap without t-SNE
  15. export    export_forward of that float32 model with a symbolic batch on the card
                and load_exported of it, called at batch 35 and 96: the graph holds the
                lshm_tpu_torch.head_fwd node, each call launches K3 once, outputs within
                1e-6 of the eager kernel path (bit-identity printed), ms at batch 96
  16. cli       lshm_tpu_torch.cli.main in this process at full width: train one epoch
                of 2 minibatches x 10 ADMM iterations with a checkpoint, --log-jsonl and
                --profile-dir, train --resume to the second epoch, export --ckpt; JSONL
                records with JAX's keys, the trace names K1-K4, K1-K4 launch 20, 20, 40,
                20 an epoch, the exported call at batch 96 within 1e-6 of Trainer.load's
                model with one K3 launch (scan_files replaced by the in-memory extract
                for the phase, restored after; eval and demo need sklearn and
                matplotlib, which the card's machine lacks: the CPU tests cover them)
  17. native_decode   the native host decoder at full width: the default sampler takes it
                on this machine; sample() native against numpy from twin samplers (420
                patches, 840 with augment) within JAX's gate (rtol 1e-5, atol 1e-5), the
                same rng state after, uv equal; read_baselines_patches_batch native
                against numpy on 8 baselines of each extract; native repeats bit for bit;
                host ms (median of 5) of sample() with each decoder, read_baseline_raw,
                the numpy path's parts and an eval chunk; cores, OpenMP threads and the
                OpenMP runtimes mapped into the process; where $CXX is not the path's
                g++, that g++'s build too (timed, held to the default build)
  18. rica      lshm_tpu_torch.cli.main(["rica", ...]) at its defaults on the card (10
                minibatches x 8 baselines x 35 patches, A [65536, 256], M = 256, 10
                solver iterations), each minibatch decoded by sample() through the
                native decoder (scan_files in lshm_tpu_torch.data replaced by the
                in-memory extract for the phase): first, on a learner of the same seed,
                the first closure within 1e-5 / 2e-5 of float64 on the CPU and one fit
                repeated (same func_evals, losses 1e-6); then the CLI's lines, finite
                loss and |dA|, the atom PNG, no port kernel launched; ms per fit,
                func_evals and host syncs per solve, sample() ms, peak memory
  19. graph     the graph networks from the float32 checkpoint of 13, at LOFAR's 62
                stations (two SAPs of 1,953 baselines, 128 x 256 channels, made by
                lofar_extract from the eval extract's baselines): the line graph built
                on the card (1,953 nodes, 236,437 edges, K3 245 times) and trained 200
                epochs, twice from the same initial weights (the distance printed);
                train_station_graph_epochs at the CLI's defaults over both SAPs (5
                rebuilds x 20 steps; each rebuild 62 nodes, 3,782 edges, K3 123 times);
                the losses finite and falling as in JAX's tests; each net on the card,
                at its initial weights and trained, against copies on the CPU: float64
                within 1e-9; float32 within 1e-5 (output, loss) and 2e-5 (gradients),
                or within twice the CPU float32's distance from float64 over 6 orders
                of the edges;
                then cli.main(["graph", "line"|"station", ...]) on the eval extract;
                build seconds, each rebuild's read+decode and rest, ms per line epoch and
                per station step (CUDA events), peak memory
  20. data_parallel   train/parallel.py and train/distributed.py in child processes
                (this process never holds a process group; a child that fails or
                outlives its timeout fails the phase): (a) a NCCL group of one rank, one
                full_khm minibatch (420 patches, 12 groups, 10 ADMM iterations) from one
                state through the plain Adam step, the data-parallel step and the fused
                step (plain, data-parallel, fused, fused, data-parallel, plain): the
                data-parallel step within twice the card's run-to-run distance of the
                plain one (bit for bit where that is 0), K1-K4 10, 10, 20, 10, 11
                all-reduces (10 of the 1,725,716 gradients, one of the metrics); the
                fused step's metrics 1e-4 from the unfused, K3 10 against 20; ms per
                ADMM iteration of each and the all-reduce's ms alone; (b) two gloo ranks
                sharing cuda:0, each a full-width Trainer (3 minibatches x 10 ADMM
                iterations of 12 baselines x 35 patches on its own sampler stream, the
                host decode through the native decoder, a checkpoint per minibatch) on a
                copy of the package whose _build/ starts empty (both ranks build at
                once): SHA-256 of the parameters and the losses equal on both ranks,
                K1-K4 30, 30, 60, 30 per rank, rank 0's last checkpoint loaded bit for
                bit by a fresh Trainer on each rank; then this process steps the two
                ranks' first minibatches concatenated (840 patches, 24 groups) from the
                same initial parameters: per-term metrics within 1e-4 and the parameters
                after the first minibatch within JAX's mesh gate (atol 2e-5, rtol 1e-4);
                ms per ADMM iteration, peak memory and the all-reduce's ms per rank (two
                ranks share the card's SMs: not a scaling figure)
  21. rewrites  the exact rewrites and remat at full width, each off by default: (a) one
                full_khm minibatch (420 patches, 12 groups, 10 ADMM iterations) from one
                state through the Adam step of the default, fuse_1d, fast_conv1d,
                packed_conv2d=2, no head, packed_conv2d=6 without the head (held
                against no head), remat, all four together (packed_conv2d=2) and the
                fused step with remat: per-term metrics within 1e-4, K1-K4 launches
                as derived (10, 10, 20, 10; K3/K4 0 without the head; under remat K1 20
                and K3 30, the fused step's K3 20), ms per ADMM iteration (CUDA events)
                in two rounds in mirrored order, peak memory of each; (b) bfloat16_full
                with fuse_1d and fast_conv1d: the first ADMM iteration within JAX's bf16
                gate of float32's, K1, K2 and the bf16 K3/K4 launched; (c) the float32
                L-BFGS closure (value, every gradient) with every rewrite and remat
                against the defaults (1e-4 / 2e-4; K1 2, K3 2 against 1, 1), then one
                L-BFGS ADMM iteration of each with func_evals; (d) recon_admm_losses at
                [420, 128, 128, 4] float32 against autograd through the term-by-term
                form (values 1e-6, gradients 1e-5), ms forward + backward of each;
                (e) the Trainer with every rewrite and remat, 1 epoch x 2 minibatches:
                K1-K4 40, 20, 60, 20
  22. cuda_graph      the Adam step on CUDA graphs (train/step.py) against the eager
                step: 3 minibatches x 10 ADMM iterations of a Trainer for full_khm,
                full_khm_bf16 and fourier_cascade, eager twice (the card's run-to-run
                distance), then on graphs: parameters and logged losses within twice
                that distance (bit for bit where it is 0), K1-K4 launching as often,
                1 capture, 40 replays and 10 eager iterations; ms of each run's last
                minibatch; full_khm's step on minibatches of 12 and 6 baselines in
                turns, six, eager twice and on graphs (within twice the run-to-run
                distance; 2 captures, 80 replays, 20 eager iterations); then a
                full_khm graph run under --profile-dir whose trace holds K1-K4 as
                often as their counters say, and cuDNN's kernels
Each path (5, 7, 8, 9, 10, 11, 13, 14, the exported calls of 15, the CLI's train,
resume and exported call, 18, 19's graph builds, trainings and CLI calls, 20's steps
and trainers, 21's steps, closures and trainer, and 22's trainers) is driven with the
launch counts set to 0 just before it and read just after.  From a Trainer's second
minibatch on, the Adam steps run on CUDA graphs (train/step.py), whose replays add
the launches their capture counted.  Then a seconds line, the kernels table as one
JSON line, the card's name and power limit, and {"ok": true, "device": {...}} as the
last line.
Without a CUDA device it exits 2 before printing any result.  It imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import tempfile
import time

import torch

ADAM_PATH = ("khm_fwd", "khm_bwd", "head_fwd", "head_bwd")    # K1-K4
BF16_PATH = ("khm_fwd", "khm_bwd", "head_fwd_bf16", "head_bwd_bf16")   # K3, K4 in bf16
HEAD_PATH = ("head_fwd", "head_bwd", "head_dx")                 # EncHead, x's gradient
HEAD_BF16_PATH = ("head_fwd_bf16", "head_bwd_bf16", "head_dx_bf16")
PATCHES = 420                  # 12 baselines x 35 patches: one full-width minibatch


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def host_ms(fn, repeats: int = 5) -> float:
    """Median host time of ``fn`` between two synchronisations, after one warm-up:
    for a call that launches many kernels and reads values on the host."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# --------------------------------------------------------------------------- phase 3

def khm_f64(X, M, p: int, g: float) -> tuple:
    """loss, e, dX, dM (cotangent g) in float64, d2 from the differences: how far a
    kernel and its plain version each lie from the nearly exact result."""
    X, M = X.double(), M.double()
    (N, D), K = X.shape, M.shape[0]
    d2 = ((X[:, None, :] - M[None]) ** 2).sum(-1)
    t = d2 ** (p // 2) + 1e-9
    e = (1.0 / t).sum(-1, keepdim=True)
    c = g * p * d2 ** (p // 2 - 1) / ((N * D) * (e + 1e-9) ** 2 * t * t)
    return ((K / (e + 1e-9)).sum() / (N * K * D), e,
            c.sum(-1, keepdim=True) * X - c @ M, c.sum(0)[:, None] * M - c.T @ X)


def khm_phase(dev) -> list[dict]:
    from lshm_tpu_torch.kernels import khm as K
    from lshm_tpu_torch.tools.measure import (bound, host_us, profiler_us, queued_us,
                                              time_ms)

    # the floor of one launch on this card: a one-element fill, queued like K1/K2 below
    one = torch.zeros(1, device=dev)
    emit({"phase": "launch_floor", "launch_floor_us": queued_us(lambda: one.fill_(1.0))})
    g = torch.Generator().manual_seed(0)
    rows = []
    # the full_khm latent (224 + 2 x 16), the fourier_cascade one (224 + 64), a larger
    # batch, a small case, a ragged D, a K above the kernels' 8-centroid chunk, and M
    # too large for shared memory beside K2's sums (K2 reads M from L2)
    for N, Kc, D in ((420, 10, 256), (420, 10, 288), (2500, 10, 256), (5, 3, 128),
                     (48, 6, 72), (200, 21, 96), (420, 200, 256)):
        X = torch.randn(N, D, generator=g).to(dev)
        M = torch.rand(Kc, D, generator=g).to(dev)
        gg = torch.tensor(0.01, device=dev)          # the main path's alpha
        loss, e = K.khm_forward(X, M, 4)
        loss2, e2 = K.khm_forward(X, M, 4)
        loss_p, e_p = K.khm_forward_plain(X, M, 4)
        dX, dM = K.khm_backward(X, M, e, gg, 4)
        dX_p, dM_p = K.khm_backward_plain(X, M, e_p, gg, 4)
        dX2, dM2 = K.khm_backward(X, M, e, gg, 4)
        loss64, e64, dX64, dM64 = khm_f64(X, M, 4, float(gg))
        torch.cuda.synchronize()
        fwd_rel = max(rel_err(loss, loss_p), rel_err(e, e_p))
        bwd_rel = max(rel_err(dX, dX_p), rel_err(dM, dM_p))
        row = {"phase": "parity", "kernel": "khm", "N": N, "K": Kc, "D": D,
               "plan": K.plan(Kc, D), "cluster": K.CLUSTER,
               "fwd_rel_err": fwd_rel, "bwd_rel_err": bwd_rel,
               "fwd_rel_err_vs_f64": {
                   "kernel": max(rel_err(loss, loss64), rel_err(e, e64)),
                   "plain": max(rel_err(loss_p, loss64), rel_err(e_p, e64))},
               "bwd_rel_err_vs_f64": {
                   "kernel": max(rel_err(dX, dX64), rel_err(dM, dM64)),
                   "plain": max(rel_err(dX_p, dX64), rel_err(dM_p, dM64))},
               "fwd_bit_identical": bool(torch.equal(loss, loss2) and torch.equal(e, e2)),
               "bwd_bit_identical": bool(torch.equal(dX, dX2) and torch.equal(dM, dM2))}
        emit(row)
        # no farther from float64 than twice the plain version
        near_f64 = all(d["kernel"] <= 2 * d["plain"]
                       for d in (row["fwd_rel_err_vs_f64"], row["bwd_rel_err_vs_f64"]))
        if (fwd_rel > 1e-5 or bwd_rel > 2e-5 or not near_f64
                or not row["fwd_bit_identical"] or not row["bwd_bit_identical"]):
            raise AssertionError(f"KHM kernels disagree with their plain versions: {row}")
        if N != 420 or Kc != 10:
            continue
        flops_dist = 2.0 * N * Kc * D + 2.0 * N * D + 2.0 * Kc * D
        b1 = bound(4.0 * (N * D + Kc * D + N + 1), flops_dist + 6.0 * N * Kc)
        b2 = bound(4.0 * (2 * N * D + 2 * Kc * D + N + 1), flops_dist + 4.0 * N * Kc * D)
        # the D = 256 rows count their launches on the main path, the D = 288 rows on
        # the Fourier trainer's
        at, path = ("", "trainer") if D == 256 else (f" (D={D})", "trainer_fourier")
        fwd = lambda: K.khm_forward(X, M, 4)          # noqa: E731
        bwd = lambda: K.khm_backward(X, M, e, gg, 4)  # noqa: E731
        # device time per launch: K1/K2 are one launch each, their only device work
        prof_fwd, prof_bwd = profiler_us(fwd), profiler_us(bwd)
        rows += [
            dict(name=f"K1 khm_fwd{at}", route="cuda", source="lshm_tpu_torch/csrc/khm.cu",
                 replaces="lshm_tpu/kernels/khm_pallas.py:71", counter="khm_fwd", path=path,
                 arch=f"one cluster of {K.CLUSTER} CTAs, sums in DSMEM",
                 max_abs_err=max(abs_err(loss, loss_p), abs_err(e, e_p)),
                 ms=time_ms(fwd), device_us=queued_us(fwd), host_us=host_us(fwd),
                 profiler_us=prof_fwd,
                 plain_ms=time_ms(lambda: K.khm_forward_plain(X, M, 4)),
                 bound_ms=b1[0], bound_by=b1[1], library_ms=None),
            dict(name=f"K2 khm_bwd{at}", route="cuda", source="lshm_tpu_torch/csrc/khm.cu",
                 replaces="lshm_tpu/kernels/khm_pallas.py:92", counter="khm_bwd", path=path,
                 arch=f"one cluster of {K.CLUSTER} CTAs, sums in DSMEM",
                 max_abs_err=max(abs_err(dX, dX_p), abs_err(dM, dM_p)),
                 ms=time_ms(bwd), device_us=queued_us(bwd), host_us=host_us(bwd),
                 profiler_us=prof_bwd,
                 plain_ms=time_ms(lambda: K.khm_backward_plain(X, M, e_p, gg, 4)),
                 bound_ms=b2[0], bound_by=b2[1], library_ms=None),
        ]
    return rows


def head_inputs(dev) -> tuple:
    """The parity phase's head inputs at the main path's shapes: x [420, 128, 128, 4]
    NHWC, w0, b0, w1, b1 and the cotangent g1, float32, from seed 1."""
    B, P, C, F0, F1 = 420, 128, 4, 8, 12
    g = torch.Generator().manual_seed(1)
    return tuple(t.to(dev) for t in (
        torch.randn(B, P, P, C, generator=g), torch.randn(F0, C, 4, 4, generator=g) * 0.2,
        torch.randn(F0, generator=g) * 0.1, torch.randn(F1, F0, 4, 4, generator=g) * 0.2,
        torch.randn(F1, generator=g) * 0.1, torch.randn(B, P // 4, P // 4, F1, generator=g)))


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes in order: equal digests, equal outputs bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def head_phase(dev) -> list[dict]:
    import torch.nn.functional as F

    from lshm_tpu_torch.kernels import conv_head as H
    from lshm_tpu_torch.tools.measure import (PEAK_BF16_TC_FLOP_S, bound, profiler_us,
                                              time_ms)

    x, w0, b0, w1, b1, g1 = head_inputs(dev)
    B, P, _, C = x.shape
    F0, F1 = w0.shape[0], w1.shape[0]
    y = H.head_forward(x, w0, b0, w1, b1)
    y2 = H.head_forward(x, w0, b0, w1, b1)
    y_p = H.enc_head_plain(x, w0, b0, w1, b1)
    gr = H.head_weight_grads(x, w0, b0, w1, b1, g1)
    gr_p = H.head_grads_plain(x, w0, b0, w1, b1, g1)
    gr2 = H.head_weight_grads(x, w0, b0, w1, b1, g1)
    dx = H.head_input_grad(x, w0, b0, w1, b1, g1)
    dx_p = H.head_grads_plain(x, w0, b0, w1, b1, g1, input_grad=True)[0]
    dx2 = H.head_input_grad(x, w0, b0, w1, b1, g1)
    # float64 reference on the first 8 samples
    first8 = (x[:8], w0, b0, w1, b1, g1[:8])
    gr8, gr8_p = H.head_weight_grads(*first8), H.head_grads_plain(*first8)
    dx8, dx8_p = H.head_input_grad(*first8), dx_plain(*first8)
    f64 = grads_f64(first8)
    c8 = head_c8(dev, torch.float32)
    torch.cuda.synchronize()
    fwd_rel = rel_err(y, y_p)
    bwd_rel = max(rel_err(a, b) for a, b in zip(gr, gr_p))
    row = {"phase": "parity", "kernel": "conv_head", "x": [B, P, P, C],
           **fwd_agreement(y, y_p, y2, head_f64(first8)), "bwd_rel_err": bwd_rel,
           "bwd_rel_err_each": [rel_err(a, b) for a, b in zip(gr, gr_p)],
           "bwd_rel_err_vs_f64": vs_f64({"kernel": gr8, "plain": gr8_p}, f64[1:]),
           "bwd_bit_identical": all(torch.equal(a, b) for a, b in zip(gr, gr2)), **c8,
           "dx_rel_err": rel_err(dx, dx_p), "dx_bit_identical": bool(torch.equal(dx, dx2)),
           "dx_vs_f64": vs_f64({"kernel": [dx8], "plain": [dx8_p]}, f64[:1]),
           "dx_misaligned_g1_refused": misaligned_g1_refused(x, w0, b0, w1, b1, g1),
           "dx_floors": dx_floors(B, P, C, F0, F1),
           "digest": {"k3": digest([y]), "k4": digest(gr), "k5": digest([dx])}}
    emit(row)
    # K3-K5 no farther from the float64 head than twice the plain version: a kernel
    # that dropped piece pairs (K4: three pairs read ~1e-5, six ~4e-7) fails here
    near_f64 = all(d["kernel"] <= 2 * d["plain"]
                   for d in (row["bwd_rel_err_vs_f64"], row["bwd_c8_rel_err_vs_f64"],
                             row["fwd_rel_err_vs_f64"], row["fwd_c8_rel_err_vs_f64"],
                             row["dx_vs_f64"], row["dx_c8_vs_f64"]))
    if (fwd_rel > 1e-5 or not row["fwd_bit_identical"]
            or row["fwd_c8_rel_err"] > 1e-5 or not row["fwd_c8_bit_identical"]
            or row["fwd_rel_err_vs_f64"]["kernel"] > 1e-5
            or row["fwd_c8_rel_err_vs_f64"]["kernel"] > 1e-5
            or bwd_rel > 2e-5 or not row["bwd_bit_identical"]
            or row["bwd_c8_rel_err"] > 2e-5 or not row["bwd_c8_bit_identical"]
            or not near_f64
            or row["dx_rel_err"] > 2e-5 or not row["dx_bit_identical"]
            or row["dx_c8_rel_err"] > 2e-5 or not row["dx_c8_bit_identical"]
            or not row["dx_misaligned_g1_refused"]):
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

    x_req = x_nchw.clone().requires_grad_()
    y_dx = F.elu(F.conv2d(F.elu(F.conv2d(x_req, w0, b0, 2, 1)), w1, b1, 2, 1))

    def cudnn_dx():       # cuDNN's data gradient of the same graph, saved activations
        return torch.autograd.grad(y_dx, x_req, g1_nchw, retain_graph=True)

    in_b, out_b = 4.0 * B * P * P * C, 4.0 * B * (P // 4) ** 2 * F1
    w_b = 4.0 * (w0.numel() + w1.numel() + F0 + F1)
    mac0 = B * (P // 2) ** 2 * F0 * 16 * C        # stage-0 multiply-adds
    mac1 = B * (P // 4) ** 2 * F1 * 16 * F0       # stage-1 multiply-adds
    # K3 and K4 compute float32-accurate products on the tensor cores, each as six bf16
    # piece pairs, which the FP32 units' rate would overstate
    b3 = bound(in_b + out_b + w_b, 6 * 2.0 * (mac0 + mac1), PEAK_BF16_TC_FLOP_S)
    # backward: recompute both stages, dW1 and the stage-0 cotangent (mac1 each), dW0
    b4 = bound(in_b + out_b + 2 * w_b, 6 * 2.0 * (2 * mac0 + 3 * mac1),
               PEAK_BF16_TC_FLOP_S)
    # input backward: recompute both stages, the stage-0 cotangent (mac1), dx (mac0);
    # reads x and g1, writes dx; six bf16 piece pairs per product on the tensor cores
    # (the parity row's dx_floors holds its other floors)
    b5 = bound(2 * in_b + out_b + w_b, 6 * 2.0 * (2 * mac0 + 2 * mac1), PEAK_BF16_TC_FLOP_S)
    k5 = lambda: H.head_input_grad(x, w0, b0, w1, b1, g1)      # noqa: E731
    return [
        dict(name="K3 head_fwd", route="cuda", source="lshm_tpu_torch/csrc/conv_head.cu",
             replaces="lshm_tpu/kernels/conv2d_outer.py:233", counter="head_fwd",
             arch="mma.sync m16n8k16 bf16, operands in 3 pieces, 6 pairs",
             max_abs_err=abs_err(y, y_p),
             ms=time_ms(lambda: H.head_forward(x, w0, b0, w1, b1)),
             plain_ms=time_ms(lambda: H.enc_head_plain(x, w0, b0, w1, b1)),
             bound_ms=b3[0], bound_by=b3[1], library_ms=time_ms(cudnn_fwd)),
        dict(name="K4 head_bwd", route="cuda", source="lshm_tpu_torch/csrc/conv_head.cu",
             replaces="lshm_tpu/kernels/conv2d_outer.py:334", counter="head_bwd",
             arch="mma.sync m16n8k16 bf16, operands in 3 pieces, 6 pairs",
             max_abs_err=max(abs_err(a, b) for a, b in zip(gr, gr_p)),
             ms=time_ms(lambda: H.head_weight_grads(x, w0, b0, w1, b1, g1)),
             plain_ms=time_ms(lambda: H.head_grads_plain(x, w0, b0, w1, b1, g1)),
             bound_ms=b4[0], bound_by=b4[1], library_ms=time_ms(cudnn_bwd)),
        dict(name="K5 head_dx", route="cuda", source="lshm_tpu_torch/csrc/conv_head.cu",
             replaces="lshm_tpu/kernels/conv2d_outer.py:404", counter="head_dx",
             path="head_input_grad",
             arch="mma.sync m16n8k16 bf16, operands in 3 pieces, 6 pairs; two passes",
             max_abs_err=abs_err(dx, dx_p), ms=time_ms(k5), profiler_us=profiler_us(k5),
             plain_ms=time_ms(lambda: H.head_grads_plain(x, w0, b0, w1, b1, g1,
                                                         input_grad=True)),
             bound_ms=b5[0], bound_by=b5[1], library_ms=time_ms(cudnn_dx)),
    ] + head_bf16_rows(x, w0, b0, w1, b1, g1)


def head_bf16_rows(x, w0, b0, w1, b1, g1) -> list[dict]:
    """K3, K4 and K5 on the same inputs rounded to bf16, against their plain
    versions."""
    import torch.nn.functional as F

    from lshm_tpu_torch.kernels import conv_head as H
    from lshm_tpu_torch.tools.measure import (PEAK_BF16_TC_FLOP_S, bound, profiler_us,
                                              time_ms)

    xb, w0b, b0b, w1b, b1b, g1b = (t.to(torch.bfloat16) for t in (x, w0, b0, w1, b1, g1))
    args = (xb, w0b, b0b, w1b, b1b)
    y = H.head_forward(*args)
    y2 = H.head_forward(*args)
    y_p = H.enc_head_plain(*args)
    gr = H.head_weight_grads(*args, g1b)       # the float32 sums, before EncHead's cast
    gr_p = H.head_grads_plain(*args, g1b)
    gr2 = H.head_weight_grads(*args, g1b)
    dx = H.head_input_grad(*args, g1b)
    dx_p = dx_plain(*args, g1b)
    dx2 = H.head_input_grad(*args, g1b)
    c8 = head_c8(x.device, torch.bfloat16)
    f64 = grads_f64((*args, g1b))
    torch.cuda.synchronize()
    row = {"phase": "parity", "kernel": "conv_head_bf16", "x": list(xb.shape),
           **fwd_agreement(y, y_p, y2, head_f64((xb[:8], *args[1:]))),
           "bwd_rel_err": max(rel_err(a, b) for a, b in zip(gr, gr_p)),
           "bwd_rel_err_each": [rel_err(a, b) for a, b in zip(gr, gr_p)],
           "bwd_rel_err_vs_f64": vs_f64({"kernel": gr, "plain": gr_p}, f64[1:]),
           "bwd_bit_identical": all(torch.equal(a, b) for a, b in zip(gr, gr2)),
           **c8, **dx_agreement(dx, dx_p, dx2),
           "dx_vs_f64": vs_f64({"kernel": [dx], "plain": [dx_p]}, f64[:1]),
           "digest": {"k3_bf16": digest([y]), "k4_bf16": digest(gr),
                      "k5_bf16": digest([dx])}}
    emit(row)
    if not (fwd_bf16_ok(row, "fwd") and fwd_bf16_ok(row, "fwd_c8")) or (
            row["bwd_rel_err"] > 1e-4 or not row["bwd_bit_identical"]
            or row["bwd_c8_rel_err"] > 1e-4 or not row["bwd_c8_bit_identical"]
            or not row["dx_within_one_ulp"] or not row["dx_bit_identical"]
            or not row["dx_c8_within_one_ulp"] or not row["dx_c8_bit_identical"]):
        raise AssertionError(f"bf16 conv-head kernels disagree with their plain versions: "
                             f"{row}")

    # yardsticks: cuDNN in bf16 on the channels-last view of the NHWC input
    x_cl = xb.permute(0, 3, 1, 2)

    def cudnn_fwd():
        return F.elu(F.conv2d(F.elu(F.conv2d(x_cl, w0b, b0b, 2, 1)), w1b, b1b, 2, 1))

    ws = [t.clone().requires_grad_() for t in (w0b, b0b, w1b, b1b)]
    y_graph = F.elu(F.conv2d(F.elu(F.conv2d(x_cl, *ws[:2], 2, 1)), *ws[2:], 2, 1))
    g1_cl = g1b.permute(0, 3, 1, 2)

    def cudnn_bwd():      # backward from saved activations, no recompute
        return torch.autograd.grad(y_graph, ws, g1_cl, retain_graph=True)

    x_req = x_cl.clone().requires_grad_()          # channels-last, like x_cl
    y_dx = F.elu(F.conv2d(F.elu(F.conv2d(x_req, w0b, b0b, 2, 1)), w1b, b1b, 2, 1))

    def cudnn_dx():       # cuDNN's bf16 data gradient of the same graph
        return torch.autograd.grad(y_dx, x_req, g1_cl, retain_graph=True)

    B, P, _, C = xb.shape
    F0, F1 = w0.shape[0], w1.shape[0]
    in_b, out_b = 2.0 * B * P * P * C, 2.0 * B * (P // 4) ** 2 * F1
    w_b = 2.0 * (w0.numel() + w1.numel() + F0 + F1)
    mac0 = B * (P // 2) ** 2 * F0 * 16 * C
    mac1 = B * (P // 4) ** 2 * F1 * 16 * F0
    b3 = bound(in_b + out_b + w_b, 2.0 * (mac0 + mac1), PEAK_BF16_TC_FLOP_S)
    b4 = bound(in_b + out_b + 2 * w_b, 2.0 * (2 * mac0 + 3 * mac1), PEAK_BF16_TC_FLOP_S)
    b5 = bound(2 * in_b + out_b + w_b, 2.0 * (2 * mac0 + 2 * mac1), PEAK_BF16_TC_FLOP_S)
    k5 = lambda: H.head_input_grad(*args, g1b)      # noqa: E731
    src, tpu = "lshm_tpu_torch/csrc/conv_head.cu", "lshm_tpu/kernels/conv2d_outer.py"
    return [
        dict(name="K3 head_fwd (bf16)", route="cuda", source=src, replaces=f"{tpu}:233",
             counter="head_fwd_bf16", arch="mma.sync m16n8k16 bf16",
             max_abs_err=abs_err(y.float(), y_p.float()),
             ms=time_ms(lambda: H.head_forward(*args)),
             plain_ms=time_ms(lambda: H.enc_head_plain(*args)),
             bound_ms=b3[0], bound_by=b3[1], library_ms=time_ms(cudnn_fwd)),
        dict(name="K4 head_bwd (bf16)", route="cuda", source=src, replaces=f"{tpu}:334",
             counter="head_bwd_bf16", arch="mma.sync m16n8k16 bf16, 3-piece split",
             max_abs_err=max(abs_err(a, b) for a, b in zip(gr, gr_p)),
             ms=time_ms(lambda: H.head_weight_grads(*args, g1b)),
             plain_ms=time_ms(lambda: H.head_grads_plain(*args, g1b)),
             bound_ms=b4[0], bound_by=b4[1], library_ms=time_ms(cudnn_bwd)),
        dict(name="K5 head_dx (bf16)", route="cuda", source=src, replaces=f"{tpu}:404",
             counter="head_dx_bf16", path="head_input_grad",
             arch="mma.sync m16n8k16 bf16, 3-piece split; two passes",
             max_abs_err=abs_err(dx.float(), dx_p.float()), ms=time_ms(k5),
             profiler_us=profiler_us(k5), plain_ms=time_ms(lambda: dx_plain(*args, g1b)),
             bound_ms=b5[0], bound_by=b5[1], library_ms=time_ms(cudnn_dx)),
    ]


def head_c8(dev, dtype) -> dict:
    """K3, K4 and K5 at C = 8 (B = 16, P = 128; each ky spans two k-steps of the
    tensor-core stage-0 products, and dx fills the whole n-tile) against their plain
    versions, each also against the head in float64, and two calls bit for bit."""
    from lshm_tpu_torch.kernels import conv_head as H

    B, P, C = 16, 128, 8
    g = torch.Generator().manual_seed(3)
    args = [torch.randn(B, P, P, C, generator=g), torch.randn(8, C, 4, 4, generator=g) * 0.2,
            torch.randn(8, generator=g) * 0.1, torch.randn(12, 8, 4, 4, generator=g) * 0.2,
            torch.randn(12, generator=g) * 0.1, torch.randn(B, P // 4, P // 4, 12, generator=g)]
    args = [t.to(dev, dtype) for t in args]
    y, y2 = H.head_forward(*args[:5]), H.head_forward(*args[:5])
    y_p = H.enc_head_plain(*args[:5])
    gr, gr2 = H.head_weight_grads(*args), H.head_weight_grads(*args)
    gr_p = H.head_grads_plain(*args)
    f64 = grads_f64(args)
    row = {**{k.replace("fwd_", "fwd_c8_", 1): v
              for k, v in fwd_agreement(y, y_p, y2, head_f64(args)).items()},
           "bwd_c8_rel_err": max(rel_err(a, b) for a, b in zip(gr, gr_p)),
           "bwd_c8_rel_err_vs_f64": vs_f64({"kernel": gr, "plain": gr_p}, f64[1:]),
           "bwd_c8_bit_identical": all(torch.equal(a, b) for a, b in zip(gr, gr2))}
    dx, dx2, dx_p = H.head_input_grad(*args), H.head_input_grad(*args), dx_plain(*args)
    if dtype == torch.bfloat16:
        row.update({k.replace("dx_", "dx_c8_"): v
                    for k, v in dx_agreement(dx, dx_p, dx2).items()})
    else:
        row.update(dx_c8_rel_err=rel_err(dx, dx_p),
                   dx_c8_bit_identical=bool(torch.equal(dx, dx2)))
    row["dx_c8_vs_f64"] = vs_f64({"kernel": [dx], "plain": [dx_p]}, f64[:1])
    return row


def grads_f64(args) -> tuple:
    """dx, dW0, db0, dW1, db1 of the plain head with its convolutions in float64 (on
    bf16 inputs e0 still rounded to bf16): how far a kernel and its plain version each
    lie from the nearly exact result.  (A bf16 kernel that sums a0 in another order can
    round an e0 near a bf16 tie the other way.)"""
    from lshm_tpu_torch.kernels import conv_head as H

    with torch.enable_grad():
        ins = [t.detach().double().requires_grad_() for t in args[:5]]
        y = H._head_f32(*ins, round_e0=args[0].dtype == torch.bfloat16)
        return torch.autograd.grad(y, ins, args[5].double())


def head_f64(args) -> torch.Tensor:
    """The plain head with its convolutions in float64 (on bf16 inputs e0 still rounded
    to bf16 between the stages), on the samples of args[0]."""
    from lshm_tpu_torch.kernels import conv_head as H

    ins = [t.double() for t in args[:5]]
    return H._head_f32(*ins, round_e0=args[0].dtype == torch.bfloat16)


def fwd_agreement(y, y_p, y2, y64) -> dict:
    """K3's output y against its plain version's y_p: the relative error, the share of
    elements that differ at all, the largest difference against one bf16 ulp of the
    plain version's largest value; each one's distance from the float64 head y64 on its
    first samples; and whether a second call y2 agrees bit for bit."""
    from lshm_tpu_torch.tools.measure import bf16_ulp

    yf, ypf, n = y.float(), y_p.float(), y64.shape[0]
    err, top = abs_err(yf, ypf), float(ypf.abs().max())
    return {"fwd_rel_err": rel_err(yf, ypf),
            "fwd_differing_share": float((y != y_p).float().mean()),
            "fwd_within_one_ulp": err <= bf16_ulp(top),
            "fwd_rel_err_vs_f64": vs_f64({"kernel": [y[:n]], "plain": [y_p[:n]]}, [y64]),
            "fwd_bit_identical": bool(torch.equal(y, y2))}


def fwd_bf16_ok(row: dict, pre: str) -> bool:
    """K3 bf16's gates, on the keys of fwd_agreement under the prefix ``pre``.  The
    tensor cores sum a0 in another order than the plain version, so an e0 near a bf16
    tie may round the other way and move an output by one ulp: at most 5e-4 of the
    outputs may differ (tests/test_torch_head_fwd_tc.py emulates 0 to 3.7e-4), each
    within one bf16 ulp of the largest value, and the kernel lies no farther from the
    float64 head than twice the plain version.  A kernel that drops or moves the
    rounding of e0 makes about a third of the outputs differ."""
    d = row[f"{pre}_rel_err_vs_f64"]
    return (row[f"{pre}_rel_err"] <= 4e-3 and row[f"{pre}_within_one_ulp"]
            and row[f"{pre}_differing_share"] <= 5e-4 and d["kernel"] <= 2 * d["plain"]
            and row[f"{pre}_bit_identical"])


def vs_f64(forms: dict, want) -> dict:
    """Each form's largest relative distance, over its tensors, from ``want``."""
    return {k: max(rel_err(a.double(), b) for a, b in zip(got, want))
            for k, got in forms.items()}


def dx_plain(x, w0, b0, w1, b1, g1) -> torch.Tensor:
    """K5's plain version: the float32 autograd gradient, rounded once to x's dtype
    (what ``head_input_grad`` returns for a CPU tensor)."""
    from lshm_tpu_torch.kernels import conv_head as H

    return H.head_grads_plain(x, w0, b0, w1, b1, g1, input_grad=True)[0].to(x.dtype)


def dx_floors(B: int, P: int, C: int, F0: int, F1: int) -> dict:
    """K5's floors beside its rows' bound_ms, from the shapes alone: float32 K5's bound
    with its products on the FP32 units, and what the two passes move in each dtype (x
    twice, g1, the float32 dpre1 written and read, dx) with that traffic's time at the
    memory rate."""
    from lshm_tpu_torch.tools.measure import bound

    n_x, n_g = B * P * P * C, B * (P // 4) ** 2 * F1
    n_w = F0 * C * 16 + F1 * F0 * 16 + F0 + F1
    mac0, mac1 = B * (P // 2) ** 2 * F0 * 16 * C, n_g * 16 * F0
    out = {"float32_fp32_units_ms": bound(4.0 * (2 * n_x + n_g + n_w),
                                          2.0 * (2 * mac0 + 2 * mac1))[0]}
    for name, size in (("float32", 4.0), ("bf16", 2.0)):
        moved = size * (3 * n_x + n_g) + 2 * 4.0 * n_g
        out[f"{name}_two_passes_mb"] = moved / 1e6
        out[f"{name}_two_passes_ms"] = bound(moved, 0.0)[0]
    return out


def misaligned_g1_refused(x, w0, b0, w1, b1, g1) -> bool:
    """Whether K5's wrapper refuses a float32 g1 one element off the 8-byte alignment
    of its channel pairs (the kernel loads them as float2) with a ValueError."""
    from lshm_tpu_torch.kernels import conv_head as H

    off = torch.empty(g1.numel() + 1, dtype=g1.dtype, device=g1.device)[1:].view(g1.shape)
    try:
        H.head_input_grad(x, w0, b0, w1, b1, off)
    except ValueError:
        return True
    return False


def dx_agreement(dx, dx_p, dx2) -> dict:
    """bf16 dx of the kernel against its plain version: the largest difference,
    against one bf16 ulp of the plain version's largest value, the share of elements
    that differ, and whether two kernel calls agree bit for bit."""
    from lshm_tpu_torch.tools.measure import bf16_ulp

    err, top = abs_err(dx.float(), dx_p.float()), float(dx_p.float().abs().max())
    return {"dx_max_abs_err": err, "dx_one_ulp_of_max": bf16_ulp(top),
            "dx_within_one_ulp": err <= bf16_ulp(top),
            "dx_differing_share": float((dx != dx_p).float().mean()),
            "dx_bit_identical": bool(torch.equal(dx, dx2))}


# ------------------------------------------------------------------- phase 4

HOST_GATE = (2e-4, 2e-5)       # JAX's device decode against the numpy host path


def within_host_gate(got: torch.Tensor, want) -> tuple[bool, float]:
    """Whether ``got`` (on the card) lies within JAX's gate of the numpy ``want``, and
    the largest absolute difference."""
    w = torch.as_tensor(want).to(got.device)
    d = (got - w).abs()
    rtol, atol = HOST_GATE
    return bool((d <= atol + rtol * w.abs()).all()), float(d.max())


def device_decode_phase(dev, tree) -> dict:
    """The decode on the card at full width on the training extract, against the numpy
    host path: ``device_decode_train`` on one ``sample_raw`` against ``sample()`` of a twin
    sampler (420 patches, 840 with augment) within JAX's gates, bit for bit with the
    normalisation off, the same rng state after each; ``device_decode_patchify`` on a
    chunk of 8 baselines against ``read_baselines_patches_batch``; two calls bit for bit;
    the prefetcher's minibatches bit for bit the same decode run on the default stream,
    with the consumer's stream held busy before it reads each (a decoded block released
    to the side stream too early would be overwritten by the next decode).  Then the
    host ms of ``sample()`` and of ``sample_raw()``, the device ms of the decode (CUDA
    events) and the bytes each pipeline copies to the card a minibatch."""
    import dataclasses

    import numpy as np

    from lshm_tpu_torch.config import preset
    from lshm_tpu_torch.data import (DeviceDecodePrefetcher, MinibatchSampler,
                                     device_decode_patchify, device_decode_train,
                                     read_baselines_patches_batch,
                                     read_baselines_raw_batch)
    from lshm_tpu_torch.tools.measure import queued_us, time_ms

    base = preset("full_khm").data

    def staged(raw):
        return [torch.from_numpy(a).to(dev) for a in (raw.vis, raw.scales, raw.flip_flags)]

    def decode(tensors, cfg):
        return device_decode_train(*tensors, num_channels=cfg.num_channels,
                                   patch_size=cfg.patch_size, clamp=cfg.clamp,
                                   normalize=cfg.normalize, augment=cfg.augment)

    row = {"phase": "device_decode", "baselines_per_minibatch": base.batch_size}
    ok = True
    for augment in (False, True):
        for normalize in (True, False):
            cfg = dataclasses.replace(base, augment=augment, normalize=normalize)
            s_host = MinibatchSampler([tree], ["0"], cfg, seed=0)
            s_raw = MinibatchSampler([tree], ["0"], cfg, seed=0)
            mb, raw = s_host.sample(), s_raw.sample_raw()
            t = staged(raw)
            x, x2 = decode(t, cfg), decode(t, cfg)
            ppb = raw.patchx * raw.patchy * (2 if augment else 1)
            case = {"patches": int(x.shape[0]),
                    "same_rng_state": s_host.rng.bit_generator.state
                    == s_raw.rng.bit_generator.state,
                    "uv_equal": bool(np.array_equal(np.repeat(raw.uv, ppb, axis=0), mb.uv)),
                    "repeat_bit_identical": bool(torch.equal(x, x2))}
            if normalize:
                case["within_gate"], case["max_abs_err"] = within_host_gate(x, mb.x)
            else:
                case["within_gate"] = case["bit_identical"] = bool(
                    torch.equal(x.cpu(), torch.from_numpy(mb.x)))
            ok &= all(v for k, v in case.items() if isinstance(v, bool))
            ok &= case["patches"] == (840 if augment else 420)
            row[f"train_augment_{augment}_normalize_{normalize}"] = case

    chunk = list(range(8))
    vis, scales, _ = read_baselines_raw_batch(tree, "0", chunk, uvdist=True)
    _, _, want, _ = read_baselines_patches_batch(tree, "0", chunk, uvdist=True)
    v, sc = torch.from_numpy(vis).to(dev), torch.from_numpy(scales).to(dev)
    x, x2 = device_decode_patchify(v, sc), device_decode_patchify(v, sc)
    within, err = within_host_gate(x, want)
    row["eval_chunk"] = {"patches": int(x.shape[0]), "within_gate": within,
                         "max_abs_err": err, "repeat_bit_identical": bool(torch.equal(x, x2))}
    ok &= within and row["eval_chunk"]["repeat_bit_identical"]

    cfg = dataclasses.replace(base, augment=True)
    s_pre = MinibatchSampler([tree], ["0"], cfg, seed=5)
    s_sync = MinibatchSampler([tree], ["0"], cfg, seed=5)
    got = []
    with DeviceDecodePrefetcher(s_pre, size=2, device=dev) as pre:
        for _ in range(4):
            mb = next(pre)
            torch.cuda._sleep(50_000_000)          # ~30 ms of the consumer's stream
            got.append((mb.x.clone(), mb.uv.clone()))
            del mb
    want = []
    for _ in range(4):
        raw = s_sync.sample_raw()
        uv = np.repeat(raw.uv, 2 * raw.patchx * raw.patchy, axis=0)
        want.append((decode(staged(raw), cfg), uv))
    row["prefetcher_bit_identical"] = all(
        torch.equal(g, w) and np.array_equal(gu.cpu().numpy(), wu)
        for (g, gu), (w, wu) in zip(got, want))
    ok &= row["prefetcher_bit_identical"]

    timing = {}
    for augment in (False, True):
        cfg = dataclasses.replace(base, augment=augment)
        s = MinibatchSampler([tree], ["0"], cfg, seed=1)
        sample_ms, raw_ms = host_ms(s.sample), host_ms(s.sample_raw)
        mb, raw = s.sample(), s.sample_raw()
        t = staged(raw)
        host_bytes = mb.x.nbytes + mb.uv.nbytes
        ppb = raw.patchx * raw.patchy * (2 if augment else 1)
        raw_bytes = (raw.vis.nbytes + raw.scales.nbytes + raw.flip_flags.nbytes
                     + np.repeat(raw.uv, ppb, axis=0).nbytes)
        timing[f"augment_{augment}"] = {
            "host_ms_sample": sample_ms, "host_ms_sample_raw": raw_ms,
            "device_ms_decode": time_ms(lambda: decode(t, cfg)),
            "device_ms_decode_queued": queued_us(lambda: decode(t, cfg), calls=20) / 1e3,
            "host_decode_copy_mb": host_bytes / 1e6,
            "device_decode_copy_mb": raw_bytes / 1e6,
            "int8_mb": raw.vis.nbytes / 1e6, "scales_kb": raw.scales.nbytes / 1e3,
            "copy_ratio": host_bytes / raw_bytes}
    row["timing"] = timing
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"the decode on the card disagrees: {row}")
    return row


# ---------------------------------------------------------------- phases 5 to 8

def flagship_config(tmpdir: str, name: str = "full_khm", compute_dtype: str | None = None,
                    device_decode: bool | None = None):
    """Preset ``name`` at full width through the kernels, 3 minibatches x 10 ADMM
    iterations (``compute_dtype`` replaces the preset's where it is given), decoding on
    the card unless ``device_decode=False``."""
    import dataclasses

    from lshm_tpu_torch.config import preset

    cfg = preset(name)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, device_decode=device_decode),
        model=dataclasses.replace(cfg.model, khm_backend="pallas", pallas_head=True,
                                  compute_dtype=compute_dtype or cfg.model.compute_dtype),
        train=dataclasses.replace(cfg.train, admm_iters=10, iters_per_epoch=3,
                                  num_epochs=1, checkpoint_dir=tmpdir),
    )


def trainer_phase(tree, tmpdir: str, name: str = "full_khm", path=ADAM_PATH,
                  phase: str = "trainer", device_decode: bool | None = None):
    """The Trainer on preset ``name`` (``flagship_config``); returns the launch counts
    and the logger's history."""
    import math

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.utils import MetricLogger

    cfg = flagship_config(tmpdir, name, device_decode=device_decode)
    sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
    logger = MetricLogger(echo=False)
    trainer = Trainer(cfg, logger=logger)           # device=None: the card
    sources = []                                    # the prefetcher Trainer.run picked
    pick = trainer._source
    trainer._source = lambda s: sources.append(pick(s)) or sources[-1]
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
    row = {"phase": phase, "preset": name, "compute_dtype": cfg.model.compute_dtype,
           "decode": "host" if device_decode is False else "device",
           "host_decoder": "native" if sampler.use_native else "numpy",
           "prefetcher": type(sources[0]).__name__, "patches": patches,
           "admm_iters": nadmm, "minibatches": len(hist), "losses": losses,
           "ms_per_admm_iter": steady_s / nadmm * 1e3,
           "patches_per_s": patches * nadmm / steady_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "wall_s": wall, "launches": counts,
           "checkpoint": sorted(os.listdir(tmpdir))}
    emit(row)
    if len(hist) != 3 or patches != 420:
        raise AssertionError(f"expected 3 minibatches of 420 patches: {row}")
    want = "PrefetchIterator" if device_decode is False else "DeviceDecodePrefetcher"
    if row["prefetcher"] != want:
        raise AssertionError(f"the trainer decoded through {row['prefetcher']}, not {want}")
    if device_decode is False and row["host_decoder"] != "native":
        raise AssertionError("the host decode did not take the native decoder")
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite losses: {losses}")
    missing = [k for k in path if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return counts, hist


def trainer_decodes_phase(tree, tmpdir: str) -> dict:
    """The float32 trainer run twice, decoding on the card (the default) and on the host
    (data.device_decode=False): K1-K4 launch 30, 30, 60 and 30 times in each, and the
    first minibatch's per-term losses agree within JAX's 5e-3 relative gate between the
    two pipelines (tests/test_device_decode.py:176).  Returns the device decode's
    counts."""
    runs = {}
    for decode, dd, phase in (("device", None, "trainer"),
                              ("host", False, "trainer_host_decode")):
        counts, hist = trainer_phase(tree, tmpdir, phase=phase, device_decode=dd)
        expect_launches(counts, {"khm_fwd": 30, "khm_bwd": 30, "head_fwd": 60,
                                 "head_bwd": 30}, f"{decode}-decode trainer")
        runs[decode] = (counts, hist[0])
    dev, host = runs["device"][1], runs["host"][1]
    gap = {k: abs(dev[k] - host[k]) / abs(host[k]) for k in host
           if k not in ("epoch", "iter", "t", "patches") and host[k] != 0.0}
    emit({"phase": "trainer_decodes", "first_minibatch_rel_gap": gap,
          "gate": 5e-3, "device_decode": dev, "host_decode": host})
    if max(gap.values()) > 5e-3:
        raise AssertionError(f"the two decodes' first minibatch disagree: {gap}")
    return runs["device"][0]


def expect_launches(counts: dict, expected: dict, what: str) -> None:
    if any(counts[k] != v for k, v in expected.items()):
        raise AssertionError(f"{what} launches {counts}, expected {expected}")


def trainer_bf16_phase(tree, tmpdir: str) -> dict:
    """The Adam trainer run of preset full_khm_bf16, then ``bf16_first_iteration``."""
    counts, _ = trainer_phase(tree, tmpdir, "full_khm_bf16", BF16_PATH, "trainer_bf16")
    expect_launches(counts, {"khm_fwd": 30, "khm_bwd": 30, "head_fwd_bf16": 60,
                             "head_bwd_bf16": 30, "head_fwd": 0, "head_bwd": 0},
                    "bf16 trainer")
    bf16_first_iteration(tree, tmpdir, "full_khm", "trainer_bf16_first_iteration")
    return counts


def bf16_first_iteration(tree, tmpdir: str, name: str, phase: str) -> None:
    """The first ADMM iteration of the trainer's first minibatch of preset ``name``
    from the same initial parameters in float32 and in bfloat16_full (both through the
    kernels): per-term losses within JAX's bf16 gate."""
    import dataclasses

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.train import LossWeights, init_train_state, make_train_step

    dev = torch.device("cuda")
    first = {}
    for dtype in ("float32", "bfloat16_full"):
        cfg = flagship_config(tmpdir, name, dtype)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, admm_iters=1))
        sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
        sampler.reseed(0)                          # as Trainer.run's first epoch
        mb = sampler.sample()
        x, uv = torch.from_numpy(mb.x).to(dev), torch.from_numpy(mb.uv).to(dev)
        w = LossWeights(alpha=cfg.loss.alpha, beta=cfg.loss.beta, gamma=cfg.loss.gamma,
                        rho=cfg.loss.rho, rica_lambda=cfg.loss.rica_lambda)
        _, m = make_train_step(cfg, mb.num_baselines)(init_train_state(cfg, dev), x, uv, w)
        first[dtype] = {k: float(v[0]) for k, v in m.items()}
    f32, bf16 = first["float32"], first["bfloat16_full"]
    gap = {k: abs(f32[k] - bf16[k]) / (0.05 * abs(f32[k]) + 5e-3) for k in f32}
    emit({"phase": phase, "preset": name, "float32": f32, "bfloat16_full": bf16,
          "gap_over_gate": gap, "rel_gap": {k: abs(f32[k] - bf16[k]) / abs(f32[k])
                                            for k in f32 if f32[k] != 0.0}})
    if max(gap.values()) > 1.0:
        raise AssertionError(f"bf16 first-iteration losses outside JAX's gate: {gap}")


def trainer_fourier_phase(tree, tmpdir: str) -> dict:
    """The Adam trainer run of preset fourier_cascade (the legacy Fourier pipeline) at
    full width: K1-K4 launch 30, 30, 60 and 30 times, and K5 never (the head's input is
    data; the Fourier AE has no fused head); the transform runs 60 times forward and 30
    backward (``dft_calls``), each one launch of the DFT kernels.  Then one minibatch
    through the kernels and through the plain path, and the first ADMM iteration in
    bfloat16_full against float32."""
    counts, _ = trainer_phase(tree, tmpdir, "fourier_cascade", ADAM_PATH,
                              "trainer_fourier")
    expect_launches(counts, {"khm_fwd": 30, "khm_bwd": 30, "head_fwd": 60, "head_bwd": 30,
                             "head_dx": 0, "head_dx_bf16": 0, "dft_fwd": 60, "dft_bwd": 30,
                             "dft2_fwd": 60, "dft2_adj": 30}, "Fourier trainer")
    agree_phase(tree, tmpdir, "fourier_cascade", "agree_fourier")
    bf16_first_iteration(tree, tmpdir, "fourier_cascade", "trainer_fourier_first_iteration")
    return counts


def dft_f64(x: torch.Tensor) -> torch.Tensor:
    """fft2_shifted's function in float64 through torch.fft: real | imag channels."""
    z = torch.fft.fftshift(torch.fft.fft2(x.double(), dim=(1, 2), norm="ortho"), dim=(1, 2))
    return torch.cat([z.real, z.imag], dim=-1)


def dft_adjoint_f64(g: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``dft_f64`` in float64: Re(F^H ifftshift(g_re + i g_im))."""
    c = g.shape[-1] // 2
    z = torch.fft.ifftshift(torch.complex(g[..., :c].double(), g[..., c:].double()),
                            dim=(1, 2))
    return torch.fft.ifft2(z, dim=(1, 2), norm="ortho").real


def dft_phase(dev) -> list[dict]:
    """The Fourier cascade's DFT kernels (kernels/dft.py, csrc/dft.cu) at the main
    path's [420, 128, 128, 4] and at C = 8: the forward and the adjoint against torch.fft
    in float64, against the dense path (fft2_dense, its backward by autograd) and
    against the plain version, each no farther from float64 than the dense path and
    within 1e-5 of the plain version; two calls bit for bit; a CUDA graph's replay bit
    for bit the eager results; ms (CUDA events) and the profiler's us a launch of each
    kernel beside the dense path's forward and backward and the plain version.  Returns
    the kernels table's rows (C = 4)."""
    from lshm_tpu_torch.kernels import dft
    from lshm_tpu_torch.models.cascade import fft2_dense
    from lshm_tpu_torch.tools.measure import bound, profiler_us, time_ms

    rows = []
    for c in (4, 8):
        g = torch.Generator().manual_seed(c)
        x = torch.randn(PATCHES, 128, 128, c, generator=g).to(dev)
        gy = torch.randn(PATCHES, 128, 128, 2 * c, generator=g).to(dev)
        y, dx = dft.dft2_forward(x), dft.dft2_adjoint(gy)
        y2, dx2 = dft.dft2_forward(x), dft.dft2_adjoint(gy)
        y_p, dx_p = dft.dft2_forward_plain(x), dft.dft2_adjoint_plain(gy)
        xr = x.clone().requires_grad_()
        yd = fft2_dense(xr)
        dxd = torch.autograd.grad(yd, xr, gy, retain_graph=True)[0]
        y64, dx64 = dft_f64(x), dft_adjoint_f64(gy)

        side = torch.cuda.Stream()              # warm-up off the capturing stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dft.dft2_forward(x), dft.dft2_adjoint(gy)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg, dxg = dft.dft2_forward(x), dft.dft2_adjoint(gy)
        graph.replay()
        torch.cuda.synchronize()
        row = {"phase": "dft", "shape": list(x.shape),
               "fwd_vs_f64": {"kernel": rel_err(y.double(), y64),
                              "dense": rel_err(yd.detach().double(), y64),
                              "plain": rel_err(y_p.double(), y64)},
               "adj_vs_f64": {"kernel": rel_err(dx.double(), dx64),
                              "dense": rel_err(dxd.double(), dx64),
                              "plain": rel_err(dx_p.double(), dx64)},
               "fwd_vs_dense": rel_err(y, yd.detach()), "adj_vs_dense": rel_err(dx, dxd),
               "fwd_vs_plain": rel_err(y, y_p), "adj_vs_plain": rel_err(dx, dx_p),
               "bit_identical": bool(torch.equal(y, y2) and torch.equal(dx, dx2)),
               "graph_bit_identical": bool(torch.equal(yg, y) and torch.equal(dxg, dx))}
        emit(row)
        near = all(d["kernel"] <= d["dense"] for d in (row["fwd_vs_f64"], row["adj_vs_f64"]))
        if (not near or row["fwd_vs_plain"] > 1e-5 or row["adj_vs_plain"] > 1e-5
                or not row["bit_identical"] or not row["graph_bit_identical"]):
            raise AssertionError(f"the DFT kernels disagree: {row}")
        del yg, dxg, graph

        fwd = lambda: dft.dft2_forward(x)                                 # noqa: E731
        adj = lambda: dft.dft2_adjoint(gy)                                # noqa: E731
        dense_bwd = lambda: torch.autograd.grad(yd, xr, gy, retain_graph=True)  # noqa: E731
        prof = {**profiler_us(fwd), **profiler_us(adj)}
        dense = {"fwd_ms": time_ms(lambda: fft2_dense(x)), "bwd_ms": time_ms(dense_bwd),
                 "fwd_profiler_us": profiler_us(lambda: fft2_dense(x)),
                 "bwd_profiler_us": profiler_us(dense_bwd)}
        # x in and real | imag out once; 5 M log2 M for each complex plane of M points
        least = bound(4.0 * 3 * x.numel(), 5.0 * x.numel() / 2 * 14)
        timing = {"phase": "dft_timing", "C": c, "fwd_ms": time_ms(fwd),
                  "adj_ms": time_ms(adj), "profiler_us": prof, "dense": dense,
                  "bound_ms": least[0], "bound_by": least[1]}
        emit(timing)
        if c != 4:
            continue
        for op, counter, plain in (
                ("forward", "dft2_fwd", lambda: dft.dft2_forward_plain(x)),
                ("adjoint", "dft2_adj", lambda: dft.dft2_adjoint_plain(gy))):
            rows.append(dict(
                name=f"DFT {counter}", route="cuda", source="lshm_tpu_torch/csrc/dft.cu",
                replaces="none (lshm_tpu/models/cascade.py:66-90, dense einsum)",
                counter=counter, path="trainer_fourier",
                arch="a complex plane of two channels a CTA in shared memory, "
                     "radix-16 x 8 FFTs in registers",
                max_abs_err=abs_err(*((y, y_p) if op == "forward" else (dx, dx_p))),
                ms=timing["fwd_ms" if op == "forward" else "adj_ms"],
                profiler_us=next(us for k, us in prof.items() if k.startswith(counter)),
                plain_ms=time_ms(plain),
                bound_ms=least[0], bound_by=least[1],
                library_ms=dense["fwd_ms" if op == "forward" else "bwd_ms"]))
        del xr, yd
    torch.cuda.empty_cache()
    return rows


def dft_profile_phase(tree, tmpdir: str) -> dict:
    """One float32 fourier_cascade minibatch (10 ADMM iterations, eager: a train state's
    first) under torch.profiler: every device operation launched inside a
    ``cascade.dft`` span or an autograd ``DFT2Backward`` node is one of the DFT's
    kernels (its name holds ``dft``), and the kernels' launches equal ``dft_calls``:
    20 forwards and 10 backwards."""
    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import LossWeights, init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg = flagship_config(tmpdir, "fourier_cascade")
    mb = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed).sample()
    x, uv = torch.from_numpy(mb.x).to(dev), torch.from_numpy(mb.uv).to(dev)
    state = init_train_state(cfg, dev)
    step = make_train_step(cfg, mb.num_baselines)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        step(state, x, uv, LossWeights())
        torch.cuda.synchronize()
    counts = launch_counts()
    events = prof.events()
    owners = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
              and (e.name == "cascade.dft" or e.name.endswith("DFT2Backward"))]
    kernels = {e.id: e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA}
    under: dict[str, dict[str, int]] = {}
    for r in events:                      # the runtime calls that launched device work
        if (r.device_type != torch.autograd.DeviceType.CPU or not r.name.startswith("cu")
                or r.id not in kernels):
            continue
        for o in owners:                  # a backward node is two nested events
            if o.time_range.start <= r.time_range.start <= o.time_range.end:
                key = "cascade.dft" if o.name == "cascade.dft" else "DFT2Backward"
                names = under.setdefault(key, {})
                names[kernels[r.id]] = names.get(kernels[r.id], 0) + 1
                break
    named = {k: sum(n for name, n in v.items() if "dft" in name.lower())
             for k, v in under.items()}
    row = {"phase": "dft_profile", "owners": len(owners), "kernels_under": under,
           "dft_calls": {k: counts[k] for k in ("dft_fwd", "dft_bwd")},
           "dft_launches": {k: counts[k] for k in ("dft2_fwd", "dft2_adj")}}
    emit(row)
    if (set(under) != {"cascade.dft", "DFT2Backward"}
            or any(named[k] != sum(v.values()) for k, v in under.items())
            or named["cascade.dft"] != counts["dft2_fwd"]
            or named["DFT2Backward"] != counts["dft2_adj"]):
        raise AssertionError(f"device work under the DFT is not the DFT's kernels: {row}")
    expect_launches(counts, {"dft_fwd": 20, "dft_bwd": 10, "dft2_fwd": 20, "dft2_adj": 10},
                    "profiled Fourier minibatch")
    return row


def agree_phase(tree, tmpdir: str, name: str = "full_khm", phase: str = "agree") -> None:
    """One minibatch of preset ``name`` (2 ADMM iterations) through the kernels and
    through the plain path from the same state, and the cascade forward on the card
    against the CPU on two patches."""
    import dataclasses

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.models import CascadedAE
    from lshm_tpu_torch.train import LossWeights, init_train_state, make_train_step

    dev = torch.device("cuda")
    cfg_k = flagship_config(tmpdir, name)
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
    keys = ("xrecon", "Mu") + (("yf_in", "yf_out") if out_cpu.yf_in is not None else ())
    fwd = {k: rel_err(getattr(out_gpu, k).cpu(), getattr(out_cpu, k).detach())
           for k in keys}
    emit({"phase": phase, "metric_rel_err": worst, "cascade_gpu_vs_cpu_rel_err": fwd,
          "kernels_metrics_last": {k: float(v[-1]) for k, v in metrics["kernels"].items()}})
    if max(worst.values()) > 1e-4 or max(fwd.values()) > 1e-4:
        raise AssertionError("kernel path and plain path disagree")


# -------------------------------------------------------------------- phases 9, 10

def head_input_grad_phase(dev) -> dict:
    """enc_head with a CUDA x that needs its gradient, backward through EncHead, in
    float32 and in bfloat16 (the same inputs rounded): K3, K4 and K5 of each dtype
    launch.  float32: dx and the weight gradients against autograd through the plain
    version (2e-5).  bf16: dx within one bf16 ulp of the plain version's largest value
    (the share of elements that differ printed) and bit-identical over two backwards;
    the weight gradients' float32 sums (head_weight_grads, before EncHead's cast) 1e-4."""
    from lshm_tpu_torch.kernels import conv_head as H
    from lshm_tpu_torch.kernels import launch_counts, reset_launches

    B, P, C = 420, 128, 4
    g = torch.Generator().manual_seed(4)
    x = torch.randn(B, P, P, C, generator=g).to(dev)
    ws = [(torch.randn(8, C, 4, 4, generator=g) * 0.2).to(dev),
          (torch.randn(8, generator=g) * 0.1).to(dev),
          (torch.randn(12, 8, 4, 4, generator=g) * 0.2).to(dev),
          (torch.randn(12, generator=g) * 0.1).to(dev)]
    g1 = torch.randn(B, P // 4, P // 4, 12, generator=g).to(dev)
    xb, wb, g1b = x.to(torch.bfloat16), [w.to(torch.bfloat16) for w in ws], g1.to(torch.bfloat16)

    def backward(x, ws, g1):
        xr, wr = x.clone().requires_grad_(), [w.clone().requires_grad_() for w in ws]
        return torch.autograd.grad(H.enc_head(xr, *wr), [xr, *wr], g1)

    reset_launches()
    dx, *dws = backward(x, ws, g1)
    dxb, *_ = backward(xb, wb, g1b)
    dxb2, *_ = backward(xb, wb, g1b)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = H.head_grads_plain(x, *ws, g1, input_grad=True)
    sums, sums_p = H.head_weight_grads(xb, *wb, g1b), H.head_grads_plain(xb, *wb, g1b)
    row = {"phase": "head_input_grad",
           "launches": {k: counts[k] for k in HEAD_PATH + HEAD_BF16_PATH},
           "dx_rel_err": rel_err(dx, want[0]),
           "dw_rel_err": max(rel_err(a, b) for a, b in zip(dws, want[1:])),
           "bf16": {**dx_agreement(dxb, dx_plain(xb, *wb, g1b), dxb2),
                    "dw_sums_rel_err": max(rel_err(a, b) for a, b in zip(sums, sums_p))}}
    emit(row)
    if any(v == 0 for v in row["launches"].values()):
        raise AssertionError(f"EncHead's backward did not launch K3/K4/K5: {row}")
    if row["dx_rel_err"] > 2e-5 or row["dw_rel_err"] > 2e-5:
        raise AssertionError(f"EncHead's gradients disagree with autograd: {row}")
    bf = row["bf16"]
    if (not bf["dx_within_one_ulp"] or not bf["dx_bit_identical"]
            or bf["dw_sums_rel_err"] > 1e-4):
        raise AssertionError(f"EncHead's bf16 gradients disagree with the plain version: "
                             f"{row}")
    return counts


# K6's gates: tests/test_torch_conv0_tc.py measured 0 to 6.1e-5 of bf16 outputs one ulp
# off the plain version (131,072 outputs, eight seeds, each C) and set the share gate
K6_SHARE_GATE = 1e-4
K6_CASES = ((PATCHES, 128, 4), (16, 128, 8), (64, 36, 8), (64, 36, 4))   # B, P, C


def conv0_agreement(dev, dtype: torch.dtype) -> dict:
    """K6 of ``dtype`` against its plain version at the probe's shapes (B = 420, P =
    128, C = 4; seed 2, the probe's parity inputs) and at C = 8, at P = 36 (a ragged
    edge of the 8- and 4-row tiles) and both: the relative error, the largest
    difference in bf16 ulps of the plain version's largest value, the share of outputs
    that differ, each form's relative distance from the convolution in float64 (on
    the first 8 samples), and whether two calls agree bit for bit; with a SHA-256
    digest of the outputs at B = 420."""
    import torch.nn.functional as F

    from lshm_tpu_torch.kernels import conv0 as k6
    from lshm_tpu_torch.tools.measure import bf16_ulp

    out = {}
    for B, P, C in K6_CASES:
        g = torch.Generator().manual_seed(2)
        x, w, b = (t.to(dev, dtype) for t in (
            torch.randn(B, P, P, C, generator=g), torch.randn(8, C, 4, 4, generator=g) * 0.1,
            torch.randn(8, generator=g) * 0.1))
        y, y2, y_p = k6.conv0_elu(x, w, b), k6.conv0_elu(x, w, b), k6.conv0_elu_plain(x, w, b)
        y64 = F.elu(F.conv2d(x[:8].double().permute(0, 3, 1, 2), w.double(), b.double(),
                             stride=2, padding=1)).permute(0, 2, 3, 1)
        err, top = abs_err(y.float(), y_p.float()), float(y_p.float().abs().max())
        out[f"B{B}_P{P}_C{C}"] = {
            "rel_err": err / top, "ulps_of_max": err / bf16_ulp(top),
            "differing_share": float((y != y_p).float().mean()),
            "vs_f64": vs_f64({"kernel": [y[:8]], "plain": [y_p[:8]]}, [y64]),
            "bit_identical": bool(torch.equal(y, y2)),
            **({"digest": digest([y])} if B == PATCHES else {})}
    return out


def conv0_ok(cases: dict, dtype: torch.dtype) -> bool:
    """K6's gates in every case: float32 within 1e-5 of the plain version and no
    farther from float64 than twice the plain version (three piece pairs instead of six
    read 5e-6 from it on the CPU, twice the plain version 7e-7); bf16 within one ulp of
    the largest value, at most K6_SHARE_GATE of the outputs differing, no farther from
    float64 than twice the plain version; both bit-identical over two calls."""
    for c in cases.values():
        near = c["vs_f64"]["kernel"] <= 2 * c["vs_f64"]["plain"]
        close = (c["rel_err"] <= 1e-5 if dtype == torch.float32 else
                 c["ulps_of_max"] <= 1 and c["differing_share"] <= K6_SHARE_GATE)
        if not (near and close and c["bit_identical"]):
            return False
    return True


def conv0_probe_phase(dev) -> tuple[dict, list[dict]]:
    """The port's probe tool at batch 420 at its default dtype (bfloat16), then in
    float32 (each: its own parity check, then the timings of kernel, plain version and
    cuDNN); then K6 of each dtype against its plain version (conv0_agreement) and the
    profiler's device time per launch at 420."""
    from lshm_tpu_torch.kernels import conv0 as k6
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.tools import conv0_probe
    from lshm_tpu_torch.tools.measure import profiler_us

    reset_launches()
    results = {"bfloat16": conv0_probe.main(["--batch", str(PATCHES)]),
               "float32": conv0_probe.run(dev, batch=PATCHES, dtype="float32")}
    counts = launch_counts()
    rows = []
    for dtype, counter in (("bfloat16", "conv0_bf16"), ("float32", "conv0")):
        result = results[dtype]
        tdtype = conv0_probe.DTYPES[dtype]
        full = conv0_probe.parity(dev, batch=PATCHES, seed=2, dtype=dtype)
        cases = conv0_agreement(dev, tdtype)
        x, w, b = conv0_probe.inputs(dev, PATCHES, 0, dtype)     # the timing's inputs
        prof = profiler_us(lambda: k6.conv0_elu(x, w, b))
        emit({"phase": "conv0_probe", "launches": counts[counter], **result,
              "parity_at_batch": full, "agreement": cases, "profiler_us": prof})
        if counts[counter] == 0:
            raise AssertionError(f"the probe did not launch K6 in {dtype}")
        if full["parity_max_abs_err"] > full["parity_tol_abs"] or not conv0_ok(cases, tdtype):
            raise AssertionError(f"conv0 kernel disagrees with its plain version: {full} "
                                 f"{cases}")
        rows.append(dict(
            name="K6 conv0" + (" (bf16)" if dtype == "bfloat16" else ""), route="cuda",
            source="lshm_tpu_torch/csrc/conv0.cu",
            replaces="benchmarks/pallas_conv_probe.py:56", counter=counter,
            path="conv0_probe",
            arch="mma.sync m16n8k16 bf16" + (", operands in 3 pieces, 6 pairs"
                                             if dtype == "float32" else ""),
            max_abs_err=full["parity_max_abs_err"], ms=result["kernel_ms"],
            profiler_us=prof, plain_ms=result["plain_ms"],
            bound_ms=result["bound_ms"], bound_by=result["bound_by"],
            library_ms=result["cudnn_ms"]))
    return counts, rows


# ------------------------------------------------------------------- phases 11, 12

def lbfgs_config(checkpoint_dir: str = "", compute_dtype: str | None = None):
    """preset full_khm_lbfgs (as published, bfloat16 activations, unless
    ``compute_dtype`` is given) with the published recipe's Adam -> L-BFGS switch, cut
    to 4 epochs x 1 minibatch x 2 ADMM iterations."""
    import dataclasses

    from lshm_tpu_torch.config import RampStage, preset

    cfg = preset("full_khm_lbfgs")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, khm_backend="pallas", pallas_head=True,
                                  compute_dtype=compute_dtype or cfg.model.compute_dtype),
        train=dataclasses.replace(
            cfg.train, num_epochs=4, iters_per_epoch=1, admm_iters=2,
            checkpoint_dir=checkpoint_dir,
            ramp=(RampStage(epochs=1, alpha=0.001, beta=0.001, gamma=0.001,
                            optimizer="adam"),
                  RampStage(epochs=3, alpha=0.01, beta=0.01, gamma=0.01,
                            optimizer="lbfgs"))),
    )


class _StepClock:
    """Times every minibatch step of a ``Trainer.run``, and nothing else of it (data,
    prefetch, revert snapshot, checkpoint): while it is entered, the step factories that
    ``Trainer.run`` calls return steps wrapped in two synchronisations.  Around each
    step it records the host time, the peak memory, and before and after it the launch
    counts, the parameters (on the host) and, for an L-BFGS step, the optimizer's
    ``func_evals`` and ``host_syncs``."""

    def __init__(self):
        from lshm_tpu_torch.train import trainer

        self.module, self.steps = trainer, []
        self.factories = (trainer.make_train_step, trainer.make_lbfgs_train_step)

    def __enter__(self):
        adam, lbfgs = self.factories
        self.module.make_train_step = self._wrap(adam, lbfgs=False)
        self.module.make_lbfgs_train_step = self._wrap(lbfgs, lbfgs=True)
        return self

    def __exit__(self, *exc):
        self.module.make_train_step, self.module.make_lbfgs_train_step = self.factories

    @staticmethod
    def _mark(state, lbfgs: bool) -> dict:
        from lshm_tpu_torch.kernels import launch_counts

        return dict(counts=launch_counts(),
                    func_evals=state.opt.func_evals if lbfgs else 0,
                    syncs=state.opt.host_syncs if lbfgs else 0,
                    params={k: v.to("cpu", copy=True)
                            for k, v in state.model.state_dict().items()})

    def _wrap(self, factory, lbfgs: bool):
        def make(*args, **kw):
            step = factory(*args, **kw)

            def timed(state, x, uv, w):
                torch.cuda.synchronize()
                before = self._mark(state, lbfgs)
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                state, metrics = step(state, x, uv, w)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                self.steps.append(dict(ms=ms, peak=torch.cuda.max_memory_allocated(),
                                       before=before, after=self._mark(state, lbfgs)))
                return state, metrics
            return timed
        return make


def lbfgs_phase(dev, tree, tmpdir: str) -> dict:
    import math

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer, active_group, group_mask, ramp_stage_for_epoch
    from lshm_tpu_torch.utils import MetricLogger, restore_checkpoint

    cfg = lbfgs_config(tmpdir)
    path = BF16_PATH                # the preset as published runs K3 and K4 in bf16
    logger = MetricLogger(echo=False)
    trainer = Trainer(cfg, device=dev, logger=logger)
    sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
    reset_launches()
    t0 = time.perf_counter()
    with _StepClock() as clock:
        trainer.run(sampler)
    wall = time.perf_counter() - t0
    total = {k: launch_counts()[k] for k in path}
    nadmm = cfg.train.admm_iters
    epochs = []
    if len(clock.steps) != cfg.train.num_epochs:
        raise AssertionError(f"expected one step per epoch, got {len(clock.steps)}")
    for e, st in enumerate(clock.steps):      # one minibatch per epoch
        a, b = st["before"], st["after"]
        kind = ramp_stage_for_epoch(cfg.train.ramp, e).optimizer
        group = active_group(cfg.optim.group_schedule, e)
        launches = {k: b["counts"][k] - a["counts"][k] for k in path}
        evals, syncs = b["func_evals"] - a["func_evals"], b["syncs"] - a["syncs"]
        ms = st["ms"] / nadmm
        rec = logger.history[e]
        row = {"phase": "lbfgs", "compute_dtype": cfg.model.compute_dtype, "epoch": e,
               "kind": kind, "group": group,
               "patches": rec["patches"], "ms_per_admm_iter": ms,
               "loss": rec["loss"], "peak_mem_gb": st["peak"] / 1e9, "launches": launches}
        if kind == "lbfgs":
            row.update(func_evals_per_admm_iter=evals / nadmm,
                       ms_per_closure_eval=ms / (evals / nadmm) if evals else None,
                       host_syncs_per_admm_iter=syncs / nadmm)
        # frozen groups' parameters unchanged bit for bit across the epoch
        mask = group_mask(a["params"], group)
        row["frozen_unchanged"] = all(
            torch.equal(a["params"][n], b["params"][n]) for n, m in mask.items() if not m)
        row["active_moved"] = any(
            not torch.equal(a["params"][n], b["params"][n]) for n, m in mask.items() if m)
        emit(row)
        epochs.append(row)
        if rec["patches"] != PATCHES or not all(math.isfinite(v) for k, v in rec.items()
                                            if k not in ("epoch", "iter", "t")):
            raise AssertionError(f"expected finite losses on {PATCHES} patches: {rec}")
        if not row["frozen_unchanged"] or not row["active_moved"]:
            raise AssertionError(f"group freeze broken in epoch {e}: {row}")
        if kind == "lbfgs" and evals <= 0:
            raise AssertionError(f"L-BFGS made no closure evaluation in epoch {e}")
        if kind == "lbfgs" and group == "ae2d" and launches[path[3]] == 0:
            raise AssertionError(f"K4 did not run in the L-BFGS ae2d epoch: {row}")
    kinds = [r["kind"] for r in epochs]
    if kinds != ["adam", "lbfgs", "lbfgs", "lbfgs"]:
        raise AssertionError(f"expected Adam then L-BFGS epochs, got {kinds}")
    missing = [k for k in path if total[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the L-BFGS path: {missing}")
    saved, _ = restore_checkpoint(tmpdir)
    emit({"phase": "lbfgs_summary", "wall_s": wall, "launches": total,
          "prefetch": cfg.data.prefetch,
          "checkpoint": sorted(os.listdir(tmpdir)), "opt_kind": saved["opt_kind"],
          "checkpoint_func_evals": saved["optimizer"]["func_evals"]})
    if saved["opt_kind"] != ["lbfgs", "ae2d"] or "s_hist" not in saved["optimizer"]:
        raise AssertionError("the checkpoint does not hold the L-BFGS state")
    return total


def agree_lbfgs_phase(dev, tree) -> None:
    import dataclasses

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.optim import value_and_grad
    from lshm_tpu_torch.train import (
        Duals,
        LossWeights,
        active_params,
        init_lbfgs_train_state,
        lbfgs_objective,
        make_lbfgs_train_step,
        metrics_and_dual_update,
    )

    cfg_k = lbfgs_config(compute_dtype="float32")
    cfg_k = dataclasses.replace(cfg_k, train=dataclasses.replace(cfg_k.train, admm_iters=1))
    cfg_p = dataclasses.replace(cfg_k, model=dataclasses.replace(
        cfg_k.model, khm_backend="xla", pallas_head=False))
    mb = MinibatchSampler([tree], ["0"], cfg_k.data, seed=13).sample()
    x, uv = torch.from_numpy(mb.x).to(dev), torch.from_numpy(mb.uv).to(dev)
    w = LossWeights(alpha=0.01, beta=0.01, gamma=0.01)
    closure, launched, steps, duals = {}, {}, {}, None
    for name, cfg in (("kernels", cfg_k), ("plain", cfg_p)):
        state = init_lbfgs_train_state(cfg, dev, "all")    # same seed: same weights
        model = state.model
        if duals is None:    # non-zero duals: one dual update from the initial weights
            _, duals = metrics_and_dual_update(model, x, uv, Duals.zeros_like(x), w,
                                               mb.num_baselines)
        value_fn = lbfgs_objective(cfg, mb.num_baselines)
        vg = value_and_grad(value_fn)
        params = active_params(model, "all")
        reset_launches()
        closure[name] = vg(params, model, {}, x, uv, duals, w)
        torch.cuda.synchronize()
        launched[name] = {k: launch_counts()[k] for k in ADAM_PATH}
        if name == "kernels":
            def probe():
                with torch.no_grad():
                    return value_fn(params, model, {}, x, uv, duals, w)
            timing = {"value_and_grad_ms": host_ms(
                          lambda: vg(params, model, {}, x, uv, duals, w)),
                      "value_only_probe_ms": host_ms(probe)}
        step = make_lbfgs_train_step(cfg, mb.num_baselines, "all")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, x, uv, w)
        loss = float(m["loss"][-1])
        steps[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                       "func_evals": state.opt.func_evals,
                       "host_syncs": state.opt.host_syncs, "loss": loss}
    (vk, gk), (vp, gp) = closure["kernels"], closure["plain"]
    grad_err = {n: rel_err(gk[n], gp[n]) for n in gp}
    worst = max(grad_err, key=grad_err.get)
    row = {"phase": "agree_lbfgs", "value_rel_err": rel_err(vk, vp),
           "grad_rel_err_max": grad_err[worst], "grad_worst": worst,
           "closure_launches": launched, "closure_kernels": timing, "step": steps}
    emit(row)
    # the kernel side went through K1-K4, the plain side through none of them
    if (any(launched["kernels"][k] == 0 for k in ADAM_PATH)
            or any(launched["plain"][k] != 0 for k in ADAM_PATH)):
        raise AssertionError(f"the closures did not take their paths: {launched}")
    if row["value_rel_err"] > 1e-4 or row["grad_rel_err_max"] > 2e-4:
        raise AssertionError("the L-BFGS closure disagrees between kernels and plain path")


# ------------------------------------------------------------------ phases 13 to 16

def _state_distance(a: dict, b: dict) -> float:
    """Largest relative max-abs distance over the tensors of two state dicts."""
    return max(rel_err(a[k].float(), b[k].float()) for k in b)


def _counting_saves(trainer, at_step: int) -> dict:
    """The launch counts at the moment ``trainer`` saves step ``at_step`` (filled in
    then): the launches of the part of the run before that checkpoint."""
    from lshm_tpu_torch.kernels import launch_counts

    seen, save = {}, trainer.save

    def counted(ckpt_dir, step, **kw):
        if step == at_step:
            seen.update(launch_counts())
        return save(ckpt_dir, step, **kw)

    trainer.save = counted
    return seen


def resume_phase(tree, tmpdir: str) -> str:
    """float32 full_khm with Adam at full width, 2 epochs x 2 minibatches x 10 ADMM
    iterations: the uninterrupted run twice (the card's own run-to-run distance), then
    the same training cut at the epoch boundary and mid-epoch (save_every_iters=1) and
    resumed by a fresh Trainer through load.  Each resumed run lies no farther from the
    first uninterrupted run than twice that distance (bit for bit where the two
    uninterrupted runs agree bit for bit), and K1-K4 launch as often in the cut and
    resumed runs together as in the uninterrupted run.  Returns the checkpoint the
    epoch-boundary resume wrote at its end."""
    import dataclasses

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.utils import MetricLogger

    base = flagship_config("")
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, num_epochs=2, iters_per_epoch=2, checkpoint_dir=""))

    def with_train(**kw):
        return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **kw))

    def run(c, trainer=None, ckpt: str | None = None, step: int | None = None):
        t = trainer or Trainer(c, logger=MetricLogger(echo=False))   # the card
        if ckpt is not None:
            t.load(ckpt, step)
        t.run(MinibatchSampler([tree], ["0"], c.data, seed=c.train.seed))
        torch.cuda.synchronize()
        return t

    def params(t):
        return {k: v.detach().clone() for k, v in t.model.state_dict().items()}

    reset_launches()
    t0 = time.perf_counter()
    full = params(run(cfg))
    uninterrupted_s = time.perf_counter() - t0
    full_counts = {k: launch_counts()[k] for k in ADAM_PATH}
    full2 = params(run(cfg))
    run_to_run = _state_distance(full2, full)

    cuts = {}
    ck_epoch, ck_mid, ck_final = (os.path.join(tmpdir, n) for n in ("epoch", "mid", "final"))
    # the epoch boundary: the first epoch's run saves step 2 at its end
    for name, cut_cfg, ckpt, step, resume_cfg in (
            ("epoch_boundary", with_train(num_epochs=1, checkpoint_dir=ck_epoch), ck_epoch,
             2, with_train(checkpoint_dir=ck_final)),
            ("mid_epoch", with_train(num_epochs=1, checkpoint_dir=ck_mid,
                                     save_every_iters=1), ck_mid, 1, cfg)):
        reset_launches()
        cut = Trainer(cut_cfg, logger=MetricLogger(echo=False))
        before_cut = _counting_saves(cut, step)
        run(cut_cfg, cut)
        reset_launches()
        resumed = run(resume_cfg, Trainer(resume_cfg, logger=MetricLogger(echo=False)),
                      ckpt, step)
        counts = {k: before_cut[k] + launch_counts()[k] for k in ADAM_PATH}
        dist = _state_distance(params(resumed), full)
        cuts[name] = {"checkpoint_step": step, "resumed_steps": resumed.state.step,
                      "distance": dist, "bit_identical": dist == 0.0, "launches": counts}
    row = {"phase": "resume", "preset": "full_khm", "compute_dtype": "float32",
           "epochs": 2, "minibatches_per_epoch": 2, "admm_iters": cfg.train.admm_iters,
           "uninterrupted_s": uninterrupted_s, "launches": full_counts,
           "run_to_run_distance": run_to_run, "run_to_run_bit_identical": run_to_run == 0.0,
           **cuts}
    emit(row)
    for name, c in cuts.items():
        if c["resumed_steps"] != 4 or c["launches"] != full_counts:
            raise AssertionError(f"{name} resume did not retrace the run: {c}, "
                                 f"uninterrupted launches {full_counts}")
        if (c["distance"] != 0.0 if run_to_run == 0.0
                else c["distance"] > 2 * run_to_run):
            raise AssertionError(f"{name} resume lies {c['distance']} from the "
                                 f"uninterrupted run (run to run: {run_to_run})")
    return ck_final


EVAL_STATIONS = 10             # 55 baselines of 384 x 512 channels (35 patches each)


def eval_phase(tree, ckpt: str):
    """The clustering evaluation of a SAP at full width from a checkpoint: a fresh
    Trainer loads it in float32 and in bfloat16_full, through the kernels and with
    pallas_head=False (the same weights), and runs baseline_distance_matrix over every
    baseline, chunks of 8 (K3 once a chunk; never on the plain path), decoding on the
    card (the default) and, through the kernels, on the host (device_decode=False);
    then the serial path (decode_lookahead=0) against the pipelined one and
    evaluate_sap without t-SNE.  float32: latents within 1e-5 and X within 1e-4 of the
    plain path and of the host decode, the same soft assignment.  Returns the float32
    kernel-path model and each dtype's row."""
    import dataclasses
    import math

    import numpy as np

    from lshm_tpu_torch import native
    from lshm_tpu_torch.data import (device_decode_patchify, patch_grid_shape,
                                     read_baselines_patches_batch, read_baselines_raw_batch,
                                     read_metadata)
    from lshm_tpu_torch.eval import baseline_distance_matrix, evaluate_sap
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.tools.measure import time_ms
    from lshm_tpu_torch.train import Trainer

    nbase, ntime, nfreq, _, _ = read_metadata(tree, "0")
    px, py = patch_grid_shape(ntime, nfreq, 128)
    patches = nbase * px * py
    bpb = 8
    nchunks = math.ceil(nbase / bpb)

    def loaded(dtype, kernels):
        cfg = flagship_config("", "full_khm", dtype)
        if not kernels:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, khm_backend="xla", pallas_head=False))
        t = Trainer(cfg)
        t.load(ckpt)
        return t.model.eval()

    def timed_matrix(model, **kw):
        baseline_distance_matrix(model, tree, "0", baseline_ids=range(bpb), **kw)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        X, lat = baseline_distance_matrix(model, tree, "0", baselines_per_batch=bpb, **kw)
        wall = time.perf_counter() - t0
        return X, lat, wall, launch_counts(), torch.cuda.max_memory_allocated() / 1e9

    runs, model_f32 = {}, None
    for dtype, counter in (("float32", "head_fwd"), ("bfloat16_full", "head_fwd_bf16")):
        out = {}
        for path in ("kernels", "plain"):
            model = loaded(dtype, path == "kernels")
            X, lat, wall, counts, peak = timed_matrix(model)
            out[path] = dict(X=X, lat=lat, wall=wall, counts=counts, peak=peak)
            if path == "kernels":
                kernel_model = model
        X, lat, wall, counts, peak = timed_matrix(kernel_model, device_decode=False)
        h = out["host_decode"] = dict(X=X, lat=lat, wall=wall, counts=counts, peak=peak)
        if dtype == "float32":
            model_f32 = kernel_model
        k, p = out["kernels"], out["plain"]
        row = {"phase": "eval", "compute_dtype": dtype, "baselines": nbase,
               "patches": patches, "chunks": nchunks, "baselines_per_batch": bpb,
               "wall_s": k["wall"], "patches_per_s": patches / k["wall"],
               "baselines_per_s": nbase / k["wall"], "peak_mem_gb": k["peak"],
               "plain_wall_s": p["wall"], "plain_patches_per_s": patches / p["wall"],
               "plain_peak_mem_gb": p["peak"],
               "k3_launches": k["counts"][counter],
               "plain_k3_launches": p["counts"]["head_fwd"] + p["counts"]["head_fwd_bf16"],
               "latents_rel_err": rel_err(torch.from_numpy(k["lat"]),
                                          torch.from_numpy(p["lat"])),
               "X_rel_err": rel_err(torch.from_numpy(k["X"]), torch.from_numpy(p["X"])),
               "soft_assign_equal_share": float(np.mean(
                   np.argmin(k["X"], 0) == np.argmin(p["X"], 0))),
               "finite": bool(np.isfinite(k["X"]).all() and np.isfinite(k["lat"]).all()),
               "host_decode": {
                   "wall_s": h["wall"], "patches_per_s": patches / h["wall"],
                   "baselines_per_s": nbase / h["wall"], "peak_mem_gb": h["peak"],
                   "k3_launches": h["counts"][counter],
                   "host_decoder": "native" if native.available() else "numpy",
                   "latents_rel_err": rel_err(torch.from_numpy(h["lat"]),
                                              torch.from_numpy(k["lat"])),
                   "X_rel_err": rel_err(torch.from_numpy(h["X"]), torch.from_numpy(k["X"])),
                   "soft_assign_equal_share": float(np.mean(
                       np.argmin(k["X"], 0) == np.argmin(h["X"], 0)))}}
        emit(row)
        runs[dtype] = row
        hd = row["host_decode"]
        if (row["k3_launches"] != nchunks or hd["k3_launches"] != nchunks
                or row["plain_k3_launches"] != 0):
            raise AssertionError(f"K3 launches {row['k3_launches']} (device decode), "
                                 f"{hd['k3_launches']} (host decode) on the kernel path "
                                 f"({nchunks} chunks), {row['plain_k3_launches']} plain")
        if dtype == "float32" and (hd["latents_rel_err"] > 1e-5 or hd["X_rel_err"] > 1e-4
                                   or hd["soft_assign_equal_share"] != 1.0):
            raise AssertionError(f"float32 eval: the two decodes disagree: {hd}")
        if not row["finite"] or k["X"].shape != (10, nbase):
            raise AssertionError(f"eval output malformed: {k['X'].shape}")
        if dtype == "float32" and (row["latents_rel_err"] > 1e-5 or row["X_rel_err"] > 1e-4
                                   or row["soft_assign_equal_share"] != 1.0):
            raise AssertionError(f"float32 eval: kernel and plain paths disagree: {row}")

    # cuDNN's transposed convolutions (dgrad engines) may sum in another order from one
    # call to the next, and the 1D AEs' input depends on the 2D AE's output, so two
    # runs on the card need not agree bit for bit (the CPU tests hold the serial and
    # pipelined paths equal): the serial path is held to the float32 gates
    X_ser, lat_ser, serial_wall, _, _ = timed_matrix(model_f32, decode_lookahead=0)
    X_pipe, lat_pipe, pipe_wall, _, _ = timed_matrix(model_f32)
    decode_s = {}
    for decoder, use_native in (("native", None), ("numpy", False)):
        t0 = time.perf_counter()
        for i in range(0, nbase, bpb):  # the host decode alone, as the decode thread runs it
            read_baselines_patches_batch(tree, "0", list(range(i, min(nbase, i + bpb))),
                                         uvdist=True, use_native=use_native)
        decode_s[decoder] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(0, nbase, bpb):      # the raw reads of the device decode
        read_baselines_raw_batch(tree, "0", list(range(i, min(nbase, i + bpb))),
                                 uvdist=True)
    raw_read_s = time.perf_counter() - t0
    vis, scales = (torch.from_numpy(a).to(next(model_f32.parameters()).device)
                   for a in read_baselines_raw_batch(tree, "0", list(range(bpb))))
    _, _, x, uv = read_baselines_patches_batch(tree, "0", list(range(bpb)), uvdist=True)
    dev = next(model_f32.parameters()).device
    x, uv = torch.from_numpy(x).to(dev), torch.from_numpy(uv).to(dev)

    def forward():
        with torch.inference_mode():
            return model_f32(x, uv).Mu

    t0 = time.perf_counter()
    res = evaluate_sap(model_f32, tree, "0", run_tsne=False, out_dir=None)
    sap_s = time.perf_counter() - t0
    X_demeaned = X_pipe - X_pipe.mean(axis=1, keepdims=True)
    row = {"phase": "eval_pipeline", "decode": "device", "serial_s": serial_wall,
           "pipelined_s": pipe_wall, "host_decode_s": decode_s["native"],
           "host_decode_numpy_s": decode_s["numpy"], "raw_read_s": raw_read_s,
           "device_decode_ms_per_chunk": time_ms(lambda: device_decode_patchify(vis, scales)),
           "forward_ms_per_chunk": host_ms(forward),
           "patches_per_chunk": int(x.shape[0]),
           "serial_vs_pipelined": {
               "bit_identical": bool(np.array_equal(X_ser, X_pipe)
                                     and np.array_equal(lat_ser, lat_pipe)),
               "X_rel_err": rel_err(torch.from_numpy(X_ser), torch.from_numpy(X_pipe)),
               "latents_rel_err": rel_err(torch.from_numpy(lat_ser),
                                          torch.from_numpy(lat_pipe))},
           "evaluate_sap_s": sap_s,
           "evaluate_sap_X_rel_err": rel_err(torch.from_numpy(res.X),
                                             torch.from_numpy(X_demeaned)),
           "soft_assign_histogram": np.bincount(res.soft_assign, minlength=10).tolist()}
    emit(row)
    sp = row["serial_vs_pipelined"]
    if sp["X_rel_err"] > 1e-4 or sp["latents_rel_err"] > 1e-5:
        raise AssertionError(f"the pipelined eval disagrees with the serial one: {sp}")
    if row["evaluate_sap_X_rel_err"] > 1e-4 or res.X.shape != X_pipe.shape:
        raise AssertionError("evaluate_sap's X is not the row-demeaned distance matrix")
    return model_f32, runs


def export_phase(model, tree) -> dict:
    """export_forward of the full-width float32 model with a symbolic batch on the card,
    load_exported of it, called at batch 35 and 96: the graph holds the K3 operator,
    each call launches K3 once, and the outputs lie within 1e-6 of the eager kernel
    path's."""
    from lshm_tpu_torch.data import read_baselines_patches_batch
    from lshm_tpu_torch.eval import export_forward, load_exported
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.losses import pairwise_sq_dists

    dev = next(model.parameters()).device
    t0 = time.perf_counter()
    blob = export_forward(model, batch_size=None)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = load_exported(blob)
    load_s = time.perf_counter() - t0
    nodes = [str(n.target) for n in fn.graph.nodes if n.op == "call_function"]
    head_nodes = [n for n in nodes if "lshm_tpu_torch.head_fwd" in n]
    _, _, patches, uv = read_baselines_patches_batch(tree, "0", [0, 1, 2], uvdist=True)
    row = {"phase": "export", "blob_mb": len(blob) / 1e6, "export_s": export_s,
           "load_s": load_s, "graph_nodes": len(nodes), "head_fwd_nodes": len(head_nodes)}
    for n in (35, 96):
        x = torch.from_numpy(patches[:n]).to(dev)
        u = torch.from_numpy(uv[:n]).to(dev)
        fn(x, u)                                   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        got = fn(x, u)
        torch.cuda.synchronize()
        k3 = launch_counts()["head_fwd"]
        with torch.inference_mode():
            out = model(x, u)
            want = (out.xrecon, out.Mu, pairwise_sq_dists(out.Mu, model.khm.M) ** 2)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        row[f"batch_{n}"] = {"k3_launches": k3, "rel_err": max(errs),
                             "bit_identical": all(torch.equal(g, w)
                                                  for g, w in zip(got, want)),
                             "shapes": [list(g.shape) for g in got]}
        if k3 != 1 or max(errs) > 1e-6 or list(got[2].shape) != [n, 10]:
            raise AssertionError(f"the exported forward at batch {n}: {row}")
    x96 = torch.from_numpy(patches[:96]).to(dev)
    u96 = torch.from_numpy(uv[:96]).to(dev)

    def eager():
        with torch.inference_mode():
            out = model(x96, u96)
            return out.xrecon, out.Mu, pairwise_sq_dists(out.Mu, model.khm.M) ** 2

    row["ms_batch_96"] = host_ms(lambda: fn(x96, u96), repeats=10)
    row["eager_ms_batch_96"] = host_ms(eager, repeats=10)
    emit(row)
    if len(head_nodes) != 1:
        raise AssertionError(f"the exported graph holds {len(head_nodes)} K3 nodes")
    return row


# the kernels of the float32 Adam path (K1-K4) by the names a profiler's trace gives them
TRACE_NAMES = {"khm_fwd": "khm_fwd_cluster_kernel", "khm_bwd": "khm_bwd_cluster_kernel",
               "head_fwd": "head_fwd_tc_kernel", "head_bwd": "head_bwd_f32_tc_kernel"}


def cli_phase(tree, tmpdir: str) -> dict:
    """``lshm_tpu_torch.cli.main`` in this process, on the card, at full width (preset
    full_khm, 2 minibatches x 10 ADMM iterations an epoch): ``train`` one epoch with a
    checkpoint, ``--log-jsonl`` and ``--profile-dir``; ``train --resume`` to 2 epochs,
    which trains the second only; ``export --ckpt`` with a symbolic batch.  The JSONL
    holds a record per minibatch with JAX's keys, the trace names K1-K4, K1-K4 launch
    20, 20, 40 and 20 times an epoch, and the exported call at batch 96 lies within 1e-6
    of the model that Trainer.load restores from the checkpoint, one K3 launch a call.
    The card's machine has no h5py, so for the phase ``scan_files`` in
    ``lshm_tpu_torch.train.trainer`` (where Trainer.run looks it up) returns the
    in-memory extract; it is restored afterwards.  ``eval`` and ``demo`` need sklearn
    and matplotlib, which that machine lacks: the CPU tests cover them."""
    import json

    from lshm_tpu_torch import cli
    from lshm_tpu_torch.config import preset
    from lshm_tpu_torch.data import read_baselines_patches_batch
    from lshm_tpu_torch.eval import load_exported
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.train import trainer as trainer_mod

    if os.environ.get("LSHM_PLATFORM"):
        raise AssertionError("the cli phase runs the CLI on the card: unset LSHM_PLATFORM")
    ckpt, prof, blob = (os.path.join(tmpdir, n) for n in ("ckpt", "profile", "fwd.pt2"))
    logs = {n: os.path.join(tmpdir, f"{n}.jsonl") for n in ("train", "resume")}
    common = ["train", "--data-dir", "in-memory", "--preset", "full_khm", "--quiet",
              "--set", "train.iters_per_epoch=2", "--set", "train.admm_iters=10",
              "--set", f"train.checkpoint_dir={ckpt}"]
    argvs = {"train": [*common, "--set", "train.num_epochs=1",
                       "--log-jsonl", logs["train"], "--profile-dir", prof],
             "resume": [*common, "--set", "train.num_epochs=2", "--resume",
                        "--log-jsonl", logs["resume"]]}
    per_epoch = {"khm_fwd": 20, "khm_bwd": 20, "head_fwd": 40, "head_bwd": 20}
    row = {"phase": "cli", "preset": "full_khm", "minibatches_per_epoch": 2,
           "admm_iters": 10,
           "scan_files": "replaced in lshm_tpu_torch.train.trainer for the phase "
                         "(the in-memory extract), restored after",
           "skipped": {"eval": "needs sklearn and matplotlib (CPU tests)",
                       "demo": "needs matplotlib (CPU tests)"}}
    real_scan = trainer_mod.scan_files
    trainer_mod.scan_files = lambda *a, **k: ([tree], ["0"])
    try:
        for name, argv in argvs.items():
            reset_launches()
            t0 = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            with open(logs[name]) as f:
                recs = [json.loads(line) for line in f]
            row[name] = {"s": time.perf_counter() - t0,
                         "launches": {k: launch_counts()[k] for k in ADAM_PATH},
                         "records": [[r["epoch"], r["iter"]] for r in recs],
                         "record_keys": sorted(recs[0]) if recs else [],
                         "patches": [r.get("patches") for r in recs]}
    finally:
        trainer_mod.scan_files = real_scan
    row["scan_files_restored"] = trainer_mod.scan_files is real_scan

    trace = os.path.join(prof, "trace_epoch_0.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    row["profile"] = {"file": os.path.basename(trace), "mb": os.path.getsize(trace) / 1e6,
                      "kernel_events": len(kernels),
                      "named": {k: sum(n in name for name in kernels)
                                for k, n in TRACE_NAMES.items()}}

    t0 = time.perf_counter()
    cli.main(["export", "--ckpt", ckpt, "--out", blob])
    export_s = time.perf_counter() - t0
    with open(blob, "rb") as f:
        fn = load_exported(f.read())
    t = Trainer(preset("full_khm"))                # the card
    t.load(ckpt)
    model = t.model.eval()
    _, _, patches, uv = read_baselines_patches_batch(tree, "0", [0, 1, 2], uvdist=True)
    dev = next(model.parameters()).device
    x = torch.from_numpy(patches[:96]).to(dev)
    u = torch.from_numpy(uv[:96]).to(dev)
    fn(x, u)                                       # warm-up
    torch.cuda.synchronize()
    reset_launches()
    got = fn(x, u)
    torch.cuda.synchronize()
    k3 = launch_counts()["head_fwd"]
    with torch.inference_mode():
        out = model(x, u)
    errs = [rel_err(g, w) for g, w in zip(got[:2], (out.xrecon, out.Mu))]
    row["export"] = {"s": export_s, "blob_mb": os.path.getsize(blob) / 1e6,
                     "k3_launches": k3, "rel_err": max(errs),
                     "shapes": [list(g.shape) for g in got]}
    emit(row)

    keys = {"epoch", "iter", "t", "patches", "loss0", "loss1", "loss2", "loss3", "kdist",
            "aug", "sim", "rica", "loss"}
    bad = []
    for name, epoch in (("train", 0), ("resume", 1)):
        r = row[name]
        if r["launches"] != per_epoch:
            bad.append(f"{name} launches {r['launches']}, expected {per_epoch}")
        if r["records"] != [[epoch, 0], [epoch, 1]] or set(r["record_keys"]) != keys:
            bad.append(f"{name} JSONL records {r['records']} with keys {r['record_keys']}")
    if not row["scan_files_restored"]:
        bad.append("scan_files not restored")
    if min(row["profile"]["named"].values()) == 0:
        bad.append(f"the trace lacks a kernel of K1-K4: {row['profile']['named']}")
    if k3 != 1 or max(errs) > 1e-6 or row["export"]["shapes"][2] != [96, 10]:
        bad.append(f"the exported forward: {row['export']}")
    if bad:
        raise AssertionError("; ".join(bad))
    return row


# ------------------------------------------------------------------ phases 17, 18

NATIVE_GATE = dict(rtol=1e-5, atol=1e-5)   # JAX's native decode against numpy


def openmp_runtimes() -> list[str]:
    """The OpenMP runtimes mapped into this process (torch's, and the decoder's if it
    brought another)."""
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f}
    return sorted(p for p in paths
                  if os.path.basename(p).startswith(("libgomp", "libomp", "libiomp")))


def native_decode_phase(tree, eval_tree) -> dict:
    """The native host decoder (``lshm_tpu_torch/native``) at full width: the default
    sampler decodes natively here; ``sample()`` native against numpy from twin samplers
    (420 patches, 840 with augment) within JAX's gate (rtol 1e-5, atol 1e-5), the same
    rng state after, uv equal; ``read_baselines_patches_batch`` native against numpy on
    a chunk of 8 baselines of each extract; native repeats bit for bit.  Then host ms
    (median of 5) of ``sample()`` with each decoder, ``read_baseline_raw`` alone, the
    numpy path in its parts, and the eval chunk with each decoder; the host's cores and
    the OpenMP threads and runtimes."""
    import dataclasses
    import shutil

    import numpy as np

    from lshm_tpu_torch import native
    from lshm_tpu_torch.config import preset
    from lshm_tpu_torch.data import (MinibatchSampler, patchify, read_baseline_raw,
                                     read_baselines_patches_batch)
    from lshm_tpu_torch.data.h5io import _decode_channels, _pad_to

    base = preset("full_khm").data
    default = MinibatchSampler([tree], ["0"], base, seed=0)
    row = {"phase": "native_decode", "build": native.build_info(),
           "default_use_native": default.use_native, "cpu_count": os.cpu_count(),
           "torch_threads": torch.get_num_threads(), "openmp_runtimes": openmp_runtimes(),
           "gate": NATIVE_GATE}
    ok = default.use_native is True

    def close(a, b) -> tuple[bool, float]:
        return bool(np.allclose(a, b, **NATIVE_GATE)), float(np.abs(a - b).max())

    for augment in (False, True):
        cfg = dataclasses.replace(base, augment=augment)
        nat, ref, rep = (MinibatchSampler([tree], ["0"], cfg, seed=3, use_native=u)
                         for u in (True, False, True))
        cases = []
        for _ in range(2):
            a, b, c = nat.sample(), ref.sample(), rep.sample()
            within, err = close(a.x, b.x)
            cases.append({"patches": int(a.x.shape[0]), "within_gate": within,
                          "max_abs_err": err, "uv_equal": bool(np.array_equal(a.uv, b.uv)),
                          "same_rng_state": nat.rng.bit_generator.state
                          == ref.rng.bit_generator.state,
                          "repeat_bit_identical": bool(np.array_equal(a.x, c.x)),
                          "patches_per_baseline": a.patches_per_baseline})
            ok &= all(v for v in cases[-1].values() if isinstance(v, bool))
            ok &= cases[-1]["patches"] == (840 if augment else 420)
        row[f"sample_augment_{augment}"] = cases

    chunk = list(range(8))
    for name, src in (("train", tree), ("eval", eval_tree)):
        got = read_baselines_patches_batch(src, "0", chunk, uvdist=True, use_native=True)
        again = read_baselines_patches_batch(src, "0", chunk, uvdist=True, use_native=True)
        want = read_baselines_patches_batch(src, "0", chunk, uvdist=True, use_native=False)
        within, err = close(got[2], want[2])
        case = {"patches": int(got[2].shape[0]), "within_gate": within, "max_abs_err": err,
                "uv_equal": bool(np.array_equal(got[3], want[3])),
                "repeat_bit_identical": bool(np.array_equal(got[2], again[2])),
                "host_ms_native": host_ms(lambda: read_baselines_patches_batch(
                    src, "0", chunk, uvdist=True, use_native=True)),
                "host_ms_numpy": host_ms(lambda: read_baselines_patches_batch(
                    src, "0", chunk, uvdist=True, use_native=False))}
        ok &= all(v for v in case.values() if isinstance(v, bool))
        row[f"chunk_{name}"] = case

    timing = {}
    for augment in (False, True):
        cfg = dataclasses.replace(base, augment=augment)
        nat, ref = (MinibatchSampler([tree], ["0"], cfg, seed=1, use_native=u)
                    for u in (True, False))
        timing[f"augment_{augment}"] = {"host_ms_sample_native": host_ms(nat.sample),
                                        "host_ms_sample_numpy": host_ms(ref.sample)}
    ids = list(range(base.batch_size))          # the numpy path in its parts, 12 baselines
    g = tree["measurement"]["saps"]["0"]
    x = _pad_to(_decode_channels(g["visibilities"], g["visibility_scale_factors"], ids, 4),
                base.patch_size)
    patches, _ = patchify(x, base.patch_size)

    def clamp_znorm():
        p = np.clip(patches, -base.clamp, base.clamp)
        return (p - p.mean()) / p.std()

    timing["parts_ms"] = {
        "read_baseline_raw": host_ms(lambda: read_baseline_raw(tree, "0", ids)),
        "numpy_decode_channels_and_pad": host_ms(lambda: _pad_to(_decode_channels(
            g["visibilities"], g["visibility_scale_factors"], ids, 4), base.patch_size)),
        "numpy_patchify": host_ms(lambda: patchify(x, base.patch_size)),
        "numpy_clamp_znorm": host_ms(clamp_znorm)}

    # where $CXX is another compiler than the path's g++ (say, one without OpenMP), the
    # same source built by that g++, timed and held to the default build
    other = shutil.which("g++")
    if other and other != row["build"]["compiler"]:
        saved = os.environ.get("CXX")
        os.environ["CXX"] = other
        try:
            case = {"build": native.build_info()}
            for augment in (False, True):
                cfg = dataclasses.replace(base, augment=augment)
                s = MinibatchSampler([tree], ["0"], cfg, seed=1, use_native=True)
                case[f"host_ms_sample_augment_{augment}"] = host_ms(s.sample)
            x_other = MinibatchSampler([tree], ["0"], base, seed=2,
                                       use_native=True).sample().x
        finally:
            if saved is None:
                del os.environ["CXX"]
            else:
                os.environ["CXX"] = saved
        x_default = MinibatchSampler([tree], ["0"], base, seed=2,
                                     use_native=True).sample().x
        case["within_gate"], case["max_abs_err"] = close(x_other, x_default)
        case["bit_identical"] = bool(np.array_equal(x_other, x_default))
        case["openmp_runtimes"] = openmp_runtimes()
        ok &= case["within_gate"]
        timing["path_gxx"] = case
    row["timing"] = timing
    row["ok"] = bool(ok)
    emit(row)
    if not ok:
        raise AssertionError(f"the native decoder disagrees with numpy: {row}")
    return row


def rica_phase(tree, tmpdir: str) -> dict:
    """``python -m lshm_tpu_torch.cli rica`` at its defaults (10 minibatches x 8
    baselines x 35 patches, patch 128, 4 channels, M = 256, l1 0.1, eta 0.1, 10 solver
    iterations) on the card, in this process: n = 280, A [65536, 256] and X [65536, 280]
    float32, each minibatch decoded by ``sample()`` (the native decoder).  ``scan_files``
    in ``lshm_tpu_torch.data`` (where cmd_rica looks it up) returns the in-memory
    extract for the phase, and ``fit_minibatch`` and ``sample`` are wrapped to time each
    call on a synchronised host clock; all three are restored after.  Gates, on a
    learner of the same seed and the CLI's first minibatch and initial code: the closure
    within 1e-5 (value) and 2e-5 (gradient) of the same closure in float64 on the CPU;
    one ``fit_minibatch`` twice from the same state, the same func_evals and losses
    within 1e-6.  Then: the CLI's lines, finite loss and |dA| at every minibatch, the
    atom PNG written, K1-K6 never launched.  Records ms per fit, func_evals and host
    syncs per solve, ``sample()`` ms, the loss and |dA| sequences and peak memory."""
    import contextlib
    import io
    import math
    import re

    from lshm_tpu_torch import cli
    from lshm_tpu_torch import data as data_mod
    from lshm_tpu_torch.config import DataConfig, LBFGSConfig
    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.optim.lbfgs import value_and_grad
    from lshm_tpu_torch.rica import RICAConfig, RICADictionaryLearner

    out_dir = os.path.join(tmpdir, "rica_out")
    argv = ["rica", "--data-dir", "in-memory", "--out", out_dir]
    args = cli.build_parser().parse_args(argv)

    # the gates: cmd_rica's configuration, first minibatch and first initial code
    dcfg = DataConfig(data_dir=args.data_dir, batch_size=args.batch,
                      patch_size=args.patch_size, num_channels=args.channels, uvdist=False)
    cfg = RICAConfig(
        input_dim=args.channels * args.patch_size * args.patch_size,
        dict_size=args.dict_size, l1_weight=args.l1, dict_lr=args.eta,
        solver=LBFGSConfig(lr=1.0, max_iter=args.solver_iters, history_size=7,
                           line_search=True, batch_mode=True),
    )
    learner = RICADictionaryLearner(cfg, seed=args.seed)        # the card
    A0 = learner.A.clone()
    X = learner.patches_to_columns(
        MinibatchSampler([tree], ["0"], dcfg, seed=args.seed).sample().x)
    n = X.shape[1]
    gen = torch.Generator().manual_seed(args.seed)        # the CLI's first draw
    s0 = torch.rand((cfg.dict_size * n,), generator=gen)
    vg = value_and_grad(learner._loss)
    Xt = torch.from_numpy(X)
    v32, g32 = vg({"s": s0.to(learner.device)}, learner.A, Xt.to(learner.device))
    v64, g64 = vg({"s": s0.double()}, A0.cpu().double(), Xt.double())
    g32, g64 = g32["s"].cpu().double(), g64["s"]
    closure = {"value_rel_err": abs(float(v32) - float(v64)) / abs(float(v64)),
               "grad_rel_err": float((g32 - g64).abs().max() / g64.abs().max()),
               "value": float(v64)}
    repeat = []
    for _ in range(2):
        learner.A = A0.clone()
        m = learner.fit_minibatch(X, s0=s0)
        repeat.append({**m, "func_evals": learner.solver_state.func_evals,
                       "host_syncs": learner.solver_state.host_syncs})
    same_evals = repeat[0]["func_evals"] == repeat[1]["func_evals"]
    loss_rel = abs(repeat[0]["loss"] - repeat[1]["loss"]) / abs(repeat[1]["loss"])
    del learner, A0

    # the CLI, timed per call
    fits, samples = [], []
    real_fit, real_sample = RICADictionaryLearner.fit_minibatch, MinibatchSampler.sample
    real_scan = data_mod.scan_files

    def timed_fit(self, X, generator=None, s0=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = real_fit(self, X, generator, s0)
        torch.cuda.synchronize()
        st = self.solver_state
        fits.append({**m, "ms": (time.perf_counter() - t0) * 1e3,
                     "func_evals": st.func_evals, "host_syncs": st.host_syncs,
                     "n_iter": st.n_iter})
        return m

    def timed_sample(self):
        t0 = time.perf_counter()
        mb = real_sample(self)
        samples.append({"ms": (time.perf_counter() - t0) * 1e3, "native": self.use_native,
                        "patches": int(mb.x.shape[0])})
        return mb

    RICADictionaryLearner.fit_minibatch, MinibatchSampler.sample = timed_fit, timed_sample
    data_mod.scan_files = lambda *a, **k: ([tree], ["0"])
    stdout = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            cli.main(argv)
    finally:
        RICADictionaryLearner.fit_minibatch, MinibatchSampler.sample = real_fit, real_sample
        data_mod.scan_files = real_scan
    wall = time.perf_counter() - t0
    counts = launch_counts()
    lines = stdout.getvalue().strip().splitlines()
    png = os.path.join(out_dir, "dictionary_atoms.png")
    with open(png, "rb") as f:
        png_signature = f.read(8) == b"\x89PNG\r\n\x1a\n"
    fit_ms = [f["ms"] for f in fits]
    row = {"phase": "rica", "argv": argv,
           "defaults": {k: v for k, v in vars(args).items() if k not in ("fn", "cmd")},
           "n": n, "A_shape": [cfg.input_dim, cfg.dict_size], "X_shape": list(X.shape),
           "host_decoder": "native" if all(x["native"] for x in samples) else "numpy",
           "closure_vs_f64": closure, "repeat": repeat, "repeat_same_func_evals": same_evals,
           "repeat_loss_rel": loss_rel, "wall_s": wall,
           "fit_ms": fit_ms, "fit_ms_median": statistics.median(fit_ms),
           "fit_ms_median_after_first": statistics.median(fit_ms[1:]),
           "sample_ms": [x["ms"] for x in samples],
           "sample_ms_median": statistics.median(x["ms"] for x in samples),
           "func_evals": [f["func_evals"] for f in fits],
           "host_syncs": [f["host_syncs"] for f in fits],
           "n_iter": [f["n_iter"] for f in fits],
           "loss": [f["loss"] for f in fits], "dA_norm": [f["dA_norm"] for f in fits],
           "lines": lines, "png_bytes": os.path.getsize(png),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
           "scan_files_restored": data_mod.scan_files is real_scan}
    emit(row)
    want = [re.compile(rf"rica {i} loss \S+ \|dA\| \S+") for i in range(args.iters)]
    bad = []
    if closure["value_rel_err"] > 1e-5 or closure["grad_rel_err"] > 2e-5:
        bad.append(f"the closure on the card against float64: {closure}")
    if not same_evals or loss_rel > 1e-6:
        bad.append(f"a repeated fit differs: {repeat}")
    if not all(math.isfinite(f["loss"]) and math.isfinite(f["dA_norm"]) for f in fits):
        bad.append("a non-finite loss or |dA|")
    if any(counts.values()):
        bad.append(f"RICA launched a port kernel: {counts}")
    if (len(lines) != args.iters + 1 or not all(w.fullmatch(x) for w, x in zip(want, lines))
            or lines[-1] != f"wrote {png} ({cfg.dict_size} atoms)" or not png_signature):
        bad.append(f"the CLI's output: {lines}")
    if (row["host_decoder"] != "native" or len(fits) != args.iters or n != 280
            or {x["patches"] for x in samples} != {n} or not row["scan_files_restored"]):
        bad.append(f"not the CLI's default run: {row['host_decoder']}, {len(fits)} fits, "
                   f"n = {n}")
    if bad:
        raise AssertionError("; ".join(bad))
    return row


# ------------------------------------------------------------------------- phase 19

LOFAR_STATIONS = 62            # LOFAR's full array: 1,953 baselines with autocorrelations
GRAPH_GATE = (1e-5, 2e-5)      # the card against the CPU: output and loss, gradients


def lofar_extract(source: dict, nstations: int = LOFAR_STATIONS, ntime: int = 128,
                  nfreq: int = 256, saps: tuple[str, ...] = ("0", "1"),
                  seed: int = 2) -> dict:
    """``synth_extract``'s schema at ``nstations`` stations (every pair, with the
    autocorrelations) without its fringe simulator, which takes 45.7 s a SAP of 62
    stations on one core: each baseline is a seeded random time x frequency crop of one
    of ``source``'s baselines of its kind (an autocorrelation of an autocorrelation, a
    cross-correlation of a cross-correlation) with its scale factors; the stations'
    positions are drawn once, uniform in +-2 km as ``synth_extract`` draws them.
    Copies only."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = source["measurement"]["saps"]["0"]
    src_vis, src_scales = g["visibilities"], g["visibility_scale_factors"]
    _, T, F, _, _ = src_vis.shape
    kinds = {True: [], False: []}
    for b, (s1, s2) in enumerate(g["baselines"]):
        kinds[bool(s1 == s2)].append(b)
    pairs = [(i, j) for i in range(nstations) for j in range(i, nstations)]
    xyz = rng.uniform(-2000.0, 2000.0, size=(nstations, 3))
    tree = {"measurement": {"info": source["measurement"]["info"], "saps": {}}}
    for sap in saps:
        vis = np.empty((len(pairs), ntime, nfreq, 4, 2), np.int8)
        scales = np.empty((len(pairs), nfreq, 4), np.float32)
        for b, (s1, s2) in enumerate(pairs):
            same = kinds[s1 == s2]
            k = same[int(rng.integers(len(same)))]
            t0, f0 = int(rng.integers(0, T - ntime + 1)), int(rng.integers(0, F - nfreq + 1))
            vis[b] = src_vis[k, t0:t0 + ntime, f0:f0 + nfreq]
            scales[b] = src_scales[k, f0:f0 + nfreq]
        tree["measurement"]["saps"][sap] = {
            "visibilities": vis, "visibility_scale_factors": scales,
            "central_frequencies": np.linspace(110e6, 180e6, nfreq),
            "baselines": np.array(pairs, dtype=np.int64),
            "antenna_locations": {"XYZ": xyz}}
    return tree


def line_edges(nstations: int) -> int:
    """The line graph's edges over every pair of ``nstations`` stations with the
    autocorrelations: an autocorrelation meets the ``nstations`` baselines of its
    station, a cross-correlation those of its first station and the others of its
    second (``line_graph_edges``)."""
    return nstations ** 2 + nstations * (nstations - 1) // 2 * (2 * nstations - 1)


def card_vs_cpu(net, inputs, loss_fn, targets, shift_free=(), orders: int = 6) -> dict:
    """``net`` (on the card) against copies of it on the CPU with the same weights and
    graph: for the output, the loss and each parameter's gradient, the largest absolute
    difference over the largest absolute value.  ``f64_card_vs_cpu``: float64 copies on
    the card and on the CPU, the same function where the order of the sums no longer
    shows.  ``card_vs_cpu``: the card's float32 against the CPU's.  ``card_vs_f64`` and
    ``cpu_vs_f64``: the card's float32 and, the largest over ``orders`` orders of the
    edges (the given order first), the CPU's float32 against float64 on the CPU.  A
    gradient that is zero but for rounding (``shift_free``) is measured against the
    net's largest gradient instead."""
    import copy

    def run(m, edge_order=None):
        p0 = next(m.parameters())
        put = lambda t: t.to(p0.device, p0.dtype if t.is_floating_point() else t.dtype)
        args = [put(t) for t in inputs]
        if edge_order is not None:          # (x, edge_index[, edge_attr]) in another order
            args[1] = args[1][:, edge_order]
            args[2:] = [a[edge_order] for a in args[2:]]
        m.zero_grad(set_to_none=True)
        pred = m(*args)
        loss = loss_fn(pred, *map(put, targets))
        loss.backward()
        out = {"output": pred, "loss": loss,
               **{f"grad {n}": p.grad for n, p in m.named_parameters()}}
        return {k: v.detach().cpu().double() for k, v in out.items()}

    cpu32, cpu64 = copy.deepcopy(net).cpu(), copy.deepcopy(net).cpu().double()
    card, f64 = run(net), run(cpu64)
    card64 = run(copy.deepcopy(net).double())
    nedges = inputs[1].shape[1]
    gen = torch.Generator().manual_seed(0)
    cpu = [run(cpu32)] + [run(cpu32, torch.randperm(nedges, generator=gen))
                          for _ in range(orders - 1)]
    largest = max(float(v.abs().max()) for k, v in f64.items() if k.startswith("grad "))

    def err(a, b, key):
        return abs_err(a, b) / largest if key[5:] in shift_free else rel_err(a, b)

    return {k: {"f64_card_vs_cpu": err(card64[k], f64[k], k),
                "card_vs_cpu": err(card[k], cpu[0][k], k),
                "card_vs_f64": err(card[k], f64[k], k),
                "cpu_vs_f64": max(err(c[k], f64[k], k) for c in cpu)} for k in f64}


def within_graph_gate(check: dict) -> bool:
    """float64 on the card within 1e-9 of float64 on the CPU; and in float32 the output
    and loss within 1e-5 of the CPU's, each gradient within 2e-5, or, where float32
    itself is that sensitive to the order of its sums, the card no farther from float64
    than twice the CPU's float32 over several orders of the edges."""
    return all(e["f64_card_vs_cpu"] <= 1e-9
               and (e["card_vs_cpu"] <= GRAPH_GATE[k.startswith("grad ")]
                    or e["card_vs_f64"] <= 2 * e["cpu_vs_f64"]) for k, e in check.items())


def graph_phase(model, eval_tree, ckpt: str, nstations: int = LOFAR_STATIONS,
                ntime: int = 128, nfreq: int = 256) -> dict:
    """The graph networks (``lshm_tpu_torch.graph``) on the card from the float32
    full_khm checkpoint (latent 224 + 2 x 16, 10 clusters), at LOFAR's 62 stations: two
    SAPs of 1,953 baselines (``lofar_extract``; 128 x 256 channels, 2 patches a
    baseline).  Line graph: ``build_line_graph_data`` on SAP 0 (decoded on the card,
    K3 once per chunk of 8: 245 launches), 1,953 nodes, 236,437 edges, x [1953, 256],
    y [1953, 10]; ``train_line_graph`` for the CLI's 200 epochs, finite losses, the
    last below the first, then again from the same initial weights (the distance
    printed: ``index_add_`` sums with float atomics on the card).  Station graph:
    ``train_station_graph_epochs`` at the CLI's defaults over both SAPs (5 rebuilds x
    20 steps, edge MLP (256, 128)); each rebuild 62 nodes all masked in and 3,782 edges
    all populated, K3 123 times (615 in all); 100 finite losses, the mean of the last 20
    below the first 20's.  Each net on the card, at the trainer's initial weights and
    trained, against copies on the CPU with the same weights and graph: in float64
    within 1e-9; in float32 output and loss 1e-5, gradients 2e-5, or within twice the
    CPU float32's distance from float64 over 6 orders of the edges
    (``within_graph_gate``).  Then ``cli.main(["graph", "line"|"station", ...])`` in
    this process over the eval extract (``scan_files`` in ``lshm_tpu_torch.data``
    replaced for the phase, restored after), JAX's result lines.
    Records build seconds, each rebuild's read+decode and rest, ms per line epoch and
    per station step (CUDA events) and peak memory."""
    import contextlib
    import io
    import math
    import re

    import numpy as np

    from lshm_tpu_torch import cli
    from lshm_tpu_torch import data as data_mod
    from lshm_tpu_torch.data import read_metadata
    from lshm_tpu_torch.graph import (build_line_graph_data, station_graph_maps,
                                      train_line_graph,
                                      train_station_graph, train_station_graph_epochs)
    from lshm_tpu_torch.graph import train as gtrain
    from lshm_tpu_torch.kernels import launch_counts, reset_launches

    t0 = time.perf_counter()
    tree = lofar_extract(eval_tree, nstations, ntime, nfreq)
    nbase = nstations * (nstations + 1) // 2
    row = {"phase": "graph", "stations": nstations, "saps": 2, "baselines_per_sap": nbase,
           "time_x_freq": [ntime, nfreq], "extract_s": time.perf_counter() - t0,
           "extract_gb": sum(a.nbytes for g in tree["measurement"]["saps"].values()
                             for a in (g["visibilities"], g["visibility_scale_factors"]))
           / 1e9}
    bad = []

    def mse(pred, y):
        return torch.mean((pred - y) ** 2)

    def masked_mse(pred, y, mask):
        return torch.sum(mask * (pred - y) ** 2) / torch.clamp(torch.sum(mask), min=1.0)

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    # the line graph: built and trained 200 epochs, twice from the same initial weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    line = build_line_graph_data(model, tree, "0")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k3 = launch_counts()["head_fwd"]
    runs = []
    for _ in range(2):
        s, e = events()
        s.record()
        net, losses = train_line_graph(line)                 # 200 epochs, the card
        e.record()
        e.synchronize()
        runs.append((net, losses, s.elapsed_time(e)))
    (net, losses, ms), (net2, losses2, ms2) = runs
    sd, sd2 = net.state_dict(), net2.state_dict()
    dev = next(net.parameters()).device
    x, ei, y = (torch.from_numpy(a) for a in (line.x, line.edge_index, line.y))
    check = {"initial": card_vs_cpu(train_line_graph(line, epochs=0)[0], (x, ei), mse, (y,)),
             "trained": card_vs_cpu(net, (x, ei), mse, (y,))}
    row["line"] = {
        "nodes": int(line.x.shape[0]), "edges": int(line.edge_index.shape[1]),
        "x_shape": list(line.x.shape), "y_shape": list(line.y.shape),
        "build_s": build_s, "k3_launches": k3, "epochs": len(losses),
        "ms_per_epoch": [ms / len(losses), ms2 / len(losses2)],
        "loss_first_last": [losses[0], losses[-1]],
        "repeat": {"bit_identical": losses == losses2
                   and all(torch.equal(sd[k], sd2[k]) for k in sd),
                   "losses_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, losses2)),
                   "weights_rel": _state_distance(sd, sd2)},
        "card_vs_cpu": check, "device": str(dev),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    L = row["line"]
    K, D = model.khm.M.shape
    if (L["nodes"], L["edges"], L["x_shape"], L["y_shape"]) != (
            nbase, line_edges(nstations), [nbase, D], [nbase, K]):
        bad.append(f"the line graph's shape: {L}")
    if k3 != math.ceil(nbase / 8):
        bad.append(f"K3 launched {k3} times building the line graph, "
                   f"expected {math.ceil(nbase / 8)}")
    if not (all(math.isfinite(v) for v in losses + losses2) and losses[-1] < losses[0]):
        bad.append(f"the line graph's losses: {losses[0]} -> {losses[-1]}")
    if not all(map(within_graph_gate, check.values())):
        bad.append(f"LineGraphNet on the card against the CPU: {check}")

    # the station graph: 5 rebuilds x 20 steps over both SAPs, each rebuild timed
    stations, bmap = station_graph_maps(
        [read_metadata(tree, sap, give_baselines=True)[0] for sap in ("0", "1")])
    rebuilds, graphs, steps = [], [], []
    real_build, real_read = gtrain.build_station_graph_data, gtrain.read_baselines_patches_batch
    real_step = gtrain._make_station_step

    def timed_read(*a, **k):
        t = time.perf_counter()
        out = real_read(*a, **k)
        rebuilds[-1]["read_decode_s"] += time.perf_counter() - t
        return out

    def timed_build(model, source, sap, *a, **k):
        rebuilds.append({"sap": sap, "read_decode_s": 0.0})
        before = launch_counts()["head_fwd"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        data = real_build(model, source, sap, *a, **k)
        torch.cuda.synchronize()
        r = rebuilds[-1]
        r["s"] = time.perf_counter() - t
        r["rest_s"] = r["s"] - r["read_decode_s"]   # copies, the forward, the labels
        r.update(k3_launches=launch_counts()["head_fwd"] - before,
                 nodes=int(data.x.shape[0]), masked_in=int(data.node_mask.sum()),
                 edges=int(data.edge_index.shape[1]))
        graphs.append(data)
        return data

    def timed_steps(net, opt):
        step = real_step(net, opt)

        def timed(*a):
            s, e = events()
            s.record()
            loss = step(*a)
            e.record()
            steps.append((s, e))
            return loss

        return timed

    gtrain.build_station_graph_data, gtrain.read_baselines_patches_batch = timed_build, timed_read
    gtrain._make_station_step = timed_steps
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        snet, slosses = train_station_graph_epochs(model, [tree, tree], ["0", "1"],
                                                   stations, bmap)     # the card
    finally:
        gtrain.build_station_graph_data, gtrain.read_baselines_patches_batch = (
            real_build, real_read)
        gtrain._make_station_step = real_step
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k3 = launch_counts()["head_fwd"]
    step_ms = [s.elapsed_time(e) for s, e in steps]
    last = graphs[-1]
    sx, sei, sea, sy = (torch.from_numpy(a) for a in (last.x, last.edge_index,
                                                      last.edge_attr, last.y))
    smask = torch.from_numpy(last.node_mask.astype(np.float32))[:, None]
    check = {name: card_vs_cpu(n, (sx, sei, sea), masked_mse, (sy, smask),
                               shift_free=("conv.bias",))
             for name, n in (("initial", train_station_graph(last, epochs=0)[0]),
                             ("trained", snet))}
    rep = [train_station_graph(last) for _ in range(2)]      # 20 steps, the same start
    rsd = [n.state_dict() for n, _ in rep]
    row["station"] = {
        "stations": len(stations), "directed_edges": len(bmap), "wall_s": wall,
        "rebuilds": rebuilds, "k3_launches": k3, "steps": len(slosses),
        "ms_per_step_min_median_max": [min(step_ms), statistics.median(step_ms),
                                       max(step_ms)],
        "losses": slosses,
        "mean_first_last_20": [float(np.mean(slosses[:20])), float(np.mean(slosses[-20:]))],
        "repeat": {"bit_identical": rep[0][1] == rep[1][1]
                   and all(torch.equal(rsd[0][k], rsd[1][k]) for k in rsd[0]),
                   "losses_rel": max(abs(a - b) / abs(b) for a, b in zip(rep[0][1], rep[1][1])),
                   # conv.bias has a gradient of rounding noise alone, which Adam's
                   # normalised step turns into steps of lr: it is apart by itself
                   "weights_rel": _state_distance(
                       *({k: v for k, v in sd.items() if k != "conv.bias"} for sd in rsd)),
                   "bias_rel": rel_err(rsd[0]["conv.bias"], rsd[1]["conv.bias"])},
        "card_vs_cpu": check, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    S = row["station"]
    per_rebuild = math.ceil(nbase / 16)
    if (len(stations), len(bmap)) != (nstations, nstations * (nstations - 1)):
        bad.append(f"station maps: {len(stations)} stations, {len(bmap)} edges")
    for r in rebuilds:
        if (r["nodes"], r["masked_in"], r["edges"], r["k3_launches"]) != (
                nstations, nstations, len(bmap), per_rebuild):
            bad.append(f"a station rebuild: {r}")
    if len(rebuilds) != 5 or k3 != 5 * per_rebuild:
        bad.append(f"{len(rebuilds)} rebuilds, K3 {k3} (expected 5, {5 * per_rebuild})")
    if (len(slosses) != 100 or not all(math.isfinite(v) for v in slosses)
            or not S["mean_first_last_20"][1] < S["mean_first_last_20"][0]):
        bad.append(f"the station losses: {len(slosses)}, {S['mean_first_last_20']}")
    if not all(map(within_graph_gate, check.values())):
        bad.append(f"StationGraphNet on the card against the CPU: {check}")

    # the CLI, in this process, on the eval extract
    ns_eval = EVAL_STATIONS
    nb_eval = ns_eval * (ns_eval + 1) // 2
    want = {"line": (["--epochs", "20"],
                     rf"line graph: {nb_eval} nodes, {line_edges(ns_eval)} edges; "
                     r"loss (\S+) -> (\S+)", math.ceil(nb_eval / 8)),
            "station": (["--epochs", "2", "--steps-per-graph", "5"],
                        rf"station graph: {ns_eval} stations, 2 rebuilt graphs x 5 steps; "
                        r"loss (\S+) -> (\S+)", 2 * math.ceil(nb_eval / 16))}
    real_scan = data_mod.scan_files
    data_mod.scan_files = lambda *a, **k: ([eval_tree], ["0"])
    row["cli"] = {}
    try:
        for kind, (extra, pattern, k3_want) in want.items():
            out = io.StringIO()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.main(["graph", kind, "--data-dir", "in-memory", "--ckpt", ckpt, *extra])
            torch.cuda.synchronize()
            lines = out.getvalue().strip().splitlines()
            row["cli"][kind] = {"argv_extra": extra, "lines": lines,
                                "s": time.perf_counter() - t0,
                                "k3_launches": launch_counts()["head_fwd"]}
            m = re.fullmatch(pattern, lines[-1]) if len(lines) == 1 else None
            if (not m or not all(math.isfinite(float(v)) for v in m.groups())
                    or row["cli"][kind]["k3_launches"] != k3_want):
                bad.append(f"cli graph {kind}: {row['cli'][kind]} (K3 {k3_want})")
    finally:
        data_mod.scan_files = real_scan
    row["scan_files_restored"] = data_mod.scan_files is real_scan
    emit(row)
    if not row["scan_files_restored"]:
        bad.append("scan_files not restored")
    if bad:
        raise AssertionError("; ".join(bad))
    return row


# ----------------------------------------------------------------------- phase 20

DP_TIMEOUT = 420               # seconds for the ranks of one data-parallel run
DP_GATE = dict(atol=2e-5, rtol=1e-4)   # JAX's mesh against unsharded Trainer gate
                                       # (tests/test_trainer.py:192-208)


def _dp_argv(mode: str, root: str, *args: str) -> list[str]:
    """The command of one rank of phase 20: this script in child ``mode``, importing
    ``lshm_tpu_torch`` from the directory ``root``."""
    return [sys.executable, os.path.abspath(__file__), "--data-parallel", mode, root,
            *args]


def _loss_weights(cfg):
    from lshm_tpu_torch.train import LossWeights

    return LossWeights(alpha=cfg.loss.alpha, beta=cfg.loss.beta, gamma=cfg.loss.gamma,
                       rho=cfg.loss.rho, rica_lambda=cfg.loss.rica_lambda)


def dp_one_rank_child(tmpdir: str, backend: str) -> None:
    """Phase 20 (a), in a child process: a process group of one rank (NCCL) on the
    card; one full-width full_khm minibatch (420 patches, 12 groups, 10 ADMM iterations)
    from the same initial state through the plain Adam step, the data-parallel step and
    the fused step, in the order plain, data-parallel, fused, fused, data-parallel,
    plain; ms, launches, metrics and parameters of each, the all-reduce's values, and
    its time alone on the gradient buffer.  Writes one_rank.pt."""
    import torch.distributed as dist

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.device import use_exact_float32
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import init_train_state, make_train_step
    from lshm_tpu_torch.train.distributed import TIMEOUT, local_card
    from lshm_tpu_torch.train.parallel import AllReduceMean, make_data_parallel_step

    dev = local_card()
    torch.cuda.set_device(dev)
    use_exact_float32()
    dist.init_process_group(backend, init_method=f"file://{tmpdir}/store_one",
                            world_size=1, rank=0, timeout=TIMEOUT)
    try:
        tree = torch.load(os.path.join(tmpdir, "tree.pt"), weights_only=False)
        cfg = flagship_config(tmpdir)
        sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
        sampler.reseed(0)
        mb = sampler.sample()
        x, uv = (torch.from_numpy(a).to(dev) for a in (mb.x, mb.uv))
        w, nb, nadmm = _loss_weights(cfg), mb.num_baselines, cfg.train.admm_iters
        mean = AllReduceMean()
        steps = {"plain": make_train_step(cfg, nb),
                 "data_parallel": make_data_parallel_step(cfg, nb, mean),
                 "fused": make_train_step(cfg, nb, fused=True)}
        steps["plain"](init_train_state(cfg, dev), x, uv, w)     # warm-up
        mean([torch.zeros(1, device=dev)])     # NCCL builds its communicator here
        torch.cuda.synchronize()
        runs: dict[str, list] = {name: [] for name in steps}
        for name in ("plain", "data_parallel", "fused", "fused", "data_parallel", "plain"):
            state = init_train_state(cfg, dev)                 # the seed's initial state
            calls, values = mean.calls, mean.values
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = steps[name](state, x, uv, w)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / nadmm
            runs[name].append({
                "ms_per_admm_iter": ms, "launches": launch_counts(),
                "allreduce_calls": mean.calls - calls,
                "allreduce_values": mean.values - values,
                "metrics": {k: v.cpu() for k, v in metrics.items()},
                "params": {k: v.detach().clone() for k, v in state.model.state_dict().items()}})
        grads = [p.grad for g in state.opt.param_groups for p in g["params"]]
        n_grad = sum(g.numel() for g in grads)
        allreduce_ms = host_ms(lambda: mean(grads))
        torch.save({"runs": runs, "n_grad": n_grad, "allreduce_ms": allreduce_ms,
                    "patches": x.shape[0], "groups": nb,
                    "backend": dist.get_backend(), "world": dist.get_world_size()},
                   os.path.join(tmpdir, "one_rank.pt"))
    finally:
        dist.destroy_process_group()


def dp_two_ranks_child(tmpdir: str) -> None:
    """Phase 20 (b), in one of two child processes sharing the card, on a copy of the
    package whose build directory starts empty (both ranks build the kernels and the
    native decoder at once): a gloo group of two; a full-width Trainer on full_khm, 3
    minibatches x 10 ADMM iterations of 12 baselines x 35 patches on the rank's own
    sampler stream, decoding on the host (natively), a checkpoint after each minibatch;
    then a fresh Trainer loads the last one.  Writes two_ranks_<rank>.json and the
    rank's first minibatch."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from lshm_tpu_torch import native
    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import _build, launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.train.distributed import init_distributed
    from lshm_tpu_torch.utils import MetricLogger

    world = init_distributed(f"file://{tmpdir}/store_two", backend="gloo")
    rank = dist.get_rank()
    try:
        t0 = time.perf_counter()
        built = _build.build_all()
        native.library()
        build_s = time.perf_counter() - t0
        tree = torch.load(os.path.join(tmpdir, "tree.pt"), weights_only=False)
        ckpt = os.path.join(tmpdir, "dp_ckpt")
        cfg = flagship_config(ckpt)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 save_every_iters=1))
        sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
        twin = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
        twin.reseed(0)                                 # as Trainer.run's first epoch
        first = twin.sample()
        np.savez(os.path.join(tmpdir, f"first_{rank}.npz"), x=first.x, uv=first.uv,
                 num_baselines=first.num_baselines)
        logger = MetricLogger(echo=False)
        logged = []
        log_step = logger.log_step

        def recording(epoch, it, metrics, patches=None):
            logged.append({k: v.cpu().tolist() for k, v in metrics.items()})
            return log_step(epoch, it, metrics, patches=patches)

        logger.log_step = recording
        trainer = Trainer(cfg, logger=logger)         # device None: cuda:<LOCAL_RANK>
        sources = []
        pick = trainer._source
        trainer._source = lambda s: sources.append(pick(s)) or sources[-1]
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        summary = trainer.run(sampler)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        hist = logger.history
        steady_s = (hist[-1]["t"] - hist[0]["t"]) / (len(hist) - 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        loaded = Trainer(cfg, logger=MetricLogger(echo=False))
        loaded.load(ckpt)
        buf = torch.zeros(sum(p.numel() for p in trainer.model.parameters()),
                          device=trainer.device)
        allreduce_ms = host_ms(lambda: trainer._mean([buf]))
        row = {"rank": rank, "world": world, "world_size": trainer.world_size,
               "device": str(trainer.device), "process_index": sampler._process_index,
               "prefetcher": type(sources[0]).__name__,
               "host_decoder": "native" if sampler.use_native else "numpy",
               "built": built, "build_s": build_s, "summary": summary,
               "losses": [h["loss"] for h in hist], "patches": [h["patches"] for h in hist],
               "first_metrics": logged[0], "launches": counts, "wall_s": wall,
               "ms_per_admm_iter": steady_s / cfg.train.admm_iters * 1e3,
               "peak_mem_gb": peak, "digest": digest(trainer.model.state_dict().values()),
               "loaded_digest": digest(loaded.model.state_dict().values()),
               "loaded_step": loaded.state.step, "allreduce_ms": allreduce_ms,
               "allreduce_values": buf.numel(), "checkpoints": sorted(os.listdir(ckpt))}
        with open(os.path.join(tmpdir, f"two_ranks_{rank}.json"), "w") as f:
            json.dump(row, f)
    finally:
        dist.destroy_process_group()


def data_parallel_phase(dev, tree, tmpdir: str) -> dict:
    """Phase 20: the data-parallel step and Trainer held to the single-process results
    on the card with their collectives running, in child processes (this process never
    holds a process group): (a) one NCCL rank, (b) two gloo ranks sharing the card, then
    one process stepping the two ranks' first minibatches concatenated.  Two ranks on
    one card share its SMs: no number here is a scaling figure.  Returns the launch
    counts of (a)'s data-parallel and fused steps and of (b)'s rank 0."""
    import shutil

    import numpy as np

    from lshm_tpu_torch.tools.ranks import check_ranks, run_ranks
    from lshm_tpu_torch.train import init_train_state, make_train_step
    from lshm_tpu_torch.utils import restore_checkpoint

    from lshm_tpu_torch.device import use_exact_float32

    use_exact_float32()             # the single-process comparison below: full float32
    torch.cuda.empty_cache()        # the children share the card with this process
    torch.save(tree, os.path.join(tmpdir, "tree.pt"))    # the training extract, for the ranks

    # (a) one NCCL rank: plain, data-parallel and fused steps from one state
    here = os.path.dirname(os.path.abspath(__file__))
    check_ranks(run_ranks(_dp_argv("one_rank", here, tmpdir, "nccl"), 1, DP_TIMEOUT))
    one = torch.load(os.path.join(tmpdir, "one_rank.pt"), weights_only=False)
    runs = one["runs"]
    nadmm = len(runs["plain"][0]["metrics"]["loss"])

    def dist_(a, b):
        return {"metrics": max(rel_err(a["metrics"][k], b["metrics"][k])
                               for k in b["metrics"]),
                "params": _state_distance(a["params"], b["params"])}

    plain, dp, fused = runs["plain"][0], runs["data_parallel"][0], runs["fused"][0]
    run_to_run = {k: max(dist_(runs[n][1], runs[n][0])[k] for n in ("plain", "data_parallel"))
                  for k in ("metrics", "params")}
    dp_gap = dist_(dp, plain)
    fused_gap = {k: rel_err(fused["metrics"][k], plain["metrics"][k])
                 for k in plain["metrics"]}
    grad_bytes = one["n_grad"] * 4
    row_a = {"phase": "data_parallel_one_rank", "backend": one["backend"],
             "world": one["world"], "preset": "full_khm", "patches": one["patches"],
             "groups": one["groups"],
             "admm_iters": nadmm,
             "ms_per_admm_iter": {n: [r["ms_per_admm_iter"] for r in rs]
                                  for n, rs in runs.items()},
             "launches": {n: rs[0]["launches"] for n, rs in runs.items()},
             "allreduce_calls_per_minibatch": dp["allreduce_calls"],
             "allreduce_values_per_minibatch": dp["allreduce_values"],
             "grad_values_per_admm_iter": one["n_grad"],
             "grad_bytes_per_admm_iter": grad_bytes,
             "allreduce_ms_grad_buffer": one["allreduce_ms"],
             "run_to_run_distance": run_to_run, "data_parallel_vs_plain": dp_gap,
             "fused_vs_unfused_metric_rel_err": fused_gap}
    emit(row_a)
    for k in ("metrics", "params"):
        if dp_gap[k] != 0.0 if run_to_run[k] == 0.0 else dp_gap[k] > 2 * run_to_run[k]:
            raise AssertionError(f"the one-rank data-parallel step's {k} lie {dp_gap[k]} "
                                 f"from the plain step's (run to run {run_to_run[k]})")
    adam = {"khm_fwd": nadmm, "khm_bwd": nadmm, "head_fwd": 2 * nadmm, "head_bwd": nadmm}
    expect_launches(dp["launches"], adam, "one-rank data-parallel step")
    expect_launches(fused["launches"], {**adam, "head_fwd": nadmm}, "fused step")
    if dp["allreduce_calls"] != nadmm + 1 or dp["allreduce_values"] != (
            nadmm * one["n_grad"] + len(dp["metrics"]) * nadmm):
        raise AssertionError(f"expected {nadmm} gradient all-reduces and one of the "
                             f"metrics: {row_a}")
    if max(fused_gap.values()) > 1e-4:
        raise AssertionError(f"the fused step's metrics are off the unfused: {fused_gap}")

    # (b) two gloo ranks on one card, each a full-width Trainer, from a copy of the
    # package whose build directory is empty
    root = os.path.join(tmpdir, "copy")
    shutil.copytree(os.path.join(here, "lshm_tpu_torch"), os.path.join(root, "lshm_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    check_ranks(run_ranks(_dp_argv("two_ranks", root, tmpdir), 2, DP_TIMEOUT,
                          local_ranks=[0, 0]))
    r0, r1 = (json.load(open(os.path.join(tmpdir, f"two_ranks_{r}.json")))
              for r in range(2))
    built = sorted(os.listdir(os.path.join(root, "lshm_tpu_torch", "_build")))

    # one process on the two ranks' first minibatches concatenated (840 patches, 24
    # groups), from the same initial parameters
    firsts = [np.load(os.path.join(tmpdir, f"first_{r}.npz")) for r in range(2)]
    x = torch.from_numpy(np.concatenate([f["x"] for f in firsts])).to(dev)
    uv = torch.from_numpy(np.concatenate([f["uv"] for f in firsts])).to(dev)
    groups = int(sum(int(f["num_baselines"]) for f in firsts))
    cfg = flagship_config(tmpdir)
    state, metrics = make_train_step(cfg, groups)(init_train_state(cfg, dev), x, uv,
                                                  _loss_weights(cfg))
    ranked = {k: torch.tensor(v) for k, v in r0["first_metrics"].items()}
    metric_gap = {k: rel_err(ranked[k], metrics[k].cpu()) for k in metrics}
    after_first = restore_checkpoint(os.path.join(tmpdir, "dp_ckpt"), 1)[0]["params"]
    single = state.model.state_dict()
    excess = max(float(((after_first[k].to(dev) - single[k]).abs()
                        - (DP_GATE["atol"] + DP_GATE["rtol"] * single[k].abs())).max())
                 for k in single)
    param_dist = _state_distance({k: v.to(dev) for k, v in after_first.items()}, single)
    expected = {"khm_fwd": 3 * nadmm, "khm_bwd": 3 * nadmm, "head_fwd": 6 * nadmm,
                "head_bwd": 3 * nadmm}
    row_b = {"phase": "data_parallel_two_ranks", "backend": "gloo", "card": "cuda:0 shared",
             "note": "two ranks share one card's SMs: not a scaling figure",
             "ranks": [{k: r[k] for k in ("rank", "device", "process_index", "prefetcher",
                                          "host_decoder", "built", "build_s", "wall_s",
                                          "ms_per_admm_iter", "peak_mem_gb", "allreduce_ms",
                                          "allreduce_values", "launches", "patches")}
                       for r in (r0, r1)],
             "build_dir": built, "digests": [r0["digest"], r1["digest"]],
             "loaded_digests": [r0["loaded_digest"], r1["loaded_digest"]],
             "losses": r0["losses"], "checkpoints": r0["checkpoints"],
             "single_process_840": {"metric_rel_err": metric_gap,
                                    "param_rel_distance": param_dist,
                                    "gate": DP_GATE, "worst_excess_over_gate": excess}}
    emit(row_b)
    for r in (r0, r1):
        expect_launches(r["launches"], expected, f"rank {r['rank']} trainer")
        if (r["world"], r["world_size"], r["process_index"]) != (2, 2, r["rank"]):
            raise AssertionError(f"rank {r['rank']} did not train data-parallel: {r}")
        if r["prefetcher"] != "PrefetchIterator" or r["host_decoder"] != "native":
            raise AssertionError(f"rank {r['rank']} did not decode on the host natively")
    if r0["digest"] != r1["digest"] or r0["losses"] != r1["losses"]:
        raise AssertionError("the two ranks' parameters or losses differ")
    if not r0["loaded_digest"] == r1["loaded_digest"] == r0["digest"] or \
            r0["loaded_step"] != 3:
        raise AssertionError("rank 0's checkpoint did not load bit for bit on both ranks")
    if max(metric_gap.values()) > 1e-4 or excess > 0.0:
        raise AssertionError("the two ranks' first minibatch disagrees with one process "
                             f"on the concatenated batch: {row_b['single_process_840']}")
    return {"data_parallel": dp["launches"], "fused": fused["launches"],
            "two_ranks": r0["launches"]}


# ------------------------------------------------------------------------- phase 21

REWRITES = dict(fuse_1d=True, fast_conv1d=True, packed_conv2d=2)
# name: (model fields, train.remat, fused step, the variant it is held against)
REWRITE_VARIANTS = {
    "default": ({}, False, False, "default"),
    "fuse_1d": (dict(fuse_1d=True), False, False, "default"),
    "fast_conv1d": (dict(fast_conv1d=True), False, False, "default"),
    "packed_conv2d=2": (dict(packed_conv2d=2), False, False, "default"),
    "no_head": (dict(pallas_head=False), False, False, "default"),
    "packed_conv2d=6,no_head": (dict(packed_conv2d=6, pallas_head=False), False, False,
                                "no_head"),
    "remat": ({}, True, False, "default"),
    "all": (REWRITES, True, False, "default"),
    "fused,remat": ({}, True, True, "default"),
}


def _variant(cfg, name: str):
    import dataclasses

    model, remat, _, _ = REWRITE_VARIANTS[name]
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, remat=remat))


def rewrite_launches(nadmm: int, name: str) -> dict:
    """K1-K4 launches of one minibatch of ``nadmm`` ADMM iterations of variant
    ``name``: per iteration the objective's forward (K1, K3), its backward (K2, K4) and
    the dual update's forward (K3; none in the fused step); under remat the backward
    runs the objective's forward again (K1 and K3 once more; the fused step recomputes
    the model's forward only, K3); without the head no K3 or K4."""
    model, remat, fused, _ = REWRITE_VARIANTS[name]
    k1 = nadmm * (2 if remat and not fused else 1)
    k3 = nadmm * ((1 if fused else 2) + (1 if remat else 0))
    head = model.get("pallas_head", True)
    return {"khm_fwd": k1, "khm_bwd": nadmm, "head_fwd": k3 if head else 0,
            "head_bwd": nadmm if head else 0}


def rewrites_phase(dev, tree, tmpdir: str) -> dict:
    """Phase 21: the exact rewrites and remat at full width, each off by default.
    (a) one full_khm minibatch (420 patches, 12 groups, 10 ADMM iterations) from one
    initial state through the Adam step of each variant of ``REWRITE_VARIANTS``: per-term
    metrics within 1e-4 of the variant it is held against, K1-K4 launches as
    ``rewrite_launches`` derives them, ms per ADMM iteration (CUDA events) in two rounds
    in mirrored order, peak memory; (b) bfloat16_full with fuse_1d and fast_conv1d, its
    first ADMM iteration within JAX's bf16 gate of float32's; (c) the float32 L-BFGS
    closure with every rewrite and remat against the defaults (1e-4 / 2e-4), then one
    L-BFGS ADMM iteration of each; (d) recon_admm_losses at [420, 128, 128, 4] against
    autograd through the term-by-term form; (e) the Trainer with every rewrite and remat,
    1 epoch x 2 minibatches.  Returns (e)'s launch counts."""
    import dataclasses
    import math

    from lshm_tpu_torch import losses
    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.optim import value_and_grad
    from lshm_tpu_torch.tools.measure import time_ms
    from lshm_tpu_torch.train import (Duals, Trainer, active_params, init_lbfgs_train_state,
                                      init_train_state, lbfgs_objective,
                                      make_lbfgs_train_step, make_train_step,
                                      metrics_and_dual_update)
    from lshm_tpu_torch.utils import MetricLogger

    cfg = flagship_config(tmpdir)
    sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
    sampler.reseed(0)
    mb = sampler.sample()
    x, uv = (torch.from_numpy(a).to(dev) for a in (mb.x, mb.uv))
    w, nb, nadmm = _loss_weights(cfg), mb.num_baselines, cfg.train.admm_iters

    # (a) the Adam step of each variant
    names = list(REWRITE_VARIANTS)
    steps = {n: make_train_step(_variant(cfg, n), nb, fused=REWRITE_VARIANTS[n][2])
             for n in names}
    one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, admm_iters=1))
    for n in names:                                  # warm-up: one ADMM iteration each
        make_train_step(_variant(one, n), nb, fused=REWRITE_VARIANTS[n][2])(
            init_train_state(_variant(one, n), dev), x, uv, w)
    runs: dict[str, list] = {n: [] for n in names}
    for n in names + names[::-1]:
        state = init_train_state(_variant(cfg, n), dev)       # the seed's initial state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, metrics = steps[n](state, x, uv, w)
        end.record()
        torch.cuda.synchronize()
        runs[n].append({"ms": start.elapsed_time(end) / nadmm, "launches": launch_counts(),
                        "peak": torch.cuda.max_memory_allocated(),
                        "metrics": {k: v.cpu() for k, v in metrics.items()}})
        del state
    gaps = {n: max(rel_err(runs[n][0]["metrics"][k], runs[REWRITE_VARIANTS[n][3]][0]
                           ["metrics"][k]) for k in runs[n][0]["metrics"])
            for n in names}
    row_a = {"phase": "rewrites_adam", "preset": "full_khm", "patches": x.shape[0],
             "groups": nb, "admm_iters": nadmm,
             "held_against": {n: REWRITE_VARIANTS[n][3] for n in names},
             "ms_per_admm_iter": {n: [r["ms"] for r in runs[n]] for n in names},
             "peak_mem_gb": {n: [r["peak"] / 1e9 for r in runs[n]] for n in names},
             "metric_rel_err": gaps,
             "launches": {n: runs[n][0]["launches"] for n in names}}
    emit(row_a)
    for n in names:
        for r in runs[n]:
            expect_launches(r["launches"], rewrite_launches(nadmm, n), f"variant {n}")
    if max(gaps.values()) > 1e-4:
        raise AssertionError(f"a rewrite's metrics are off its reference: {gaps}")

    # (b) bfloat16_full with the 1D rewrites: the first ADMM iteration against float32's
    cfg_b = dataclasses.replace(one, model=dataclasses.replace(
        one.model, compute_dtype="bfloat16_full", fuse_1d=True, fast_conv1d=True))
    reset_launches()
    _, m_b = make_train_step(cfg_b, nb)(init_train_state(cfg_b, dev), x, uv, w)
    torch.cuda.synchronize()
    launched_b = launch_counts()
    f32 = {k: float(v[0]) for k, v in runs["default"][0]["metrics"].items()}
    bf16 = {k: float(v[0]) for k, v in m_b.items()}
    gap_b = {k: abs(f32[k] - bf16[k]) / (0.05 * abs(f32[k]) + 5e-3) for k in f32}
    emit({"phase": "rewrites_bf16", "flags": ["fuse_1d", "fast_conv1d"], "float32": f32,
          "bfloat16_full": bf16, "gap_over_gate": gap_b, "launches": launched_b})
    expect_launches(launched_b, {"khm_fwd": 1, "khm_bwd": 1, "head_fwd_bf16": 2,
                                 "head_bwd_bf16": 1, "head_fwd": 0, "head_bwd": 0},
                    "bf16 step with the 1D rewrites")
    if max(gap_b.values()) > 1.0:
        raise AssertionError(f"bf16 with the rewrites is outside JAX's gate: {gap_b}")

    # (c) the float32 L-BFGS closure and one ADMM iteration, every rewrite and remat
    cfg_l = lbfgs_config(compute_dtype="float32")
    cfg_l = dataclasses.replace(cfg_l, train=dataclasses.replace(cfg_l.train, admm_iters=1))
    cfg_lr = dataclasses.replace(
        cfg_l, model=dataclasses.replace(cfg_l.model, **REWRITES),
        train=dataclasses.replace(cfg_l.train, remat=True))
    wl = _loss_weights(cfg_l)
    closure, launched, lsteps, duals = {}, {}, {}, None
    for name, c in (("defaults", cfg_l), ("rewrites_remat", cfg_lr)):
        state = init_lbfgs_train_state(c, dev, "all")
        model = state.model
        if duals is None:    # non-zero duals: one dual update from the initial weights
            _, duals = metrics_and_dual_update(model, x, uv, Duals.zeros_like(x), wl, nb)
        params = active_params(model, "all")
        vg = value_and_grad(lbfgs_objective(c, nb))
        reset_launches()
        closure[name] = vg(params, model, {}, x, uv, duals, wl)
        torch.cuda.synchronize()
        launched[name] = {k: launch_counts()[k] for k in ADAM_PATH}
        lstep = make_lbfgs_train_step(c, nb, "all")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = lstep(state, x, uv, wl)
        torch.cuda.synchronize()
        lsteps[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                        "func_evals": state.opt.func_evals,
                        "host_syncs": state.opt.host_syncs, "loss": float(m["loss"][-1])}
    (vd, gd), (vr, gr) = closure["defaults"], closure["rewrites_remat"]
    grad_err = {n: rel_err(gr[n], gd[n]) for n in gd}
    worst = max(grad_err, key=grad_err.get)
    row_c = {"phase": "rewrites_lbfgs", "flags": {**REWRITES, "remat": True},
             "value_rel_err": rel_err(vr, vd), "grad_rel_err_max": grad_err[worst],
             "grad_worst": worst, "closure_launches": launched, "step": lsteps}
    emit(row_c)
    expect_launches(launched["defaults"], dict.fromkeys(ADAM_PATH, 1), "L-BFGS closure")
    expect_launches(launched["rewrites_remat"], {"khm_fwd": 2, "khm_bwd": 1, "head_fwd": 2,
                                                 "head_bwd": 1}, "remat L-BFGS closure")
    if row_c["value_rel_err"] > 1e-4 or row_c["grad_rel_err_max"] > 2e-4:
        raise AssertionError("the L-BFGS closure with the rewrites disagrees")

    # (d) recon_admm_losses against autograd through the term-by-term form
    gen = torch.Generator(device=dev).manual_seed(21)
    shape = (PATCHES, 128, 128, 4)
    xr, *rest = (torch.randn(shape, device=dev, generator=gen) for _ in range(7))
    a1, a2, a3, y1, y2, y3 = rest
    numel, rho = xr.numel(), 1.0
    wts = (1.0, 2.0, 3.0, 4.0)

    def term_form(b1, b2, b3):
        x11 = (xr - b1) * 0.5
        return (losses.mse_sum(b1 + b2 + b3, xr) / numel,
                losses.admm_term(y1, xr - b1, rho) / numel,
                losses.admm_term(y2, x11 - b2, rho) / numel,
                losses.admm_term(y3, x11 - b3, rho) / numel)

    forms = {"recon_admm_losses": lambda *b: losses.recon_admm_losses(*b, xr, y1, y2, y3, rho),
             "autograd": term_form}
    results, times = {}, {}
    for name, form in forms.items():
        def fwd_bwd():
            args = [a.detach().requires_grad_() for a in (a1, a2, a3)]
            terms = form(*args)
            sum(c * t for c, t in zip(wts, terms)).backward()
            return [t.detach() for t in terms], [a.grad for a in args]
        results[name] = fwd_bwd()
        times[name] = time_ms(fwd_bwd, repeats=10)
    (vf, gf), (va, ga) = results["recon_admm_losses"], results["autograd"]
    row_d = {"phase": "rewrites_recon_admm_losses", "shape": list(shape),
             "value_rel_err": [rel_err(p, q) for p, q in zip(vf, va)],
             "grad_rel_err": [rel_err(p, q) for p, q in zip(gf, ga)],
             "ms_fwd_bwd": times}
    emit(row_d)
    if max(row_d["value_rel_err"]) > 1e-6 or max(row_d["grad_rel_err"]) > 1e-5:
        raise AssertionError(f"recon_admm_losses disagrees with autograd: {row_d}")
    del xr, rest, a1, a2, a3, y1, y2, y3, results

    # (e) the Trainer with every rewrite and remat
    cfg_e = _variant(cfg, "all")
    cfg_e = dataclasses.replace(cfg_e, train=dataclasses.replace(cfg_e.train,
                                                                 iters_per_epoch=2))
    sampler = MinibatchSampler([tree], ["0"], cfg_e.data, seed=cfg_e.train.seed)
    logger = MetricLogger(echo=False)
    trainer = Trainer(cfg_e, logger=logger)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    summary = trainer.run(sampler)
    counts = launch_counts()
    hist = logger.history
    row_e = {"phase": "rewrites_trainer", "flags": {**REWRITES, "remat": True},
             "minibatches": len(hist), "losses": summary, "launches": counts,
             "ms_per_admm_iter": (hist[-1]["t"] - hist[0]["t"]) / nadmm * 1e3,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row_e)
    expect_launches(counts, {k: 2 * v for k, v in rewrite_launches(nadmm, "all").items()},
                    "Trainer with the rewrites")
    if len(hist) != 2 or not all(math.isfinite(v) for v in summary.values()):
        raise AssertionError(f"the Trainer with the rewrites did not train: {row_e}")
    return counts


# --------------------------------------------------------------------- phase 22

GRAPH_PRESETS = (("full_khm", ADAM_PATH), ("full_khm_bf16", BF16_PATH),
                 ("fourier_cascade", ADAM_PATH))


@contextlib.contextmanager
def _graphs_on(graphs: bool):
    """Inside the block the Adam step runs on CUDA graphs or, with ``graphs=False``,
    eagerly (``train/step.py::graphs_engage`` answering False)."""
    from lshm_tpu_torch.train import step as step_mod

    engage = step_mod.graphs_engage
    if not graphs:
        step_mod.graphs_engage = lambda x: False
    try:
        yield
    finally:
        step_mod.graphs_engage = engage


def _trainer_run(tree, tmpdir: str, name: str, graphs: bool, profile_dir=None) -> dict:
    """One ``trainer_phase``-sized run of preset ``name`` (3 minibatches x 10 ADMM
    iterations, no checkpoint), on CUDA graphs or eagerly (``_graphs_on``): the logger's
    losses, the parameters, K1-K6's launches, ``graph_counts`` and the ms between the
    last two records (the last minibatch: on graphs a replayed one)."""
    import dataclasses

    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.kernels import launch_counts, reset_launches
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.train import step as step_mod
    from lshm_tpu_torch.utils import MetricLogger

    cfg = flagship_config(tmpdir, name)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=""))
    sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
    logger = MetricLogger(echo=False)
    with _graphs_on(graphs):
        trainer = Trainer(cfg, logger=logger, profile_dir=profile_dir)
        reset_launches()
        step_mod.reset_graph_counts()
        trainer.run(sampler)
        torch.cuda.synchronize()
    hist = logger.history
    return {"losses": torch.tensor([[r[k] for k in sorted(r) if k not in
                                     ("epoch", "iter", "t", "patches")] for r in hist],
                                   dtype=torch.float64),
            "params": {k: v.detach().clone()
                       for k, v in trainer.model.state_dict().items()},
            "launches": launch_counts(), "graph_counts": step_mod.graph_counts(),
            "ms_last_minibatch": (hist[-1]["t"] - hist[-2]["t"]) * 1e3}


def _two_shapes_run(tree, tmpdir: str, graphs: bool) -> dict:
    """full_khm's Adam step (``flagship_config``) on minibatches of two shapes in
    turns, six: the sampler's first minibatch of 12 baselines and its first 6
    baselines (on graphs: eager, eager, capture, capture, replay, replay), eagerly
    with ``graphs=False`` (``_graphs_on``).  The parameters after, each minibatch's
    metrics, ``graph_counts`` and the peak of allocated memory (GB)."""
    from lshm_tpu_torch.data import MinibatchSampler
    from lshm_tpu_torch.train import init_train_state, make_train_step
    from lshm_tpu_torch.train import step as step_mod

    dev = torch.device("cuda")
    cfg = flagship_config(tmpdir)
    sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=cfg.train.seed)
    sampler.reseed(0)
    mb = sampler.sample()
    x, uv = (torch.from_numpy(a).to(dev) for a in (mb.x, mb.uv))
    nb = mb.num_baselines
    n = x.shape[0] // nb * (nb // 2)                 # baseline-major: the first half
    shapes = [(x, uv, nb), (x[:n].contiguous(), uv[:n].contiguous(), nb // 2)]
    w = _loss_weights(cfg)
    with _graphs_on(graphs):
        state = init_train_state(cfg, dev)
        step_mod.reset_graph_counts()
        torch.cuda.reset_peak_memory_stats()
        metrics = []
        for xb, uvb, g in shapes * 3:
            state, m = make_train_step(cfg, g)(state, xb, uvb, w)
            metrics.append(torch.stack([m[k] for k in sorted(m)]).double())
        torch.cuda.synchronize()
    return {"params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "losses": torch.stack(metrics).cpu(), "graph_counts": step_mod.graph_counts(),
            "keys": len(state.graphs), "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def cuda_graph_phase(tree, tmpdir: str) -> dict:
    """The Adam step on CUDA graphs against the eager step, three minibatches of a
    Trainer for each of full_khm (float32), full_khm_bf16 (bfloat16_full) and
    fourier_cascade: eager twice (the card's run-to-run distance), then on graphs.
    The graph run lies no farther from the first eager run than twice that distance,
    in the parameters and in each minibatch's logged losses (bit for bit where the
    two eager runs are); K1-K4 launch as often; one capture, 2 x 10 x 2 replays and
    the first minibatch's 10 eager iterations.  Then full_khm's step on two shapes in
    turns (``_two_shapes_run``), held the same way, with a capture and a pair of
    graphs per shape and no eager iteration after each shape's first minibatch.  Then
    a full_khm graph run under
    ``--profile-dir`` (the profiler on before the capture): its trace holds K1-K4's
    kernels as often as their counters say, and cuDNN's."""
    import json

    row = {"phase": "cuda_graph"}
    bad = []
    for name, path in GRAPH_PRESETS:
        eager, again, graphs = (_trainer_run(tree, tmpdir, name, g)
                                for g in (False, False, True))
        run_to_run = max(_state_distance(again["params"], eager["params"]),
                         rel_err(again["losses"], eager["losses"]))
        gap = max(_state_distance(graphs["params"], eager["params"]),
                  rel_err(graphs["losses"], eager["losses"]))
        launches = {k: graphs["launches"][k] for k in path}
        row[name] = {"run_to_run": run_to_run, "graphs_vs_eager": gap,
                     "launches": launches, "graph_counts": graphs["graph_counts"],
                     "eager_graph_counts": eager["graph_counts"],
                     "ms_last_minibatch": {"eager": eager["ms_last_minibatch"],
                                           "graphs": graphs["ms_last_minibatch"]}}
        if (gap != 0.0 if run_to_run == 0.0 else gap > 2 * run_to_run):
            bad.append(f"{name}: graphs {gap} from eager (run to run {run_to_run})")
        if launches != {k: eager["launches"][k] for k in path}:
            bad.append(f"{name}: launches {launches} against eager {eager['launches']}")
        if graphs["graph_counts"] != {"captures": 1, "replays": 40, "eager_iters": 10}:
            bad.append(f"{name}: graph counts {graphs['graph_counts']}")
        if eager["graph_counts"] != {"captures": 0, "replays": 0, "eager_iters": 30}:
            bad.append(f"{name}: eager counts {eager['graph_counts']}")

    eager, again, graphs = (_two_shapes_run(tree, tmpdir, g) for g in (False, False, True))
    run_to_run = max(_state_distance(again["params"], eager["params"]),
                     rel_err(again["losses"], eager["losses"]))
    gap = max(_state_distance(graphs["params"], eager["params"]),
              rel_err(graphs["losses"], eager["losses"]))
    row["two_shapes"] = {"run_to_run": run_to_run, "graphs_vs_eager": gap,
                         "graph_counts": graphs["graph_counts"], "keys": graphs["keys"],
                         "peak_gb": {"eager": eager["peak_gb"], "graphs": graphs["peak_gb"]}}
    if (gap != 0.0 if run_to_run == 0.0 else gap > 2 * run_to_run):
        bad.append(f"two shapes: graphs {gap} from eager (run to run {run_to_run})")
    if (graphs["graph_counts"] != {"captures": 2, "replays": 80, "eager_iters": 20}
            or graphs["keys"] != 2):
        bad.append(f"two shapes: {row['two_shapes']}")

    prof = os.path.join(tmpdir, "graph_profile")
    traced = _trainer_run(tree, tmpdir, "full_khm", True, profile_dir=prof)
    with open(os.path.join(prof, "trace_epoch_0.json")) as f:
        kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    named = {k: sum(n in name for name in kernels) for k, n in TRACE_NAMES.items()}
    cudnn = sum("cudnn" in name or "xmma" in name for name in kernels)
    row["profile"] = {"kernel_events": len(kernels), "named": named, "cudnn": cudnn,
                      "launches": {k: traced["launches"][k] for k in ADAM_PATH},
                      "graph_counts": traced["graph_counts"]}
    emit(row)
    if named != row["profile"]["launches"] or cudnn == 0:
        bad.append(f"the trace of a graph run: {row['profile']}")
    if bad:
        raise AssertionError("; ".join(bad))
    return row


def data_parallel_child(mode: str, root: str, *args: str) -> int:
    """The entry of a child of phase 20 (``_dp_argv``)."""
    sys.path.insert(0, root)
    {"one_rank": dp_one_rank_child, "two_ranks": dp_two_ranks_child}[mode](*args)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--data-parallel"]:   # a rank of phase 20
        return data_parallel_child(*sys.argv[2:])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lshm_tpu_torch import native
    from lshm_tpu_torch.data import synth_extract
    from lshm_tpu_torch.device import use_exact_float32
    from lshm_tpu_torch.kernels import _build
    from lshm_tpu_torch.tools.measure import card

    dev = torch.device("cuda")
    use_exact_float32()
    smi = card()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn": torch.backends.cudnn.allow_tf32})

    t0 = time.perf_counter()
    per_source = _build.build_all()
    t1 = time.perf_counter()
    native.library()                  # the host decoder: a failed build raises here
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "per_source_s": per_source,
          "native_decoder_s": time.perf_counter() - t1, "compiler": native.compiler()})

    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        """fn(*args), its host seconds recorded under ``name``."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    def in_tmpdir(fn, *args):
        with tempfile.TemporaryDirectory() as tmpdir:
            return fn(*args, tmpdir)

    kernels = timed("parity", lambda: khm_phase(dev) + head_phase(dev))
    tree = timed("data", lambda: synth_extract(nstations=5, ntime=384, nfreq=512, seed=0))
    eval_tree = timed("eval_data", lambda: synth_extract(
        nstations=EVAL_STATIONS, ntime=384, nfreq=512, seed=1))
    emit({"phase": "data", "baselines": int(tree["measurement"]["saps"]["0"]
                                            ["visibilities"].shape[0]),
          "eval_baselines": int(eval_tree["measurement"]["saps"]["0"]
                                ["visibilities"].shape[0])})
    timed("device_decode", device_decode_phase, dev, tree)
    def trainer_and_agree(tmpdir):
        counts = trainer_decodes_phase(tree, tmpdir)
        agree_phase(tree, tmpdir)
        return counts

    adam = timed("trainer", in_tmpdir, trainer_and_agree)
    adam_bf16 = timed("trainer_bf16", in_tmpdir, lambda d: trainer_bf16_phase(tree, d))
    fourier = timed("trainer_fourier", in_tmpdir, lambda d: trainer_fourier_phase(tree, d))
    kernels += timed("dft", dft_phase, dev)
    timed("dft_profile", in_tmpdir, lambda d: dft_profile_phase(tree, d))
    head = timed("head_input_grad", head_input_grad_phase, dev)
    probe, k6_rows = timed("conv0_probe", conv0_probe_phase, dev)
    kernels += k6_rows
    lbfgs = timed("lbfgs", in_tmpdir, lambda d: lbfgs_phase(dev, tree, d))
    timed("agree_lbfgs", agree_lbfgs_phase, dev, tree)

    def from_checkpoint(tmpdir):
        """Train, cut and resume (phase 13), then evaluate (14), export (15) and build
        and train the graph networks from (19) the resumed run's final checkpoint."""
        ckpt = timed("resume", resume_phase, tree, tmpdir)
        model, evals = timed("eval", eval_phase, eval_tree, ckpt)
        export = timed("export", export_phase, model, eval_tree)
        return evals, export, timed("graph", graph_phase, model, eval_tree, ckpt)

    evals, export, graph = in_tmpdir(from_checkpoint)
    cli_row = timed("cli", in_tmpdir, lambda d: cli_phase(tree, d))
    timed("native_decode", native_decode_phase, tree, eval_tree)
    timed("rica", in_tmpdir, lambda d: rica_phase(tree, d))
    dp = timed("data_parallel", in_tmpdir, lambda d: data_parallel_phase(dev, tree, d))
    rewrites = timed("rewrites", in_tmpdir, lambda d: rewrites_phase(dev, tree, d))
    timed("cuda_graph", in_tmpdir, lambda d: cuda_graph_phase(tree, d))
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})

    # launches on each kernel's own path: K1-K4 the Adam trainer (the main path; K1/K2
    # at D = 288 the Fourier trainer), the bf16 K3 and K4 the bf16 Adam trainer (their
    # counts on the bf16 L-BFGS recipe beside), K5 EncHead's backward w.r.t. its input
    # in either dtype, K6 the probe tool in either dtype
    runs = {"trainer": adam, "trainer_bf16": adam_bf16, "trainer_fourier": fourier,
            "head_input_grad": head, "conv0_probe": probe}
    bf16_trainer = {"head_fwd_bf16", "head_bwd_bf16"}
    for k in kernels:
        counter = k.pop("counter")
        path = k.pop("path", "trainer_bf16" if counter in bf16_trainer else "trainer")
        k["launches"] = runs[path][counter]
        k["path"] = path
        k["on_main_path"] = path in ("trainer", "trainer_bf16", "trainer_fourier")
        k["launches_fourier"] = fourier[counter]
        if counter in lbfgs:
            k["launches_lbfgs"] = lbfgs[counter]
        if path == "trainer":         # K1-K4 through the CLI: train, then --resume
            k["launches_cli"] = {n: cli_row[n]["launches"][counter]
                                 for n in ("train", "resume")}
            # one minibatch of the one-rank data-parallel and fused steps; rank 0 of the
            # two-rank Trainer (3 minibatches)
            k["launches_data_parallel"] = {n: dp[n][counter]
                                           for n in ("data_parallel", "fused", "two_ranks")}
            # the Trainer with every exact rewrite and remat (2 minibatches)
            k["launches_rewrites"] = rewrites[counter]
        if counter in ("head_fwd", "head_fwd_bf16"):   # K3: per chunk, per exported call
            ev = evals["float32" if counter == "head_fwd" else "bfloat16_full"]
            k["launches_eval"] = {"device_decode": ev["k3_launches"],
                                  "host_decode": ev["host_decode"]["k3_launches"]}
        if counter == "head_fwd":
            k["launches_export"] = [export[f"batch_{n}"]["k3_launches"] for n in (35, 96)]
            k["launches_cli_export"] = cli_row["export"]["k3_launches"]
            k["launches_graph"] = {n: graph[n]["k3_launches"] for n in ("line", "station")}
        k["status"] = "ported, held against its plain version"
    emit({"kernels": kernels, "still_to_port": []})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
