"""Configuration dataclasses for the PyTorch/CUDA port of LSHM.

A field-for-field copy of ``lshm_tpu/config.py``: the same dataclasses, presets and
``section.key=value`` override syntax, so a preset name or an override string means the
same experiment in both packages.  Two defaults differ (``ModelConfig.khm_backend`` and
``ModelConfig.pallas_head``, see their comments): the JAX defaults were chosen from TPU
measurements, and on the GPU those two fields select the hand-written CUDA kernels.

Fields whose code the port does not have yet are rejected by ``check_supported`` with
``NotImplementedError`` naming the field, never silently ignored.  The long comments on
the TPU-only layout rewrites are kept from the JAX file because they explain what those
fields mean; their timings are TPU v5e measurements, not the port's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class DataConfig:
    """Input-pipeline configuration (reference: src/lofar_tools.py:51-211).

    ``num_channels``: 4 = (re,im) of XX and YY; 8 = (re,im) of XX,XY,YX,YY.
    ``patch_size``: square patch edge; patches overlap 50% (stride = patch_size // 2).
    ``clamp``: clip magnitude applied after patching (reference uses 1e3 in training,
    1e6 in the per-baseline eval reader).
    """

    data_dir: str = ""
    file_pattern: str = "L*.MS_extract.h5"
    recursive_search: bool = True
    batch_size: int = 12              # baselines per minibatch
    patch_size: int = 128
    num_channels: int = 4
    normalize: bool = True            # global z-score over the minibatch
    clamp: float = 1e3
    uvdist: bool = True               # compute per-baseline (u,v) in wavelengths
    augment: bool = False             # double data with an augmentation transform
    prefetch: int = 2                 # host->device prefetch depth
    # Copy raw int8 + scales to the device and decode/patchify/augment there
    # (data/device_decode.py, in the prefetcher data/sampler.py::
    # DeviceDecodePrefetcher) instead of copying decoded float32 patches: 5.8x fewer
    # bytes a full-width minibatch, 11.6x with augmentation.  None = auto: on when the
    # Trainer's device is CUDA and the augment transform is the default (its rng flip
    # decisions travel as flags); True requires it (and prefetch > 0), False keeps
    # the host decode.  The data stream is the host decode's (same rng draws), so
    # checkpoints and exact resume are interchangeable between the two.
    device_decode: bool | None = None

    def __post_init__(self):
        assert self.num_channels in (4, 8), "num_channels must be 4 or 8"


@dataclass(frozen=True)
class ModelConfig:
    """Model topology (reference: src/lofar_models.py:12-184, src/kharmonic_lofar.py:37-57)."""

    latent_dim: int = 224             # L: 2D AE latent
    latent_dim_1d: int = 16           # Lt: 1D AE latents (time & freq axes)
    num_channels: int = 4             # input channels: 4 (XX,YY re/im) or 8 (all pols)
    num_clusters: int = 10            # Kc
    khm_order: int = 4                # Khp: p in 1/||.||^p
    harmonic_scales: tuple[float, ...] = (1e-4, 1e-3, 1e-2, 1e-1)
    rica: bool = True                 # reconstruction-ICA sparse latent heads
    # KHM loss backend.  "xla" = the plain tensor expression (losses.khm_loss, the
    # port of the JAX function of that name); "pallas" and "auto" = the fused KHM
    # kernel with its analytic backward (kernels/khm.py): the CUDA kernel for a CUDA
    # tensor, its plain PyTorch version for a CPU tensor.  Default "auto" in the
    # port (JAX: "xla"): the JAX default was a TPU measurement, and on the GPU this
    # field is what routes the main path through the hand-written kernel.
    khm_backend: str = "auto"
    # compute dtype for conv/dense activations
    # ("float32" | "bfloat16" | "bfloat16_full"); params stay f32 in all modes.
    # bfloat16 feeds the v5e MXU natively (f32 convs lower to multi-pass bf16) but
    # keeps the full-resolution residual/loss path in f32.  bfloat16_full also casts
    # the input batch (and therefore the AE outputs, residuals and ADMM duals) to
    # bf16 — the flagship step is HBM-bandwidth-bound on those ~110 MB arrays, so
    # halving their width is the single biggest throughput lever; every loss still
    # accumulates in f32 (lshm_tpu/losses.py::_f32).
    compute_dtype: str = "float32"
    # Run the two identical-topology 1D AEs (time-major aeT + freq-major aeF) as one
    # grouped-convolution stack: exact same math (parity-tested), half the 1D op
    # count, double the channel width per op.  Param tree / checkpoints / importer
    # are unchanged — the fusion reads the aeT/aeF subtrees at apply time.
    # DEFAULT OFF — measured negative result on TPU v5e (2026-08-17): the fused
    # flagship step timed 22.5 ms/ADMM-iter vs 14.4 unfused (XLA lowers
    # feature_group_count=2 convs worse than two separate thin convs here).
    fuse_1d: bool = False
    # Exact rewrites of the 1D AEs' stride-4 ops (packed-view conv backward +
    # Dense-as-ConvTranspose; see lshm_tpu/models/autoencoders.py). Same math and
    # param tree, parity-tested.  DEFAULT OFF — measured negative IN-GRAPH on TPU
    # v5e (2026-08-17, bf16_full flagship batch 420): packed-bwd convs 39.0k vs
    # 41.0k patches/s, Dense tconv 28.8-30.5k — even though standalone op probes
    # showed 1.5-2.4x backward wins; composed with the surrounding bias/ELU/cotangent
    # fusions XLA's native conv lowering is better.
    fast_conv1d: bool = False
    # Space-to-depth packed rewrite of the 2D AE's outermost stride-2 conv stages
    # (encoder conv0..conv{n-1}, decoder tconv{6-n}..tconv5): exact math, identical
    # param tree (lshm_tpu/models/autoencoders.py::conv2d_s2_packed).  The k=4, s=2,
    # p=1 geometry packs with zero tap duplication, so the full-resolution layers —
    # where the step's HBM traffic lives — run with 4x the channel (lane) width.
    # DEFAULT OFF — measured composed-step NEGATIVE on TPU v5e (2026-08-18,
    # bf16_full flagship batch 420): depths 1/2/3 all ~12-13% below the depth-0
    # control (36.5/36.0/35.8k vs 41.3k patches/s) — the s2d/d2s copies break more
    # fusion than the lane packing wins (benchmarks/packed_conv2d_report.json).
    packed_conv2d: int = 0
    # Fused kernel for the 2D AE's two outermost encoder stages (conv0 + ELU +
    # conv1 + ELU in one pass, with a rematerialising backward for the weight
    # gradients — kernels/conv_head.py, CUDA for a CUDA tensor, the plain PyTorch
    # version for a CPU tensor).  Same math and parameters as the strided stages.
    # Default True in the port (JAX: False, a TPU measurement): on the GPU this
    # field routes the main path through the hand-written kernel.
    pallas_head: bool = True
    # legacy pipeline (reference Demo.ipynb): second 2D AE on the FFT of the residual
    # instead of the two 1D AEs.
    fourier_variant: bool = False
    latent_dim_fourier: int = 64      # latent of the legacy Fourier-space 2D AE

    @property
    def total_latent_dim(self) -> int:
        if self.fourier_variant:
            return self.latent_dim + self.latent_dim_fourier
        return self.latent_dim + 2 * self.latent_dim_1d


@dataclass(frozen=True)
class LossConfig:
    """Loss weights (reference: src/kharmonic_lofar.py:41-48)."""

    alpha: float = 0.01               # K-harmonic clustering loss weight
    beta: float = 0.01                # cluster-similarity (contrastive) penalty
    gamma: float = 0.01               # augmentation (intra-baseline) penalty
    rho: float = 1.0                  # ADMM penalty parameter
    rica_lambda: float = 0.01         # log-cosh L1 weight on sparse latents


@dataclass(frozen=True)
class LBFGSConfig:
    """Jittable L-BFGS hyperparameters (reference: src/lbfgsnew.py:61-69)."""

    lr: float = 1.0
    max_iter: int = 4
    history_size: int = 7
    tolerance_grad: float = 1e-5
    tolerance_change: float = 1e-9
    line_search: bool = True
    batch_mode: bool = True           # stochastic variant with variance-damped max step
    # Unroll the outer L-BFGS iteration (max_iter slots) into straight-line XLA with
    # done-masking instead of a lax.while_loop — the optimizer-level analog of
    # TrainConfig.admm_unroll.  ``done`` is sticky, so slot i is either exactly
    # iteration i+1 or a discarded no-op; trajectories match the while lowering
    # bit-for-bit (tests/test_lbfgs.py::test_unroll_outer_matches_while).  The line
    # searches inside each slot keep their (data-dependent) while loops.
    # Measured on the flagship closure (TPU v5e, 2026-08-19, benchmarks/
    # lbfgs_decompose.py + lbfgs_ab.py): the while-loop lowering costs the
    # value_and_grad body ~1.18x in isolation (12.56 vs 10.66 ms/eval inside vs
    # outside a while region) but the COMPOSED optimizer step is neutral (82.96 vs
    # 83.28 ms/step) — the data-dependent line-search whiles still partition the
    # program either way, so nothing like the 6.4x ADMM-scan pessimization applies.
    # DEFAULT OFF (honest neutral): compile time scales with max_iter (each slot
    # clones the line-search while bodies), pathological for large-max_iter
    # full-batch configs (tests use up to 50), and the unrolled lowering buys no
    # measured throughput.  Kept as a bit-parity-tested alternative lowering
    # (tests/test_lbfgs.py::test_unroll_outer_matches_while).
    unroll_outer: bool = False        # the port's eager loop is its one lowering:
                                      # accepted, no effect (lshm_tpu_torch/optim/lbfgs.py)
    # Keep gradient machinery enabled during line-search probes (reference:
    # src/lbfgsnew.py:61-69,686-693).  In the reference this is required when the cost
    # itself consumes gradients (e.g. a gradient-norm regularizer) because probes run
    # under torch.set_grad_enabled(False); in JAX a pure value closure may always call
    # jax.grad internally, so False never breaks such costs — True only reproduces the
    # reference's costlier probe path (probes evaluate value_and_grad, grad discarded).
    cost_use_gradient: bool = False
    # backtracking line-search constants (reference: src/lbfgsnew.py:127-131)
    ls_c1: float = 1e-4
    ls_max_steps: int = 35
    # cubic (strong-Wolfe) line-search constants (reference: src/lbfgsnew.py:203-209)
    cubic_sigma: float = 0.1
    cubic_rho: float = 0.01
    cubic_t1: float = 9.0
    cubic_t2: float = 0.1
    cubic_t3: float = 0.5
    cubic_step: float = 1e-6          # finite-difference step
    trust_region_lm0: float = 1e-6    # batch-mode damping y += lm0*s


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer selection + alternating-update schedule.

    The reference alternates which of the three model groups (2D CNN / 1D CNNs / KHM head)
    is trained by hand-editing the parameter list (src/kharmonic_lofar.py:86-90) and by
    switching Adam <-> LBFGS by editing line :92-93.  Here both are config.

    ``group_schedule``: sequence of group names cycled per epoch; each entry is one of
    "ae2d", "ae1d", "khm", "all".  Empty = train everything jointly.
    """

    optimizer: str = "adam"           # "adam" | "lbfgs"
    adam_lr: float = 1e-4
    lbfgs: LBFGSConfig = field(default_factory=LBFGSConfig)
    group_schedule: tuple[str, ...] = ()

    def __post_init__(self):
        assert self.optimizer in ("adam", "lbfgs")
        for g in self.group_schedule:
            assert g in ("ae2d", "ae1d", "khm", "all"), g


@dataclass(frozen=True)
class RampStage:
    """One stage of the published training recipe (reference README.md:24-30):
    alpha=beta=gamma ramp 0.001 -> 0.01 -> 0.1 with an Adam -> LBFGS switch."""

    epochs: int = 1
    alpha: float = 0.001
    beta: float = 0.001
    gamma: float = 0.001
    optimizer: str = "adam"


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 5               # reference: src/kharmonic_lofar.py:26
    iters_per_epoch: int = 80         # Niter
    admm_iters: int = 10              # Nadmm
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    save_every: int = 0               # epochs between checkpoints; 0 = only at end
    save_every_iters: int = 0         # mid-epoch checkpoint cadence (iters); 0 = off.
                                      # Resume is exact either way: the sampler stream
                                      # is repositioned to (epoch, iter) via skip()
    log_every: int = 1
    ramp: tuple[RampStage, ...] = ()  # optional published recipe; overrides LossConfig weights
    # parallelism: one process per card (torchrun, or the CLI's multi-host flags);
    # a run of several processes splits the batch over every rank on mesh_axes[0]
    # (train/parallel.py: data_parallel_layout checks this shape against the world
    # size; every axis but the first is 1).  One process with a product > 1 raises.
    mesh_shape: tuple[int, ...] = (1,)
    mesh_axes: tuple[str, ...] = ("data",)
    precision: str = "float32"        # compute dtype for conv/matmul inputs
    remat: bool = False               # jax.checkpoint the cascade forward (trade FLOPs
                                      # for HBM when patch batches grow large)
    # Unroll the ADMM inner loop into straight-line XLA instead of lax.scan.
    # Measured on TPU v5e (benchmarks/decompose.py, 2026-08-17): the identical
    # iteration body runs 6.4x SLOWER inside the while-loop lowering (79 vs 12.3
    # ms/iter at batch 420) — loop-body layout/fusion pessimization — so unrolling
    # is a pure win for the static, small admm_iters counts used here (compile time
    # scales with admm_iters; the math is identical either way).
    # In the port the ADMM loop is a Python loop whichever value this has: the
    # field (like precision, mesh_axes and admm_unroll_lbfgs) is kept so that
    # override strings stay valid in both packages.
    admm_unroll: bool = True
    # L-BFGS path override for admm_unroll (None = inherit).  Unlike the Adam body,
    # the L-BFGS iteration is dominated by its data-dependent line-search while
    # loops, which partition the program either way — unrolling is perf-NEUTRAL
    # there (83.0 vs 83.3 ms/iter, benchmarks/lbfgs_decompose.py round 4) while
    # compile time scales with admm_iters (148 s at nadmm=2 unrolled).  Set False
    # to lower the L-BFGS ADMM loop as one lax.scan: same math and speed,
    # admm_iters-independent compile (the full-recipe default via the
    # full_khm_lbfgs preset and benchmarks/recipe_run.py).
    admm_unroll_lbfgs: bool | None = None   # the port: accepted, no effect (as admm_unroll)
    skip_nonfinite: bool = True       # drop minibatches whose step produced NaN/Inf loss
                                      # (keep previous state) — the explicit version of
                                      # the reference's scattered NaN tolerance


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def __post_init__(self):
        assert self.data.num_channels == self.model.num_channels, (
            "data.num_channels and model.num_channels must agree "
            f"({self.data.num_channels} != {self.model.num_channels})"
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


COMPUTE_DTYPES = ("float32", "bfloat16", "bfloat16_full")


def _raise_unsupported(root: Any, prefix: str, unsupported: list) -> None:
    for name, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"{prefix}{name}={_get(root, name)!r} is not ported to lshm_tpu_torch yet")


def check_model_supported(m: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the first model field whose code the port
    does not have yet (the JAX package implements all of them)."""
    _raise_unsupported(m, "model.", [
        ("fuse_1d", m.fuse_1d),
        ("fast_conv1d", m.fast_conv1d),
        ("packed_conv2d", m.packed_conv2d > 0),
    ])
    if m.khm_backend not in ("xla", "pallas", "auto"):
        raise ValueError(f"model.khm_backend={m.khm_backend!r}")
    if m.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"model.compute_dtype={m.compute_dtype!r}: one of {COMPUTE_DTYPES}")


def check_supported(cfg: Config) -> None:
    """``check_model_supported`` plus the data, optimizer and training fields."""
    check_model_supported(cfg.model)
    _raise_unsupported(cfg, "", [("train.remat", cfg.train.remat)])


def _get(root: Any, path: str) -> Any:
    node: Any = root
    for k in path.split("."):
        node = getattr(node, k)
    return node


def _apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``section.key=value`` overrides, e.g. ``data.batch_size=4``."""
    out = cfg
    for ov in overrides:
        path, _, raw = ov.partition("=")
        keys = path.strip().split(".")
        node = out
        parents = []
        for k in keys[:-1]:
            parents.append((node, k))
            node = getattr(node, k)
        cur = getattr(node, keys[-1])
        if isinstance(cur, bool):
            val: Any = raw.strip().lower() in ("1", "true", "yes")
        elif isinstance(cur, int):
            val = int(raw)
        elif isinstance(cur, float):
            val = float(raw)
        elif isinstance(cur, tuple):
            if not raw:
                val = ()
            else:
                # element type from the current value when non-empty; empty tuples
                # (group_schedule, harmonic_scales overrides on fresh configs) parse as
                # str unless every element looks numeric
                if cur:
                    elem_t = type(cur[0])
                else:
                    try:
                        [float(v) for v in raw.split(",")]
                        elem_t = float
                    except ValueError:
                        elem_t = str
                if cur and not isinstance(cur[0], (str, int, float, bool)):
                    raise ValueError(
                        f"cannot override structured tuple field {path!r} from the CLI"
                    )
                val = tuple(elem_t(v) for v in raw.split(","))
        elif cur is None:
            # None-default fields (device_decode, admm_unroll_lbfgs, ...) carry no
            # type to coerce to: parse the literal (none/bool/number), else string
            r = raw.strip().lower()
            if r in ("none", "null", "auto", ""):
                val = None
            elif r in ("true", "yes"):
                val = True
            elif r in ("false", "no"):
                val = False
            else:
                try:
                    val = int(raw)
                except ValueError:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
        else:
            val = raw
        node = dataclasses.replace(node, **{keys[-1]: val})
        for parent, k in reversed(parents):
            node = dataclasses.replace(parent, **{k: node})
        out = node
    return out


# Named presets mirroring BASELINE.json "configs".
def preset(name: str) -> Config:
    base = Config()
    if name == "ae2d_adam":          # config #1: 2D AE alone, Adam, recon loss only
        return base.replace(
            loss=LossConfig(alpha=0.0, beta=0.0, gamma=0.0, rica_lambda=0.0),
            model=dataclasses.replace(base.model, rica=False),
            optim=OptimConfig(optimizer="adam", group_schedule=("ae2d",)),
        )
    if name == "fourier_cascade":    # config #2: legacy FFT pipeline
        return base.replace(model=dataclasses.replace(base.model, fourier_variant=True))
    if name == "full_khm":           # config #3: full cascaded duo + KHM + ADMM
        return base
    if name == "full_khm_bf16":      # config #3 in the accuracy-gated mixed-precision
        # mode (bf16 activations/residuals/duals, f32 params/optimizer/losses):
        # ~1.4x train throughput on TPU v5e (tests/test_bf16.py gates; bench.py
        # headline mode).  Adam path only — bf16_full loss noise degrades the L-BFGS
        # line search (benchmarks/PERF_NOTES.md).
        return base.replace(
            model=dataclasses.replace(base.model, compute_dtype="bfloat16_full")
        )
    if name == "full_khm_lbfgs":     # config #4: same but LBFGS w/ alternating groups.
        # The closure runs compute_dtype="bfloat16" (bf16 conv/dense activations,
        # f32 residual/loss path): the Armijo sufficient-decrease test still compares
        # f32 losses, so unlike bf16_full (func_evals blew up 6.8x) the search
        # trajectory is preserved up to the small f32-loss perturbation bf16
        # activations introduce — identical func_evals and loss to 7e-6 relative at
        # flagship dims, +/-1 func_eval on small probes, ~10% faster per step
        # (benchmarks/PERF_NOTES.md round 4; accuracy gate:
        # tests/test_bf16.py::test_lbfgs_bf16_tracks_f32).
        # admm_unroll_lbfgs=False: the L-BFGS ADMM loop lowers as one lax.scan —
        # measured perf-neutral (line-search while loops dominate either way) and
        # the compile cost stops scaling with admm_iters (148 s at nadmm=2
        # unrolled; the Adam path keeps the 6.4x-faster unrolled lowering).
        return base.replace(
            model=dataclasses.replace(base.model, compute_dtype="bfloat16"),
            optim=OptimConfig(optimizer="lbfgs", group_schedule=("ae2d", "ae1d", "khm")),
            train=dataclasses.replace(base.train, admm_unroll_lbfgs=False),
        )
    raise ValueError(f"unknown preset: {name}")
