"""Configuration dataclasses for the PyTorch/CUDA port of LSHM.

A field-for-field copy of ``lshm_tpu/config.py``: the same dataclasses, presets and
``section.key=value`` override syntax, so a preset name or an override string means the
same experiment in both packages.  Two defaults differ (``ModelConfig.khm_backend`` and
``ModelConfig.pallas_head``, see their comments): the JAX defaults were chosen from TPU
measurements, and on the GPU those two fields select the hand-written CUDA kernels.

Every field is ported: ``check_supported`` raises only on a value the JAX package
would not take either.  Comments here say what a field does in the port.  The JAX
package's TPU record of each field, the reason for its JAX default, is in
``lshm_tpu/config.py``; the port's own times on the card are in ``PERF.md``.
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
    # bfloat16 computes the convolutions and dense layers in bf16 and keeps the
    # full-resolution residual and loss path in float32; bfloat16_full also casts
    # the input batch (and therefore the AE outputs, residuals and ADMM duals) to
    # bf16, which halves the bytes of those full-resolution arrays.  Every loss still
    # accumulates in float32 (losses.py::_f32).
    compute_dtype: str = "float32"
    # The three exact rewrites below compute the same sums as the layers they replace,
    # on the same parameters, so checkpoints and the reference importer are unchanged.
    # All three are off by default, as in JAX, whose defaults are TPU results; the
    # port's times on the card are in PERF.md.
    # Run the two identical-topology 1D AEs (time-major aeT + freq-major aeF) as one
    # grouped-convolution stack (models/autoencoders.py::fused_dual_ae1d): half the
    # 1D conv launches, twice the channels per op.
    fuse_1d: bool = False
    # Exact rewrites of the 1D AEs' stride-4 ops: the conv's backward as the
    # gradients of its packed-view k=2, s=1 equivalent (conv1d_s4), the transposed
    # conv as one matrix product (its taps do not overlap).
    fast_conv1d: bool = False
    # Space-to-depth packed rewrite of the 2D AEs' outermost stride-2 stages (encoder
    # conv0..conv{n-1}, decoder tconv{6-n}..tconv5; conv2d_s2_packed,
    # convt2d_s2_packed): the k=4, s=2, p=1 geometry packs with no tap duplication,
    # so the full-resolution layers run as k=2, s=1 convs with 4x the channels.
    # Under pallas_head, encoder stages 0 and 1 stay in the fused kernel.
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
    # A choice between two XLA lowerings of the same math (default off in JAX).
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
    remat: bool = False               # recompute the cascade forward in the backward
                                      # (torch.utils.checkpoint; train/step.py); as one
                                      # segment it does not lower the peak (PERF.md)
    # Unroll the ADMM inner loop into straight-line XLA instead of lax.scan.
    # In JAX it chooses between two lowerings with the same math.
    # In the port the ADMM loop is a Python loop whichever value this has: the
    # field (like precision, mesh_axes and admm_unroll_lbfgs) is kept so that
    # override strings stay valid in both packages.
    admm_unroll: bool = True
    # L-BFGS path override for admm_unroll (None = inherit; in JAX False lowers the
    # L-BFGS ADMM loop as one lax.scan, with the same math).
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


def check_model_supported(m: ModelConfig) -> None:
    """Raise ``ValueError`` for a model field value the JAX package does not take
    either (an unknown KHM backend or compute dtype)."""
    if m.khm_backend not in ("xla", "pallas", "auto"):
        raise ValueError(f"model.khm_backend={m.khm_backend!r}")
    if m.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"model.compute_dtype={m.compute_dtype!r}: one of {COMPUTE_DTYPES}")


def check_supported(cfg: Config) -> None:
    """``check_model_supported`` on the model; every other field is ported."""
    check_model_supported(cfg.model)


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
        # mode (bf16 activations/residuals/duals, f32 params/optimizer/losses;
        # tests/test_torch_bf16*.py hold it to JAX).  Adam path only, as in JAX.
        return base.replace(
            model=dataclasses.replace(base.model, compute_dtype="bfloat16_full")
        )
    if name == "full_khm_lbfgs":     # config #4: same but LBFGS w/ alternating groups.
        # The closure runs compute_dtype="bfloat16" (bf16 conv/dense activations,
        # f32 residual/loss path), so the Armijo test still compares float32 losses.
        # admm_unroll_lbfgs=False: JAX's lowering choice; no effect in the port.
        return base.replace(
            model=dataclasses.replace(base.model, compute_dtype="bfloat16"),
            optim=OptimConfig(optimizer="lbfgs", group_schedule=("ae2d", "ae1d", "khm")),
            train=dataclasses.replace(base.train, admm_unroll_lbfgs=False),
        )
    raise ValueError(f"unknown preset: {name}")
