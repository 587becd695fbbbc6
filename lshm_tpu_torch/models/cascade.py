"""The cascaded autoencoders + clustering head (port of ``lshm_tpu/models/cascade.py``).

Current pipeline (reference: src/kharmonic_lofar.py:132-159):

    x1, mu = AE2D(x, uv)
    x11    = (x - x1) / 2                       # halved residual
    x2     = AE1D_T(vec(x11), uv)               # time-major vectorisation
    x3     = AE1D_F(vec(x11^T), uv)^T           # freq-major vectorisation
    xrecon = x1 + x2 + x3
    Mu     = concat(mu, muT, muF)               # clustering feature

Legacy Fourier pipeline (``model.fourier_variant``; reference: Demo.ipynb cells 6 and
10, src/EvaluateClusters.ipynb):

    x1, mu    = AE2D(x, uv)
    yf        = clamp(fft2_shifted(x - x1), -10, 10)   # FULL residual, 2C channels
    yhat, ymu = AE2D_F(yf, uv)                  # second 2D AE in Fourier space
    Mu        = concat(mu, ymu)

Inputs and outputs are NHWC like the JAX module.  Submodule names (ae2d, aeT, aeF, aef,
khm) match the Flax param tree, so ``lshm_tpu_torch.params`` maps one onto the other.

Under the bfloat16 compute dtypes the AEs compute in bf16 and their outputs and
latents are cast back to the input's dtype (``lshm_tpu/models/cascade.py:152-154,
161, 195-197``): float32 under ``bfloat16``, bf16 under ``bfloat16_full`` (whose step
casts the input batch, so the Fourier transform runs in bf16 there, as in JAX).  The
KHM head's centroids stay float32.

Under a profiler the Fourier variant records the spans ``cascade.dft`` (the transform)
and ``cascade.aef`` (the Fourier AE's call) (``utils/spans.py``).  ``dft_calls`` counts
the transform's forwards and the backwards through them among the kernels' launch
counters (``kernels.register_counters``): a CUDA graph's capture takes back what it
counted and each replay adds it (``train/step.py::CudaGraph``), so an eager ADMM
iteration and a replayed one count alike.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import nn

from lshm_tpu_torch.config import ModelConfig, check_model_supported
from lshm_tpu_torch.kernels import dft, register_counters
from lshm_tpu_torch.models.autoencoders import (
    AutoEncoder1D,
    AutoEncoder2D,
    fused_dual_ae1d,
    uv_harmonic_features,
)
from lshm_tpu_torch.models.khm import KHarmonicMeans
from lshm_tpu_torch.utils.spans import span

# calls of fft2_shifted since the last reset (kernels.reset_launches): forwards, and
# backwards through a forward's output
dft_calls = {"dft_fwd": 0, "dft_bwd": 0}
register_counters(dft_calls)


def _count_backward(grad: torch.Tensor) -> None:
    dft_calls["dft_bwd"] += 1


@dataclass
class CascadeOutputs:
    """Everything the objective and the ADMM dual update need from one forward pass."""

    x1: torch.Tensor            # 2D AE reconstruction          [N, P, P, C]
    x11: torch.Tensor           # halved residual (x - x1) / 2  [N, P, P, C]
    x2: torch.Tensor            # time-axis 1D AE recon         [N, P, P, C]
    x3: torch.Tensor            # freq-axis 1D AE recon         [N, P, P, C]
    xrecon: torch.Tensor        # x1 + x2 + x3                  [N, P, P, C]
    Mu: torch.Tensor            # concat latent                 [N, L + 2*Lt]
    mu: torch.Tensor            # 2D latent                     [N, L]
    muT: torch.Tensor           # time-axis 1D latent           [N, Lt]
    muF: torch.Tensor           # freq-axis 1D latent           [N, Lt]
    # the Fourier variant's extras (None otherwise)
    yf_in: torch.Tensor | None = None    # Fourier-space AE input  [N, P, P, 2C]
    yf_out: torch.Tensor | None = None   # Fourier-space AE recon  [N, P, P, 2C]


@functools.cache
def dft_mats(n: int, dtype: torch.dtype, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) parts of the orthonormal n-point DFT matrix,
    F[j, k] = exp(-2 pi i j k / n) / sqrt(n), in ``dtype`` (``_dft_mats`` of the JAX
    package).  j k is reduced mod n in integers before the trigonometry.  Each step is
    rounded to ``dtype`` where JAX's computes in it: the angle's scale, the angle, the
    cos and sin, 1/sqrt(n) and the products (float32 holds each bf16 product exactly,
    so rounding it once is the bf16 operation).  Built once per (n, dtype, device), as
    normal tensors even under ``inference_mode`` (an evaluation's), so that a later
    training step can save them for its backward."""
    rnd = lambda t: t.to(dtype).float()
    with torch.inference_mode(False):
        k = torch.arange(n)
        m = rnd(torch.outer(k, k) % n)
        ang = rnd(m * rnd(torch.tensor(-2.0 * math.pi / n)))
        s = rnd(1.0 / rnd(torch.sqrt(rnd(torch.tensor(float(n))))))
        return tuple(rnd(rnd(f(ang)) * s).to(dtype).to(device)
                     for f in (torch.cos, torch.sin))


def fft2_dense(x: torch.Tensor) -> torch.Tensor:
    """``fft2_shifted`` as JAX computes it: dense DFT matrices in x's dtype and six
    matrix products, without an FFT: axis h is C_h @ x viewed [N, H, W*C], axis w is
    C_w @ y viewed [N*H, W, C] (F is symmetric), then the real | imag cat and the roll."""
    n, h, w, c = x.shape
    Ch, Sh = dft_mats(h, x.dtype, x.device)
    Cw, Sw = dft_mats(w, x.dtype, x.device)
    xh = x.reshape(n, h, w * c)
    yre = (Ch @ xh).view(n * h, w, c)
    yim = (Sh @ xh).view(n * h, w, c)
    zre = Cw @ yre - Sw @ yim
    zim = Sw @ yre + Cw @ yim
    z = torch.cat([zre, zim], dim=-1).view(n, h, w, 2 * c)
    return torch.roll(z, (h // 2, w // 2), dims=(1, 2))


def fft2_shifted(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2D DFT over the spatial dims of NHWC x, then fftshift (a roll by
    n // 2 on both), returned as real | imag channels [N, P, P, 2C] (reference:
    src/lofar_tools.py:24-30).  A float32 CUDA tensor with P a power of two from 8 to
    128 and C 2, 4 or 8 (``kernels.dft.takes``) goes through the FFT kernels, one launch
    forward and one backward (``kernels/dft.py``); anything else (the CPU, bfloat16,
    other sizes) through the dense products of ``fft2_dense``, as in JAX.  Counted in ``dft_calls``;
    a host-side count only, so that a CUDA graph can capture the call."""
    z = dft.dft2_shifted(x) if x.is_cuda and dft.takes(x) else fft2_dense(x)
    dft_calls["dft_fwd"] += 1
    if z.requires_grad:
        z.register_hook(_count_backward)
    return z


class CascadedAE(nn.Module):
    """Flagship model: AE2D + (AE1D_T, AE1D_F | AE2D_Fourier) + KHM head.  ``generator``
    seeds the initialisation (drawn on the CPU; move the module with ``.to(device)``)."""

    def __init__(self, cfg: ModelConfig | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = cfg if cfg is not None else ModelConfig()
        check_model_supported(c)
        self.cfg = c
        dtype = torch.bfloat16 if c.compute_dtype.startswith("bfloat16") else torch.float32
        common = dict(harmonic_scales=c.harmonic_scales, rica=c.rica, dtype=dtype,
                      generator=generator)
        ch = c.num_channels
        self.ae2d = AutoEncoder2D(latent_dim=c.latent_dim, channels=ch,
                                  pallas_head=c.pallas_head, packed=c.packed_conv2d,
                                  **common)
        if c.fourier_variant:
            # real + imag channels; no fused head (lshm_tpu/models/cascade.py:113-122)
            self.aef = AutoEncoder2D(latent_dim=c.latent_dim_fourier, channels=2 * ch,
                                     packed=c.packed_conv2d, **common)
        else:
            self.aeT = AutoEncoder1D(latent_dim=c.latent_dim_1d, channels=ch,
                                     fast=c.fast_conv1d, **common)
            self.aeF = AutoEncoder1D(latent_dim=c.latent_dim_1d, channels=ch,
                                     fast=c.fast_conv1d, **common)
        self.khm = KHarmonicMeans(latent_dim=c.total_latent_dim,
                                  num_clusters=c.num_clusters, order=c.khm_order,
                                  generator=generator)

    def forward(self, x: torch.Tensor, uv: torch.Tensor) -> CascadeOutputs:
        n, h, w, ch = x.shape
        like_x = lambda *ts: [t.to(x.dtype) for t in ts]
        x1, mu = like_x(*self.ae2d(x, uv))
        x11 = (x - x1) * 0.5
        if self.cfg.fourier_variant:
            # the full residual, with the notebooks' stability clamp
            r = x - x1
            with span("cascade.dft"):
                yf = fft2_shifted(r)
            yf_in = torch.clamp(yf, -10.0, 10.0)
            with span("cascade.aef"):
                yf_out, ymu = like_x(*self.aef(yf_in, uv))
            zero = torch.zeros_like(x)
            return CascadeOutputs(
                x1=x1, x11=x11, x2=zero, x3=zero, xrecon=x1,
                Mu=torch.cat([mu, ymu], dim=-1), mu=mu, muT=ymu, muF=ymu[:, :0],
                yf_in=yf_in, yf_out=yf_out,
            )
        sT = x11.reshape(n, h * w, ch)                      # time-major vectorisation
        sF = x11.transpose(1, 2).reshape(n, w * h, ch)      # freq-major
        if self.cfg.fuse_1d:
            uvf = uv_harmonic_features(uv, self.cfg.harmonic_scales)
            (yyT, muT), (yyF, muF) = fused_dual_ae1d(self.aeT, self.aeF, sT, sF, uvf,
                                                     self.cfg.rica, self.aeT.dtype)
            yyT, muT, yyF, muF = like_x(yyT, muT, yyF, muF)
        else:
            yyT, muT = like_x(*self.aeT(sT, uv))
            yyF, muF = like_x(*self.aeF(sF, uv))
        x2 = yyT.reshape(n, h, w, ch)
        x3 = yyF.reshape(n, w, h, ch).transpose(1, 2)
        return CascadeOutputs(
            x1=x1, x11=x11, x2=x2, x3=x3, xrecon=x1 + x2 + x3,
            Mu=torch.cat([mu, muT, muF], dim=-1), mu=mu, muT=muT, muF=muF,
        )
