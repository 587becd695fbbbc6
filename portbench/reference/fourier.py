"""The plain reference of the legacy Fourier cascade (config #2, the port's preset
``fourier_cascade``), its objective and its dual update.

The published pipeline (https://github.com/SarodYatawatta/LSHM, Demo.ipynb cells 6 and
10, src/EvaluateClusters.ipynb cells 8 and 18):

    x1, mu    = AE2D(x)                                    latent 224
    yf_in     = clamp(shift(DFT(x - x1)), -10, 10)         the FULL residual
    yf_out, ymu = AE2D_F(yf_in)                           AutoEncoderCNN2(latent_dim=64,
                                                           channels=2*4)
    Mu        = concat(mu, ymu)                            KHM at D = 288

The transform follows src/lofar_tools.py:24-30 (``torch.fft.fftn(dim=(2, 3),
norm='ortho')`` and ``torch_fftshift``): ``torch.fft.fft2`` with the orthonormal
scaling over the spatial axes of the NHWC residual, a roll by n // 2 on both, real |
imag concatenated as 2C channels, then the notebooks' +-10 clamp.  It shares nothing
with the port's dense DFT matrices.

Departure, as in the port and the JAX package: the notebooks call the AEs without uv
features and define no ADMM for this pipeline; it is trained here under src/'s
objective (kharmonic_lofar.py): uv features, RICA, the KHM head and ADMM.  loss0 adds
||yf_out - yf_in||^2 / numel(yf_in); loss2 is the ADMM term on the 2C-channel Fourier
residual yf_in - yf_out over its own numel, with y2 shaped [N, P, P, 2C]; loss3 is 0
(y3 is empty); RICA takes (mu, ymu).

The AEs, the KHM, similarity and augmentation losses and ``Precision`` are
``model.py``'s; ``adam`` is ``train.py``'s ADMM loop with this cascade, objective and
dual update in place of the 1D cascade's.  Float32 throughout; TF32 is the caller's
switch (off, as for ``model.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import model, train
from portbench.reference.model import (Precision, Weights, augmentation_loss, autoencoder,
                                       khm_loss, log_cosh, similarity_loss, uv_features)
from portbench.reference.rebound import rebound

CLAMP = 10.0


@dataclass(frozen=True)
class FourierShape:
    """The Fourier model's widths (``lshm_tpu_torch.config.ModelConfig`` with
    ``fourier_variant``)."""
    latent: int = 224
    latent_f: int = 64
    channels: int = 4
    clusters: int = 10
    order: int = 4
    scales: tuple = (1e-4, 1e-3, 1e-2, 1e-1)
    rica: bool = True

    @property
    def total_latent(self) -> int:
        return self.latent + self.latent_f


def param_spec(s: FourierShape) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter, in the port's order: the 2D AE on C
    channels, the Fourier AE on 2C channels (``aef``, no fused head), the centroids."""

    def ae2d(prefix: str, latent: int, channels: int):
        one = model.param_spec(model.Shape(latent=latent, channels=channels,
                                           scales=s.scales, rica=s.rica))
        return [(prefix + n[len("ae2d"):], shp, fan) for n, shp, fan in one
                if n.startswith("ae2d.")]

    return (ae2d("ae2d", s.latent, s.channels) + ae2d("aef", s.latent_f, 2 * s.channels)
            + [("khm.M", (s.clusters, s.total_latent), -1)])


def dft_shifted(r: torch.Tensor) -> torch.Tensor:
    """NHWC [N, P, P, C] -> the shifted orthonormal 2D DFT as real | imag, [N, P, P, 2C]."""
    h, w = r.shape[1:3]
    f = torch.fft.fft2(r, dim=(1, 2), norm="ortho")
    f = torch.roll(f, (h // 2, w // 2), dims=(1, 2))
    return torch.cat([f.real, f.imag], dim=-1)


def cascade(p: dict, x: torch.Tensor, uv: torch.Tensor, s: FourierShape,
            q: Precision) -> dict:
    uvf = uv_features(uv, s.scales)
    y, mu = autoencoder(p, "ae2d", x.permute(0, 3, 1, 2), uvf, 2, s, q)
    x1 = y.permute(0, 2, 3, 1)
    yf_in = dft_shifted(x - x1).clamp(-CLAMP, CLAMP)
    yf, ymu = autoencoder(p, "aef", yf_in.permute(0, 3, 1, 2), uvf, 2, s, q)
    return dict(x1=x1, yf_in=yf_in, yf_out=yf.permute(0, 2, 3, 1),
                Mu=torch.cat([mu, ymu], dim=-1), latents=(mu, ymu))


def zero_duals(x: torch.Tensor) -> tuple:
    """y1 like x, y2 like the Fourier residual, y3 empty."""
    return (torch.zeros_like(x), x.new_zeros((*x.shape[:-1], 2 * x.shape[-1])),
            x.new_zeros((0,)))


def objective(out: dict, M, x, duals, w: Weights, groups: int, s: FourierShape):
    """(total, {term: value}) of the augmented-Lagrangian objective."""
    numel, nf = x.numel(), out["yf_in"].numel()
    term = lambda y, r, n: (torch.sum(y * r) + 0.5 * w.rho * torch.sum(r * r)) / n
    y1, y2, _ = duals
    m = {
        "loss0": (torch.sum((out["x1"] - x) ** 2) / numel
                  + torch.sum((out["yf_out"] - out["yf_in"]) ** 2) / nf),
        "loss1": term(y1, x - out["x1"], numel),
        "loss2": term(y2, out["yf_in"] - out["yf_out"], nf),
        "loss3": torch.zeros((), device=x.device),
        "kdist": w.alpha * khm_loss(out["Mu"], M, s.order),
        "sim": w.beta * similarity_loss(M),
        "aug": w.gamma * augmentation_loss(out["Mu"], groups),
    }
    if s.rica:
        m["rica"] = w.rica_lambda * sum(torch.sum(log_cosh(t)) / t.numel()
                                        for t in out["latents"])
    total = sum(m.values())
    m["loss"] = total
    return total, m


def dual_update(out: dict, x, duals, rho: float):
    y1, y2, y3 = duals
    return (y1 + rho * (x - out["x1"]).detach(),
            y2 + rho * (out["yf_in"] - out["yf_out"]).detach(), y3)


adam = rebound(train.adam, cascade=cascade, objective=objective, dual_update=dual_update,
               _zeros=zero_duals)
