"""The cascaded autoencoder trio + clustering head (port of the non-Fourier branch of
``lshm_tpu/models/cascade.py``; reference: src/kharmonic_lofar.py:132-159):

    x1, mu = AE2D(x, uv)
    x11    = (x - x1) / 2                       # halved residual
    x2     = AE1D_T(vec(x11), uv)               # time-major vectorisation
    x3     = AE1D_F(vec(x11^T), uv)^T           # freq-major vectorisation
    xrecon = x1 + x2 + x3
    Mu     = concat(mu, muT, muF)               # clustering feature

Inputs and outputs are NHWC like the JAX module.  Submodule names (ae2d, aeT, aeF, khm)
match the Flax param tree, so ``lshm_tpu_torch.params`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from lshm_tpu_torch.config import ModelConfig, check_model_supported
from lshm_tpu_torch.models.autoencoders import AutoEncoder1D, AutoEncoder2D
from lshm_tpu_torch.models.khm import KHarmonicMeans


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


class CascadedAE(nn.Module):
    """Flagship model: AE2D + (AE1D_T, AE1D_F) + KHM head.  ``generator`` seeds the
    initialisation (drawn on the CPU; move the module with ``.to(device)``)."""

    def __init__(self, cfg: ModelConfig | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = cfg if cfg is not None else ModelConfig()
        check_model_supported(c)
        self.cfg = c
        common = dict(channels=c.num_channels, harmonic_scales=c.harmonic_scales,
                      rica=c.rica, generator=generator)
        self.ae2d = AutoEncoder2D(latent_dim=c.latent_dim, pallas_head=c.pallas_head,
                                  **common)
        self.aeT = AutoEncoder1D(latent_dim=c.latent_dim_1d, **common)
        self.aeF = AutoEncoder1D(latent_dim=c.latent_dim_1d, **common)
        self.khm = KHarmonicMeans(latent_dim=c.total_latent_dim,
                                  num_clusters=c.num_clusters, order=c.khm_order,
                                  generator=generator)

    def forward(self, x: torch.Tensor, uv: torch.Tensor) -> CascadeOutputs:
        n, h, w, ch = x.shape
        x1, mu = self.ae2d(x, uv)
        x11 = (x - x1) * 0.5
        yyT, muT = self.aeT(x11.reshape(n, h * w, ch), uv)
        yyF, muF = self.aeF(x11.transpose(1, 2).reshape(n, w * h, ch), uv)
        x2 = yyT.reshape(n, h, w, ch)
        x3 = yyF.reshape(n, w, h, ch).transpose(1, 2)
        return CascadeOutputs(
            x1=x1, x11=x11, x2=x2, x3=x3, xrecon=x1 + x2 + x3,
            Mu=torch.cat([mu, muT, muF], dim=-1), mu=mu, muT=muT, muF=muF,
        )
