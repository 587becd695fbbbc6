"""The initial parameters, made by the benchmark on the device from the seed.

Every weight is drawn from one normal draw of ``torch.Generator`` on the device,
split into the leaves of ``reference.model.param_spec`` and scaled to flax's
lecun-normal (variance 1 / fan_in, cut at two standard deviations); biases are zero
and the KHM centroids uniform in [0, 1), as the port initialises them.  The same
tensors go to the port (``Trainer.load`` of a parameters-only checkpoint) and to the
reference.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.model import Shape, param_spec

TRUNC = 0.87962566103423978      # std of a unit normal cut at +-2


def shape_of(model_cfg: dict) -> Shape:
    """The reference's ``Shape`` from a configuration's ``model`` section."""
    if model_cfg.get("fourier_variant"):
        raise ValueError("the reference covers the 1D cascade, not the Fourier variant")
    return Shape(latent=model_cfg["latent_dim"], latent_1d=model_cfg["latent_dim_1d"],
                 channels=model_cfg["num_channels"], clusters=model_cfg["num_clusters"],
                 order=model_cfg["khm_order"], scales=tuple(model_cfg["harmonic_scales"]),
                 rica=model_cfg["rica"])


def init_params(s: Shape, seed: int, device) -> dict[str, torch.Tensor]:
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed((seed * 2654435761 + 1) % 2**63)
    spec = param_spec(s)
    weights = [(n, shp, fan) for n, shp, fan in spec if fan > 0]
    total = sum(math.prod(shp) for _, shp, _ in weights)
    flat = torch.randn(total, generator=g, device=dev).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shp, fan in spec:
        if fan > 0:
            k = math.prod(shp)
            out[name] = flat[at:at + k].view(shp) * (math.sqrt(1.0 / fan) / TRUNC)
            at += k
        elif fan == 0:
            out[name] = torch.zeros(shp, device=dev)
        else:
            out[name] = torch.rand(shp, generator=g, device=dev)
    return out
