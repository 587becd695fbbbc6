"""The Fourier cascade's initial parameters: ``weights.init_params``'s draw (one normal
draw of ``torch.Generator`` on the device, lecun-normal weights, zero biases, uniform
centroids) over ``reference.fourier.param_spec``."""

from __future__ import annotations

from portbench import weights
from portbench.reference.fourier import FourierShape, param_spec
from portbench.reference.rebound import rebound


def shape_of(model_cfg: dict) -> FourierShape:
    """The reference's ``FourierShape`` from a configuration's ``model`` section."""
    if not model_cfg.get("fourier_variant"):
        raise ValueError("the Fourier reference covers the Fourier variant, not the 1D cascade")
    return FourierShape(latent=model_cfg["latent_dim"], latent_f=model_cfg["latent_dim_fourier"],
                        channels=model_cfg["num_channels"], clusters=model_cfg["num_clusters"],
                        order=model_cfg["khm_order"], scales=tuple(model_cfg["harmonic_scales"]),
                        rica=model_cfg["rica"])


init_params = rebound(weights.init_params, param_spec=param_spec)
