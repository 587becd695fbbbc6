from lshm_tpu_torch.models.autoencoders import (
    AutoEncoder1D,
    AutoEncoder2D,
    uv_harmonic_features,
)
from lshm_tpu_torch.models.cascade import CascadedAE, CascadeOutputs
from lshm_tpu_torch.models.khm import KHarmonicMeans, khm_offline_update

__all__ = [
    "AutoEncoder2D",
    "AutoEncoder1D",
    "uv_harmonic_features",
    "KHarmonicMeans",
    "khm_offline_update",
    "CascadedAE",
    "CascadeOutputs",
]
