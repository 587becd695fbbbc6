from lshm_tpu_torch.data.h5io import compute_uv, read_baseline_channels, read_metadata, scan_files
from lshm_tpu_torch.data.patches import patch_grid_shape, patchify
from lshm_tpu_torch.data.sampler import Minibatch, MinibatchSampler, PrefetchIterator
from lshm_tpu_torch.data.synthetic import synth_extract, write_synthetic_h5

__all__ = [
    "scan_files",
    "read_metadata",
    "read_baseline_channels",
    "compute_uv",
    "patchify",
    "patch_grid_shape",
    "Minibatch",
    "MinibatchSampler",
    "PrefetchIterator",
    "synth_extract",
    "write_synthetic_h5",
]
