from lshm_tpu_torch.data.device_decode import device_decode_patchify, device_decode_train
from lshm_tpu_torch.data.h5io import (
    compute_uv,
    read_baseline_channels,
    read_baseline_flat,
    read_baseline_patches,
    read_baseline_raw,
    read_baselines_patches_batch,
    read_baselines_raw_batch,
    read_metadata,
    scan_files,
)
from lshm_tpu_torch.data.patches import patch_grid_shape, patchify, patchify_torch
from lshm_tpu_torch.data.sampler import (
    DeviceDecodePrefetcher,
    Minibatch,
    MinibatchSampler,
    PrefetchIterator,
    RawMinibatch,
)
from lshm_tpu_torch.data.synthetic import synth_extract, write_synthetic_h5

__all__ = [
    "scan_files",
    "read_metadata",
    "read_baseline_channels",
    "read_baseline_flat",
    "read_baseline_patches",
    "read_baselines_patches_batch",
    "read_baseline_raw",
    "read_baselines_raw_batch",
    "compute_uv",
    "patchify",
    "patchify_torch",
    "patch_grid_shape",
    "device_decode_patchify",
    "device_decode_train",
    "Minibatch",
    "RawMinibatch",
    "MinibatchSampler",
    "PrefetchIterator",
    "DeviceDecodePrefetcher",
    "synth_extract",
    "write_synthetic_h5",
]
