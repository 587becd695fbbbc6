"""Decode and patchify on the device: the host ships int8, not float32 patches (port of
``lshm_tpu/data/device_decode.py``).

The host reads the raw int8 visibilities and float32 scale factors as stored in the H5
(reference schema: src/lofar_tools.py:76-83) and copies those to the card; there the
functions below scale, select channels, zero-pad, cut the overlapping patches, clamp,
z-normalise and (training) augment.  The copy shrinks by the patches' overlap (35
patches of 128 x 128 hold 2.9 times a 384 x 512 spectrogram) times 4 (float32 to int8)
over 2 (the raw data hold four polarizations, 4 channels use two): 5.8 times fewer
bytes for a training minibatch of that shape, 11.6 with augmentation.  The math is the
host readers' (decode per src/lofar_tools.py:112-141; clamp and per-baseline z-norm per
the eval reader :333-338; global z-norm per the training sampler :190-193), in plain
tensor operations on whatever device the inputs lie on.  Nothing here synchronises
with the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lshm_tpu_torch.data.patches import patchify_torch

_POLS_4CH = (0, 3)
_POLS_8CH = (0, 1, 2, 3)
_EVAL_CLAMP = 1e6         # the eval reader's clamp (src/lofar_tools.py:333-338)


def _decode_channels_dev(vis: torch.Tensor, scales: torch.Tensor,
                         num_channels: int) -> torch.Tensor:
    """int8 ``vis`` [B, T, F, npol, 2] x float32 ``scales`` [B, F, npol] -> float32
    [B, T, F, C]: (re, im) of each selected polarization (reference decode:
    src/lofar_tools.py:112-141)."""
    if num_channels not in (4, 8):
        raise ValueError(f"num_channels must be 4 or 8, got {num_channels}")
    pols = _POLS_4CH if num_channels == 4 else _POLS_8CH
    v = vis.float()
    chans = []
    for p in pols:
        s = scales[:, None, :, p]                          # [B, 1, F]
        chans.append(v[:, :, :, p, 0] * s)
        chans.append(v[:, :, :, p, 1] * s)
    return torch.stack(chans, dim=-1)


def _patches(vis, scales, num_channels: int, patch_size: int, clamp: float):
    """Decoded, zero-padded up to the patch size, patchified and clamped:
    ([B * px * py, ps, ps, C], (px, py))."""
    _, t, f, _, _ = vis.shape
    x = _decode_channels_dev(vis, scales, num_channels)
    pt, pf = max(t, patch_size), max(f, patch_size)
    if (pt, pf) != (t, f):
        x = F.pad(x, (0, 0, 0, pf - f, 0, pt - t))
    patches, grid = patchify_torch(x, patch_size)
    return patches.clamp(-clamp, clamp), grid


def _znorm(x: torch.Tensor, dims) -> torch.Tensor:
    """(x - mean) / std over ``dims`` (std dividing by N, as numpy and JAX), a zero std
    taken as 1; ``torch.where``, not a branch, so the host never waits on the device."""
    std, mean = torch.std_mean(x, dim=dims, correction=0, keepdim=True)
    return (x - mean) / torch.where(std > 0, std, torch.ones_like(std))


def device_decode_patchify(vis: torch.Tensor, scales: torch.Tensor, num_channels: int = 4,
                           patch_size: int = 128) -> torch.Tensor:
    """int8 ``vis`` [B, T, F, npol, 2] x float32 ``scales`` [B, F, npol] -> z-normalised
    float32 patches [B * px * py, ps, ps, C], baseline-major: the eval batch reader's
    math (``read_baselines_patches_batch``), clamp +-1e6, then z-norm per baseline over
    its own patches (JAX's defaults ``clamp=1e6``, ``per_baseline_norm=True``, the
    only ones the evaluation uses)."""
    b = vis.shape[0]
    patches, (px, py) = _patches(vis, scales, num_channels, patch_size, _EVAL_CLAMP)
    grouped = patches.reshape(b, px * py, *patches.shape[1:])
    return _znorm(grouped, (1, 2, 3, 4)).reshape(patches.shape)


def device_decode_train(vis: torch.Tensor, scales: torch.Tensor, flip_flags: torch.Tensor,
                        num_channels: int = 4, patch_size: int = 128, clamp: float = 1e3,
                        normalize: bool = True, augment: bool = False) -> torch.Tensor:
    """The training sampler's decode on the device: int8 ``vis`` [B, T, F, npol, 2] x
    float32 ``scales`` [B, F, npol] -> float32 patches, baseline-major, the math of
    ``MinibatchSampler.sample()`` (reference: src/lofar_tools.py:51-211): decode,
    zero-pad, patchify, clamp +-``clamp``, z-norm over the whole minibatch when
    ``normalize``; then, when ``augment``, each baseline's patches followed by their
    flipped copy, flipped in time where ``flip_flags[b, 0]`` and in frequency where
    ``flip_flags[b, 1]`` (bool [B, 2], the host rng's draws of ``default_augment``, so
    the stream is the host path's).  Returns [B * px * py * (2 if augment else 1), ps,
    ps, C]."""
    b = vis.shape[0]
    patches, (px, py) = _patches(vis, scales, num_channels, patch_size, clamp)
    if normalize:
        patches = _znorm(patches, None)
    if not augment:
        return patches
    grouped = patches.reshape(b, px * py, *patches.shape[1:])
    flags = flip_flags.reshape(b, 2, 1, 1, 1, 1)
    flipped = torch.where(flags[:, 0], grouped.flip(2), grouped)
    flipped = torch.where(flags[:, 1], flipped.flip(3), flipped)
    return torch.stack([grouped, flipped], dim=1).reshape(-1, *patches.shape[1:])
