"""LOFAR ``MS_extract.h5`` reading on the host (numpy; port of the read half of
``lshm_tpu/data/h5io.py``; reference: src/lofar_tools.py:51-463): the training reads,
the evaluation readers (``read_baselines_patches_batch``, ``read_baseline_patches``,
``read_baseline_flat``), decoded on the host, and the raw reads
(``read_baseline_raw``, ``read_baselines_raw_batch``) whose int8 visibilities
``data/device_decode.py`` decodes on the device.  ``read_baselines_patches_batch``
decodes through the native decoder (``native/``) or in numpy (``use_native``).

Every reader takes a ``source``: a path to an H5 file (``h5py`` is imported only then)
or the same tree held in memory as nested dicts of numpy arrays
(``lshm_tpu_torch.data.synthetic.synth_extract``).  Arrays come back in the NHWC
layout of the JAX package: spectrograms ``[time, freq, channels]``.

H5 schema (reference: src/lofar_tools.py:76-109):
  measurement/saps/<SAP>/visibilities               int8  [nbase, ntime, nfreq, npol=4, reim=2]
  measurement/saps/<SAP>/visibility_scale_factors   f32   [nbase, nfreq, npol]
  measurement/saps/<SAP>/central_frequencies        f64   [nfreq]
  measurement/saps/<SAP>/baselines                  int   [nbase, 2]
  measurement/saps/<SAP>/antenna_locations/XYZ      f64   [nstation, 3]
  measurement/info/start_time                       bytes ["YYYY-MM-DD hh:mm:ss", ...]
"""

from __future__ import annotations

import contextlib
import glob
import math
import os
from typing import Any, Iterator, Mapping, Sequence, Union

import numpy as np

from lshm_tpu_torch.data.patches import patchify

SPEED_OF_LIGHT = 2.99792458e8

# channel selection: (re, im) of XX (0) and YY (3) for 4 channels, all four pols for 8
# (reference: src/lofar_tools.py:125-141)
_POLS_4CH = (0, 3)
_POLS_8CH = (0, 1, 2, 3)

Source = Union[str, os.PathLike, Mapping]


def pols_for(num_channels: int) -> tuple[int, ...]:
    """The polarisations whose (re, im) make ``num_channels`` channels."""
    if num_channels not in (4, 8):
        raise ValueError(f"num_channels must be 4 or 8, got {num_channels}")
    return _POLS_4CH if num_channels == 4 else _POLS_8CH


def native_choice(use_native: bool | None) -> bool:
    """The JAX package's rule for ``use_native``: None means the native decoder where
    there is a C++ compiler, else numpy; True the native decoder; False numpy.  When
    the answer is native the library is built or loaded now, so that a build that
    fails raises here rather than falling back."""
    from lshm_tpu_torch import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        native.library()
    return bool(use_native)


@contextlib.contextmanager
def _open(source: Source) -> Iterator[Any]:
    if isinstance(source, Mapping):
        yield source
        return
    import h5py

    with h5py.File(source, "r") as f:
        yield f


def scan_files(pathname: str, pattern: str = "L*.MS_extract.h5",
               recursive: bool = True) -> tuple[list[str], list[str]]:
    """Valid (file, SAP) pairs under ``pathname``.  Validity gate per SAP: nbase > 1,
    nfreq >= 90, ntime >= 90, npol == 4, reim == 2 (reference: src/lofar_tools.py:430-463)."""
    import h5py

    if recursive:
        rawlist = glob.glob(os.path.join(pathname, "**", pattern), recursive=True)
    else:
        rawlist = glob.glob(os.path.join(pathname, pattern))
    file_list: list[str] = []
    sap_list: list[str] = []
    for filename in sorted(rawlist):
        try:
            with h5py.File(filename, "r") as f:
                saps = f["measurement"]["saps"]
                for sap in saps:
                    try:
                        nbase, ntime, nfreq, npol, reim = saps[sap]["visibilities"].shape
                    except (KeyError, ValueError):
                        continue
                    if nbase > 1 and nfreq >= 90 and ntime >= 90 and npol == 4 and reim == 2:
                        file_list.append(filename)
                        sap_list.append(sap)
        except OSError:       # not an H5 file, or unreadable
            continue
    return file_list, sap_list


def read_metadata(source: Source, sap: str, give_baselines: bool = False):
    """Visibility shape (nbase, ntime, nfreq, npol, reim); with ``give_baselines``,
    ``(baselines [nbase, 2], shape)`` (reference: src/lofar_tools.py:410-426)."""
    with _open(source) as f:
        g = f["measurement"]["saps"][sap]
        shape = tuple(g["visibilities"].shape)
        if give_baselines:
            return np.asarray(g["baselines"][...]), shape
        return shape


def compute_uv(source: Source, sap: str, baseline_ids: Sequence[int]) -> np.ndarray:
    """Per-baseline (u, v) in wavelengths at observation start and the central
    frequency: antenna XYZ differences rotated by the start-time hour angle and scaled
    by 1/lambda (reference: src/lofar_tools.py:90-110,143-151).  float32 [B, 2]."""
    with _open(source) as f:
        return _compute_uv_open(f, sap, baseline_ids)


def _compute_uv_open(f, sap: str, baseline_ids: Sequence[int]) -> np.ndarray:
    hms = f["measurement"]["info"]["start_time"][0].decode("ascii").split()[1].split(":")
    start_hours = float(hms[0]) + float(hms[1]) / 60.0 + float(hms[2]) / 3600.0
    theta = start_hours / 24.0 * (2.0 * math.pi)
    g = f["measurement"]["saps"][sap]
    frq = g["central_frequencies"]
    inv_lambda = frq[frq.shape[0] // 2] / SPEED_OF_LIGHT
    rot00 = math.cos(theta) * inv_lambda
    rot01 = math.sin(theta) * inv_lambda
    baselines = g["baselines"][...]
    xyz = g["antenna_locations"]["XYZ"][...]
    out = np.zeros((len(baseline_ids), 2), dtype=np.float32)
    for i, b in enumerate(baseline_ids):
        s1, s2 = int(baselines[b][0]), int(baselines[b][1])
        dx = xyz[s1][0] - xyz[s2][0]
        dy = xyz[s1][1] - xyz[s2][1]
        out[i, 0] = dx * rot00 + dy * rot01
        out[i, 1] = -dx * rot01 + dy * rot00
    return out


def _decode_channels(g, h, baseline_ids: Sequence[int], num_channels: int) -> np.ndarray:
    """int8 visibilities x per-(baseline, freq, pol) scales -> float32
    [B, ntime, nfreq, C]; channels 2i / 2i+1 are re / im of the i-th selected pol
    (reference: src/lofar_tools.py:112-141)."""
    pols = pols_for(num_channels)
    _, ntime, nfreq, _, _ = g.shape
    out = np.empty((len(baseline_ids), ntime, nfreq, num_channels), dtype=np.float32)
    for i, b in enumerate(baseline_ids):
        vis = g[b].astype(np.float32)                      # [ntime, nfreq, npol, 2]
        scale = h[b].astype(np.float32)                    # [nfreq, npol]
        for ci, p in enumerate(pols):
            s = scale[None, :, p]
            out[i, :, :, 2 * ci] = vis[:, :, p, 0] * s
            out[i, :, :, 2 * ci + 1] = vis[:, :, p, 1] * s
    return out


def read_baseline_raw(source: Source, sap: str,
                      baseline_ids: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    """Raw int8 visibilities [B, T, F, npol, 2] and float32 scale factors [B, F, npol]
    of the given baselines, undecoded (the training sampler's ``sample_raw``)."""
    with _open(source) as f:
        g = f["measurement"]["saps"][sap]
        return _raw(g, baseline_ids)


def _raw(g, baseline_ids: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    vis, scales = g["visibilities"], g["visibility_scale_factors"]
    return (np.stack([vis[b] for b in baseline_ids]),
            np.stack([scales[b] for b in baseline_ids]))


def read_baselines_raw_batch(source: Source, sap: str, baseline_ids: Sequence[int],
                             uvdist: bool = False):
    """The evaluation's raw read, one open of the source for a chunk of baselines:
    (vis [B, T, F, npol, 2] int8, scales [B, F, npol] float32[, uv [B, 2] float32]).
    Decoded on the device, these carry 5.8 times fewer bytes to it than the decoded
    patches at 384 x 512 (``data/device_decode.py``)."""
    if len(baseline_ids) == 0:
        raise ValueError("read_baselines_raw_batch: baseline_ids must be non-empty")
    with _open(source) as f:
        vis, scales = _raw(f["measurement"]["saps"][sap], baseline_ids)
        if uvdist:
            return vis, scales, _compute_uv_open(f, sap, baseline_ids)
    return vis, scales


def read_baseline_channels(source: Source, sap: str, baseline_ids: Sequence[int],
                           num_channels: int = 4, patch_size: int | None = None) -> np.ndarray:
    """Decoded spectrograms of the given baselines, zero-padded to at least
    ``patch_size`` along time and freq when given.  float32 [B, T, F, C]."""
    if num_channels not in (4, 8):
        raise ValueError(f"num_channels must be 4 or 8, got {num_channels}")
    with _open(source) as f:
        g = f["measurement"]["saps"][sap]
        x = _decode_channels(g["visibilities"], g["visibility_scale_factors"],
                             baseline_ids, num_channels)
    return x if patch_size is None else _pad_to(x, patch_size)


def _pad_to(x: np.ndarray, patch_size: int) -> np.ndarray:
    """[B, T, F, C] zero-padded to at least ``patch_size`` along time and freq."""
    _, ntime, nfreq, _ = x.shape
    pt, pf = max(ntime, patch_size), max(nfreq, patch_size)
    if (pt, pf) == (ntime, nfreq):
        return x
    pad = np.zeros((x.shape[0], pt, pf, x.shape[-1]), dtype=np.float32)
    pad[:, :ntime, :nfreq] = x
    return pad


# ------------------------------------------------------------------ evaluation readers

def read_baseline_flat(source: Source, sap: str, baseline_id: int,
                       num_channels: int = 4) -> np.ndarray:
    """Full un-patched spectrogram of one baseline, clamped to +-1e6
    (reference: src/lofar_tools.py:352-406).  float32 [ntime, nfreq, C]."""
    x = read_baseline_channels(source, sap, [baseline_id], num_channels)[0]
    return np.clip(x, -1e6, 1e6)


def read_baselines_patches_batch(source: Source, sap: str, baseline_ids: Sequence[int],
                                 patch_size: int = 128, num_channels: int = 4,
                                 uvdist: bool = False, give_baselines: bool = False,
                                 use_native: bool | None = None):
    """Evaluation reader for many baselines in one open of the source: the same as
    ``read_baseline_patches`` per id (patch, clamp to +-1e6, z-normalise each baseline
    over its own patches; reference: src/lofar_tools.py:214-349).  ``use_native``
    follows ``native_choice``: the native decoder is called once per baseline, so the
    z-norm stays per baseline; False decodes in numpy.

    Returns (patchx, patchy, patches [B*ppb, ps, ps, C], [uv [B*ppb, 2]],
    [station_pairs [B, 2]]), baseline-major."""
    if len(baseline_ids) == 0:
        raise ValueError("read_baselines_patches_batch: baseline_ids must be non-empty")
    pols = pols_for(num_channels)
    use_native = native_choice(use_native)
    with _open(source) as f:
        g = f["measurement"]["saps"][sap]
        vis, scales = g["visibilities"], g["visibility_scale_factors"]
        if use_native:
            from lshm_tpu_torch import native

            outs = [native.decode_patchify(np.asarray(vis[b])[None],
                                           np.asarray(scales[b])[None], pols, patch_size,
                                           1e6, normalize=True)
                    for b in baseline_ids]
            px, py = outs[0][1]
            patches = np.concatenate([o for o, _ in outs])
        else:
            x = _decode_channels(vis, scales, baseline_ids, num_channels)
        uv = _compute_uv_open(f, sap, baseline_ids) if uvdist else None
        pairs = (np.asarray(g["baselines"][...])[np.asarray(baseline_ids)]
                 if give_baselines else None)
    if not use_native:
        patches, (px, py) = patchify(_pad_to(x, patch_size), patch_size)
        patches = np.clip(patches, -1e6, 1e6)
        # per-baseline z-norm over that baseline's own patch group (baseline-major rows)
        grouped = patches.reshape(len(baseline_ids), px * py, *patches.shape[1:])
        mean = grouped.mean(axis=(1, 2, 3, 4), keepdims=True)
        std = grouped.std(axis=(1, 2, 3, 4), keepdims=True)
        patches = ((grouped - mean) / np.where(std > 0, std, 1.0)).reshape(patches.shape)
    result: list = [px, py, patches]
    if uvdist:
        result.append(np.repeat(uv, px * py, axis=0))
    if give_baselines:
        result.append(pairs)
    return tuple(result)


def read_baseline_patches(source: Source, sap: str, baseline_id: int,
                          patch_size: int = 128, num_channels: int = 4,
                          give_baseline: bool = False, uvdist: bool = False):
    """Evaluation reader for one baseline: patch, clamp to +-1e6, always z-normalise
    (reference: src/lofar_tools.py:214-349).

    Returns (patchx, patchy, patches [P, ps, ps, C], [uv [P, 2]], [(station1, station2)])."""
    x = read_baseline_channels(source, sap, [baseline_id], num_channels, patch_size)
    patches, (px, py) = patchify(x, patch_size)
    patches = np.clip(patches, -1e6, 1e6)
    std = patches.std()
    patches = (patches - patches.mean()) / (std if std > 0 else 1.0)
    result: list = [px, py, patches]
    if uvdist:
        uv = compute_uv(source, sap, [baseline_id])
        result.append(np.broadcast_to(uv, (patches.shape[0], 2)).copy())
    if give_baseline:
        with _open(source) as f:
            result.append(tuple(f["measurement"]["saps"][sap]["baselines"][baseline_id]))
    return tuple(result)
