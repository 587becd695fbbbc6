"""LOFAR ``MS_extract.h5`` reading on the host (numpy; port of the read half of
``lshm_tpu/data/h5io.py``; reference: src/lofar_tools.py:51-463).

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

SPEED_OF_LIGHT = 2.99792458e8

# channel selection: (re, im) of XX (0) and YY (3) for 4 channels, all four pols for 8
# (reference: src/lofar_tools.py:125-141)
_POLS_4CH = (0, 3)
_POLS_8CH = (0, 1, 2, 3)

Source = Union[str, os.PathLike, Mapping]


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


def read_metadata(source: Source, sap: str) -> tuple:
    """Visibility shape (nbase, ntime, nfreq, npol, reim)
    (reference: src/lofar_tools.py:410-426)."""
    with _open(source) as f:
        return tuple(f["measurement"]["saps"][sap]["visibilities"].shape)


def compute_uv(source: Source, sap: str, baseline_ids: Sequence[int]) -> np.ndarray:
    """Per-baseline (u, v) in wavelengths at observation start and the central
    frequency: antenna XYZ differences rotated by the start-time hour angle and scaled
    by 1/lambda (reference: src/lofar_tools.py:90-110,143-151).  float32 [B, 2]."""
    with _open(source) as f:
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
    pols = _POLS_4CH if num_channels == 4 else _POLS_8CH
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
    if patch_size is not None:
        _, ntime, nfreq, _ = x.shape
        pt, pf = max(ntime, patch_size), max(nfreq, patch_size)
        if (pt, pf) != (ntime, nfreq):
            pad = np.zeros((x.shape[0], pt, pf, x.shape[-1]), dtype=np.float32)
            pad[:, :ntime, :nfreq] = x
            x = pad
    return x
