"""Synthetic LOFAR ``MS_extract.h5`` contents (port of ``lshm_tpu/data/synthetic.py``).

``synth_extract`` returns the file's tree as nested dicts of numpy arrays (the same
group paths and the same rng draws as the JAX package's ``write_synthetic_h5``), so a
machine without ``h5py`` can feed the real sampler from memory; ``write_synthetic_h5``
writes that tree to an H5 file and imports ``h5py`` only when called.  The physics is the
reference's fringe simulator (reference: src/display_colors.py:27-51): a point source
seen through a time-rotated, frequency-scaled uv track with per-polarisation gains.
"""

from __future__ import annotations

import os

import numpy as np


def synth_fringe(rng: np.random.Generator, ntime: int, nfreq: int, uv_meters: np.ndarray,
                 noise: float = 0.1) -> np.ndarray:
    """One baseline's visibilities: float [ntime, nfreq, 4 pol, 2 reim]."""
    t = np.linspace(0.0, 0.25, ntime) * 2.0 * np.pi                    # hour-angle sweep
    f = np.linspace(110e6, 180e6, nfreq) / 2.99792458e8                # 1 / lambda
    tt, ff = np.meshgrid(t, f, indexing="ij")
    u = (uv_meters[0] * np.cos(tt) + uv_meters[1] * np.sin(tt)) * ff
    v = (-uv_meters[0] * np.sin(tt) + uv_meters[1] * np.cos(tt)) * ff
    l, m = rng.uniform(-0.7, 0.7, size=2)
    phase = 2.0 * np.pi * (u * l + v * m)
    out = np.empty((ntime, nfreq, 4, 2), dtype=np.float64)
    for p in range(4):
        g_re, g_im = rng.uniform(0.3, 1.0), rng.uniform(-0.2, 0.2)
        out[:, :, p, 0] = g_re * np.cos(phase) - g_im * np.sin(phase)
        out[:, :, p, 1] = g_re * np.sin(phase) + g_im * np.cos(phase)
    out += rng.normal(0.0, noise, size=out.shape)
    return out


def synth_extract(nstations: int = 4, ntime: int = 192, nfreq: int = 192,
                  saps: tuple[str, ...] = ("0",), include_autocorr: bool = True,
                  seed: int = 0) -> dict:
    """A schema-valid synthetic extract as a tree of numpy arrays:
    ``tree["measurement"]["saps"][sap]["visibilities"]`` etc. (schema in
    ``lshm_tpu_torch/data/h5io.py``).  Baselines are all station pairs (i <= j with
    ``include_autocorr``, else i < j); visibilities are int8 with per-(baseline, freq,
    pol) float32 scale factors, like real LOFAR extracts."""
    rng = np.random.default_rng(seed)
    pairs = [(i, j) for i in range(nstations)
             for j in range(i if include_autocorr else i + 1, nstations)]
    nbase = len(pairs)
    xyz = rng.uniform(-2000.0, 2000.0, size=(nstations, 3))
    tree: dict = {"measurement": {
        "info": {"start_time": np.array([b"2020-01-01 12:30:00"], dtype="S19")},
        "saps": {},
    }}
    for sap in saps:
        vis = np.empty((nbase, ntime, nfreq, 4, 2), dtype=np.int8)
        scales = np.empty((nbase, nfreq, 4), dtype=np.float32)
        for b, (s1, s2) in enumerate(pairs):
            if s1 == s2:  # autocorrelation: noise-dominated, flat
                raw = np.abs(rng.normal(1.0, 0.2, size=(ntime, nfreq, 4, 2)))
            else:
                raw = synth_fringe(rng, ntime, nfreq, xyz[s1, :2] - xyz[s2, :2])
            amax = np.abs(raw).max(axis=(0, 3)) + 1e-12      # [nfreq, 4]
            scale = (amax / 127.0).astype(np.float32)
            q = np.clip(np.round(raw / scale[None, :, :, None]), -127, 127)
            vis[b] = q.astype(np.int8)
            scales[b] = scale
        tree["measurement"]["saps"][sap] = {
            "visibilities": vis,
            "visibility_scale_factors": scales,
            "central_frequencies": np.linspace(110e6, 180e6, nfreq),
            "baselines": np.array(pairs, dtype=np.int64),
            "antenna_locations": {"XYZ": xyz},
        }
    return tree


def write_synthetic_h5(path: str, **kw) -> str:
    """Write ``synth_extract(**kw)`` to an H5 file at ``path``; returns ``path``."""
    import h5py

    def write(group, tree: dict) -> None:
        for name, val in tree.items():
            if isinstance(val, dict):
                write(group.require_group(name), val)
            else:
                group.create_dataset(name, data=val)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as f:
        write(f, synth_extract(**kw))
    return path
