"""The benchmark's inputs: a synthetic LOFAR extract made on the card from the seed.

The physics is the reference's fringe simulator (https://github.com/SarodYatawatta/LSHM,
src/display_colors.py:27-51; the port carries it as ``lshm_tpu_torch/data/synthetic.py``
at commit 7ff9298): a point source seen through a time-rotated, frequency-scaled uv
track with per-polarisation gains and noise, autocorrelations flat noise, quantised to
int8 with one float32 scale per (baseline, frequency, polarisation), as real extracts
store it.  Here it is drawn with a ``torch.Generator`` on the device in blocks of
baselines, and held on the host as
the extract's tree of numpy arrays, which the port's readers take in place of an H5
file.  ``uv`` and the decodes are worked out here too, from the raw tree alone: the
reference reads nothing the port has made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LIGHT = 2.99792458e8
START = "2020-01-01 12:30:00"
F_LO, F_HI = 110e6, 180e6


def stations_pairs(nstations: int) -> list[tuple[int, int]]:
    """All station pairs i <= j (autocorrelations included, as LOFAR stores them)."""
    return [(i, j) for i in range(nstations) for j in range(i, nstations)]


def synth_sap(nstations: int, ntime: int, nfreq: int, seed: int, device,
              block: int = 64) -> dict:
    """One SAP "0" of ``nstations`` stations as the extract's tree."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed % 2**63)
    pairs = stations_pairs(nstations)
    xyz = (torch.rand(nstations, 3, generator=g, device=dev, dtype=torch.float64)
           * 4000.0 - 2000.0)
    s1 = torch.tensor([a for a, _ in pairs], device=dev)
    s2 = torch.tensor([b for _, b in pairs], device=dev)
    t = torch.linspace(0.0, 0.25, ntime, device=dev) * (2.0 * math.pi)
    f = torch.linspace(F_LO, F_HI, nfreq, device=dev) / LIGHT
    vis = np.empty((len(pairs), ntime, nfreq, 4, 2), np.int8)
    scales = np.empty((len(pairs), nfreq, 4), np.float32)
    for lo in range(0, len(pairs), block):
        hi = min(lo + block, len(pairs))
        nb = hi - lo
        uvm = (xyz[s1[lo:hi], :2] - xyz[s2[lo:hi], :2]).float()          # [b, 2]
        lm = torch.rand(nb, 2, generator=g, device=dev) * 1.4 - 0.7
        gre = torch.rand(nb, 4, generator=g, device=dev) * 0.7 + 0.3
        gim = torch.rand(nb, 4, generator=g, device=dev) * 0.4 - 0.2
        noise = torch.randn(nb, ntime, nfreq, 4, 2, generator=g, device=dev)
        ct, st = torch.cos(t)[:, None], torch.sin(t)[:, None]
        u = (uvm[:, 0, None, None] * ct + uvm[:, 1, None, None] * st) * f
        v = (-uvm[:, 0, None, None] * st + uvm[:, 1, None, None] * ct) * f
        ph = 2.0 * math.pi * (u * lm[:, 0, None, None] + v * lm[:, 1, None, None])
        cph, sph = torch.cos(ph)[..., None], torch.sin(ph)[..., None]
        gre, gim = gre[:, None, None, :], gim[:, None, None, :]
        raw = torch.stack([gre * cph - gim * sph, gre * sph + gim * cph], dim=-1)
        raw = raw + 0.1 * noise
        auto = (s1[lo:hi] == s2[lo:hi])[:, None, None, None, None]
        raw = torch.where(auto, (1.0 + 0.2 * noise).abs(), raw)
        scale = raw.abs().amax(dim=(1, 4)) / 127.0 + 1e-12 / 127.0      # [b, F, 4]
        q = torch.round(raw / scale[:, None, :, :, None]).clamp_(-127, 127)
        vis[lo:hi] = q.to(torch.int8).cpu().numpy()
        scales[lo:hi] = scale.cpu().numpy()
    return {"measurement": {
        "info": {"start_time": np.array([START.encode()], dtype="S19")},
        "saps": {"0": {
            "visibilities": vis,
            "visibility_scale_factors": scales,
            "central_frequencies": np.linspace(F_LO, F_HI, nfreq),
            "baselines": np.array(pairs, dtype=np.int64),
            "antenna_locations": {"XYZ": xyz.cpu().numpy()},
        }},
    }}


def grid(ntime: int, nfreq: int, patch: int) -> tuple[int, int]:
    """Patches along time and frequency: 50 % overlap, the spectrogram zero-padded up
    to the patch size."""
    st = patch // 2
    return (max(ntime, patch) - patch) // st + 1, (max(nfreq, patch) - patch) // st + 1


def sap(tree: dict) -> dict:
    return tree["measurement"]["saps"]["0"]


def uv_of(tree: dict, ids) -> np.ndarray:
    """(u, v) in wavelengths of baselines ``ids`` at the start time and the central
    frequency (src/lofar_tools.py:90-110,143-151): float32 [B, 2]."""
    hms = [float(v) for v in START.split()[1].split(":")]
    theta = (hms[0] + hms[1] / 60.0 + hms[2] / 3600.0) / 24.0 * (2.0 * math.pi)
    g = sap(tree)
    frq = g["central_frequencies"]
    inv_lambda = frq[frq.shape[0] // 2] / LIGHT
    c, s = math.cos(theta) * inv_lambda, math.sin(theta) * inv_lambda
    xyz, pairs = g["antenna_locations"]["XYZ"], g["baselines"][np.asarray(ids)]
    d = xyz[pairs[:, 0], :2] - xyz[pairs[:, 1], :2]
    return np.stack([d[:, 0] * c + d[:, 1] * s, -d[:, 0] * s + d[:, 1] * c],
                    axis=-1).astype(np.float32)


def decode(vis: torch.Tensor, scales: torch.Tensor, patch: int, clamp: float) -> torch.Tensor:
    """int8 [B, T, F, 4, 2] x float32 [B, F, 4] -> z-normalised float32 patches
    [B * px * py, patch, patch, 4], baseline-major: (re, im) of XX and YY, zero-padded
    to the patch size, cut with 50 % overlap, clamped, then z-normalised over the whole
    minibatch (training, src/lofar_tools.py:51-211)."""
    v = vis.float()
    x = torch.stack([v[:, :, :, p, r] * scales[:, None, :, p] for p in (0, 3)
                     for r in (0, 1)], dim=-1)                      # [B, T, F, 4]
    b, t, f, c = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, max(f, patch) - f, 0, max(t, patch) - t))
    st = patch // 2
    x = x.unfold(1, patch, st).unfold(2, patch, st)                 # [B, px, py, C, p, p]
    x = x.permute(0, 1, 2, 4, 5, 3).reshape(b, -1, patch, patch, c).clamp(-clamp, clamp)
    std, mean = torch.std_mean(x, correction=0)
    x = (x - mean) / torch.where(std > 0, std, torch.ones_like(std))
    return x.reshape(-1, patch, patch, c)
