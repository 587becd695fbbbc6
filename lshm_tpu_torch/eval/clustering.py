"""Clustering evaluation: per-baseline cluster distances -> t-SNE -> agglomerative
hard clustering -> montages (port of ``lshm_tpu/eval/clustering.py``; reference:
src/evaluate_clustering.py:40-163).

Baselines go through the cascade forward in chunks of ``baselines_per_batch`` on the
card (K3, the fused encoder head, once per chunk), and the per-cluster mean
||Mu - m_k||^p reduces there too; only t-SNE and the agglomerative pass (sklearn) run
on the host.  By default each chunk's int8 visibilities are copied and decoded on the
device (``data/device_decode.py``); the reads (or the host decode) of the next chunks
overlap the device's forward (``decode_lookahead``).  sklearn, scipy, matplotlib and
PIL are imported inside the functions that use them.  The model holds its weights, so
the JAX functions' ``params`` argument is gone; ``M`` is ``model.khm.M``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from lshm_tpu_torch.data.device_decode import device_decode_patchify
from lshm_tpu_torch.data.h5io import (
    Source,
    read_baseline_flat,
    read_baseline_patches,
    read_baselines_patches_batch,
    read_baselines_raw_batch,
    read_metadata,
)
from lshm_tpu_torch.data.sampler import DeviceStaging
from lshm_tpu_torch.device import resolve_device
from lshm_tpu_torch.losses import khm_distances


@dataclass
class EvalResult:
    X: np.ndarray                 # [K, nbase] per-baseline mean distances (row-demeaned)
    soft_assign: np.ndarray       # [nbase] argmin-distance cluster id (reference clusid)
    labels: np.ndarray | None     # [nbase] agglomerative hard labels (None if skipped)
    embedding: np.ndarray | None  # [nbase, 2] t-SNE embedding (None if skipped)
    mean_latents: np.ndarray      # [nbase, D] per-baseline mean latent (GNN node features)


def _model_device(model: nn.Module, device: torch.device) -> None:
    have = next(model.parameters()).device
    if have.type != device.type or (device.index is not None and have != device):
        raise ValueError(f"the model's parameters are on {have}, the evaluation runs "
                         f"on {device}: move the model first")


def _batched_features(model: nn.Module, x: torch.Tensor, uv: torch.Tensor, ppb: int,
                      order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B*ppb, ps, ps, C] -> (dists [B, K], mean_latents [B, D]) for B baselines.
    Row b of dists is the reference's statistic mean_n ||Mu_n - m_k||^p over the
    baseline's patches (reference: src/evaluate_clustering.py:111-115)."""
    out = model(x, uv)
    Mu = out.Mu.reshape(-1, ppb, out.Mu.shape[-1])
    dists = torch.func.vmap(khm_distances, in_dims=(0, None, None))(Mu, model.khm.M, order)
    return dists, Mu.mean(dim=1)


def baseline_distance_matrix(
    model: nn.Module,
    source: Source,
    sap: str,
    patch_size: int = 128,
    num_channels: int = 4,
    order: int = 4,
    baselines_per_batch: int = 8,
    baseline_ids: Sequence[int] | None = None,
    decode_lookahead: int = 2,
    device_decode: bool = True,
    device: str | torch.device | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (X [K, nbase] raw distance matrix, mean_latents [nbase, D]).

    ``source`` is an H5 path or an in-memory extract tree.  ``device=None`` means the
    card (it raises when there is none); the model must already be on ``device``.
    Each chunk of ``baselines_per_batch`` baselines runs ``model(x, uv)`` under
    ``torch.inference_mode()``; the tail chunk is not padded (JAX pads it only to avoid
    a retrace).

    The host work and the device forward are pipelined: one background thread reads
    up to ``decode_lookahead`` chunks ahead and stages each in pinned memory with a
    non-blocking copy, while the device runs the previous chunk's forward, and each
    chunk's results are fetched one chunk late.  ``decode_lookahead=0`` is the serial
    path, with the same results bit for bit.

    ``device_decode=True`` (the default, as in JAX) reads each chunk's raw int8
    visibilities, scales and uv, and the consumer's stream decodes them
    (``device_decode_patchify``: clamp +-1e6, z-norm per baseline) before the forward.
    ``False`` decodes on the host (``read_baselines_patches_batch``) and copies the
    float32 patches."""
    device = resolve_device(device)
    _model_device(model, device)
    nbase = read_metadata(source, sap)[0]
    ids = list(baseline_ids) if baseline_ids is not None else list(range(nbase))
    K = model.khm.M.shape[0]
    X = np.zeros((K, len(ids)), np.float64)
    latents = None
    chunks = [ids[s: s + baselines_per_batch]
              for s in range(0, len(ids), baselines_per_batch)]
    staging = DeviceStaging(device)
    cuda = device.type == "cuda"

    def decode(chunk):
        # one open of the source per chunk serves the data and uv of its baselines
        if device_decode:
            arrays = read_baselines_raw_batch(source, sap, chunk, uvdist=True)
        else:
            arrays = read_baselines_patches_batch(source, sap, chunk, patch_size,
                                                  num_channels, uvdist=True)[2:]
        return staging.put(*arrays), len(chunk)

    def dispatch(staged):
        """Queue the chunk's decode (on the device), forward and the copy of its results
        to the host; returns what ``fetch`` waits on."""
        (tensors, ready), nb = staged
        staging.take(tensors, ready)
        with torch.inference_mode():
            if device_decode:
                vis, scales, uv = tensors
                x = device_decode_patchify(vis, scales, num_channels, patch_size)
                uv = uv.repeat_interleave(x.shape[0] // nb, dim=0)
            else:
                x, uv = tensors
            dists, mls = _batched_features(model, x, uv, x.shape[0] // nb, order)
            if not cuda:
                return dists, mls, None
            dists, mls = dists.to("cpu", non_blocking=True), mls.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return dists, mls, done

    def fetch(pending):
        dists, mls, done = pending
        if done is not None:
            done.synchronize()
        return dists.numpy(), mls.float().numpy()

    def store(i, dists, mls):
        nonlocal latents
        start = i * baselines_per_batch
        if latents is None:
            latents = np.zeros((len(ids), mls.shape[-1]), np.float32)
        X[:, start: start + dists.shape[0]] = dists.T
        latents[start: start + mls.shape[0]] = mls

    if decode_lookahead <= 0:
        for i, chunk in enumerate(chunks):
            store(i, *fetch(dispatch(decode(chunk))))
        return X, latents

    ex = ThreadPoolExecutor(max_workers=1)       # h5py is not thread-safe across opens
    try:
        nprimed = min(decode_lookahead, len(chunks))
        decoding = [ex.submit(decode, c) for c in chunks[:nprimed]]
        inflight = None                          # (index, pending results), one deep
        for i in range(len(chunks)):
            decoded = decoding.pop(0).result()
            if i + nprimed < len(chunks):
                decoding.append(ex.submit(decode, chunks[i + nprimed]))
            pending = dispatch(decoded)
            if inflight is not None:             # the device runs chunk i meanwhile
                store(inflight[0], *fetch(inflight[1]))
            inflight = (i, pending)
        if inflight is not None:
            store(inflight[0], *fetch(inflight[1]))
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    return X, latents


def evaluate_sap(
    model: nn.Module,
    source: Source,
    sap: str,
    patch_size: int = 128,
    num_channels: int = 4,
    order: int = 4,
    num_hard_clusters: int = 10,
    out_dir: str | None = None,
    run_tsne: bool = True,
    montages: bool = False,
    recon_panels: bool = False,
    tsne_seed: int = 99,
    device: str | torch.device | None = None,
) -> EvalResult:
    """Full evaluation of one SAP (reference: src/evaluate_clustering.py:65-163):
    distance matrix -> row-demean -> t-SNE(2) -> StandardScaler + AgglomerativeClustering
    (linkage='average') -> optional per-cluster spectrogram montages.  With ``out_dir``
    it writes ``X.mat``, ``M.mat``, ``M.png``, the scatter plots and, when asked, the
    montages (``b<label>_<baseline>.png``) and recon panels (``xx_<baseline>.png``)."""
    X_raw, latents = baseline_distance_matrix(
        model, source, sap, patch_size, num_channels, order, device=device)
    soft = np.argmin(X_raw, axis=0)
    X = X_raw - X_raw.mean(axis=1, keepdims=True)       # row-demean (reference :122-123)

    embedding = None
    labels = None
    nbase = X.shape[1]
    if run_tsne and nbase >= 5:
        from sklearn.cluster import AgglomerativeClustering
        from sklearn.manifold import TSNE
        from sklearn.preprocessing import StandardScaler

        perpl = min(30.0, max(2.0, (nbase - 1) / 3))
        tsne = TSNE(n_components=2, random_state=tsne_seed, perplexity=perpl)
        embedding = tsne.fit_transform(X.T)
        scaled = StandardScaler().fit_transform(embedding)
        k = min(num_hard_clusters, nbase)
        labels = AgglomerativeClustering(linkage="average", n_clusters=k).fit(scaled).labels_

    if out_dir:
        from scipy.io import savemat

        from lshm_tpu_torch.utils.rgb import save_image_grid

        os.makedirs(out_dir, exist_ok=True)
        savemat(os.path.join(out_dir, "X.mat"), {"X": X})
        M = model.khm.M.detach().float().cpu().numpy()
        savemat(os.path.join(out_dir, "M.mat"), {"M": M})
        # centroid matrix as a grayscale image (reference: evaluate_clustering.py:61)
        save_image_grid([np.repeat(M[..., None], 3, axis=-1)],
                        os.path.join(out_dir, "M.png"))
        if embedding is not None:
            _plot_scatter(embedding, soft, labels, out_dir)
        if montages:
            _save_montages(source, sap, labels if labels is not None else soft,
                           num_channels, out_dir)
        if recon_panels:
            save_recon_panels(model, source, sap, range(nbase), out_dir, patch_size,
                              num_channels, device=device)

    return EvalResult(X=X, soft_assign=soft, labels=labels, embedding=embedding,
                      mean_latents=latents)


def _plot_scatter(embedding, soft, labels, out_dir):
    from lshm_tpu_torch.utils.rgb import headless_matplotlib

    headless_matplotlib()
    import matplotlib.pyplot as plt

    for name, colors in (("scatter", soft), ("clusters", labels)):
        if colors is None:
            continue
        fig, ax = plt.subplots(figsize=(8, 6))
        sc = ax.scatter(embedding[:, 0], embedding[:, 1], c=colors, cmap="Spectral", s=60)
        ax.set_title(f"{name}: {len(set(colors.tolist()))} clusters")
        fig.colorbar(sc)
        fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=100)
        plt.close(fig)


def save_recon_panels(
    model: nn.Module, source: Source, sap: str, baseline_ids, out_dir: str,
    patch_size: int = 128, num_channels: int = 4,
    device: str | torch.device | None = None,
) -> None:
    """Per-baseline reconstruction panels: [x | xhat2D] / [x2_T | x3_F] / [xrec | xerr]
    pseudocolor grid, one PNG per baseline (reference: src/evaluate_clustering.py:92-107);
    the Fourier variant's middle row is [y | yhat]."""
    from lshm_tpu_torch.utils.rgb import channel_to_rgb, save_image_grid

    device = resolve_device(device)
    _model_device(model, device)
    os.makedirs(out_dir, exist_ok=True)
    host = lambda t: t[0].float().cpu().numpy()[..., :4]      # noqa: E731
    for nb in baseline_ids:
        _, _, patches, uv = read_baseline_patches(source, sap, nb, patch_size,
                                                  num_channels, uvdist=True)
        with torch.inference_mode():
            out = model(torch.from_numpy(patches[:1]).to(device),
                        torch.from_numpy(uv[:1]).to(device))
        x = patches[0][..., :4]
        if out.yf_in is not None:
            # legacy Fourier pipeline panels (reference: src/EvaluateClusters.ipynb cell 18)
            mid = [channel_to_rgb(host(out.yf_in)), channel_to_rgb(host(out.yf_out))]
        else:
            mid = [channel_to_rgb(host(out.x2)), channel_to_rgb(host(out.x3))]
        recon = host(out.xrecon)
        panels = [channel_to_rgb(x), channel_to_rgb(host(out.x1)), *mid,
                  channel_to_rgb(recon), channel_to_rgb(x - recon)]
        save_image_grid(panels, os.path.join(out_dir, f"xx_{nb}.png"), ncol=2)


def _save_montages(source, sap, labels, num_channels, out_dir):
    """Per-cluster flat-spectrogram PNGs (reference: src/evaluate_clustering.py:158-163)."""
    from lshm_tpu_torch.utils.rgb import channel_to_rgb, save_image_grid

    for nb, lab in enumerate(labels):
        vis = read_baseline_flat(source, sap, nb, num_channels)
        img = channel_to_rgb(vis[..., :4])
        save_image_grid([img], os.path.join(out_dir, f"b{int(lab)}_{nb}.png"))


def nmi(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized mutual information between two hard assignments (the BASELINE.md
    cluster-parity metric)."""
    from sklearn.metrics import normalized_mutual_info_score

    return float(normalized_mutual_info_score(a, b))
