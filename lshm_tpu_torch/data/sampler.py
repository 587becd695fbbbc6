"""Training minibatch sampler (host side) with device prefetch (port of
``lshm_tpu/data/sampler.py``; reference: src/lofar_tools.py:51-211).

Randomly pick one (file, SAP), randomly pick ``batch_size`` baselines, decode int8 x scale
into real channels, patchify baseline-major, clamp, z-normalise over the minibatch, and
optionally double the batch with an augmentation transform interleaved per baseline.
``sample()`` does all of it on the host, through the native decoder (``native/``) or in
numpy (``use_native``); ``sample_raw()`` draws the same minibatch and leaves the decode
to the device (``DeviceDecodePrefetcher``, ``data/device_decode.py``).
The numpy rng stream (``default_rng([seed, process_index])``, ``reseed``, ``skip``) is
the JAX sampler's, so both packages draw identical minibatches from the same seed.
A file entry may be a path or an in-memory extract tree (``synth_extract``).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from lshm_tpu_torch import native
from lshm_tpu_torch.config import DataConfig
from lshm_tpu_torch.data.device_decode import device_decode_train
from lshm_tpu_torch.data.h5io import (Source, compute_uv, native_choice, pols_for,
                                      read_baseline_channels, read_baseline_raw,
                                      read_metadata)
from lshm_tpu_torch.data.patches import patch_grid_shape, patchify
from lshm_tpu_torch.utils.spans import span


@dataclass
class Minibatch:
    """x: [batch_size * patchx * patchy (*2 if augmented), ps, ps, C] float32,
    baseline-major; uv: matching [N, 2] float32 (u, v), constant within a baseline.
    numpy arrays from ``sample()``, device tensors from ``PrefetchIterator``."""

    x: Any
    uv: Any
    patchx: int
    patchy: int
    num_baselines: int

    @property
    def patches_per_baseline(self) -> int:
        """patchx * patchy, twice that with augmentation."""
        return self.x.shape[0] // self.num_baselines


@dataclass
class RawMinibatch:
    """One minibatch before its decode: vis [B, T, F, npol, 2] int8, scales [B, F, npol]
    float32, uv [B, 2] float32 per baseline (zeros without ``uvdist``), flip_flags
    [B, 2] bool, each baseline's (time, freq) flips (all False without ``augment``)."""

    vis: np.ndarray
    scales: np.ndarray
    uv: np.ndarray
    flip_flags: np.ndarray
    patchx: int
    patchy: int
    num_baselines: int


def _flip_flags(rng: np.random.Generator) -> tuple[bool, bool]:
    """``default_augment``'s two draws: (flip in time, flip in frequency)."""
    return rng.random() < 0.5, rng.random() < 0.5


def default_augment(rng: np.random.Generator, patches: np.ndarray) -> np.ndarray:
    """Random time/freq flips (the reference leaves its transform unspecified;
    reference: src/lofar_tools.py:196-203)."""
    flip_t, flip_f = _flip_flags(rng)
    out = patches
    if flip_t:
        out = out[:, ::-1, :, :]
    if flip_f:
        out = out[:, :, ::-1, :]
    return np.ascontiguousarray(out)


class _SignatureRng:
    """Proxy around ``np.random.Generator`` recording the signature of every draw, so a
    data-dependent ``augment_fn`` (which would desynchronise ``skip()``) raises."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self.calls: list = []

    @staticmethod
    def _norm(v):
        if isinstance(v, np.ndarray):
            return ("arr", v.shape)
        if isinstance(v, (int, float, bool, str, bytes, tuple, type(None))):
            return v
        return ("obj", type(v).__name__)

    def __getattr__(self, name):
        attr = getattr(self._rng, name)
        if not callable(attr):
            return attr

        def wrapped(*a, **k):
            self.calls.append((name, tuple(self._norm(v) for v in a),
                               tuple(sorted((kk, self._norm(vv)) for kk, vv in k.items()))))
            return attr(*a, **k)

        return wrapped


class MinibatchSampler:
    """Random (file, SAP, baselines) sampler producing ``Minibatch`` objects.

    ``use_native``: how ``sample()`` decodes.  None means the native decoder wherever
    there is a C++ compiler (``native.available()``), else numpy; True the native
    decoder, or raise; False numpy.  A native build that fails raises here.  Both make
    the same rng draws.

    ``process_index`` is folded into the rng stream, so that the ranks of a
    data-parallel run draw disjoint minibatches.  None means this process's rank when a
    process group of more than one rank is initialised, else 0 (JAX's default, with
    ``jax.process_index()``)."""

    def __init__(self, file_list: list[Source], sap_list: list[str], cfg: DataConfig,
                 seed: int = 0,
                 augment_fn: Callable[[np.random.Generator, np.ndarray], np.ndarray] | None = None,
                 process_index: int | None = None, use_native: bool | None = None):
        if len(file_list) != len(sap_list) or not file_list:
            raise ValueError("file_list and sap_list must be non-empty and parallel")
        if process_index is None:
            dist = torch.distributed
            process_index = (dist.get_rank() if dist.is_available() and dist.is_initialized()
                             and dist.get_world_size() > 1 else 0)
        self.file_list = file_list
        self.sap_list = sap_list
        self.cfg = cfg
        self._seed = seed
        self._process_index = process_index
        self.rng = np.random.default_rng([seed, process_index])
        self.augment_fn = augment_fn or default_augment
        self._meta = [read_metadata(f, s) for f, s in zip(file_list, sap_list)]
        self.use_native = native_choice(use_native)
        # the augment fn must consume the rng identically for every input: probe it on
        # two different inputs with a throwaway rng, so a violation fails here
        self._augment_sig: list | None = None
        if cfg.augment:
            probe_rng = np.random.default_rng(0)
            shape = (2, 8, 8, cfg.num_channels)
            for probe in (probe_rng.normal(size=shape).astype(np.float32),
                          np.zeros(shape, np.float32)):
                proxy = _SignatureRng(np.random.default_rng(1))
                self.augment_fn(proxy, probe)
                self._check_augment_sig(proxy.calls, where="construction probe")

    def _check_augment_sig(self, calls: list, where: str) -> None:
        if self._augment_sig is None:
            self._augment_sig = calls
        elif calls != self._augment_sig:
            raise RuntimeError(
                f"augment_fn's rng consumption is data-dependent: draw signature {calls!r} "
                f"at {where} differs from {self._augment_sig!r}; skip() replays the rng "
                "stream without data, so the transform must draw a fixed sequence")

    def reseed(self, epoch: int) -> None:
        """Deterministic per-epoch stream."""
        self.rng = np.random.default_rng([self._seed, self._process_index, epoch])

    def _draw(self) -> tuple[int, np.ndarray]:
        """The minibatch's first draws, shared by ``sample``, ``sample_raw`` and
        ``skip``: the (file, SAP) index, then ``batch_size`` baseline ids."""
        idx = int(self.rng.integers(0, len(self.file_list)))
        return idx, self.rng.integers(0, self._meta[idx][0], self.cfg.batch_size)

    def skip(self, n: int) -> None:
        """Advance past ``n`` minibatches without reading data, by replaying exactly the
        rng draws ``sample()`` makes."""
        dummy = np.zeros((1, 1, 1, 1), dtype=np.float32)
        for _ in range(n):
            self._draw()
            if self.cfg.augment:
                for _ in range(self.cfg.batch_size):
                    proxy = _SignatureRng(self.rng)
                    self.augment_fn(proxy, dummy)
                    self._check_augment_sig(proxy.calls, where="skip() replay")

    def sample(self) -> Minibatch:
        cfg = self.cfg
        idx, baseline_ids = self._draw()
        source, sap = self.file_list[idx], self.sap_list[idx]

        if self.use_native:
            vis, scales = read_baseline_raw(source, sap, baseline_ids)
            patches, (px, py) = native.decode_patchify(
                vis, scales, pols_for(cfg.num_channels), cfg.patch_size, cfg.clamp,
                normalize=cfg.normalize)
        else:
            x = read_baseline_channels(source, sap, baseline_ids, cfg.num_channels,
                                       cfg.patch_size)
            patches, (px, py) = patchify(x, cfg.patch_size)
            patches = np.clip(patches, -cfg.clamp, cfg.clamp)
            if cfg.normalize:
                std = patches.std()
                patches = (patches - patches.mean()) / (std if std > 0 else 1.0)

        if cfg.uvdist:
            uv = compute_uv(source, sap, baseline_ids)          # [B, 2]
        else:
            uv = np.zeros((cfg.batch_size, 2), dtype=np.float32)
        ppb = px * py
        uv_full = np.repeat(uv, ppb, axis=0)                    # baseline-major

        if cfg.augment:
            grouped = patches.reshape(cfg.batch_size, ppb, *patches.shape[1:])
            pieces = []
            for b in range(cfg.batch_size):
                pieces.append(grouped[b])
                proxy = _SignatureRng(self.rng)
                pieces.append(self.augment_fn(proxy, grouped[b]))
                self._check_augment_sig(proxy.calls, where="sample()")
            patches = np.concatenate(pieces, axis=0)
            uv_full = np.repeat(uv, 2 * ppb, axis=0)

        return Minibatch(x=patches.astype(np.float32), uv=uv_full.astype(np.float32),
                         patchx=px, patchy=py, num_baselines=cfg.batch_size)

    @property
    def supports_device_decode(self) -> bool:
        """The device decode reproduces only the default flip augmentation (its rng
        decisions travel as flags); a custom ``augment_fn`` needs the host decode."""
        return not self.cfg.augment or self.augment_fn is default_augment

    def sample_raw(self) -> RawMinibatch:
        """``sample()`` without the decode.  It makes exactly ``sample()``'s rng draws
        (``_draw``, then, augmenting, ``default_augment``'s ``_flip_flags`` per
        baseline), so ``skip()``, checkpoints and exact resume are interchangeable
        between the host and the device decode."""
        cfg = self.cfg
        if not self.supports_device_decode:
            raise RuntimeError(
                "sample_raw: a custom augment_fn cannot be replayed on the device; use "
                "the host decode (data.device_decode=False)")
        idx, baseline_ids = self._draw()
        source, sap = self.file_list[idx], self.sap_list[idx]
        ntime, nfreq = self._meta[idx][1:3]
        vis, scales = read_baseline_raw(source, sap, baseline_ids)
        if cfg.uvdist:
            uv = compute_uv(source, sap, baseline_ids)
        else:
            uv = np.zeros((cfg.batch_size, 2), dtype=np.float32)
        flags = np.zeros((cfg.batch_size, 2), dtype=bool)
        if cfg.augment:
            for b in range(cfg.batch_size):
                flags[b] = _flip_flags(self.rng)
        px, py = patch_grid_shape(max(ntime, cfg.patch_size), max(nfreq, cfg.patch_size),
                                  cfg.patch_size)
        return RawMinibatch(vis=vis, scales=scales, uv=uv.astype(np.float32),
                            flip_flags=flags, patchx=px, patchy=py,
                            num_baselines=cfg.batch_size)


class DeviceStaging:
    """Host arrays -> tensors on ``device``.  On a CUDA device ``put`` (from any thread)
    pins the arrays and copies them with ``non_blocking`` on a side stream, and ``take``
    makes the consumer's current stream wait for that copy (and for what ``put``'s
    ``then`` queued after it on that stream)."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def put(self, *arrays: np.ndarray, then: Callable | None = None) -> tuple[Any, Any]:
        """The arrays as device tensors, or ``then(*tensors)`` run on them on the same
        stream, and the event recorded after both (None off the card)."""
        ts = [torch.from_numpy(a) for a in arrays]
        if self.stream is None:
            ts = [t.to(self.device) for t in ts]
            return (then(*ts) if then else ts), None
        with torch.cuda.stream(self.stream):
            ts = [t.pin_memory().to(self.device, non_blocking=True) for t in ts]
            out = then(*ts) if then else ts
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def take(self, tensors, ready) -> None:
        """Order the current stream after the copy of ``tensors``."""
        if ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for t in tensors:
            t.record_stream(stream)   # allocated on the copy stream, used here


class PrefetchIterator:
    """Background thread that samples on the host and copies to ``device``, keeping a
    bounded queue so the device never waits on decoding.  On a CUDA device the host
    arrays are pinned and copied with ``non_blocking`` on a side stream; the consumer's
    stream waits for that copy (``DeviceStaging``).  A producer error is raised in the
    consumer."""

    def __init__(self, sampler: MinibatchSampler, size: int = 2,
                 device: torch.device | str = "cpu"):
        self._staging = DeviceStaging(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(size, 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._sampler = sampler
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _item(self) -> tuple[Minibatch, Any]:
        """The next minibatch on the device, and the event ``take`` waits for."""
        with span("prefetch.sample"):
            mb = self._sampler.sample()
        with span("prefetch.stage"):
            (x, uv), ready = self._staging.put(mb.x, mb.uv)
        return Minibatch(x=x, uv=uv, patchx=mb.patchx, patchy=mb.patchy,
                         num_baselines=mb.num_baselines), ready

    def _producer(self) -> None:
        while not self._stop.is_set():
            try:
                item, ready = self._item()
            except Exception as e:    # surfaced in the consumer by __next__
                self._err = e
                self._stop.set()
                return
            while not self._stop.is_set():
                try:
                    self._q.put((item, ready), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Minibatch]:
        return self

    def __next__(self) -> Minibatch:
        while True:
            try:
                item, ready = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._err is not None:
                    raise RuntimeError("prefetch failed") from self._err
        self._staging.take((item.x, item.uv), ready)
        return item

    def close(self) -> None:
        self._stop.set()
        try:      # drain so a blocked put returns and device buffers are freed
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DeviceDecodePrefetcher(PrefetchIterator):
    """``PrefetchIterator`` that copies the raw int8 visibilities, scales and flip flags
    (``sample_raw``) and decodes them on ``device`` (``device_decode_train``): the step
    sees the same [N, ps, ps, C] minibatch, and the copy carries 5.8 times fewer bytes
    at full width (11.6 with augmentation).  On a CUDA device the copy and the decode
    run on the staging side stream, under ``no_grad`` (not ``inference_mode``: the step
    saves its input for backward); the consumer's stream waits for the decode, and the
    decoded ``x`` and ``uv``, allocated on the side stream, are marked as used by the
    consumer's (``DeviceStaging.take``).  The raw tensors are read on the side stream
    only.  A sampler with a custom ``augment_fn`` fails in ``sample_raw``, and the first
    ``next`` raises it."""

    def _decode(self, vis, scales, flags, uv):
        cfg = self._sampler.cfg
        with torch.no_grad():
            x = device_decode_train(vis, scales, flags, num_channels=cfg.num_channels,
                                    patch_size=cfg.patch_size, clamp=cfg.clamp,
                                    normalize=cfg.normalize, augment=cfg.augment)
        return x, uv

    def _item(self) -> tuple[Minibatch, Any]:
        with span("prefetch.sample"):
            raw = self._sampler.sample_raw()
        ppb = raw.patchx * raw.patchy * (2 if self._sampler.cfg.augment else 1)
        with span("prefetch.stage"):
            (x, uv), ready = self._staging.put(raw.vis, raw.scales, raw.flip_flags,
                                               np.repeat(raw.uv, ppb, axis=0),
                                               then=self._decode)
        return Minibatch(x=x, uv=uv, patchx=raw.patchx, patchy=raw.patchy,
                         num_baselines=raw.num_baselines), ready
