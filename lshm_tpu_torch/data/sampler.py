"""Training minibatch sampler (host side) with device prefetch (port of the host-decode
path of ``lshm_tpu/data/sampler.py``; reference: src/lofar_tools.py:51-211).

Randomly pick one (file, SAP), randomly pick ``batch_size`` baselines, decode int8 x scale
into real channels, patchify baseline-major, clamp, z-normalise over the minibatch, and
optionally double the batch with an augmentation transform interleaved per baseline.
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

from lshm_tpu_torch.config import DataConfig
from lshm_tpu_torch.data.h5io import Source, compute_uv, read_baseline_channels, read_metadata
from lshm_tpu_torch.data.patches import patchify


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


def default_augment(rng: np.random.Generator, patches: np.ndarray) -> np.ndarray:
    """Random time/freq flips (the reference leaves its transform unspecified;
    reference: src/lofar_tools.py:196-203)."""
    out = patches
    if rng.random() < 0.5:
        out = out[:, ::-1, :, :]
    if rng.random() < 0.5:
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
    """Random (file, SAP, baselines) sampler producing ``Minibatch`` objects."""

    def __init__(self, file_list: list[Source], sap_list: list[str], cfg: DataConfig,
                 seed: int = 0,
                 augment_fn: Callable[[np.random.Generator, np.ndarray], np.ndarray] | None = None,
                 process_index: int = 0):
        if len(file_list) != len(sap_list) or not file_list:
            raise ValueError("file_list and sap_list must be non-empty and parallel")
        self.file_list = file_list
        self.sap_list = sap_list
        self.cfg = cfg
        self._seed = seed
        self._process_index = process_index
        self.rng = np.random.default_rng([seed, process_index])
        self.augment_fn = augment_fn or default_augment
        self._meta = [read_metadata(f, s) for f, s in zip(file_list, sap_list)]
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

    def skip(self, n: int) -> None:
        """Advance past ``n`` minibatches without reading data, by replaying exactly the
        rng draws ``sample()`` makes."""
        dummy = np.zeros((1, 1, 1, 1), dtype=np.float32)
        for _ in range(n):
            idx = int(self.rng.integers(0, len(self.file_list)))
            self.rng.integers(0, self._meta[idx][0], self.cfg.batch_size)
            if self.cfg.augment:
                for _ in range(self.cfg.batch_size):
                    proxy = _SignatureRng(self.rng)
                    self.augment_fn(proxy, dummy)
                    self._check_augment_sig(proxy.calls, where="skip() replay")

    def sample(self) -> Minibatch:
        cfg = self.cfg
        idx = int(self.rng.integers(0, len(self.file_list)))
        source, sap = self.file_list[idx], self.sap_list[idx]
        baseline_ids = self.rng.integers(0, self._meta[idx][0], cfg.batch_size)

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


class PrefetchIterator:
    """Background thread that samples on the host and copies to ``device``, keeping a
    bounded queue so the device never waits on decoding.  On a CUDA device the host
    arrays are pinned and copied with ``non_blocking`` on a side stream; the consumer's
    stream waits for that copy.  A producer error is raised in the consumer."""

    def __init__(self, sampler: MinibatchSampler, size: int = 2,
                 device: torch.device | str = "cpu"):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self._device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=max(size, 1))
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._sampler = sampler
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if not self._cuda:
            return t.to(self._device)
        with torch.cuda.stream(self._copy_stream):
            return t.pin_memory().to(self._device, non_blocking=True)

    def _producer(self) -> None:
        while not self._stop.is_set():
            try:
                mb = self._sampler.sample()
                item = Minibatch(x=self._to_device(mb.x), uv=self._to_device(mb.uv),
                                 patchx=mb.patchx, patchy=mb.patchy,
                                 num_baselines=mb.num_baselines)
                ready = None
                if self._cuda:
                    ready = torch.cuda.Event()
                    ready.record(self._copy_stream)
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
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in (item.x, item.uv):
                t.record_stream(stream)   # allocated on the copy stream, used here
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
