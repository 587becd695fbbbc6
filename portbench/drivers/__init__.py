"""The drivers a traffic mix names (``traffic/<mix>.json``: ``"driver"``), each with a
``run(ctx) -> dict``, and what they share."""

from __future__ import annotations

import gc
import tempfile
import time

import torch


class Phases(dict):
    """Seconds of set-up by phase, each from the end of the one before; ``imports``
    from the process's start."""

    def __init__(self, t_start: float):
        self._t = time.perf_counter()
        super().__init__(imports=self._t - t_start)

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self[name], self._t = now - self._t, now


def load_trainer(cfg, params: dict, device: torch.device, logger=None):
    """A ``Trainer`` holding ``params``, loaded from a parameters-only checkpoint under
    ``TMPDIR`` the way the CLI loads one (``Trainer.load``)."""
    from lshm_tpu_torch.train import Trainer
    from lshm_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as ckdir:
        save_checkpoint(ckdir, {"params": {k: v.cpu() for k, v in params.items()}}, 0)
        trainer = Trainer(cfg, device=device, logger=logger)
        trainer.load(ckdir)
    return trainer


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated() if device.type == "cuda" else 0


def release(device: torch.device) -> None:
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
