"""Training metrics logging (port of ``lshm_tpu/utils/metrics.py``).

One stdout line per ADMM iteration in the reference's format
(``epoch batch admm loss0..rica``; reference: src/kharmonic_lofar.py:176-181) and an
in-memory history with wall-clock time.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

_ORDER = ("loss0", "loss1", "loss2", "loss3", "kdist", "aug", "sim", "rica")


def _host(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):          # a torch tensor, possibly on the card
        v = v.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(v))


class MetricLogger:
    def __init__(self, echo: bool = True):
        self.echo = echo
        self.history: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()

    def log_step(self, epoch: int, it: int, metrics: dict[str, Any],
                 patches: int | None = None) -> None:
        """``metrics`` values may be [admm_iters]-stacked tensors from the step."""
        stacked = {k: _host(v) for k, v in metrics.items()}
        nadmm = len(next(iter(stacked.values())))
        now = time.perf_counter()
        if self.echo:
            for admm in range(nadmm):
                vals = [float(stacked[k][admm]) for k in _ORDER if k in stacked]
                print(f"{epoch} {it} {admm} " + " ".join(f"{v:f}" for v in vals))
        rec = {"epoch": epoch, "iter": it, "t": now - self._t0,
               **{k: float(v[-1]) for k, v in stacked.items()}}
        if patches:
            rec["patches"] = patches
        self.history.append(rec)

    def summary(self) -> dict[str, float]:
        if not self.history:
            return {}
        return {k: v for k, v in self.history[-1].items() if isinstance(v, float)}
