"""Training metrics logging (port of ``lshm_tpu/utils/metrics.py``).

One stdout line per ADMM iteration in the reference's format
(``epoch batch admm loss0..rica``; reference: src/kharmonic_lofar.py:176-181), an
in-memory history with wall-clock time, and optionally one JSON record per logged step
in a JSONL file; ``plot`` draws the loss curves.
"""

from __future__ import annotations

import json
import time
from typing import Any

import numpy as np

_ORDER = ("loss0", "loss1", "loss2", "loss3", "kdist", "aug", "sim", "rica")


def _host(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):          # a torch tensor, possibly on the card
        v = v.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(v))


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None, echo: bool = True):
        """``jsonl_path``: truncated here, then one record per logged step: ``epoch``,
        ``iter``, ``t`` (seconds since construction), the last ADMM value of each term
        and ``patches``."""
        self.jsonl_path = jsonl_path
        self.echo = echo
        self.history: list[dict[str, Any]] = []
        self._t0 = time.perf_counter()
        if jsonl_path:
            open(jsonl_path, "w").close()

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
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def summary(self) -> dict[str, float]:
        if not self.history:
            return {}
        return {k: v for k, v in self.history[-1].items() if isinstance(v, float)}

    def plot(self, path: str, terms: tuple[str, ...] = _ORDER + ("loss",)) -> None:
        """The loss curves over the logged steps on a log scale, as a PNG (the
        reference's figures/errors.png, drawn instead of assembled by hand)."""
        from lshm_tpu_torch.utils.rgb import headless_matplotlib

        headless_matplotlib()
        import matplotlib.pyplot as plt

        if not self.history:
            return
        fig, ax = plt.subplots(figsize=(9, 5))
        xs = np.arange(len(self.history))
        for k in terms:
            ys = [h.get(k) for h in self.history]
            if any(y is not None for y in ys):
                ax.plot(xs, [y if y is not None else np.nan for y in ys], label=k)
        ax.set_xlabel("logged step")
        ax.set_ylabel("loss")
        ax.set_yscale("log")
        ax.legend(ncol=3, fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
