"""Driver of the Fourier cascade's training cells: ``drivers/trainer.py``'s run, the
same code, with the Fourier reference's weights (``weights_fourier``), ADMM Adam
trajectory (``reference/fourier.py``) and model-FLOP count
(``rooflines/model_flops_fourier.py``) in place of the 1D cascade's.  Its traffic
parameters are ``trainer.py``'s.

The profiled stretch of a ``--trace 1`` run also reads the port's DFT call counters
(``lshm_tpu_torch.models.cascade.dft_calls``, forwards and backwards) from its start to
its stop, under ``dft_calls`` (None where the port has no such counters), and the
record gains the transform's shapes under ``dft``.  Every run prints the port's graph
counts (captures, replays, eager ADMM iterations) over the run on standard error.
"""

from __future__ import annotations

import sys
import types

from portbench import trace, weights_fourier
from portbench.drivers import trainer
from portbench.reference import fourier
from portbench.reference.rebound import rebound
from portbench.rooflines import model_flops_fourier


def _dft_calls() -> dict | None:
    from lshm_tpu_torch.models import cascade

    calls = getattr(cascade, "dft_calls", None)
    return dict(calls) if calls is not None else None


class Stretch(trace.Stretch):
    """``trace.Stretch`` that reads the port's DFT call counters over the stretch."""

    def start(self) -> None:
        super().start()
        self.calls0 = _dft_calls()

    def stop(self) -> None:
        super().stop()
        self.calls1 = _dft_calls()

    def summary(self) -> dict:
        out = super().summary()
        c0, c1 = self.calls0, self.calls1
        out["dft_calls"] = {k: c1[k] - c0[k] for k in c0} if c0 is not None else None
        return out


_run = rebound(trainer.run, weights=weights_fourier,
               ref_train=types.SimpleNamespace(adam=fourier.adam),
               model_flops=model_flops_fourier,
               trace=types.SimpleNamespace(Stretch=Stretch))


def run(ctx) -> dict:
    from lshm_tpu_torch.train.step import graph_counts, reset_graph_counts

    reset_graph_counts()
    out = _run(ctx)
    print(f"portbench: graph_counts {graph_counts()}", file=sys.stderr)
    rec = out["record"]
    rec["dft"] = {k: rec["head"][k] for k in ("batches", "patch", "channels", "itemsize")}
    return out
