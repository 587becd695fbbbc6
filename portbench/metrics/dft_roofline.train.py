"""Per cent: the DFT's least time over the device time of its kernels in the profiled
stretch.  The least time is a bound per call from the transform's shapes
(``rooflines/dft.py``), times the forwards and backwards the port's counters
(``dft_calls``) counted over the stretch; nothing where the port has no counters."""

from portbench.readers import _stretch
from portbench.rooflines import dft


def read(rec: dict):
    s, d = _stretch(rec), rec.get("dft")
    if s is None or d is None or not s.get("dft_calls"):
        return None
    _, sec = dft.spent(s["kernels"])
    if sec <= 0:
        return None
    shape = (d["batches"], d["patch"], d["channels"], d["itemsize"])
    least = sum(s["dft_calls"][f"dft_{op}"] * dft.bound(op, *shape) for op in ("fwd", "bwd"))
    return 100.0 * least / sec
