"""Device ms per ADMM iteration of the DFT's kernels (``rooflines/dft.py``) in the
profiled stretch; nothing where none ran."""

from portbench.readers import _per_iter, _stretch
from portbench.rooflines import dft


def read(rec: dict):
    s = _stretch(rec)
    if s is None:
        return None
    calls, sec = dft.spent(s["kernels"])
    return _per_iter(rec, 1e3 * sec) if calls else None
