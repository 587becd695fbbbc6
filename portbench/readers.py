"""The arithmetic of the per-layer metrics, each from the record a driver returns for a
``--trace 1`` run: the profiled stretch (``trace.Stretch.summary``) of whole units of
work after the window, and the window's own counts and seconds.  Each ``metrics/<metric>.py``
binds one of these; a reader that finds nothing to read returns None."""

from __future__ import annotations

from portbench.rooflines import PEAK_FLOP_S
from portbench.rooflines import head as head_rl
from portbench.rooflines import khm as khm_rl


def base_name(kernel: str) -> str:
    """A kernel's name without namespaces and template arguments:
    ``tc::head_fwd_tc_kernel<4, float>`` -> ``head_fwd_tc_kernel``."""
    return kernel.split("<", 1)[0].rsplit("::", 1)[-1]


def _by_base(kernels: dict) -> dict:
    out: dict[str, list] = {}
    for name, (calls, sec) in kernels.items():
        d = out.setdefault(base_name(name), [0, 0.0])
        d[0] += calls
        d[1] += sec
    return out


def _stretch(rec: dict):
    s = rec.get("stretch")
    return s if s and s["kernels"] else None


def idle_share(rec: dict):
    """Per cent of a unit of work's wall time in which no device operation ran: the
    device's busy time per unit in the profiled stretch over the untraced window's wall
    time per unit, so that the profiler's own cost on the host counts in neither."""
    s = _stretch(rec)
    if s is None or not rec["window_units"]:
        return None
    wall = rec["window_s"] / rec["window_units"]
    return 100.0 * (1.0 - s["busy_s"] / rec["profiled_units"] / wall)


def window_flops(rec: dict) -> float:
    """Model FLOPs of the work completed in the window (``rooflines/model_flops.py``):
    an Adam ADMM iteration one forward and one backward of the objective."""
    f = rec["flops"]
    return rec["window_units"] * rec["admm_iters"] * (f["fwd"] + f["bwd"])


def mfu(rec: dict):
    """Per cent of the card's dense bf16 peak that the window's model FLOPs make."""
    if not rec["window_s"] or not rec["window_units"]:
        return None
    return 100.0 * window_flops(rec) / rec["window_s"] / PEAK_FLOP_S


def _family_share(rec: dict, names: dict, calls: dict, bound) -> float | None:
    s = _stretch(rec)
    if s is None:
        return None
    k = _by_base(s["kernels"])
    spent = sum(k[n][1] for op in names.values() for n in op if n in k)
    least = 0.0
    for op, callers in calls.items():
        callers = (callers,) if isinstance(callers, str) else callers
        launches = sum(k[n][0] for n in callers if n in k)
        least += bound(op, launches)
    return 100.0 * least / spent if spent > 0 else None


def head_roofline(rec: dict):
    """Per cent: the fused head's least time (K3, K4 with its reduction, K5) over its
    device time in the stretch; a bound per launch from its batch."""
    h = rec["head"]
    return _family_share(rec, head_rl.NAMES, head_rl.CALLS, lambda op, n: n * head_rl.bound(
        op, h["batches"], h["patch"], h["channels"], h["itemsize"]))


def khm_roofline(rec: dict):
    """Per cent: K1's and K2's least time over their device time in the stretch."""
    m = rec.get("khm")
    if m is None:
        return None
    calls = {op: names[0] for op, names in khm_rl.NAMES.items()}
    return _family_share(rec, khm_rl.NAMES, calls,
                         lambda op, n: n * khm_rl.bound(op, m["n"], m["k"], m["d"]))


def _per_iter(rec: dict, value: float):
    iters = rec["profiled_units"] * rec["admm_iters"]
    return value / iters if iters else None


def conv_ms_per_iter(rec: dict):
    """Device ms of convolution kernels per ADMM iteration in the stretch."""
    s = _stretch(rec)
    return None if s is None else _per_iter(rec, 1e3 * s["categories"].get("convolution", 0.0))


def launches_per_iter(rec: dict):
    """Device operations (kernels, copies, fills) per ADMM iteration in the stretch."""
    s = _stretch(rec)
    return None if s is None else _per_iter(rec, sum(c for c, _ in s["kernels"].values()))


def sample_ms(rec: dict):
    """Median host ms of the sampler's ``sample_raw`` in the window."""
    return rec.get("sample_ms")
