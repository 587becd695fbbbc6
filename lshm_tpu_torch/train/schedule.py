"""Alternating-update groups and the published alpha/beta/gamma ramp as data (port of
``lshm_tpu/train/schedule.py``; reference: src/kharmonic_lofar.py:86-92, README.md:24-30).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from lshm_tpu_torch.config import RampStage

# model-group name -> top-level submodule names it owns
GROUP_KEYS = {
    "ae2d": ("ae2d",),
    "ae1d": ("aeT", "aeF", "aef"),
    "khm": ("khm",),
}


def group_mask(names: Iterable[str], group: str) -> dict[str, bool]:
    """{parameter name: belongs to ``group``} for state_dict-style dotted names;
    ``group='all'`` is all-True."""
    if group == "all":
        return {n: True for n in names}
    keys = GROUP_KEYS[group]
    return {n: n.split(".", 1)[0] in keys for n in names}


def active_group(schedule: Sequence[str], epoch: int) -> str:
    """Which group trains this epoch (cycled); 'all' when no schedule is configured."""
    if not schedule:
        return "all"
    return schedule[epoch % len(schedule)]


def ramp_stage_for_epoch(ramp: Sequence[RampStage], epoch: int) -> RampStage | None:
    """The ramp stage covering ``epoch`` (stages are consecutive epoch spans); the last
    stage extends indefinitely.  None if no ramp is configured."""
    if not ramp:
        return None
    e = 0
    for stage in ramp:
        e += stage.epochs
        if epoch < e:
            return stage
    return ramp[-1]
