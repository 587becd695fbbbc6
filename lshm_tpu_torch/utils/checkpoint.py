"""Checkpoints as one ``torch.save`` file per step (the port's stand-in for the JAX
package's orbax checkpoints): parameters, optimizer state and step in
``ckpt_<step>.pt``, and the config and position in a JSON sidecar ``extras_<step>.json``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch


def save_checkpoint(ckpt_dir: str, state: dict[str, Any], step: int,
                    extras: dict | None = None) -> str:
    """Write ``state`` (tensors and plain containers) for ``step``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{step}.pt")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)            # a crash mid-write never leaves a torn checkpoint
    if extras:
        with open(os.path.join(ckpt_dir, f"extras_{step}.json"), "w") as f:
            json.dump(extras, f, indent=2, default=str)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(n[5:-3]) for n in os.listdir(ckpt_dir)
             if n.startswith("ckpt_") and n.endswith(".pt") and n[5:-3].isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       map_location: Any = "cpu") -> tuple[dict, dict | None]:
    """(state, extras) of ``step`` (default: the latest)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
    state = torch.load(os.path.join(ckpt_dir, f"ckpt_{step}.pt"),
                       map_location=map_location, weights_only=True)
    extras = None
    sidecar = os.path.join(ckpt_dir, f"extras_{step}.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            extras = json.load(f)
    return state, extras
