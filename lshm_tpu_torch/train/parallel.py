"""Data-parallel training over ``torch.distributed`` (port of
``lshm_tpu/train/parallel.py``).

JAX builds a device mesh, shards the patch batch on its ``data`` axis, replicates the
state and lets GSPMD (or ``shard_map`` with hand-placed ``pmean``s) insert the
collectives.  The port runs one process per card and places the collectives itself:
every rank steps on its own rows with the rank's own augmentation groups, and the ranks
meet in

- one all-reduce of one flat buffer per Adam update: every gradient of the optimizer's
  parameters (the active group's), divided by the world size (JAX's ``pmean(grads)``,
  "the one collective");
- one all-reduce per L-BFGS closure evaluation: value and gradient in one buffer, or
  the value alone for a value-only probe, so that every rank sees the same numbers and
  takes the same line-search branches and ``.item()`` reads;
- one all-reduce of the stacked per-term metrics per minibatch, so that every rank
  logs the same values and takes the same non-finite revert decision.

Why the mean of the ranks' objectives is the global objective: the shards are equal
and every term is a sum over its batch divided by a count proportional to it (loss0-3
by numel, kdist by N K D, aug by num_groups P, rica by size; sim reads M only).  So each
rank passes its local number of baselines as ``num_groups``; JAX passes the global count
because its step sees the global batch (``make_train_step_shard_map``'s docstring).

Explicit collectives rather than ``DistributedDataParallel``: the L-BFGS closures
evaluate the model through ``functional_call`` on detached parameter dicts, which DDP's
parameter hooks never see; value-only closures need a reduction DDP does not do; and
DDP's hooks would fire inside every backward of the line search.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from lshm_tpu_torch.config import Config


def world_and_rank() -> tuple[int, int]:
    """(world size, rank) of the default process group, (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def data_parallel_layout(mesh_shape: Sequence[int], world: int | None = None) -> int:
    """The number of ranks the batch is split over, from ``train.mesh_shape`` and the
    process group's world size (JAX's ``Trainer.mesh`` rules, one process per card):
    one process with a product of 1 (or ``()``, or a ``-1``) trains alone; more than
    one process spans every rank on the first axis when the product is 1, holds a
    ``-1`` or equals the world size.  Every axis but the first must have size 1 (the
    port splits the data axis only), so multi-axis ``mesh_axes`` such as
    ``("data", "model")`` take shapes like ``(2, 1)``."""
    if world is None:
        world = world_and_rank()[0]
    shape = tuple(mesh_shape) or (1,)
    if any(s != 1 for s in shape[1:]):
        raise ValueError(f"train.mesh_shape={shape}: lshm_tpu_torch splits the batch "
                         "on the first (data) axis only; every other axis must be 1")
    product = math.prod(s for s in shape if s != -1)
    if world == 1:
        if product > 1:
            raise ValueError(
                f"train.mesh_shape={shape} asks for {product} devices, but this is one "
                "process: lshm_tpu_torch runs one process per card, so launch "
                f"{product} processes (torchrun --nproc-per-node {product}, or the "
                "CLI's --coordinator/--num-processes/--process-id)")
        return 1
    if -1 not in shape and product not in (1, world):
        raise ValueError(f"train.mesh_shape={shape} does not cover the {world} global "
                         f"devices of this {world}-process run")
    return world


def shard_batch(x: torch.Tensor, uv: torch.Tensor, rank: int, world: int):
    """This rank's contiguous rows of a global batch.  Batches are baseline-major, so
    whole augmentation groups stay on one rank when the number of baselines divides by
    ``world`` (JAX asserts ``num_groups % ndev == 0``): each rank then has
    ``num_groups // world`` of them."""
    n = x.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} rows does not split over {world} ranks")
    lo, hi = rank * n // world, (rank + 1) * n // world
    return x[lo:hi], uv[lo:hi]


def _copy_back(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    """Write the consecutive pieces of ``flat`` into ``tensors``, in place (one
    multi-tensor copy where the devices allow, not a launch per tensor)."""
    pieces = flat.split([t.numel() for t in tensors])
    dst = [t.detach() for t in tensors]
    src = [p.view_as(t) for p, t in zip(pieces, dst)]
    if all(t.device == flat.device for t in dst):
        torch._foreach_copy_(dst, src)
    else:
        for d, s_ in zip(dst, src):
            d.copy_(s_)


class AllReduceMean:
    """The mean over the ranks of a process group, taken in place over a list of
    tensors of one dtype with one all-reduce of one flat buffer.  ``calls`` and
    ``values`` count the all-reduces and the values they carried."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.world = dist.get_world_size(group)
        self.calls = 0
        self.values = 0

    def __call__(self, tensors: Sequence[torch.Tensor]) -> None:
        import torch.distributed as dist

        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world
        _copy_back(flat, tensors)
        self.calls += 1
        self.values += flat.numel()


def _tensors(obj) -> list[torch.Tensor]:
    """Every tensor in nested dicts and lists, in their order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def replicate_state(state, src: int = 0, group=None) -> None:
    """Broadcast rank ``src``'s parameters and optimizer state (Adam's moments and step
    counts, or the L-BFGS state's tensors) to every rank, in place: one broadcast of one
    flat buffer per dtype, staged on the parameters' device."""
    import torch.distributed as dist

    tensors = list(state.model.state_dict().values())
    if state.opt is not None:
        tensors += _tensors(state.opt.state_dict())
    device = next(state.model.parameters()).device
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in group_tensors])
        dist.broadcast(flat, src=src, group=group)
        _copy_back(flat, group_tensors)


def barrier(group=None) -> None:
    """Every rank waits here for the others (on NCCL, on this process's card)."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def mean_metrics(metrics: dict[str, torch.Tensor],
                 mean: Callable[[Sequence[torch.Tensor]], None]) -> dict[str, torch.Tensor]:
    """The ranks' mean of a step's stacked per-term metrics, in one all-reduce."""
    if not metrics:
        return metrics
    keys = list(metrics)
    stacked = torch.stack([metrics[k] for k in keys])
    mean([stacked])
    return dict(zip(keys, stacked.unbind(0)))


def make_data_parallel_step(cfg: Config, num_groups: int, mean: AllReduceMean,
                            kind: str = "adam", group: str = "all",
                            fused: bool = False) -> Callable:
    """The port's Adam step (``fused`` or not) or L-BFGS step over this rank's rows,
    with the reductions of this module: (state, x, uv, weights) -> (state, metrics),
    the metrics the ranks' mean.  ``num_groups`` is this rank's number of baselines
    (see the module's docstring).  The state must start equal on every rank
    (``replicate_state``); the reductions keep it so."""
    from lshm_tpu_torch.train.step import make_lbfgs_train_step, make_train_step

    if kind == "adam":
        inner = make_train_step(cfg, num_groups, fused=fused, grad_mean=mean)
    else:
        inner = make_lbfgs_train_step(cfg, num_groups, group, grad_mean=mean)

    def step(state, x, uv, w):
        state, metrics = inner(state, x, uv, w)
        return state, mean_metrics(metrics, mean)

    return step
