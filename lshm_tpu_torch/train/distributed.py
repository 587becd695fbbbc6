"""Multi-process bootstrap (port of ``lshm_tpu/train/distributed.py``).

Data parallelism across processes composes from three pieces, as in the JAX package:

1. this bootstrap: ``torch.distributed.init_process_group``, one process per card;
2. the per-process sampler stream: ``MinibatchSampler`` folds the process's rank into
   its rng, so processes draw disjoint minibatches (``lshm_tpu_torch/data/sampler.py``);
3. the data-parallel step: one gradient all-reduce per ADMM iteration
   (``lshm_tpu_torch/train/parallel.py``).

Launch with ``torchrun --nproc-per-node N -m lshm_tpu_torch.cli train ...`` (its
environment variables) or with the CLI's ``--coordinator/--num-processes/--process-id``.
"""

from __future__ import annotations

import datetime
import os

import torch

TIMEOUT = datetime.timedelta(minutes=5)   # a peer that never arrives fails the group


def on_cpu() -> bool:
    """Whether the caller asked for the CPU (``LSHM_PLATFORM=cpu``)."""
    return os.environ.get("LSHM_PLATFORM", "").lower() == "cpu"


def local_card() -> torch.device:
    """This process's card on its host, ``cuda:<LOCAL_RANK>`` (torchrun sets it; 0
    without it: the CLI's flags start one process per host); raises when this host has
    no such card, never moving the rank to another device or to the CPU."""
    index = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise RuntimeError(f"LOCAL_RANK={index} has no card: this host has {count} CUDA "
                           "device(s); LSHM_PLATFORM=cpu runs on the CPU")
    return torch.device("cuda", index)


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    *,
    timeout: datetime.timedelta = TIMEOUT,
) -> int:
    """Join the process group.  Arguments default to the variables PyTorch's launcher
    sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a no-op returning 1
    when neither arguments nor environment ask for more than one process.

    ``coordinator`` is ``host:port`` (``tcp://host:port`` for ``init_process_group``) or
    a ``file://`` store.  ``backend`` defaults to ``"nccl"`` on cards and ``"gloo"``
    under ``LSHM_PLATFORM=cpu``; on cards the process's current device becomes
    ``local_card()``.  A peer that has not joined within ``timeout`` makes this raise,
    and every collective of the group is bounded by it too.  Returns the world size."""
    import torch.distributed as dist

    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE") or 0)
    if coordinator is None and num_processes != 1 and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
    if process_id is None and env.get("RANK") is not None:
        process_id = int(env["RANK"])

    if not coordinator and num_processes <= 1:
        return 1
    if not coordinator or num_processes <= 1:
        # exactly one of (coordinator, num_processes > 1) was given: a misconfigured
        # launch; proceeding single-process would train diverging replicas
        raise ValueError(
            "incomplete multi-host configuration: need BOTH a coordinator address and "
            f"num_processes > 1 (got coordinator={coordinator!r}, "
            f"num_processes={num_processes})"
        )
    if process_id is None:
        raise ValueError(f"num_processes={num_processes} needs this process's id "
                         "(process_id, or RANK in the environment)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id={process_id} is not in [0, {num_processes})")
    if "://" in coordinator:
        init_method = coordinator
    else:
        host, _, port = coordinator.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator={coordinator!r}: expected host:port")
        init_method = f"tcp://{coordinator}"

    if not on_cpu():
        torch.cuda.set_device(local_card())
    if backend is None:
        backend = "gloo" if on_cpu() else "nccl"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return dist.get_world_size()
