"""Top-level training orchestration (port of ``lshm_tpu/train/trainer.py``;
reference: src/kharmonic_lofar.py:115-222).

Epochs x iterations x ADMM schedule, the published alpha/beta/gamma ramp with the
Adam -> L-BFGS switch (``RampStage.optimizer``, else ``optim.optimizer``), alternating
model groups, a prefetching input pipeline (decoding on the card by default, see
``_source``), metric logging, an optional ``torch.profiler`` trace of the first epoch,
the one-step-delayed non-finite revert, and checkpoints with exact resume (``load``:
parameters, optimizer state, step and the sampler position).  A switch of (optimizer
kind, group) carries the parameters over and resets the optimizer state, as in JAX; the
L-BFGS state persists across the minibatches of one (kind, group).  One card per
process; ``Trainer(cfg)`` runs on the card and raises when there is none.

In a process group of more than one rank (``train/distributed.py``) the trainer is
data-parallel (``train/parallel.py``): each rank samples its own minibatches (the
sampler folds in its rank), the state is broadcast from rank 0 whenever it is built or
loaded, and every step reduces its gradients and metrics over the ranks, so that the
parameters stay bit-identical.  Under data parallelism the ranks decode on the host,
as JAX does under a mesh.  Every rank enters ``save``; rank 0 writes and the ranks
meet at a barrier after it.  The logger logs the reduced metrics on every rank: the
caller gives a JSONL path to one rank only (the CLI gives it to rank 0).

Under a profiler each minibatch's stages are spans (``utils/spans.py``):
``trainer.fetch`` (the prefetcher's next minibatch and the stream join, or the sample
and its placement), ``trainer.prepare`` (the optimizer state and the step),
``trainer.settle`` (the delayed check, with ``trainer.log`` around the logger),
``trainer.snapshot``, ``trainer.step`` and ``trainer.save``.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from lshm_tpu_torch.config import Config, check_supported
from lshm_tpu_torch.data import (DeviceDecodePrefetcher, MinibatchSampler,
                                 PrefetchIterator, scan_files)
from lshm_tpu_torch.device import resolve_device, use_exact_float32
from lshm_tpu_torch.optim import lbfgs_init
from lshm_tpu_torch.train import parallel
from lshm_tpu_torch.train.distributed import local_card
from lshm_tpu_torch.train.objective import LossWeights
from lshm_tpu_torch.train.schedule import active_group, ramp_stage_for_epoch
from lshm_tpu_torch.train.step import (
    TrainState,
    active_params,
    init_model,
    make_lbfgs_train_step,
    make_optimizer,
    make_train_step,
)
from lshm_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger
from lshm_tpu_torch.utils.spans import span


class Trainer:
    """Stateful training loop.  ``device=None`` means the card (under data parallelism
    ``cuda:<LOCAL_RANK>``).  With ``profile_dir``, the first epoch that ``run()``
    executes is traced with ``torch.profiler`` (the host, and the card on CUDA) into a
    Chrome trace ``trace_epoch_<epoch>.json`` there.  ``world_size`` and ``rank`` say
    how the batch is split (1 and 0 without data parallelism)."""

    def __init__(self, cfg: Config, device: str | torch.device | None = None,
                 logger: MetricLogger | None = None, profile_dir: str | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.world_size = parallel.data_parallel_layout(cfg.train.mesh_shape)
        self.rank = parallel.world_and_rank()[1] if self.world_size > 1 else 0
        # the ranks' mean of gradients and metrics (None: one process, no collective)
        self._mean = parallel.AllReduceMean() if self.world_size > 1 else None
        if device is None and self._mean is not None:
            device = local_card()
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_exact_float32()
        self.logger = logger or MetricLogger(echo=True)
        self.profile_dir = profile_dir
        self.state: TrainState | None = None
        self._opt_kind: tuple[str, str] | None = None    # (optimizer kind, group)
        self._resume_epoch = 0       # where the next run() starts (set by load)
        self._resume_iter = 0

    @property
    def model(self):
        return None if self.state is None else self.state.model

    def _ensure_state(self, kind: str, group: str) -> None:
        """Build the optimizer state of (kind, group) on a switch; the parameters (and
        the step count) carry over.  After a params-only ``load`` the state holds the
        model and no optimizer, and ``_opt_kind`` is None, so the first step builds
        one around the loaded parameters.  Under data parallelism the new state is
        rank 0's on every rank."""
        if self.state is not None and (kind, group) == self._opt_kind:
            return
        self._build_state(kind, group)
        self._replicate()

    def _replicate(self) -> None:
        if self._mean is not None:
            parallel.replicate_state(self.state)

    def _build_state(self, kind: str, group: str) -> None:
        if self.state is None:
            model, step = init_model(self.cfg, self.device), 0
        else:
            model, step = self.state.model, self.state.step
        opt = (make_optimizer(self.cfg, model, group) if kind == "adam" else
               lbfgs_init(active_params(model, group), self.cfg.optim.lbfgs))
        self.state = TrainState(model, opt, step)
        self._opt_kind = (kind, group)

    def _snapshot(self):
        s = self.state
        params = {k: v.detach().clone() for k, v in s.model.state_dict().items()}
        return params, copy.deepcopy(s.opt.state_dict()), s.step

    def _restore(self, snap) -> None:
        params, opt, step = snap
        self.state.model.load_state_dict(params)
        self.state.opt.load_state_dict(opt)
        self.state.step = step

    def _source(self, sampler: MinibatchSampler):
        """The prefetcher of one epoch, or None (``data.prefetch == 0``: the loop samples
        itself).  ``data.device_decode``: None decodes on the device when it is CUDA and
        the sampler can (``supports_device_decode``) and the trainer is not
        data-parallel, True requires both, False decodes on the host."""
        cfg = self.cfg.data
        if self._mean is not None and cfg.device_decode:
            raise ValueError(
                "data.device_decode=True needs an unsharded mesh and the default augment "
                "transform (custom augment_fns and sharded batches use the host-decode "
                "path)")
        if cfg.prefetch <= 0:
            if cfg.device_decode:
                raise ValueError("data.device_decode=True requires data.prefetch > 0 "
                                 "(the decode on the device runs in the prefetcher)")
            return None
        raw_ok = sampler.supports_device_decode
        if cfg.device_decode and not raw_ok:
            raise ValueError("data.device_decode=True needs the default augment "
                             "transform (a custom augment_fn uses the host decode)")
        use = cfg.device_decode
        if use is None:
            use = raw_ok and self.device.type == "cuda" and self._mean is None
        kind = DeviceDecodePrefetcher if use else PrefetchIterator
        return kind(sampler, cfg.prefetch, self.device)

    def run(self, sampler: MinibatchSampler | None = None) -> dict:
        cfg = self.cfg
        if sampler is None:
            files, saps = scan_files(cfg.data.data_dir, cfg.data.file_pattern,
                                     cfg.data.recursive_search)
            if not files:
                raise FileNotFoundError(f"no valid H5 data under {cfg.data.data_dir!r}")
            sampler = MinibatchSampler(files, saps, cfg.data, seed=cfg.train.seed)

        def place(a):
            return torch.from_numpy(a).to(self.device)

        start_epoch, start_iter = self._resume_epoch, self._resume_iter
        self._resume_epoch = self._resume_iter = 0   # consumed: a second run() starts fresh
        for epoch in range(start_epoch, cfg.train.num_epochs):
            sampler.reseed(epoch)   # per-epoch stream: a resumed run sees the same data
            first_iter = start_iter if epoch == start_epoch else 0
            if first_iter:
                sampler.skip(first_iter)   # replay the rng draws, before the prefetch thread
            stage = ramp_stage_for_epoch(cfg.train.ramp, epoch)
            src = stage if stage is not None else cfg.loss
            w = LossWeights(alpha=src.alpha, beta=src.beta, gamma=src.gamma,
                            rho=cfg.loss.rho, rica_lambda=cfg.loss.rica_lambda)
            kind = stage.optimizer if stage is not None else cfg.optim.optimizer
            group = active_group(cfg.optim.group_schedule, epoch)
            profiler = None
            if self.profile_dir is not None and epoch == start_epoch:
                profiler = self._start_profiler()
            source = None
            pending = None   # (snapshot before the step, metrics, iteration, patches)

            def settle(pending):
                """One-step-delayed non-finite guard: checked after the next minibatch
                is ready, by when the previous step has usually finished."""
                snap, metrics, pit, patches = pending
                with span("trainer.settle"):
                    if not np.isfinite(float(metrics["loss"][-1])):
                        self._restore(snap)
                        print(f"warning: non-finite loss at epoch {epoch} iter {pit}; "
                              "step reverted")
                    elif pit % max(cfg.train.log_every, 1) == 0:
                        with span("trainer.log"):
                            self.logger.log_step(epoch, pit, metrics, patches=patches)

            try:
                source = self._source(sampler)
                for it in range(first_iter, cfg.train.iters_per_epoch):
                    with span("trainer.fetch"):
                        if source is not None:
                            mb = next(source)
                            x, uv = mb.x, mb.uv
                        else:
                            mb = sampler.sample()
                            x, uv = place(mb.x), place(mb.uv)
                    with span("trainer.prepare"):
                        self._ensure_state(kind, group)
                        step = self._step(kind, group, mb.num_baselines)
                    if pending is not None:
                        settle(pending)
                    snap = None
                    if cfg.train.skip_nonfinite:
                        with span("trainer.snapshot"):
                            snap = self._snapshot()
                    with span("trainer.step"):
                        self.state, metrics = step(self.state, x, uv, w)
                    patches = x.shape[0] * self.world_size     # the global batch
                    if cfg.train.skip_nonfinite:
                        pending = (snap, metrics, it, patches)
                    elif it % max(cfg.train.log_every, 1) == 0:
                        with span("trainer.log"):
                            self.logger.log_step(epoch, it, metrics, patches=patches)
                    every = cfg.train.save_every_iters
                    if (every and cfg.train.checkpoint_dir and (it + 1) % every == 0
                            and it + 1 < cfg.train.iters_per_epoch):
                        if pending is not None:
                            settle(pending)   # never checkpoint an unchecked step
                            pending = None
                        self.save(cfg.train.checkpoint_dir,
                                  step=epoch * cfg.train.iters_per_epoch + it + 1,
                                  epoch=epoch, iter_in_epoch=it + 1)
                if pending is not None:
                    settle(pending)
            finally:
                if source is not None:
                    source.close()
                if profiler is not None:
                    self._stop_profiler(profiler, epoch)
            if cfg.train.save_every and (epoch + 1) % cfg.train.save_every == 0:
                self.save(cfg.train.checkpoint_dir,
                          step=(epoch + 1) * cfg.train.iters_per_epoch, epoch=epoch + 1)

        if cfg.train.checkpoint_dir:
            self.save(cfg.train.checkpoint_dir,
                      step=cfg.train.num_epochs * cfg.train.iters_per_epoch,
                      epoch=cfg.train.num_epochs)
        return self.logger.summary()

    def _step(self, kind: str, group: str, num_groups: int):
        """The minibatch step of (kind, group); under data parallelism ``num_groups``
        is this rank's count (``train/parallel.py`` says why)."""
        if self._mean is not None:
            return parallel.make_data_parallel_step(self.cfg, num_groups, self._mean,
                                                    kind, group)
        if kind == "adam":
            return make_train_step(self.cfg, num_groups)
        return make_lbfgs_train_step(self.cfg, num_groups, group)

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof, epoch: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)    # the epoch's kernels in the trace
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              f"trace_epoch_{epoch}.json"))

    def save(self, ckpt_dir: str, step: int, epoch: int | None = None,
             iter_in_epoch: int = 0) -> None:
        """Parameters, optimizer state (Adam's, or the L-BFGS state) and step in one
        file, with ``opt_kind`` = [kind, group]; the config and the position (epoch,
        iteration within it) beside it.  Before any step after a params-only ``load``
        there is no optimizer state, and the file holds the parameters only.  Under
        data parallelism every rank enters; rank 0 writes the file (whole, by rename)
        and no rank returns before it is written."""
        if self.state is None:
            print("warning: nothing to checkpoint (no training has run); skipping save")
            return
        with span("trainer.save"):
            if self.rank == 0:
                s = self.state
                state = {"params": s.model.state_dict()}
                if self._opt_kind is not None:
                    state.update(optimizer=s.opt.state_dict(), step=s.step,
                                 opt_kind=list(self._opt_kind))
                save_checkpoint(ckpt_dir, state, step,
                                extras={"config": self.cfg.to_dict(), "epoch": epoch,
                                        "iter": int(iter_in_epoch)})
            if self._mean is not None:
                parallel.barrier()

    def load(self, ckpt_dir: str, step: int | None = None) -> None:
        """Restore a checkpoint (default: the latest step).  A file with ``optimizer``
        and ``opt_kind`` resumes exactly: the optimizer of the saved (kind, group) is
        built first, then the parameters, its state and the step are loaded into it.
        A params-only file (an imported reference model) loads the parameters; the
        optimizer state is built around them at the first step.  The sidecar's epoch
        and iteration set where the next ``run()`` starts; a load with no recorded
        position starts from epoch 0 (never from an earlier load's position).  Under
        data parallelism every rank reads the file and then takes rank 0's state."""
        saved, extras = restore_checkpoint(ckpt_dir, step, map_location="cpu")
        self.state, self._opt_kind = None, None
        if "optimizer" in saved and "opt_kind" in saved:
            kind, group = saved["opt_kind"]
            self._build_state(kind, group)
            s = self.state
            s.model.load_state_dict(saved["params"])
            if kind == "adam":
                s.opt.load_state_dict(saved["optimizer"])   # Adam moves its moments
            else:            # the L-BFGS state is taken by reference: onto the device
                s.opt.load_state_dict(_to_device(saved["optimizer"], self.device))
            s.step = int(saved["step"])
        else:
            model = init_model(self.cfg, self.device)
            model.load_state_dict(saved["params"])
            self.state = TrainState(model, opt=None, step=0)
        self._replicate()
        if extras and extras.get("epoch") is not None:
            self._resume_epoch = int(extras["epoch"])
            self._resume_iter = int(extras.get("iter") or 0)
        else:
            self._resume_epoch = self._resume_iter = 0


def _to_device(obj, device: torch.device):
    """Every tensor in nested dicts (the L-BFGS state's fields) moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


def train_from_config(cfg: Config, device: str | torch.device | None = None) -> Trainer:
    """A ``Trainer`` on ``cfg`` run over the H5 files under ``cfg.data.data_dir``
    (JAX's ``train_from_config``); ``device=None`` means the card."""
    t = Trainer(cfg, device=device)
    t.run()
    return t
