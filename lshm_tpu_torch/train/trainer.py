"""Top-level training orchestration (port of the Adam path of
``lshm_tpu/train/trainer.py``; reference: src/kharmonic_lofar.py:115-222).

Epochs x iterations x ADMM schedule, the alpha/beta/gamma ramp (Adam stages),
alternating model groups (optimizer moments reset on a switch, as in JAX), a prefetching
input pipeline, metric logging, the one-step-delayed non-finite revert, and a
checkpoint at the end.  One device; ``Trainer(cfg)`` runs on the card and raises when
there is none.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from lshm_tpu_torch.config import Config, check_supported
from lshm_tpu_torch.data import MinibatchSampler, PrefetchIterator, scan_files
from lshm_tpu_torch.device import resolve_device, use_exact_float32
from lshm_tpu_torch.train.objective import LossWeights
from lshm_tpu_torch.train.schedule import active_group, ramp_stage_for_epoch
from lshm_tpu_torch.train.step import TrainState, init_train_state, make_optimizer, make_train_step
from lshm_tpu_torch.utils.checkpoint import save_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger


class Trainer:
    """Stateful training loop.  ``device=None`` means the card."""

    def __init__(self, cfg: Config, device: str | torch.device | None = None,
                 logger: MetricLogger | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_exact_float32()
        self.logger = logger or MetricLogger(echo=True)
        self.state: TrainState | None = None
        self._group: str | None = None

    @property
    def model(self):
        return None if self.state is None else self.state.model

    def _ensure_state(self, group: str) -> None:
        if self.state is None:
            self.state = init_train_state(self.cfg, self.device, group)
        elif group != self._group:   # group switch: params carry over, moments reset
            self.state.optimizer = make_optimizer(self.cfg, self.state.model, group)
        self._group = group

    def _snapshot(self):
        s = self.state
        params = {k: v.detach().clone() for k, v in s.model.state_dict().items()}
        return params, copy.deepcopy(s.optimizer.state_dict()), s.step

    def _restore(self, snap) -> None:
        params, opt, step = snap
        self.state.model.load_state_dict(params)
        self.state.optimizer.load_state_dict(opt)
        self.state.step = step

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

        for epoch in range(cfg.train.num_epochs):
            sampler.reseed(epoch)   # per-epoch stream
            stage = ramp_stage_for_epoch(cfg.train.ramp, epoch)
            src = stage if stage is not None else cfg.loss
            w = LossWeights(alpha=src.alpha, beta=src.beta, gamma=src.gamma,
                            rho=cfg.loss.rho, rica_lambda=cfg.loss.rica_lambda)
            group = active_group(cfg.optim.group_schedule, epoch)
            source = (PrefetchIterator(sampler, cfg.data.prefetch, self.device)
                      if cfg.data.prefetch > 0 else None)
            pending = None   # (snapshot before the step, metrics, iteration, patches)

            def settle(pending):
                """One-step-delayed non-finite guard: checked after the next minibatch
                is ready, by when the previous step has usually finished."""
                snap, metrics, pit, patches = pending
                if not np.isfinite(float(metrics["loss"][-1])):
                    self._restore(snap)
                    print(f"warning: non-finite loss at epoch {epoch} iter {pit}; "
                          "step reverted")
                elif pit % max(cfg.train.log_every, 1) == 0:
                    self.logger.log_step(epoch, pit, metrics, patches=patches)

            try:
                for it in range(cfg.train.iters_per_epoch):
                    if source is not None:
                        mb = next(source)
                        x, uv = mb.x, mb.uv
                    else:
                        mb = sampler.sample()
                        x, uv = place(mb.x), place(mb.uv)
                    self._ensure_state(group)
                    step = make_train_step(cfg, mb.num_baselines)
                    if pending is not None:
                        settle(pending)
                    snap = self._snapshot() if cfg.train.skip_nonfinite else None
                    self.state, metrics = step(self.state, x, uv, w)
                    if cfg.train.skip_nonfinite:
                        pending = (snap, metrics, it, x.shape[0])
                    elif it % max(cfg.train.log_every, 1) == 0:
                        self.logger.log_step(epoch, it, metrics, patches=x.shape[0])
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
            if cfg.train.save_every and (epoch + 1) % cfg.train.save_every == 0:
                self.save(cfg.train.checkpoint_dir,
                          step=(epoch + 1) * cfg.train.iters_per_epoch, epoch=epoch + 1)

        if cfg.train.checkpoint_dir:
            self.save(cfg.train.checkpoint_dir,
                      step=cfg.train.num_epochs * cfg.train.iters_per_epoch,
                      epoch=cfg.train.num_epochs)
        return self.logger.summary()

    def save(self, ckpt_dir: str, step: int, epoch: int | None = None,
             iter_in_epoch: int = 0) -> None:
        """Parameters, optimizer state and step in one file, the config beside it."""
        if self.state is None:
            print("warning: nothing to checkpoint (no training has run); skipping save")
            return
        s = self.state
        save_checkpoint(ckpt_dir, {
            "params": s.model.state_dict(),
            "optimizer": s.optimizer.state_dict(),
            "step": s.step,
            "opt_kind": ["adam", self._group],
        }, step, extras={"config": self.cfg.to_dict(), "epoch": epoch,
                         "iter": int(iter_in_epoch)})
