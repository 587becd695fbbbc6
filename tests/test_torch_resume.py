"""The port's ``Trainer.load`` and exact resume (mirrors ``tests/test_trainer.py``:
``test_exact_resume_roundtrip``, ``test_mid_epoch_exact_resume``,
``test_resume_iter_not_stale_across_loads``, ``test_lbfgs_mode_exact_resume``).

A run cut at an epoch boundary or mid-epoch and resumed by a fresh Trainer through
``load`` must equal the uninterrupted run bit for bit (``torch.equal``), with and
without the prefetch thread, in Adam and in L-BFGS mode.  The data is the same
synthetic extract as the JAX suite's ``synth_h5`` fixture, held in memory."""

import dataclasses

import pytest
import torch

from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.utils import MetricLogger, restore_checkpoint, save_checkpoint

TREE = synth_extract(nstations=4, ntime=192, nfreq=192, seed=7)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on a few cores, and
    the many small operators here slow down badly when their threads oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(ckpt_dir="", prefetch=0, optimizer="adam", **train_kw):
    return tc.Config(
        data=tc.DataConfig(batch_size=1, patch_size=128, num_channels=4, prefetch=prefetch),
        model=tc.ModelConfig(latent_dim=16, latent_dim_1d=8, num_clusters=4, rica=True),
        optim=tc.OptimConfig(optimizer=optimizer, adam_lr=1e-3,
                             lbfgs=tc.LBFGSConfig(max_iter=2, history_size=3)),
        train=tc.TrainConfig(**{"num_epochs": 1, "iters_per_epoch": 2, "admm_iters": 1,
                                "checkpoint_dir": ckpt_dir, **train_kw}),
    )


def _train(cfg, trainer=None):
    t = trainer or Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    t.run(MinibatchSampler([TREE], ["0"], cfg.data, seed=0))
    return t


def _fresh(cfg):
    return Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))


def _assert_same_params(a: Trainer, b: Trainer):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _with(cfg, **train_kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_exact_resume_roundtrip(tmp_path, prefetch):
    """Cut after epoch 1 of 2 and resumed: optimizer state, step and epoch restored,
    parameters equal to the uninterrupted run's bit for bit."""
    ckpt = str(tmp_path / "ck")
    full = _train(tiny_cfg(prefetch=prefetch, num_epochs=2))
    _train(tiny_cfg(ckpt, prefetch=prefetch, num_epochs=1))

    t_b = _fresh(tiny_cfg(prefetch=prefetch, num_epochs=2))
    t_b.load(ckpt)
    assert (t_b._resume_epoch, t_b._resume_iter) == (1, 0)
    assert t_b._opt_kind == ("adam", "all") and t_b.state.step == 2
    t_b.run(MinibatchSampler([TREE], ["0"], t_b.cfg.data, seed=0))
    assert t_b.state.step == full.state.step == 4
    _assert_same_params(full, t_b)
    for k, v in full.state.opt.state_dict()["state"].items():
        for name, t in v.items():
            assert torch.equal(t, t_b.state.opt.state_dict()["state"][k][name]), name


@pytest.mark.parametrize("prefetch", [0, 2])
def test_mid_epoch_exact_resume(tmp_path, prefetch):
    """save_every_iters checkpoints (epoch, iter); resume replays the sampler stream with
    skip() and finishes the epoch on the same minibatches."""
    ckpt = str(tmp_path / "ck")
    cfg = tiny_cfg(ckpt, prefetch=prefetch, iters_per_epoch=4, save_every_iters=2)
    cfg_full = _with(cfg, checkpoint_dir="", save_every_iters=0)
    full = _train(cfg_full)
    _train(cfg)

    t_b = _fresh(cfg_full)
    t_b.load(ckpt, step=2)                      # the mid-epoch checkpoint
    assert (t_b._resume_epoch, t_b._resume_iter) == (0, 2)
    t_b.run(MinibatchSampler([TREE], ["0"], cfg_full.data, seed=0))
    assert [h["iter"] for h in t_b.logger.history] == [2, 3]
    _assert_same_params(full, t_b)


def test_resume_iter_not_stale_across_loads(tmp_path):
    """A later load of an epoch-boundary checkpoint clears a mid-epoch position left by
    an earlier load; run() consumes the position (a second run starts fresh); a
    params-only file leaves no stale position either."""
    ckpt = str(tmp_path / "ck")
    cfg = tiny_cfg(ckpt, iters_per_epoch=4, save_every_iters=2)
    t = _train(cfg)

    t2 = _fresh(cfg)
    t2.load(ckpt, step=2)
    assert t2._resume_iter == 2
    t2.load(ckpt, step=4)                       # epoch boundary (iter 0)
    assert (t2._resume_epoch, t2._resume_iter) == (1, 0)

    t2.load(ckpt, step=2)
    t2.run(MinibatchSampler([TREE], ["0"], cfg.data, seed=0))
    assert (t2._resume_epoch, t2._resume_iter) == (0, 0)

    params_only = str(tmp_path / "params")
    save_checkpoint(params_only, {"params": t.model.state_dict()}, step=0,
                    extras={"source": "torch-reference"})
    t2.load(ckpt, step=2)
    t2.load(params_only)
    assert (t2._resume_epoch, t2._resume_iter) == (0, 0)
    assert t2._opt_kind is None and t2.state.opt is None and t2.state.step == 0
    _assert_same_params(t, t2)
    # the optimizer is built around the loaded parameters at the first step
    t2.run(MinibatchSampler([TREE], ["0"], cfg.data, seed=0))
    assert t2._opt_kind == ("adam", "all") and t2.state.step == 4


def test_save_after_params_only_load_keeps_the_parameters(tmp_path):
    """Before any step, a params-only Trainer saves the parameters alone, and that file
    loads params-only again."""
    cfg = tiny_cfg()
    t = _fresh(cfg)
    src = str(tmp_path / "src")
    save_checkpoint(src, {"params": _train(cfg).model.state_dict()}, step=0)
    t.load(src)
    out = str(tmp_path / "out")
    t.save(out, step=0)
    state, _ = restore_checkpoint(out)
    assert set(state) == {"params"}
    t3 = _fresh(cfg)
    t3.load(out)
    _assert_same_params(t, t3)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_lbfgs_mode_exact_resume(tmp_path, prefetch):
    """A checkpoint in L-BFGS mode restores the whole optimizer state (curvature
    history, running batch statistics, func_evals) and the resumed run reproduces the
    uninterrupted trajectory bit for bit."""
    ckpt = str(tmp_path / "ck")
    kw = dict(prefetch=prefetch, optimizer="lbfgs", iters_per_epoch=1)
    full = _train(tiny_cfg(num_epochs=2, **kw))
    t_a = _train(tiny_cfg(ckpt, num_epochs=1, **kw))

    t_b = _fresh(tiny_cfg(num_epochs=2, **kw))
    t_b.load(ckpt)
    assert t_b._opt_kind == ("lbfgs", "all")
    assert t_b.state.opt.func_evals == t_a.state.opt.func_evals > 0
    assert t_b.state.opt.n_iter == t_a.state.opt.n_iter
    assert all(torch.equal(t_b.state.opt.s_hist[k], v) for k, v in t_a.state.opt.s_hist.items())
    t_b.run(MinibatchSampler([TREE], ["0"], t_b.cfg.data, seed=0))
    assert t_b.state.opt.func_evals == full.state.opt.func_evals
    _assert_same_params(full, t_b)
