"""The port's bfloat16 modes against its own float32 path, within the JAX package's
bf16-vs-f32 gates (tests/test_bf16.py), at that file's small size (4 patches, latent
16 / 8, 4 clusters); the bf16 presets through ``Trainer.run`` on the CPU; and the bf16
transposed convolution of the 1D AE, whose gradient PyTorch's CPU conv_transpose1d
gets wrong at one of the ladder's shapes.

Gates, with the largest gap measured on the CPU beside them:
- first-iteration loss terms, ``bfloat16`` and ``bfloat16_full`` against float32:
  0.05 |a| + 5e-3 (tests/test_bf16.py:61, :120; measured 3.1e-3 |a|, ``aug``);
- three Adam minibatches of ``bfloat16_full`` (admm_iters=2) against float32: final
  losses within 0.02 |a| + 5e-3, and falling (:188; measured 1.6e-5 |a|);
- two L-BFGS minibatches (admm_iters=1) of ``preset("full_khm_lbfgs")`` (bfloat16)
  against its float32 run: func_evals within 2 and losses within 0.02 |a| + 5e-3
  (:124-159; measured: the same 9 func_evals, losses within 3.8e-5 |a|).
"""

import dataclasses

import numpy as np
import pytest
import torch

from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.models import AutoEncoder1D
from lshm_tpu_torch.models.autoencoders import _run
from lshm_tpu_torch.tools import convt1d_probe
from lshm_tpu_torch.train import (
    Duals,
    LossWeights,
    Trainer,
    cascade_objective,
    init_lbfgs_train_state,
    init_model,
    init_train_state,
    make_lbfgs_train_step,
    make_train_step,
)
from lshm_tpu_torch.utils import restore_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)


def _small(cfg, dtype=None, **train_kw):
    model = dataclasses.replace(cfg.model, **MODEL)
    if dtype is not None:
        model = dataclasses.replace(model, compute_dtype=dtype)
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=2),
                               model=model,
                               train=dataclasses.replace(cfg.train, seed=4, **train_kw))


def _batch(groups=2):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(groups, 2)) * 300, 4 // groups, axis=0)
    return torch.tensor(x), torch.tensor(uv.astype(np.float32))


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_bf16_transposed_convs_match_float32_gradients():
    """Every transposed convolution of the 1D AE in bf16 against float32: output and
    the three gradients within 2e-2 of the largest magnitude (measured 6.4e-3; bf16
    keeps 8 bits).  F.conv_transpose1d on the CPU returns an input gradient 1.2 away
    at [4, 48, 64] -> 24 channels; the port's bf16 path computes these layers as one
    matrix product (``autoencoders._convt1d_taps``)."""
    ae = AutoEncoder1D(latent_dim=8, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    L = 4
    for i in range(6):
        m = getattr(ae, f"tconv{i}")
        h = torch.tensor(rng.normal(size=(4, m.in_channels, L)).astype(np.float32))
        g = torch.tensor(rng.normal(size=(4, m.out_channels, 4 * L)).astype(np.float32))
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            hh = h.clone().requires_grad_()
            y = _run(m, hh, dtype)
            grads = torch.autograd.grad(y, (hh, m.weight, m.bias), g.to(y.dtype))
            res[dtype] = [t.detach().float() for t in (y, *grads)]
        errs = [_rel(a, b) for a, b in zip(res[torch.bfloat16], res[torch.float32])]
        assert max(errs) <= 2e-2, (i, errs)
        L *= 4


def test_convt1d_probe_errors_on_the_cpu_and_no_timing_without_a_card(monkeypatch):
    """The probe's error step runs anywhere: the bf16 taps within 2e-2 of float32 at
    every decoder layer (measured 5.5e-3 at batch 2); its entry point times on the card
    and raises when there is none."""
    rows = convt1d_probe.errors(torch.device("cpu"), batch=2)
    assert [r["x"][1] for r in rows] == [192, 96, 48, 24, 12, 8]
    assert all(max(r["taps_rel_err"]) <= 2e-2 for r in rows), rows
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convt1d_probe.main(["--batch", "2"])


@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16_full"])
def test_bf16_loss_terms_close_to_float32(dtype):
    cfg32 = _small(tc.Config())
    cfg16 = _small(tc.Config(), dtype)
    m32, m16 = init_model(cfg32, "cpu"), init_model(cfg16, "cpu")
    m16.load_state_dict(m32.state_dict())
    x, uv = _batch()
    xb = x.to(torch.bfloat16) if dtype == "bfloat16_full" else x
    with torch.no_grad():
        _, t32 = cascade_objective(m32, x, uv, Duals.zeros_like(x), LossWeights(), 2)
        _, t16 = cascade_objective(m16, xb, uv, Duals.zeros_like(xb), LossWeights(), 2)
    for k in t32:
        a, b = float(t32[k]), float(t16[k])
        assert t16[k].dtype == torch.float32 and np.isfinite(b), k
        assert abs(a - b) <= 0.05 * abs(a) + 5e-3, (k, a, b)


def test_bf16_full_training_tracks_float32():
    x, uv = _batch(groups=1)
    traj = {}
    for dtype in ("float32", "bfloat16_full"):
        cfg = _small(tc.Config(), dtype, admm_iters=2)
        cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, adam_lr=1e-3))
        state = init_train_state(cfg, "cpu")
        step = make_train_step(cfg, 1)
        losses = []
        for _ in range(3):
            state, metrics = step(state, x, uv, LossWeights())
            assert np.all(np.isfinite(metrics["loss"].numpy()))
            losses.append(float(metrics["loss"][-1]))
        traj[dtype] = losses
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        assert all(t.dtype == torch.float32 for s in state.opt.state.values()
                   for t in s.values())
        assert losses[-1] < losses[0], (dtype, losses)
    for a, b in zip(traj["float32"], traj["bfloat16_full"]):
        assert abs(a - b) <= 0.02 * abs(a) + 5e-3, traj


def test_lbfgs_preset_in_bfloat16_tracks_float32():
    """preset("full_khm_lbfgs") as published (bfloat16 activations, float32 losses)
    against the same preset in float32: the line search takes the same path up to a
    borderline accept."""
    published = tc.preset("full_khm_lbfgs")
    assert published.model.compute_dtype == "bfloat16"
    x, uv = _batch(groups=1)
    traj, evals = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = _small(published, dtype, admm_iters=1)
        state = init_lbfgs_train_state(cfg, "cpu")
        step = make_lbfgs_train_step(cfg, 1)
        losses = []
        for _ in range(2):
            state, metrics = step(state, x, uv, LossWeights())
            assert np.all(np.isfinite(metrics["loss"].numpy()))
            losses.append(float(metrics["loss"][-1]))
        traj[dtype], evals[dtype] = losses, state.opt.func_evals
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        assert all(t.dtype == torch.float32 for vec in (state.opt.s_hist, state.opt.y_hist,
                                                         state.opt.prev_grad)
                   for t in vec.values())
    assert abs(evals["float32"] - evals["bfloat16"]) <= 2, evals
    for a, b in zip(traj["float32"], traj["bfloat16"]):
        assert abs(a - b) <= 0.02 * abs(a) + 5e-3, traj


def _sampler(cfg):
    return MinibatchSampler([synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"],
                            cfg.data, seed=0)


@pytest.mark.parametrize("name", ["full_khm_bf16", "full_khm_lbfgs"])
def test_bf16_presets_train_through_the_trainer(name, tmp_path):
    """Both published bf16 presets through Trainer.run on the CPU: full_khm_bf16 with
    Adam, full_khm_lbfgs through an Adam -> L-BFGS ramp; finite losses and a
    checkpoint whose parameters are float32."""
    cfg = _small(tc.preset(name), num_epochs=2, iters_per_epoch=1, admm_iters=1,
                 checkpoint_dir=str(tmp_path))
    if name == "full_khm_lbfgs":
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ramp=(
            tc.RampStage(epochs=1, optimizer="adam"),
            tc.RampStage(epochs=1, alpha=0.01, beta=0.01, gamma=0.01, optimizer="lbfgs"))))
    assert cfg.model.compute_dtype == tc.preset(name).model.compute_dtype != "float32"
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    summary = trainer.run(_sampler(cfg))
    assert all(np.isfinite(v) for v in summary.values())
    saved, _ = restore_checkpoint(str(tmp_path))
    assert saved["step"] == 2
    assert saved["opt_kind"][0] == ("lbfgs" if name == "full_khm_lbfgs" else "adam")
    assert all(v.dtype == torch.float32 for v in saved["params"].values())


def test_bf16_trainer_reverts_a_non_finite_step(capsys):
    class NaNSampler:
        def __init__(self, inner):
            self.inner = inner

        def reseed(self, epoch):
            self.inner.reseed(epoch)

        def sample(self):
            mb = self.inner.sample()
            mb.x[:] = np.nan
            return mb

    cfg = _small(tc.preset("full_khm_bf16"), num_epochs=1, iters_per_epoch=2,
                 admm_iters=1, checkpoint_dir="")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, prefetch=0))
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    trainer.run(NaNSampler(_sampler(cfg)))
    assert capsys.readouterr().out.count("step reverted") == 2
    init = init_model(cfg, "cpu").state_dict()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(init[k], v), k
