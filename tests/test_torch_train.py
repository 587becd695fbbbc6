"""The port's Adam ADMM step against the JAX step (``make_train_step(jit=False)``) on
one minibatch with admm_iters=3, for group "all" and a frozen group; and the port's
Trainer end to end on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import config as jc
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.train import LossWeights as JLossWeights
from lshm_tpu.train import TrainState as JTrainState
from lshm_tpu.train import make_train_step as jax_make_train_step
from lshm_tpu.train.step import make_optimizer as jax_make_optimizer
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.params import to_flax
from lshm_tpu_torch.train import (
    LossWeights,
    Trainer,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from lshm_tpu_torch.utils import restore_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)


def _cfg(mod, **model_kw):
    return mod.Config(data=mod.DataConfig(batch_size=2),
                      model=mod.ModelConfig(**MODEL, **model_kw),
                      optim=mod.OptimConfig(adam_lr=1e-4),
                      train=mod.TrainConfig(admm_iters=3, seed=3))


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(2, 2)) * 300, 2, axis=0).astype(np.float32)
    return x, uv


@pytest.fixture(scope="module", params=["all", "ae1d"])
def jax_reference(request):
    """Initial port state dict, and the JAX step's metrics and params from it."""
    group = request.param
    cfg = _cfg(jc)                     # plain XLA convs and the XLA KHM expression
    init_sd = {k: v.clone() for k, v in
               init_train_state(_cfg(tc), "cpu").model.state_dict().items()}
    params = jax.tree.map(jnp.asarray, to_flax(init_sd))
    tx = jax_make_optimizer(cfg, params, group)
    state = JTrainState(params=params, opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(JCascadedAE(cfg=cfg.model), tx, cfg, num_groups=2,
                               donate=False, jit=False)
    x, uv = _batch()
    new_state, metrics = step(state, jnp.asarray(x), jnp.asarray(uv), JLossWeights())
    return group, init_sd, jax.device_get(metrics), jax.device_get(new_state.params)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_step_matches_jax(jax_reference, kernels):
    """kernels=True: the port's defaults (fused KHM loss, fused conv head — their plain
    versions on the CPU); False: the plain XLA-equivalent expressions."""
    group, init_sd, want_metrics, want_params = jax_reference
    model_kw = {} if kernels else dict(khm_backend="xla", pallas_head=False)
    cfg = _cfg(tc, **model_kw)
    state = init_train_state(cfg, "cpu", group)
    state.model.load_state_dict(init_sd)
    x, uv = _batch()
    state, metrics = make_train_step(cfg, 2)(state, torch.tensor(x), torch.tensor(uv),
                                             LossWeights())
    assert state.step == 1
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        assert metrics[k].shape == (3,)
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-5, err_msg=k)
    leaves = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got, init = leaves(to_flax(state.model.state_dict())), leaves(to_flax(init_sd))
    for path, v in leaves(want_params).items():
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[path], v, rtol=1e-5, atol=1e-6, err_msg=name)
        frozen = group == "ae1d" and "'aeT'" not in name and "'aeF'" not in name
        if frozen:
            np.testing.assert_array_equal(got[path], init[path], err_msg=name)


def test_frozen_parameters_are_not_given_to_adam():
    cfg = _cfg(tc)
    model = init_train_state(cfg, "cpu").model
    opt = make_optimizer(cfg, model, "khm")
    assert [p for g in opt.param_groups for p in g["params"]] == [model.khm.M]


def _trainer_cfg(tmp_path, **train_kw):
    cfg = _cfg(tc)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, prefetch=2),
        train=dataclasses.replace(cfg.train, **{
            "admm_iters": 1, "num_epochs": 1, "iters_per_epoch": 2,
            "checkpoint_dir": str(tmp_path), **train_kw}))


def test_trainer_runs_on_cpu(tmp_path):
    cfg = _trainer_cfg(tmp_path)
    sampler = MinibatchSampler([synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"],
                               cfg.data, seed=0)
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    summary = trainer.run(sampler)
    assert {"loss", "loss0", "kdist", "rica"} <= summary.keys()
    assert all(np.isfinite(v) for v in summary.values())
    state, extras = restore_checkpoint(str(tmp_path))
    assert state["step"] == 2 and extras["config"]["model"]["latent_dim"] == 16
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(state["params"][k], v), k


def test_trainer_switches_groups_and_follows_the_ramp(tmp_path):
    """Epoch 0 trains the KHM head, epoch 1 the 2D AE (fresh Adam moments); the 1D AEs
    never move.  Adam ramp stages set the loss weights."""
    cfg = _trainer_cfg(tmp_path, num_epochs=2, iters_per_epoch=1, checkpoint_dir="",
                       ramp=(tc.RampStage(epochs=1, alpha=0.1, beta=0.1, gamma=0.1),))
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, group_schedule=("khm", "ae2d")))
    sampler = MinibatchSampler([synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"],
                               cfg.data, seed=0)
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    trainer.run(sampler)
    init = init_train_state(cfg, "cpu").model.state_dict()
    now = trainer.model.state_dict()
    moved = lambda prefix: any(not torch.equal(init[k], now[k])
                               for k in now if k.startswith(prefix))
    assert moved("khm.") and moved("ae2d.")
    assert not moved("aeT.") and not moved("aeF.")
    assert [p for g in trainer.state.optimizer.param_groups for p in g["params"]] == \
        list(trainer.model.ae2d.parameters())
    first = trainer.logger.history[0]
    assert first["kdist"] > 0 and np.isfinite(first["loss"])


def test_trainer_reverts_a_non_finite_step(tmp_path, capsys):
    class NaNSampler:
        def __init__(self, inner):
            self.inner = inner

        def reseed(self, epoch):
            self.inner.reseed(epoch)

        def sample(self):
            mb = self.inner.sample()
            mb.x[:] = np.nan
            return mb

    cfg = _trainer_cfg(tmp_path, checkpoint_dir="")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, prefetch=0))
    sampler = NaNSampler(MinibatchSampler(
        [synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"], cfg.data, seed=0))
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    trainer.run(sampler)
    assert capsys.readouterr().out.count("step reverted") == 2
    init = init_train_state(cfg, "cpu").model.state_dict()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(init[k], v), k
    assert trainer.state.step == 0
