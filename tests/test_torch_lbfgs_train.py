"""The port's L-BFGS ADMM step against the JAX step (``make_lbfgs_train_step``, jitted)
on one minibatch of 4 patches (latent 16/8, 4 clusters, max_iter=2, admm_iters=1), for
group "all" with the backtracking line search and for the frozen-group path (group
"ae1d") with the fixed step; the same step data-parallel on two gloo ranks, each on
its half of the minibatch, against the same JAX references (JAX's sharded gates,
``test_lbfgs_sharded_step_matches_single_device``, ``tests/test_train_step.py:161``);
and the port's Trainer through an Adam -> L-BFGS ramp on the CPU.

The JAX reference is computed once per case in a module fixture: the jitted step
(about 60 s to compile with the line search on this CPU, 40 s without) is cheaper than
the same step under ``jax.disable_jit()`` (about 90 s)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import config as jc
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.optim import lbfgs_init as jax_lbfgs_init
from lshm_tpu.train import LossWeights as JLossWeights
from lshm_tpu.train.step import LBFGSTrainState as JLBFGSTrainState
from lshm_tpu.train.step import make_lbfgs_train_step as jax_make_lbfgs_train_step
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.optim import LBFGSState
from lshm_tpu_torch.params import to_flax
from lshm_tpu_torch.train import (
    LossWeights,
    Trainer,
    init_lbfgs_train_state,
    init_model,
    make_lbfgs_train_step,
)
from lshm_tpu_torch.utils import restore_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger
from test_torch_parallel import assert_ranks_identical, start_ranks

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)


def _cfg(mod, line_search=True, **model_kw):
    return mod.Config(
        data=mod.DataConfig(batch_size=2),
        model=mod.ModelConfig(**MODEL, **model_kw),
        optim=mod.OptimConfig(optimizer="lbfgs", lbfgs=mod.LBFGSConfig(
            lr=1.0, max_iter=2, history_size=5, line_search=line_search,
            batch_mode=True)),
        train=mod.TrainConfig(admm_iters=1, seed=3))


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(2, 2)) * 300, 2, axis=0).astype(np.float32)
    return x, uv


CASES = {"all-line_search": ("all", True), "ae1d-fixed_step": ("ae1d", False)}


def _init_sd(group: str) -> dict:
    return {k: v.clone() for k, v in
            init_lbfgs_train_state(_cfg(tc), "cpu", group).model.state_dict().items()}


@pytest.fixture(scope="module", autouse=True)
def data_parallel_ranks(tmp_path_factory):
    """Both cases' step on two gloo ranks (``tests/test_torch_parallel.py``'s child),
    started before the JAX references compile and read by the data-parallel tests."""
    cases = [{"name": name, "cfg": _cfg(tc, line_search), "kind": "lbfgs",
              "group": group, "init": _init_sd(group)}
             for name, (group, line_search) in CASES.items()]
    return start_ranks(tmp_path_factory.mktemp("ranks"), cases, *_batch(), groups=2)


@pytest.fixture(scope="module", params=list(CASES.values()), ids=list(CASES))
def jax_reference(request):
    """Initial port state dict, and the JAX step's metrics, func_evals and params."""
    group, line_search = request.param
    cfg = _cfg(jc, line_search)        # plain XLA convs and the XLA KHM expression
    init_sd = _init_sd(group)
    params = jax.tree.map(jnp.asarray, to_flax(init_sd))
    state = JLBFGSTrainState(params=params, opt_state=jax_lbfgs_init(params, cfg.optim.lbfgs),
                             step=jnp.zeros((), jnp.int32))
    step = jax_make_lbfgs_train_step(JCascadedAE(cfg=cfg.model), cfg, num_groups=2,
                                     group=group, donate=False)
    x, uv = _batch()
    new_state, metrics = step(state, jnp.asarray(x), jnp.asarray(uv), JLossWeights())
    return (group, line_search, init_sd, jax.device_get(metrics),
            int(new_state.opt_state.func_evals), jax.device_get(new_state.params))


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_lbfgs_step_matches_jax(jax_reference, kernels):
    """kernels=True: the port's defaults (fused KHM loss, fused conv head — their plain
    versions on the CPU); False: the plain XLA-equivalent expressions."""
    group, line_search, init_sd, want_metrics, want_evals, want_params = jax_reference
    model_kw = {} if kernels else dict(khm_backend="xla", pallas_head=False)
    cfg = _cfg(tc, line_search, **model_kw)
    state = init_lbfgs_train_state(cfg, "cpu", group)
    state.model.load_state_dict(init_sd)
    x, uv = _batch()
    state, metrics = make_lbfgs_train_step(cfg, 2, group)(
        state, torch.tensor(x), torch.tensor(uv), LossWeights())
    assert state.step == 1
    assert state.opt.func_evals == want_evals > 0
    assert metrics.keys() == want_metrics.keys()
    for k, v in want_metrics.items():
        assert metrics[k].shape == (1,)
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-5, err_msg=k)
    leaves = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got, init = leaves(to_flax(state.model.state_dict())), leaves(to_flax(init_sd))
    moved = 0
    for path, v in leaves(want_params).items():
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[path], v, rtol=1e-4, atol=1e-6, err_msg=name)
        frozen = group == "ae1d" and "'aeT'" not in name and "'aeF'" not in name
        if frozen:
            np.testing.assert_array_equal(got[path], init[path], err_msg=name)
        else:
            moved += not np.array_equal(got[path], init[path])
    assert moved > 0
    # the L-BFGS state spans the active group's parameters only
    names = set(state.opt.d)
    assert names == {n for n in init_sd if group == "all" or n.split(".")[0] in ("aeT", "aeF")}


def test_data_parallel_lbfgs_step_matches_jax(jax_reference, data_parallel_ranks):
    """Two ranks, each on 2 of the 4 patches with its one augmentation group: every
    closure evaluation reduced over the ranks, so both take the same line-search
    branches (bit-identical parameters, the same func_evals and host reads) and match
    JAX on the whole minibatch at JAX's sharded gates (loss rtol 2e-4, the same
    func_evals, parameters atol 3e-4), and the port's single-process step's closure
    evaluations and host reads."""
    group, line_search, init_sd, want_metrics, want_evals, want_params = jax_reference
    name = "all-line_search" if line_search else "ae1d-fixed_step"
    ranks = data_parallel_ranks.result()
    assert_ranks_identical(ranks, name)
    got = ranks[1][name]
    assert got["func_evals"] == ranks[0][name]["func_evals"] == want_evals
    assert got["host_syncs"] == ranks[0][name]["host_syncs"] > 0
    for k, v in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), v, rtol=2e-4, err_msg=k)
    leaves = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    mine = leaves(to_flax(got["params"]))
    for path, v in leaves(want_params).items():
        np.testing.assert_allclose(mine[path], v, atol=3e-4,
                                   err_msg=jax.tree_util.keystr(path))
    # the single-process port on the whole minibatch: the same reads of the host
    cfg = _cfg(tc, line_search)
    state = init_lbfgs_train_state(cfg, "cpu", group)
    state.model.load_state_dict(init_sd)
    x, uv = _batch()
    state, _ = make_lbfgs_train_step(cfg, 2, group)(
        state, torch.tensor(x), torch.tensor(uv), LossWeights())
    assert got["host_syncs"] == state.opt.host_syncs
    # one all-reduce per closure evaluation and one of the metrics: the line search's
    # value-only probes are reduced too, though only its halvings count in func_evals
    if line_search:
        assert got["calls"] > got["func_evals"] + 1
    else:
        assert got["calls"] == got["func_evals"] + 1


def _trainer_cfg(tmp_path, **train_kw):
    cfg = _cfg(tc)
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, prefetch=0),
        optim=dataclasses.replace(cfg.optim, group_schedule=("ae2d", "khm")),
        train=dataclasses.replace(cfg.train, **{
            "num_epochs": 2, "iters_per_epoch": 2, "checkpoint_dir": str(tmp_path),
            "ramp": (tc.RampStage(epochs=1, optimizer="adam"),
                     tc.RampStage(epochs=1, alpha=0.01, beta=0.01, gamma=0.01,
                                  optimizer="lbfgs")),
            **train_kw}))


def _sampler(cfg):
    return MinibatchSampler([synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"],
                            cfg.data, seed=0)


def test_trainer_adam_then_lbfgs_checkpoints_the_lbfgs_state(tmp_path):
    """Epoch 0: Adam on the 2D AE.  Epoch 1: L-BFGS on the KHM head, its state kept
    across the two minibatches.  The 1D AEs never move; the checkpoint holds the
    L-BFGS state under opt_kind ["lbfgs", "khm"]."""
    cfg = _trainer_cfg(tmp_path)
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    summary = trainer.run(_sampler(cfg))
    assert all(np.isfinite(v) for v in summary.values())
    assert isinstance(trainer.state.opt, LBFGSState)
    opt = trainer.state.opt
    assert list(opt.d) == ["khm.M"]
    # alphabar moves only in a step that finds an earlier minibatch's state
    # (batch_changed): the state persisted from the first minibatch to the second
    assert opt.n_iter >= 2 and float(opt.alphabar) != cfg.optim.lbfgs.lr
    init = init_model(cfg, "cpu").state_dict()
    now = trainer.model.state_dict()
    moved = lambda prefix: any(not torch.equal(init[k], now[k])
                               for k in now if k.startswith(prefix))
    assert moved("ae2d.") and moved("khm.")
    assert not moved("aeT.") and not moved("aeF.")
    state, extras = restore_checkpoint(str(tmp_path))
    assert state["opt_kind"] == ["lbfgs", "khm"] and state["step"] == 4
    assert state["optimizer"]["func_evals"] == opt.func_evals > 0
    assert torch.equal(state["optimizer"]["s_hist"]["khm.M"], opt.s_hist["khm.M"])
    assert extras["config"]["train"]["ramp"][1]["optimizer"] == "lbfgs"


def test_trainer_reverts_a_non_finite_lbfgs_step(tmp_path, capsys):
    """A NaN minibatch in an L-BFGS epoch: the step is reverted, the L-BFGS state with
    it (its func_evals back to 0)."""
    class NaNSampler:
        def __init__(self, inner):
            self.inner = inner

        def reseed(self, epoch):
            self.inner.reseed(epoch)

        def sample(self):
            mb = self.inner.sample()
            mb.x[:] = np.nan
            return mb

    cfg = _trainer_cfg(tmp_path, num_epochs=1, checkpoint_dir="", ramp=())
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    trainer.run(NaNSampler(_sampler(cfg)))
    assert capsys.readouterr().out.count("step reverted") == 2
    assert trainer.state.opt.func_evals == 0 and trainer.state.step == 0
    init = init_model(cfg, "cpu").state_dict()
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(init[k], v), k
