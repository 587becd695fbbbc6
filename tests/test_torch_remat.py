"""``train.remat`` in the port's steps, the rewrites through the data-parallel step and
the Trainer, and the last two ports of JAX functions (``unpatchify_mean``,
``train_from_config``), on the CPU, at 2 patches.

With ``remat`` the forward runs again in the backward on the same inputs, so on the
CPU the unfused, fused and L-BFGS steps are bit for bit the steps without it, and the
kernels' forwards (their plain versions here) run once more per backward: per ADMM
iteration of the unfused Adam step K1 2 and K3 3 (without remat 1 and 2), of the fused
step K3 2 (K1 stays outside the recomputed forward), K2 and K4 once either way."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import config as jc
from lshm_tpu.data.patches import patchify_jax
from lshm_tpu.data.patches import unpatchify_mean as jax_unpatchify_mean
from lshm_tpu.train.trainer import train_from_config as jax_train_from_config
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.data.patches import patchify_torch, unpatchify_mean
from lshm_tpu_torch.kernels import conv_head, khm
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.train import (
    LossWeights,
    Trainer,
    init_lbfgs_train_state,
    init_train_state,
    make_lbfgs_train_step,
    make_train_step,
)
from lshm_tpu_torch.train.trainer import train_from_config
from lshm_tpu_torch.utils.metrics import MetricLogger

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)
REWRITES = dict(fuse_1d=True, fast_conv1d=True, packed_conv2d=2)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs six workers on the host's cores, and torch's default of a thread
    per core in each makes these small CPU steps 10-20 times slower than alone, so
    this file runs torch on one thread (both sides of every comparison alike)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _cfg(remat=False, **model_kw):
    return tc.Config(data=tc.DataConfig(batch_size=1),
                     model=tc.ModelConfig(**MODEL, **model_kw),
                     optim=tc.OptimConfig(adam_lr=1e-4, lbfgs=tc.LBFGSConfig(max_iter=1)),
                     train=tc.TrainConfig(admm_iters=2, seed=3, remat=remat))


def _batch():
    """One baseline's 2 patches."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(1, 2)) * 300, 2, axis=0).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(uv)


def _counting(monkeypatch) -> dict:
    """Count the calls of K1-K4's functions (their plain versions on the CPU)."""
    calls = {}
    for mod, name in ((khm, "khm_forward"), (khm, "khm_backward"),
                      (conv_head, "head_forward"), (conv_head, "head_weight_grads")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a)

        monkeypatch.setattr(mod, name, counted)
    return calls


def _run(kind, remat, monkeypatch, **model_kw):
    cfg = _cfg(remat, **model_kw)
    x, uv = _batch()
    calls = _counting(monkeypatch)
    if kind == "lbfgs":
        state = init_lbfgs_train_state(cfg, "cpu", "all")
        step = make_lbfgs_train_step(cfg, 1, "all")
    else:
        state = init_train_state(cfg, "cpu")
        step = make_train_step(cfg, 1, fused=kind == "fused")
    state, metrics = step(state, x, uv, LossWeights())
    monkeypatch.undo()
    return state, metrics, calls


# (kind, model flags): the defaults, and every rewrite on (the L-BFGS closure evaluates
# the model through functional_call)
STEPS = [("unfused", {}), ("fused", {}), ("lbfgs", {}), ("unfused", REWRITES),
         ("lbfgs", REWRITES)]


@pytest.mark.parametrize("kind,model_kw", STEPS,
                         ids=[f"{k}-{'rewrites' if m else 'defaults'}" for k, m in STEPS])
def test_remat_steps_are_bit_for_bit(kind, model_kw, monkeypatch):
    s0, m0, c0 = _run(kind, False, monkeypatch, **model_kw)
    s1, m1, c1 = _run(kind, True, monkeypatch, **model_kw)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    p1 = s1.model.state_dict()
    for k, v in s0.model.state_dict().items():
        assert torch.equal(v, p1[k]), k
    nadmm = 2
    if kind == "unfused":      # objective forward, its recomputation, dual update
        assert c0 == {"khm_forward": nadmm, "khm_backward": nadmm, "head_forward": 2 * nadmm,
                      "head_weight_grads": nadmm}
        assert c1 == {**c0, "khm_forward": 2 * nadmm, "head_forward": 3 * nadmm}
    elif kind == "fused":      # one forward per ADMM iteration, recomputed
        assert c0["head_forward"] == nadmm and c1["head_forward"] == 2 * nadmm
        assert c1["khm_forward"] == c0["khm_forward"] == nadmm
    else:                      # each closure with a gradient recomputes its forward
        assert s0.opt.func_evals == s1.opt.func_evals
        with_grad = c0["khm_backward"]
        assert c1["khm_backward"] == with_grad
        assert c1["khm_forward"] == c0["khm_forward"] + with_grad
        assert c1["head_forward"] == c0["head_forward"] + with_grad


def test_data_parallel_step_with_rewrites_and_remat(tmp_path):
    """The data-parallel Adam step (its gradient all-reduce inside) with every rewrite
    and remat on, in a gloo group of one rank: bit for bit the plain step."""
    import torch.distributed as dist

    from lshm_tpu_torch.train.parallel import AllReduceMean, make_data_parallel_step

    cfg = _cfg(True, **REWRITES)
    x, uv = _batch()
    _, want = make_train_step(cfg, 1)(init_train_state(cfg, "cpu"), x, uv, LossWeights())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mean = AllReduceMean()
        step = make_data_parallel_step(cfg, 1, mean)
        _, got = step(init_train_state(cfg, "cpu"), x, uv, LossWeights())
    finally:
        dist.destroy_process_group()
    assert mean.calls == cfg.train.admm_iters + 1
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_trainer_runs_every_rewrite_and_remat(tmp_path):
    """The Trainer accepts the four fields and trains with them (1 epoch x 2
    minibatches), its checkpoint holding the same parameter names as the defaults'."""
    cfg = _cfg(True, **REWRITES)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, admm_iters=1, num_epochs=1, iters_per_epoch=2,
        checkpoint_dir=str(tmp_path)))
    tc.check_supported(cfg)
    sampler = MinibatchSampler([synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"],
                               cfg.data, seed=0)
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    summary = trainer.run(sampler)
    assert all(np.isfinite(v) for v in summary.values())
    assert trainer.model.state_dict().keys() == CascadedAE(_cfg().model).state_dict().keys()


@pytest.mark.parametrize("field", ["model.fuse_1d", "model.fast_conv1d",
                                   "model.packed_conv2d", "train.remat"])
def test_config_fields_are_accepted(field):
    """Every field the port once refused is accepted by ``check_supported``, the CLI's
    override syntax and the Trainer, and off by default as in JAX."""
    section, name = field.split(".")
    value = 3 if name == "packed_conv2d" else True
    cfg = tc._apply_overrides(tc.Config(), [f"{field}={value}"])
    assert getattr(getattr(cfg, section), name) == value
    assert getattr(getattr(tc.Config(), section), name) == \
        getattr(getattr(jc.Config(), section), name) in (0, False)
    tc.check_supported(cfg)
    assert Trainer(cfg, device="cpu").state is None


@pytest.mark.parametrize("T,F", [(256, 384), (200, 330)], ids=["covered", "ragged"])
def test_unpatchify_mean_matches_jax(T, F):
    """Bit for bit JAX's on a ``patchify_torch`` output; where the patches cover the
    spectrogram it returns the input (every overlap averages equal values)."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, T, F, 4)).astype(np.float32)
    patches, (px, py) = patchify_torch(torch.from_numpy(x), 128)
    want = np.asarray(jax_unpatchify_mean(jnp.asarray(patches.numpy()), 2, px, py, T, F))
    got = unpatchify_mean(patches, 2, px, py, T, F)
    np.testing.assert_array_equal(got.numpy(), want)
    jp, _ = patchify_jax(jnp.asarray(x), 128)
    np.testing.assert_array_equal(patches.numpy(), np.asarray(jp))
    covered = (slice(None), slice(0, 64 * (px + 1)), slice(0, 64 * (py + 1)))
    np.testing.assert_array_equal(got.numpy()[covered], x[covered])


def test_train_from_config_without_data_raises_as_jax(tmp_path):
    """Both packages' ``train_from_config`` scan ``data.data_dir`` and refuse an
    empty one with the same message."""
    msgs = []
    for mod, call in ((jc, jax_train_from_config),
                      (tc, lambda c: train_from_config(c, device="cpu"))):
        cfg = mod.Config(data=mod.DataConfig(data_dir=str(tmp_path)))
        with pytest.raises(FileNotFoundError) as e:
            call(cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no valid H5 data" in msgs[0]


def test_train_from_config_trains_from_the_data_dir(synth_h5_dir, tmp_path):
    """``train_from_config`` is ``Trainer(cfg).run()`` over the files under
    ``data.data_dir``: the same parameters and checkpoint as that run."""
    cfg = dataclasses.replace(
        _cfg(), data=tc.DataConfig(data_dir=synth_h5_dir, batch_size=1, prefetch=0),
        train=tc.TrainConfig(admm_iters=1, num_epochs=1, iters_per_epoch=1, seed=3,
                             checkpoint_dir=str(tmp_path / "a")))
    got = train_from_config(cfg, device="cpu")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "b")))
    want = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    want.run()
    assert got.state.step == want.state.step == 1
    w = want.model.state_dict()
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, w[k]), k
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        sorted(p.name for p in (tmp_path / "b").iterdir())
