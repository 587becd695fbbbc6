"""The port's Fourier cascade (``model.fourier_variant``, preset ``fourier_cascade``)
against the JAX package on the CPU, at 2 patches of 128 x 128 x 4, latent 16,
``latent_dim_fourier`` 8 and 4 clusters.  JAX runs jitted with the plain strided
convolutions and the XLA KHM expression (``pallas_head=False``, ``khm_backend="xla"``;
the head kernels are held to JAX by test_torch_conv_head.py and
test_torch_bf16_head.py); the port runs its defaults (the kernels' plain versions on
the CPU) and the plain expressions.

Tolerances, with what was measured on the CPU beside them:
- the DFT 1e-5 relative to the largest magnitude (measured 4.5e-7 against torch.fft);
  the bf16 DFT matrices equal JAX's bit for bit;
- float32 outputs and objective terms 1e-5, gradients 2e-5;
- the Adam step's metrics 1e-5 and its parameters 1e-5 relative + 1e-6 (as
  tests/test_torch_train.py), except that at most 1 entry in 1e5 may miss that band
  by up to 5 % of the learning rate (measured 3 of 1.64 M entries, at most 1.73e-6 =
  1.7 % of lr): Adam scales each update by its own gradient's size, so an entry whose
  gradient is rounding noise moves by another share of lr;
- the bf16 modes as tests/test_torch_bf16.py, at its size of 4 patches in 2 baselines
  (outputs 2e-2 of the largest magnitude, measured 1.0e-2; first-iteration terms
  2.5e-3 |a|, measured 2.4e-3, ``rica`` under ``bfloat16_full``).  At 2 patches the
  ``aug`` and ``rica`` terms average over too few latents: there JAX's own bf16 moves
  ``rica`` by 3.8e-3 of its float32 value, and the port is as far from JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import config as jc
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.models.cascade import _dft_mats as jax_dft_mats
from lshm_tpu.models.cascade import fft2_shifted as jax_fft2_shifted
from lshm_tpu.train import LossWeights as JLossWeights
from lshm_tpu.train import TrainState as JTrainState
from lshm_tpu.train import make_train_step as jax_make_train_step
from lshm_tpu.train.objective import Duals as JDuals
from lshm_tpu.train.objective import cascade_objective as jax_objective
from lshm_tpu.train.step import make_optimizer as jax_make_optimizer
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.models.cascade import dft_mats, fft2_shifted
from lshm_tpu_torch.params import from_flax, to_flax
from lshm_tpu_torch.train import (
    Duals,
    LossWeights,
    Trainer,
    cascade_objective,
    init_train_state,
    make_train_step,
)
from lshm_tpu_torch.utils import MetricLogger, restore_checkpoint

MODEL = dict(latent_dim=16, latent_dim_fourier=8, num_clusters=4, fourier_variant=True)
NADMM, LR = 2, 1e-4
OUTPUTS = ("x1", "x11", "x2", "x3", "xrecon", "Mu", "mu", "muT", "muF", "yf_in", "yf_out")
PLAIN = dict(pallas_head=False, khm_backend="xla")


def _cfg(mod, dtype="float32", **model_kw):
    return mod.Config(data=mod.DataConfig(batch_size=1),
                      model=mod.ModelConfig(**MODEL, compute_dtype=dtype, **model_kw),
                      optim=mod.OptimConfig(adam_lr=LR),
                      train=mod.TrainConfig(admm_iters=NADMM, seed=3))


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(1, 2)) * 300, 2, axis=0).astype(np.float32)
    # non-zero duals, so the ADMM terms' linear parts count
    y1 = (rng.normal(size=x.shape) * 0.1).astype(np.float32)
    y2 = (rng.normal(size=(*x.shape[:3], 8)) * 0.1).astype(np.float32)
    return x, uv, y1, y2


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.size == 0:                                        # muF of the Fourier variant
        return 0.0
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_reference():
    """The port's initial state dict; from it, JAX's float32 outputs, objective terms
    and parameter gradients (non-zero duals) and one Adam minibatch, all jitted."""
    init_sd = {k: v.clone() for k, v in
               init_train_state(_cfg(tc), "cpu").model.state_dict().items()}
    cfg = _cfg(jc)
    model = JCascadedAE(cfg=cfg.model)
    params = jax.tree.map(jnp.asarray, to_flax(init_sd))
    x, uv, y1, y2 = _batch()
    duals = JDuals(y1=jnp.asarray(y1), y2=jnp.asarray(y2), y3=jnp.zeros((0,)))

    def fwd_obj(p, xx, u, d):
        (_, terms), grads = jax.value_and_grad(
            lambda q: jax_objective(model, q, xx, u, d, JLossWeights(), 1),
            has_aux=True)(p)
        return model.apply(p, xx, u), terms, grads

    out, terms, grads = jax.jit(fwd_obj)(params, jnp.asarray(x), jnp.asarray(uv), duals)
    tx = jax_make_optimizer(cfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, tx, cfg, num_groups=1, donate=False)
    new_state, metrics = step(state, jnp.asarray(x), jnp.asarray(uv), JLossWeights())
    return dict(init_sd=init_sd, params=params,
                out={k: np.asarray(getattr(out, k)) for k in OUTPUTS},
                terms={k: float(v) for k, v in terms.items()}, grads=_leaves(grads),
                metrics=jax.device_get(metrics), new_params=_leaves(new_state.params))


def _port_model(ref, dtype="float32", **model_kw):
    state = init_train_state(_cfg(tc, dtype, **model_kw), "cpu")
    state.model.load_state_dict(ref["init_sd"])
    return state


def test_fft2_shifted_matches_jax_and_torch_fft():
    x = np.random.default_rng(1).normal(size=(2, 128, 128, 4)).astype(np.float32)
    got = fft2_shifted(torch.tensor(x))
    assert got.shape == (2, 128, 128, 8) and got.dtype == torch.float32
    assert _rel(got.numpy(), jax_fft2_shifted(jnp.asarray(x))) <= 1e-5
    f = torch.fft.fftshift(torch.fft.fft2(torch.tensor(x), dim=(1, 2), norm="ortho"),
                           dim=(1, 2))
    assert _rel(got.numpy(), torch.cat([f.real, f.imag], dim=-1).numpy()) <= 1e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dft_matrices_match_jax(dtype):
    """bf16: bit for bit (the JAX matrices computed eagerly, each operation rounded to
    bf16); float32: within 1e-7 absolute (cos and sin may differ by an ulp)."""
    got = dft_mats(128, getattr(torch, dtype), torch.device("cpu"))
    want = jax_dft_mats(128, getattr(jnp, dtype))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == (128, 128)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          np.asarray(w).view(np.int16))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-7)


def test_dft_matrices_made_under_inference_mode_serve_a_backward():
    """The matrices are cached: those first made under ``inference_mode`` (an
    evaluation) are normal tensors, which a later training step saves for its
    backward (a size no other test builds, so that this call makes them)."""
    x = torch.randn(1, 24, 24, 2)
    with torch.inference_mode():
        want = fft2_shifted(x)
    xg = x.clone().requires_grad_()
    got = fft2_shifted(xg)
    got.square().sum().backward()
    assert torch.equal(got.detach(), want) and xg.grad.shape == x.shape


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_cascade_outputs_and_duals_match_jax(jax_reference, kernels):
    ref = jax_reference
    model = _port_model(ref, **({} if kernels else PLAIN)).model
    x, uv, _, _ = _batch()
    with torch.no_grad():
        out = model(torch.tensor(x), torch.tensor(uv))
    for k in OUTPUTS:
        got = getattr(out, k).numpy()
        assert got.shape == ref["out"][k].shape, k
        assert _rel(got, ref["out"][k]) <= 1e-5, k
    assert float(out.yf_in.abs().max()) <= 10.0          # the stability clamp
    d, jd = Duals.zeros_like(out.x1, fourier=True), JDuals.zeros_like(
        jnp.asarray(x), fourier=True)
    for name in ("y1", "y2", "y3"):
        assert tuple(getattr(d, name).shape) == getattr(jd, name).shape, name


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_objective_terms_and_gradients_match_jax(jax_reference, kernels):
    ref = jax_reference
    model = _port_model(ref, **({} if kernels else PLAIN)).model
    x, uv, y1, y2 = _batch()
    duals = Duals(y1=torch.tensor(y1), y2=torch.tensor(y2), y3=torch.zeros(0))
    kw = {} if kernels else dict(khm_backend="xla")
    loss, terms = cascade_objective(model, torch.tensor(x), torch.tensor(uv), duals,
                                    LossWeights(), 1, **kw)
    assert terms.keys() == ref["terms"].keys() and float(terms["loss3"]) == 0.0
    for k, a in ref["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), a, rtol=1e-5, err_msg=k)
    loss.backward()
    got = _leaves(to_flax({n: p.grad for n, p in model.named_parameters()}))
    assert got.keys() == ref["grads"].keys()
    for k, want in ref["grads"].items():
        assert _rel(got[k], want) <= 2e-5, k


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
def test_adam_step_matches_jax(jax_reference, kernels):
    ref = jax_reference
    model_kw = {} if kernels else PLAIN
    state = _port_model(ref, **model_kw)
    x, uv, _, _ = _batch()
    state, metrics = make_train_step(_cfg(tc, **model_kw), 1)(
        state, torch.tensor(x), torch.tensor(uv), LossWeights())
    assert metrics.keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        assert metrics[k].shape == (NADMM,)
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-5, err_msg=k)
    got = _leaves(to_flax(state.model.state_dict()))
    n = off = 0
    for k, v in ref["new_params"].items():
        d = np.abs(got[k] - v)
        n, off = n + v.size, off + int(np.sum(d > 1e-6 + 1e-5 * np.abs(v)))
        assert float(d.max()) <= 0.05 * LR, k
    assert off <= n * 1e-5, (off, n)


@pytest.mark.parametrize("dtype", ["bfloat16", "bfloat16_full"])
def test_bf16_modes_match_jax(jax_reference, dtype):
    """Outputs and the first ADMM iteration's loss terms (zero duals) of each bf16 mode
    against jitted JAX at the same mode, from the same parameters, on 4 patches."""
    ref = jax_reference
    model = JCascadedAE(cfg=_cfg(jc, dtype).model)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(2, 2)) * 300, 2, axis=0).astype(np.float32)
    xj = jnp.asarray(x)
    if dtype == "bfloat16_full":
        xj = xj.astype(jnp.bfloat16)
    out_j, terms_j = jax.jit(lambda p, xx, u: (
        model.apply(p, xx, u),
        jax_objective(model, p, xx, u, JDuals.zeros_like(xx, fourier=True),
                      JLossWeights(), 2)[1]))(ref["params"], xj, jnp.asarray(uv))

    pmodel = _port_model(ref, dtype).model
    xt = torch.tensor(x).to(torch.bfloat16 if dtype == "bfloat16_full" else torch.float32)
    with torch.no_grad():
        out = pmodel(xt, torch.tensor(uv))
        _, terms = cascade_objective(pmodel, xt, torch.tensor(uv),
                                     Duals.zeros_like(xt, fourier=True), LossWeights(), 2)
    for k in OUTPUTS:
        got, want = getattr(out, k), getattr(out_j, k)
        assert got.dtype == xt.dtype and str(want.dtype) == str(xt.dtype).split(".")[-1], k
        assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 2e-2, k
    for k, a in terms_j.items():
        b = float(terms[k])
        assert terms[k].dtype == torch.float32, k
        assert abs(float(a) - b) <= 2.5e-3 * abs(float(a)), (k, float(a), b)


def test_params_round_trip_with_the_fourier_ae(jax_reference):
    """to_flax gives the Flax tree of JAX's own init (same paths and shapes, aef with
    2C input channels), and from_flax inverts it exactly."""
    ref = jax_reference
    x, uv, _, _ = _batch()
    jparams = jax.eval_shape(JCascadedAE(cfg=_cfg(jc).model).init, jax.random.PRNGKey(0),
                             jnp.asarray(x[:1]), jnp.asarray(uv[:1]))
    want = {jax.tree_util.keystr(p): v.shape
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {k: v.shape for k, v in _leaves(ref["params"]).items()} == want
    assert ref["params"]["params"]["aef"]["conv0"]["kernel"].shape == (4, 4, 8, 8)
    back = from_flax(to_flax(ref["init_sd"]))
    assert back.keys() == ref["init_sd"].keys()
    for k, v in ref["init_sd"].items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def _small_fourier_cfg(tmp_path, **optim_kw):
    cfg = tc.preset("fourier_cascade")
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2, prefetch=2),
        model=dataclasses.replace(cfg.model, latent_dim=16, latent_dim_fourier=8,
                                  num_clusters=4),
        optim=dataclasses.replace(cfg.optim, **optim_kw),
        train=dataclasses.replace(cfg.train, admm_iters=1, num_epochs=1,
                                  iters_per_epoch=1, checkpoint_dir=str(tmp_path)))


@pytest.mark.parametrize("schedule", [(), ("ae1d",)], ids=["all", "ae1d"])
def test_trainer_runs_the_fourier_preset(tmp_path, schedule):
    """preset("fourier_cascade") through Trainer.run on the CPU: finite losses and a
    checkpoint; an "ae1d" epoch moves the Fourier AE and nothing else."""
    cfg = _small_fourier_cfg(tmp_path, group_schedule=schedule)
    assert cfg.model.fourier_variant and cfg.model.total_latent_dim == 24
    sampler = MinibatchSampler([synth_extract(nstations=4, ntime=192, nfreq=192)], ["0"],
                               cfg.data, seed=0)
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    summary = trainer.run(sampler)
    assert {"loss", "loss0", "loss2", "kdist", "rica"} <= summary.keys()
    assert all(np.isfinite(v) for v in summary.values()) and summary["loss3"] == 0.0
    saved, _ = restore_checkpoint(str(tmp_path))
    now = trainer.model.state_dict()
    assert saved["params"].keys() == now.keys() and any(k.startswith("aef.") for k in now)
    init = init_train_state(cfg, "cpu").model.state_dict()
    moved = {k.split(".")[0] for k in now if not torch.equal(init[k], now[k])}
    assert moved == ({"aef"} if schedule else {"ae2d", "aef", "khm"})
