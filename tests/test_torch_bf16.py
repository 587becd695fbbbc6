"""The port's bfloat16 compute modes against the JAX package at the same dtype, at the
small size of tests/test_bf16.py (4 patches, latent 16 / 8, 4 clusters): the cascade's
outputs, the per-term losses of ``cascade_objective`` and one Adam minibatch step
(admm_iters=2), for ``bfloat16`` and ``bfloat16_full``, with the fused head
(``pallas_head``; JAX runs its Pallas kernels in interpret mode, the port the plain
versions) and with the strided convolutions, on both sides.

Both sides round to bf16 at the same layers, but each sums in its own order, so the
bf16 values differ by an ulp here and there and the differences grow through the six
conv stages.  Tolerances, with the largest error measured on the CPU over the four
cases beside them:
- outputs 2e-2 relative to the largest magnitude (measured 7.9e-3, ``x3``);
- first-iteration loss terms |a - b| <= 2.5e-3 |a| (measured 6.5e-4, ``aug``);
- the step's per-term metrics over both ADMM iterations 1e-2 |a| (measured 4.1e-3);
  all three are inside JAX's own bf16-vs-f32 gate, 0.05 |a| + 5e-3
  (tests/test_bf16.py:61);
- the parameter updates: Adam's first updates are about lr times the sign of the
  gradient, so an entry whose gradient is near 0 can move the other way under
  another rounding.  At least 99 % of the entries move in JAX's direction (measured
  99.8 %) and the update vector is within 0.1 of JAX's in relative L2 norm (measured
  3.7e-2; JAX's own bf16 and float32 steps differ by 4.8e-2).
The parameters and Adam's moments stay float32.
"""

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
from lshm_tpu.train.objective import Duals as JDuals
from lshm_tpu.train.objective import cascade_objective as jax_objective
from lshm_tpu.train.step import make_optimizer as jax_make_optimizer
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.params import to_flax
from lshm_tpu_torch.train import (
    Duals,
    LossWeights,
    cascade_objective,
    init_train_state,
    make_train_step,
)

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)
CASES = [("bfloat16", True), ("bfloat16", False), ("bfloat16_full", True),
         ("bfloat16_full", False)]
OUTPUTS = ("x1", "x11", "x2", "x3", "xrecon", "Mu", "mu", "muT", "muF")
LR, NADMM = 1e-4, 2


def _cfg(mod, dtype, pallas_head):
    return mod.Config(data=mod.DataConfig(batch_size=2),
                      model=mod.ModelConfig(**MODEL, compute_dtype=dtype,
                                            pallas_head=pallas_head),
                      optim=mod.OptimConfig(adam_lr=LR),
                      train=mod.TrainConfig(admm_iters=NADMM, seed=3))


def _batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(2, 2)) * 300, 2, axis=0).astype(np.float32)
    return x, uv


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{d}-{'head' if h else 'strided'}" for d, h in CASES])
def jax_reference(request):
    """The port's initial state dict, and from it JAX's outputs, first-iteration loss
    terms (zero duals) and one Adam step, each jitted (eager, the interpreted Pallas
    kernels cost about 90 s more here)."""
    dtype, head = request.param
    init_sd = {k: v.clone() for k, v in
               init_train_state(_cfg(tc, dtype, head), "cpu").model.state_dict().items()}
    cfg = _cfg(jc, dtype, head)
    params = jax.tree.map(jnp.asarray, to_flax(init_sd))
    model = JCascadedAE(cfg=cfg.model)
    x, uv = _batch()
    xj = jnp.asarray(x)
    if dtype == "bfloat16_full":
        xj = xj.astype(jnp.bfloat16)
    out, terms = jax.jit(lambda p, xx, u: (
        model.apply(p, xx, u),
        jax_objective(model, p, xx, u, JDuals.zeros_like(xx), JLossWeights(), 2)[1]))(
            params, xj, jnp.asarray(uv))
    tx = jax_make_optimizer(cfg, params)
    state = JTrainState(params=params, opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(model, tx, cfg, num_groups=2, donate=False)
    new_state, metrics = step(state, jnp.asarray(x), jnp.asarray(uv), JLossWeights())
    return dict(dtype=dtype, head=head, init_sd=init_sd,
                out={k: (getattr(out, k).dtype, _np32(getattr(out, k))) for k in OUTPUTS},
                terms={k: float(v) for k, v in terms.items()},
                metrics=jax.device_get(metrics), params=jax.device_get(new_state.params))


def _port(ref):
    cfg = _cfg(tc, ref["dtype"], ref["head"])
    state = init_train_state(cfg, "cpu")
    state.model.load_state_dict(ref["init_sd"])
    x, uv = _batch()
    x = torch.tensor(x)
    if ref["dtype"] == "bfloat16_full":
        x = x.to(torch.bfloat16)
    return cfg, state, x, torch.tensor(uv)


def test_cascade_outputs_match_jax(jax_reference):
    ref = jax_reference
    _, state, x, uv = _port(ref)
    with torch.no_grad():
        out = state.model(x, uv)
    want_dtype = torch.bfloat16 if ref["dtype"] == "bfloat16_full" else torch.float32
    for k in OUTPUTS:
        got = getattr(out, k)
        jdtype, want = ref["out"][k]
        assert got.dtype == want_dtype and str(jdtype) == str(want_dtype).split(".")[-1], k
        assert _rel(got.float().numpy(), want) <= 2e-2, k
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def test_objective_terms_match_jax(jax_reference):
    ref = jax_reference
    _, state, x, uv = _port(ref)
    with torch.no_grad():
        _, terms = cascade_objective(state.model, x, uv, Duals.zeros_like(x),
                                     LossWeights(), 2)
    assert terms.keys() == ref["terms"].keys()
    for k, a in ref["terms"].items():
        b = float(terms[k])
        assert terms[k].dtype == torch.float32, k
        assert abs(a - b) <= 2.5e-3 * abs(a), (k, a, b)


def test_adam_step_matches_jax(jax_reference):
    ref = jax_reference
    cfg, state, _, uv = _port(ref)
    x = torch.tensor(_batch()[0])                  # float32: the step casts it itself
    state, metrics = make_train_step(cfg, 2)(state, x, uv, LossWeights())
    assert metrics.keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        assert metrics[k].shape == (NADMM,)
        np.testing.assert_allclose(metrics[k].numpy(), v, rtol=1e-2, atol=0, err_msg=k)
    sd = state.model.state_dict()
    assert all(t.dtype == torch.float32 for t in sd.values())
    assert all(t.dtype == torch.float32 for s in state.opt.state.values()
               for t in s.values() if t.dim() > 0)
    leaves = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    got, want = leaves(to_flax(sd)), leaves(ref["params"])
    init = leaves(to_flax(ref["init_sd"]))
    upd = lambda tree: np.concatenate([(np.asarray(tree[p]) - init[p]).ravel() for p in want])
    du, dw = upd(got), upd(want)
    same_sign = float(np.mean(np.sign(du) == np.sign(dw)))
    l2 = float(np.linalg.norm(du - dw) / np.linalg.norm(dw))
    assert same_sign >= 0.99 and l2 <= 0.1, (same_sign, l2)
