"""The port's stochastic L-BFGS (``lshm_tpu_torch.optim``) against the JAX step
(``lshm_tpu.optim.make_lbfgs_step``, jitted), several steps on the same problems from
the same numpy inputs: ``func_evals``, the iteration count and the history length equal
after every step, loss and parameters within the case's tolerance.

Batch mode (backtracking), the fixed step and the NaN guard run in float32, the
training type: RTOL/ATOL cover float32 summation order only (a matrix product or a dot
sums in another order in XLA than in PyTorch, and the port takes one dot over all
parameters where JAX adds per-leaf dots).  The full-batch cubic search estimates
derivatives by central differences with a step of 1e-6: in float32 a one-ulp
difference in the loss changes such a derivative by about 1%, enough to move the
cubic minimiser and, a few probes later, a branch.  Those cases therefore run in
float64, as ``tests/test_lbfgs.py::test_func_evals_parity_fullbatch`` runs the JAX
step against the reference, and they stop before the optimum, where even float64
central differences decide branches by rounding (jitted and eager JAX then differ
from each other by a count too).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import config as jc
from lshm_tpu.optim import lbfgs_init as jax_lbfgs_init
from lshm_tpu.optim import make_lbfgs_step as jax_make_lbfgs_step
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.optim import LBFGS, lbfgs_init, make_lbfgs_step, value_and_grad

RTOL, ATOL = 2e-4, 2e-5            # float32 cases
# float64 cases: a central difference with a step of 1e-6 turns float64 rounding of
# the loss (1e-16 relative) into ~1e-10 of a derivative, which the cubic minimiser
# passes on to the step sizes
RTOL64, ATOL64 = 1e-6, 1e-8


def quad_problem(n=12, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    A = (Q @ Q.T / n + np.eye(n)).astype(dtype)
    b = rng.normal(size=n).astype(dtype)
    x0 = rng.normal(size=n).astype(dtype)
    return A, b, x0


def _quadratic(seed, dtype=np.float32):
    A, b, x0 = quad_problem(seed=seed, dtype=dtype)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.tensor(A), torch.tensor(b)
    return (lambda v: 0.5 * v @ Aj @ v - bj @ v,
            lambda p: 0.5 * p["v"] @ At @ p["v"] - bt @ p["v"], x0)


def _rosenbrock(dtype):
    fj = lambda v: 100.0 * (v[1] - v[0] ** 2) ** 2 + (1.0 - v[0]) ** 2
    ft = lambda p: 100.0 * (p["v"][1] - p["v"][0] ** 2) ** 2 + (1.0 - p["v"][0]) ** 2
    return fj, ft, np.array([-1.2, 1.0], dtype)


def _noisy_least_squares(steps):
    rng = np.random.default_rng(3)
    n, dim = 256, 8
    W = rng.normal(size=(n, dim)).astype(np.float32)
    y = (W @ rng.normal(size=dim) + 0.05 * rng.normal(size=n)).astype(np.float32)
    batches = []
    for _ in range(steps):
        idx = rng.integers(0, n, 64)
        batches.append((W[idx], y[idx]))

    def fj(v, Wb, yb):
        r = Wb @ v - yb
        return jnp.mean(r * r)

    def ft(p, Wb, yb):
        r = Wb @ p["v"] - yb
        return torch.mean(r * r)

    return fj, ft, np.zeros(dim, np.float32), batches


def _nan_objective():
    fj = lambda v: jnp.where(jnp.abs(v[0]) > 3.0, jnp.nan, jnp.sum(v * v))
    ft = lambda p: torch.where(p["v"][0].abs() > 3.0, torch.tensor(float("nan")),
                               torch.sum(p["v"] * p["v"]))
    return fj, ft, np.array([1.0, 2.0], np.float32)


def _gradient_consuming_cost(dtype):
    """A cost that consumes a gradient (quadratic + a small gradient-norm term): the
    reason for cost_use_gradient (reference: src/lbfgsnew.py:61-69,686-693)."""
    A, b, x0 = quad_problem(seed=5, dtype=dtype)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), torch.tensor(A), torch.tensor(b)
    inner_j = lambda v: 0.5 * v @ Aj @ v - bj @ v

    def fj(v):
        g = jax.grad(inner_j)(v)
        return inner_j(v) + 1e-4 * jnp.sum(g * g)

    def ft(p):
        v = p["v"]
        inner = 0.5 * v @ At @ v - bt @ v
        (g,) = torch.autograd.grad(inner, v, create_graph=True)
        return inner + 1e-4 * torch.sum(g * g)

    return fj, ft, x0


def _case(name):
    """(LBFGSConfig kwargs, jax closure, torch closure, x0, per-step args); the dtype of
    x0 is the case's."""
    full = dict(lr=1.0, line_search=True, batch_mode=False)
    f64 = np.float64
    if name == "quadratic_cubic":
        return (dict(full, max_iter=8, history_size=7), *_quadratic(0, f64), [()] * 2)
    if name == "rosenbrock":
        return (dict(full, max_iter=50, history_size=7), *_rosenbrock(f64), [()] * 3)
    if name == "noisy_batch_mode":
        fj, ft, x0, batches = _noisy_least_squares(25)
        return (dict(lr=1.0, max_iter=4, history_size=7, line_search=True,
                     batch_mode=True), fj, ft, x0, batches)
    if name == "fixed_step":
        return (dict(lr=0.2, max_iter=10, line_search=False, batch_mode=False),
                *_quadratic(1), [()] * 3)
    if name == "history_wraps":
        return (dict(full, max_iter=6, history_size=3), *_quadratic(6, f64), [()] * 3)
    if name == "nan_objective":
        return (dict(lr=1.0, max_iter=4, line_search=True, batch_mode=True),
                *_nan_objective(), [()] * 5)
    if name == "cost_use_gradient":
        return (dict(full, max_iter=10, cost_use_gradient=True),
                *_gradient_consuming_cost(f64), [()] * 3)
    raise ValueError(name)


CASES = ["quadratic_cubic", "rosenbrock", "noisy_batch_mode", "fixed_step",
         "history_wraps", "nan_objective", "cost_use_gradient"]
FLOAT64 = {"quadratic_cubic", "rosenbrock", "history_wraps", "cost_use_gradient"}


@pytest.fixture
def jax_x64(request):
    """float64 JAX for the cases in FLOAT64, restored afterwards."""
    on = request.node.callspec.params["case"] in FLOAT64
    jax.config.update("jax_enable_x64", on)
    yield on
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("case", CASES)
def test_lbfgs_step_matches_jax(case, jax_x64):
    kw, fj, ft, x0, per_step = _case(case)
    assert (x0.dtype == np.float64) == jax_x64
    rtol, atol = (RTOL64, ATOL64) if jax_x64 else (RTOL, ATOL)
    jcfg, tcfg = jc.LBFGSConfig(**kw), tc.LBFGSConfig(**kw)
    jstep = jax.jit(jax_make_lbfgs_step(jax.value_and_grad(fj), fj, jcfg))
    tstep = make_lbfgs_step(value_and_grad(ft), ft, tcfg)
    jx, jstate = jnp.asarray(x0), jax_lbfgs_init(x0.size, jcfg, dtype=jnp.asarray(x0).dtype)
    tx = {"v": torch.tensor(x0)}
    tstate = lbfgs_init(tx, tcfg)
    for i, args in enumerate(per_step):
        jx, jstate, jloss = jstep(jx, jstate, *map(jnp.asarray, args))
        res = tstep(tx, tstate, *map(torch.tensor, args))
        tx, tstate = res.x, res.state
        assert tstate.func_evals == int(jstate.func_evals), f"step {i}"
        assert tstate.n_iter == int(jstate.n_iter), f"step {i}"
        assert tstate.hist_count == int(jstate.hist_count), f"step {i}"
        np.testing.assert_allclose(float(res.loss), float(jloss), rtol=rtol, atol=atol,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(tx["v"].numpy(), np.asarray(jx), rtol=rtol, atol=atol,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(float(tstate.alphabar), float(jstate.alphabar),
                                   rtol=rtol, err_msg=f"step {i}")
    assert tx["v"].dtype == torch.from_numpy(x0).dtype
    assert np.all(np.isfinite(tx["v"].numpy()))
    if case == "history_wraps":          # more accepted pairs than slots
        assert tstate.hist_count == 3 and tstate.n_iter > 6
        assert tstate.s_hist["v"].shape == (3, x0.size)
    assert tstate.host_syncs > 0


def test_wrapper_on_a_dict_of_parameters():
    """The LBFGS wrapper on two named parameters, as the JAX wrapper on a pytree."""
    params = {"w": torch.ones(3), "b": torch.zeros(())}

    def loss(p):
        return torch.sum((p["w"] - 2.0) ** 2) + (p["b"] + 1.0) ** 2

    opt = LBFGS(loss, params, tc.LBFGSConfig(lr=1.0, max_iter=20, line_search=True,
                                             batch_mode=False))
    for _ in range(5):
        opt.step()
    np.testing.assert_allclose(opt.params["w"].numpy(), 2.0, atol=1e-3)
    np.testing.assert_allclose(float(opt.params["b"]), -1.0, atol=1e-3)


def test_state_clone_is_independent():
    """The trainer's non-finite revert keeps a deep copy of ``state_dict()``; a step
    must not write into it, and ``load_state_dict`` puts it back."""
    fj, ft, x0 = _quadratic(2)
    cfg = tc.LBFGSConfig(lr=1.0, max_iter=4, history_size=3)
    step = make_lbfgs_step(value_and_grad(ft), ft, cfg)
    x = {"v": torch.tensor(x0)}
    state = lbfgs_init(x, cfg)
    res = step(x, state)
    snap = copy.deepcopy(state.state_dict())
    before = {k: v.clone() for k, v in snap["s_hist"].items()}
    step(res.x, state)
    assert snap["func_evals"] < state.func_evals
    assert all(torch.equal(before[k], snap["s_hist"][k]) for k in before)
    state.load_state_dict(snap)
    assert state.func_evals == snap["func_evals"] and state.s_hist is snap["s_hist"]
