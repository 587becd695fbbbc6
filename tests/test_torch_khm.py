"""The port's fused KHM loss (kernels K1/K2, plain versions on the CPU) against the JAX
Pallas kernel in interpret mode, on the cases of tests/test_khm_pallas.py: values to
rtol 1e-5, gradients to rtol 2e-4 (the JAX suite's own tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.kernels import khm_loss_fused as jax_khm_fused
from lshm_tpu_torch import losses as tl
from lshm_tpu_torch.kernels import khm as tk


def _data(n, d, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.uniform(size=(k, d)).astype(np.float32))


def _port(X, M, p, backend="pallas"):
    Xt, Mt = (torch.tensor(a, requires_grad=True) for a in (X, M))
    loss = tk.khm_loss_fused(Xt, Mt, p, backend=backend)
    gx, gm = torch.autograd.grad(loss, (Xt, Mt))
    return float(loss.detach()), gx.numpy(), gm.numpy()


def _jax(X, M, p):
    f = lambda x, m: jax_khm_fused(x, m, p, force="interpret")
    val = float(f(jnp.asarray(X), jnp.asarray(M)))
    gx, gm = jax.grad(f, argnums=(0, 1))(jnp.asarray(X), jnp.asarray(M))
    return val, np.asarray(gx), np.asarray(gm)


# (n, d, k, p, seed): the shapes of tests/test_khm_pallas.py, plus the main path's
CASES = [(48, 256, 10, 4, 0), (16, 128, 4, 2, 1), (24, 128, 6, 4, 2),
         (2500, 256, 6, 4, 6), (5, 128, 3, 4, 7), (420, 256, 10, 4, 9)]


@pytest.mark.parametrize("n,d,k,p,seed", CASES)
def test_fused_matches_jax_interpret(n, d, k, p, seed):
    X, M = _data(n, d, k, seed)
    want, gx_w, gm_w = _jax(X, M, p)
    got, gx, gm = _port(X, M, p)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(gx, gx_w, rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(gm, gm_w, rtol=2e-4, atol=1e-8)


def test_odd_p_takes_the_plain_expression():
    X, M = _data(8, 16, 3, 3)
    got, gx, gm = _port(X, M, 3)
    want = float(jax_khm_fused(jnp.asarray(X), jnp.asarray(M), 3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    before = dict(tk.launches)
    Xt = torch.tensor(X)
    assert float(tk.khm_loss_fused(Xt, torch.tensor(M), 3)) == float(
        tl.khm_loss(Xt, torch.tensor(M), 3))
    assert tk.launches == before


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_backends_agree(backend):
    X, M = _data(30, 64, 5, 4)
    ref, gx_r, gm_r = _port(X, M, 4, backend="pallas")
    got, gx, gm = _port(X, M, 4, backend=backend)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(gx, gx_r, rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(gm, gm_r, rtol=2e-4, atol=1e-8)


def test_bf16_latents_are_upcast():
    X, M = _data(64, 16, 4, 5)
    Xb = torch.tensor(X).bfloat16().requires_grad_()
    v16 = tk.khm_loss_fused(Xb, torch.tensor(M), 4)
    v32 = tl.khm_loss(Xb.detach().float(), torch.tensor(M), 4)
    assert abs(float(v16.detach()) - float(v32)) < 1e-4 * abs(float(v32)) + 1e-6
    (g,) = torch.autograd.grad(v16, Xb)
    assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())


def test_cpu_wrappers_do_not_count_launches():
    X, M = _data(16, 32, 3, 8)
    before = dict(tk.launches)
    _port(X, M, 4)
    assert tk.launches == before
