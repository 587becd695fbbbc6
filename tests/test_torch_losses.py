"""Losses of the PyTorch port against the JAX package: values (rtol 1e-5) and autograd
gradients (2e-5 relative) on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import losses as jl
from lshm_tpu_torch import losses as tl


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return {
        "X": f(12, 16), "M": rng.uniform(size=(4, 16)).astype(np.float32),
        "Z": f(12, 16), "big": f(50, scale=8.0),
        "a": f(6, 8), "b": f(6, 4), "c": f(6, 4),
        "y": f(3, 5, 5, 2), "r": f(3, 5, 5, 2),
    }


# name -> (argument names, call with the module's functions)
CASES = {
    "pairwise_sq_dists": (("X", "M"), lambda L, X, M: L.pairwise_sq_dists(X, M)),
    "khm_loss_p4": (("X", "M"), lambda L, X, M: L.khm_loss(X, M, 4)),
    "khm_loss_p2": (("X", "M"), lambda L, X, M: L.khm_loss(X, M, 2)),
    "khm_loss_p3": (("X", "M"), lambda L, X, M: L.khm_loss(X, M, 3)),
    "khm_distances_p4": (("X", "M"), lambda L, X, M: L.khm_distances(X, M, 4)),
    "khm_distances_p3": (("X", "M"), lambda L, X, M: L.khm_distances(X, M, 3)),
    "cluster_similarity_loss": (("M",), lambda L, M: L.cluster_similarity_loss(M)),
    "augmentation_loss": (("Z",), lambda L, Z: L.augmentation_loss(Z, 3)),
    "log_cosh": (("big",), lambda L, v: L.log_cosh(v)),
    "rica_loss": (("a", "b", "c"), lambda L, a, b, c: L.rica_loss(a, b, c)),
    "mse_sum": (("a", "X"), lambda L, a, X: L.mse_sum(a, X[:6, :8])),
    "admm_term_shaped": (("y", "r"), lambda L, y, r: L.admm_term(y, r, 0.7)),
    "admm_term_flat": (("y", "r"), lambda L, y, r: L.admm_term(y.reshape(-1), r, 0.7)),
}


def _cotangent(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name):
    argnames, call = CASES[name]
    data = _inputs()
    args = [data[a] for a in argnames]

    want = np.asarray(call(jl, *[jnp.asarray(a) for a in args]))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got_t = call(tl, *targs)
    np.testing.assert_allclose(got_t.detach().numpy(), want, rtol=1e-5, atol=1e-7)

    ct = _cotangent(want.shape)
    jgrads = jax.grad(lambda *a: jnp.sum(call(jl, *a) * ct), argnums=tuple(
        range(len(args))))(*[jnp.asarray(a) for a in args])
    tgrads = torch.autograd.grad(torch.sum(got_t * torch.from_numpy(ct)), targs)
    for jg, tg in zip(jgrads, tgrads):
        jg, tg = np.asarray(jg), tg.numpy()
        scale = float(np.max(np.abs(jg))) + 1e-30
        assert float(np.max(np.abs(tg - jg))) / scale < 2e-5, name


def test_losses_accumulate_in_float32():
    X = torch.randn(8, 16, dtype=torch.bfloat16)
    M = torch.rand(3, 16)
    assert tl.khm_loss(X, M).dtype == torch.float32
    assert tl.mse_sum(X, X).dtype == torch.float32
    assert tl.rica_loss(X).dtype == torch.float32
