"""Models of the PyTorch port against the JAX package with bridged parameters: outputs
(1e-5) and all parameter gradients (2e-5 relative), on 2 patches of 128 x 128."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.models import AutoEncoder1D as JAE1D
from lshm_tpu.models import AutoEncoder2D as JAE2D
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu_torch.config import ModelConfig
from lshm_tpu_torch.models import AutoEncoder1D, AutoEncoder2D, CascadedAE
from lshm_tpu_torch.params import to_flax

N = 2


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(N, 2)) * 300).astype(np.float32))


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def _grad_tree(module, prefix=""):
    return {prefix + n: p.grad for n, p in module.named_parameters()}


def _compare_trees(got, want, tol):
    got_l = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        assert _rel(np.asarray(got_l[path]), np.asarray(w)) < tol, jax.tree_util.keystr(path)


def _check_ae(port, jax_mod, prefix, x, uv):
    """Forward and gradients of one AE: the port's random init is bridged into Flax."""
    flax = to_flax({f"{prefix}.{k}": v for k, v in port.state_dict().items()}
                   | {"khm.M": np.zeros((1, 1), np.float32)})["params"][prefix]
    rng = np.random.default_rng(9)
    y_j, mu_j = jax_mod.apply({"params": flax}, jnp.asarray(x), jnp.asarray(uv))
    ct_y = rng.normal(size=y_j.shape).astype(np.float32)
    ct_mu = rng.normal(size=mu_j.shape).astype(np.float32)

    y, mu = port(torch.tensor(x), torch.tensor(uv))
    assert _rel(y.detach().numpy(), np.asarray(y_j)) < 1e-5
    assert _rel(mu.detach().numpy(), np.asarray(mu_j)) < 1e-5

    def loss_j(p):
        yy, mm = jax_mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(uv))
        return jnp.sum(yy * ct_y) + jnp.sum(mm * ct_mu)

    want = jax.grad(loss_j)(flax)
    (torch.sum(y * torch.from_numpy(ct_y)) + torch.sum(mu * torch.from_numpy(ct_mu))).backward()
    grads = {f"{prefix}.{k}": v for k, v in _grad_tree(port).items()}
    got = to_flax(grads | {"khm.M": np.zeros((1, 1), np.float32)})["params"][prefix]
    _compare_trees(got, want, 2e-5)


@pytest.mark.parametrize("pallas_head", [False, True])
def test_ae2d_matches_flax(pallas_head):
    x, uv = _batch((N, 128, 128, 4))
    port = AutoEncoder2D(latent_dim=16, pallas_head=pallas_head,
                         generator=torch.Generator().manual_seed(1))
    # the JAX module with pallas_head runs the Pallas kernel in interpret mode
    _check_ae(port, JAE2D(latent_dim=16, pallas_head=pallas_head), "ae2d", x, uv)


def test_ae1d_matches_flax():
    x, uv = _batch((N, 128 * 128, 4), seed=1)
    port = AutoEncoder1D(latent_dim=8, generator=torch.Generator().manual_seed(2))
    _check_ae(port, JAE1D(latent_dim=8), "aeT", x, uv)


@pytest.mark.parametrize("rica", [True, False])
def test_cascade_matches_flax(rica):
    x, uv = _batch((N, 128, 128, 4), seed=2)
    cfg = dict(latent_dim=16, latent_dim_1d=8, num_clusters=3, rica=rica)
    port = CascadedAE(ModelConfig(**cfg, pallas_head=True),
                      generator=torch.Generator().manual_seed(4))
    jmod = JCascadedAE(cfg=JModelConfig(**cfg))
    params = to_flax(port.state_dict())
    out_j = jmod.apply(params, jnp.asarray(x), jnp.asarray(uv))
    out = port(torch.tensor(x), torch.tensor(uv))
    for name in ("x1", "x11", "x2", "x3", "xrecon", "Mu", "mu", "muT", "muF"):
        assert _rel(getattr(out, name).detach().numpy(),
                    np.asarray(getattr(out_j, name))) < 1e-5, name

    cts = {k: np.random.default_rng(i).normal(size=getattr(out_j, k).shape)
           .astype(np.float32) for i, k in enumerate(("xrecon", "x11", "Mu"))}

    def loss_j(p):
        o = jmod.apply(p, jnp.asarray(x), jnp.asarray(uv))
        return sum(jnp.sum(getattr(o, k) * c) for k, c in cts.items()) \
            + jnp.sum(p["params"]["khm"]["M"] ** 2)

    want = jax.grad(loss_j)(params)
    loss = sum(torch.sum(getattr(out, k) * torch.from_numpy(c)) for k, c in cts.items())
    (loss + torch.sum(port.khm.M ** 2)).backward()
    _compare_trees(to_flax(_grad_tree(port)), want, 2e-5)


def test_khm_head_matches_flax():
    from lshm_tpu.models import KHarmonicMeans as JKHM
    from lshm_tpu.models.khm import khm_offline_update as jax_update
    from lshm_tpu_torch.models import KHarmonicMeans, khm_offline_update

    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 12)).astype(np.float32)
    head = KHarmonicMeans(latent_dim=12, num_clusters=5,
                          generator=torch.Generator().manual_seed(0))
    M = head.M.detach().numpy()
    assert M.shape == (5, 12) and 0.0 <= M.min() and M.max() < 1.0
    jhead, jp = JKHM(latent_dim=12, num_clusters=5), {"params": {"M": jnp.asarray(M)}}
    Xj, Xt = jnp.asarray(X), torch.tensor(X)
    pairs = [
        (head(Xt), jhead.apply(jp, Xj)),
        (head.cluster_similarity(), jhead.apply(jp, method=jhead.cluster_similarity)),
        (head.distances(Xt), jhead.apply(jp, Xj, method=jhead.distances)),
        (khm_offline_update(Xt, head.M), jax_update(Xj, jnp.asarray(M))),
    ]
    for got, want in pairs:
        assert _rel(got.detach().numpy(), np.asarray(want)) < 1e-5
    np.testing.assert_array_equal(head.assign(Xt).numpy(),
                                  np.asarray(jhead.apply(jp, Xj, method=jhead.assign)))


def test_unported_model_fields_raise():
    for kw in (dict(fourier_variant=True), dict(fuse_1d=True), dict(fast_conv1d=True),
               dict(packed_conv2d=1), dict(compute_dtype="bfloat16_full")):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            CascadedAE(ModelConfig(**kw))
