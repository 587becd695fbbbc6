"""The port's serving export (``torch.export`` with K3 as the registered operator
``lshm_tpu_torch::head_fwd``) against the JAX package's ``export_forward`` (mirrors
``tests/test_export.py``): the round trip of a static and of a symbolic batch, at the
JAX suite's tolerances (1e-4 / 1e-5; distances 1e-3), from the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.eval import export_forward as jax_export_forward
from lshm_tpu.eval import load_exported as jax_load_exported
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.eval import export_forward, load_exported
from lshm_tpu_torch.kernels import conv_head
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.params import to_flax

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4, rica=True)


@pytest.fixture(scope="module")
def small_model():
    port = CascadedAE(tc.ModelConfig(**MODEL), generator=torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, to_flax(port.state_dict()))
    return port, JCascadedAE(cfg=JModelConfig(**MODEL)), params


@pytest.fixture(scope="module")
def jax_symbolic(small_model):
    _, jmodel, params = small_model
    return jax_load_exported(jax_export_forward(jmodel, params, batch_size=None))


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 128, 128, 4)).astype(np.float32),
            rng.normal(size=(n, 2)).astype(np.float32))


def _check(got, want):
    (xr, mu, d), (wxr, wmu, wd) = got, want
    np.testing.assert_allclose(xr.numpy(), np.asarray(wxr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mu.numpy(), np.asarray(wmu), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=1e-3, atol=1e-5)


def _head_nodes(fn):
    return [n for n in fn.graph.nodes
            if n.op == "call_function" and "lshm_tpu_torch.head_fwd" in str(n.target)]


def test_export_static_batch_roundtrip(small_model):
    port, jmodel, params = small_model
    blob = export_forward(port, batch_size=2)
    assert isinstance(blob, bytes) and len(blob) > 1000
    fn = load_exported(blob)
    x, uv = _inputs(2, 1)
    want = jax_load_exported(jax_export_forward(jmodel, params, batch_size=2))(
        jnp.asarray(x), jnp.asarray(uv))
    _check(fn(torch.from_numpy(x), torch.from_numpy(uv)), want)
    assert len(_head_nodes(fn)) == 1


def test_export_symbolic_batch(small_model, jax_symbolic):
    """One artifact serves several batch sizes, as JAX's does."""
    port, _, _ = small_model
    fn = load_exported(export_forward(port, batch_size=None))
    for n in (1, 3):
        x, uv = _inputs(n, 10 + n)
        xr, mu, d = fn(torch.from_numpy(x), torch.from_numpy(uv))
        assert xr.shape == (n, 128, 128, 4) and mu.shape == (n, 32) and d.shape == (n, 4)
        _check((xr, mu, d), jax_symbolic(jnp.asarray(x), jnp.asarray(uv)))


def test_exported_graph_calls_the_head_operator(small_model, monkeypatch):
    """The K3 operator stays one opaque node in the exported graph, on the CPU too (its
    plain version is not traced into the program), and the loaded program calls it
    once per forward: with a stand-in for the kernel wrapper, the call reaches it."""
    port, _, _ = small_model
    fn = load_exported(export_forward(port, batch_size=None))
    assert len(_head_nodes(fn)) == 1
    calls = []
    real = conv_head.head_forward

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(conv_head, "head_forward", spy)
    fn(*map(torch.from_numpy, _inputs(3, 5)))
    assert calls == [torch.Size([3, 128, 128, 4])]


def test_export_twice_from_an_empty_scales_cache(small_model):
    """The uv harmonic scales are cached per device for the eager and graph-captured
    forwards; a trace must not fill that cache with its fake tensor, or the next
    export in the process fails to lift it."""
    from lshm_tpu_torch.models import autoencoders

    port, _, _ = small_model
    autoencoders._scales.cache_clear()
    x, uv = _inputs(2, 3)
    outs = [load_exported(export_forward(port, batch_size=2))(torch.from_numpy(x),
                                                                torch.from_numpy(uv))
            for _ in range(2)]
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert autoencoders._scales.cache_info().currsize == 0
