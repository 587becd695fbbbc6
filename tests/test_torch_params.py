"""Weight bridge of the PyTorch port: Flax CascadedAE params <-> the port's state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.utils.torch_import import convert_autoencoder
from lshm_tpu_torch.config import ModelConfig
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.params import from_flax, to_flax

SMALL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=3)


@pytest.fixture(scope="module")
def flax_params():
    x, uv = jnp.zeros((1, 128, 128, 4)), jnp.zeros((1, 2))
    return jax.jit(JCascadedAE(cfg=JModelConfig(**SMALL)).init)(jax.random.PRNGKey(0), x, uv)


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_roundtrip_is_bit_exact(flax_params):
    back = _leaves(to_flax(from_flax(flax_params)))
    want = _leaves(jax.device_get(flax_params))
    assert back.keys() == want.keys()
    for k in want:
        assert back[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_state_dict_fits_the_port_model(flax_params):
    model = CascadedAE(ModelConfig(**SMALL))
    sd = from_flax(flax_params)
    own = model.state_dict()
    assert sd.keys() == own.keys()
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    back = _leaves(to_flax(model.state_dict()))
    for k, v in _leaves(jax.device_get(flax_params)).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("name,ndim", [("ae2d", 2), ("aeT", 1)])
def test_port_layout_is_the_reference_layout(flax_params, name, ndim):
    """The JAX package's importer of reference checkpoints reads the port's state_dict
    back into the same Flax params: the port stores the reference's layouts."""
    sd = from_flax(flax_params)
    sub = {k[len(name) + 1:]: v for k, v in sd.items() if k.startswith(name + ".")}
    got = _leaves(convert_autoencoder(sub, ndim, rica=True))
    want = _leaves(jax.device_get(flax_params["params"][name]))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_init_follows_flax_distributions():
    model = CascadedAE(ModelConfig(**SMALL), generator=torch.Generator().manual_seed(3))
    for name, p in model.named_parameters():
        v = p.detach().numpy()
        if name.endswith(".bias"):
            assert not v.any(), name
        elif name == "khm.M":
            assert 0.0 <= v.min() and v.max() < 1.0
        else:
            fan_in = v[0].size if "tconv" not in name else v.shape[0] * v[0, 0].size
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
            assert np.abs(v).max() <= 2.0 * std * (1 + 1e-6), name
            if v.size >= 2000:   # variance 1 / fan_in within sampling error
                assert abs(v.var() * fan_in - 1.0) < 0.15, name
