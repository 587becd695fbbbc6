"""The benchmark's plain reference against the port's plain paths on the CPU, at 2-4
patches: the model, the objective, the decode, uv, Adam's trajectory."""

import numpy as np
import pytest
import torch

from portbench import data, weights
from portbench.reference import train as ref_train
from portbench.reference.model import (Precision, Shape, Weights, cascade, objective,
                                       param_spec)

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def tree():
    return data.synth_sap(3, 192, 128, SEED, "cpu")


@pytest.fixture(scope="module")
def batch(tree):
    ids = [1, 4]
    g = data.sap(tree)
    x = data.decode(torch.from_numpy(g["visibilities"][ids]),
                    torch.from_numpy(g["visibility_scale_factors"][ids]), 128, 1e3)
    uv = torch.from_numpy(data.uv_of(tree, ids)).repeat_interleave(2, dim=0)
    return x, uv


def _port_model(params, **model_kw):
    from lshm_tpu_torch.config import ModelConfig
    from lshm_tpu_torch.models import CascadedAE

    m = CascadedAE(ModelConfig(**model_kw))
    m.load_state_dict(params)
    return m


def test_param_spec_is_the_ports():
    from lshm_tpu_torch.config import ModelConfig
    from lshm_tpu_torch.models import CascadedAE

    sd = CascadedAE(ModelConfig()).state_dict()
    assert {n: tuple(s) for n, s, _ in param_spec(Shape())} == {k: tuple(v.shape) for k, v in sd.items()}


def test_tree_reads_like_an_extract(tree):
    from lshm_tpu_torch.data import compute_uv, read_metadata

    assert read_metadata(tree, "0") == (6, 192, 128, 4, 2)
    np.testing.assert_allclose(data.uv_of(tree, [0, 2, 5]), compute_uv(tree, "0", [0, 2, 5]),
                               rtol=1e-6)


def test_decode_is_the_ports(tree):
    from lshm_tpu_torch.data import device_decode_train

    g = data.sap(tree)
    vis = torch.from_numpy(g["visibilities"][[0, 3, 5]])
    scl = torch.from_numpy(g["visibility_scale_factors"][[0, 3, 5]])
    mine = data.decode(vis, scl, 128, 1e3)
    port = device_decode_train(vis, scl, torch.zeros(3, 2, dtype=torch.bool))
    torch.testing.assert_close(mine, port, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("head", [False, True])
def test_cascade_and_objective_are_the_ports(batch, head):
    from lshm_tpu_torch.train.objective import Duals, LossWeights, loss_from_outputs

    x, uv = batch
    s = Shape()
    p = weights.init_params(s, SEED, "cpu")
    model = _port_model(p, pallas_head=head)
    with torch.no_grad():
        out = model(x, uv)
        mine = cascade(p, x, uv, s, Precision())
        for k in ("x1", "x2", "x3", "xrecon", "Mu"):
            torch.testing.assert_close(mine[k], getattr(out, k), rtol=1e-5, atol=1e-5)
        duals = tuple(0.1 * torch.randn(x.shape, generator=torch.Generator().manual_seed(i))
                      for i in range(3))
        _, m_port = loss_from_outputs(out, model.khm.M, x, Duals(*duals), LossWeights(), 2,
                                      khm_backend="auto")
        _, m_ref = objective(mine, p["khm.M"], x, duals, Weights(), 2, s)
        for k, v in m_port.items():
            torch.testing.assert_close(m_ref[k], v, rtol=1e-5, atol=1e-7)


def test_adam_trajectory_is_the_ports(batch):
    from lshm_tpu_torch.config import Config, TrainConfig
    from lshm_tpu_torch.train import LossWeights, make_train_step
    from lshm_tpu_torch.train.step import TrainState, make_optimizer

    x, uv = batch
    s = Shape()
    p = weights.init_params(s, SEED, "cpu")
    cfg = Config(train=TrainConfig(admm_iters=2))
    model = _port_model(p)
    state = TrainState(model, make_optimizer(cfg, model))
    step = make_train_step(cfg, 2)
    losses = [step(state, x, uv, LossWeights())[1]["loss"] for _ in range(2)]
    names = [n for n, _, _ in param_spec(s)]
    ref = ref_train.adam(p, [(x, uv)] * 2, names, s, Weights(), 2, 2, 1e-4, Precision())
    torch.testing.assert_close(ref.losses, torch.stack(losses).double(), rtol=1e-5, atol=0)
    for n, v in model.state_dict().items():
        torch.testing.assert_close(ref.params[n], v, rtol=1e-4, atol=1e-6)


def test_adam_from_moments_continues_the_trajectory(batch):
    """Following from an optimizer's moments and step count gives what one run over
    both minibatches gives."""
    x, uv = batch
    s = Shape()
    p = weights.init_params(s, SEED, "cpu")
    names = [n for n, _, _ in param_spec(s)]
    run = lambda p0, bs, moments=None: ref_train.adam(p0, bs, names, s, Weights(), 2, 2,
                                                      1e-4, Precision(), moments)
    whole = run(p, [(x, uv)] * 2)
    one = run(p, [(x, uv)])
    assert one.moments[2] == 2
    rest = run(one.params, [(x, uv)], one.moments)
    torch.testing.assert_close(rest.losses[0], whole.losses[1], rtol=0, atol=0)
    for n in names:
        torch.testing.assert_close(rest.params[n], whole.params[n], rtol=0, atol=0)
