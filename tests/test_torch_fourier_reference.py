"""The port's Fourier cascade (preset ``fourier_cascade``) against the benchmark's plain
reference (``portbench/reference/fourier.py``) on the CPU, at 2 patches of
128 x 128 x 4 and the preset's widths, from the benchmark's seeded weights
(``portbench/weights_fourier.py``); and the port's DFT spans and call counters.

The reference transforms with ``torch.fft`` and the port with dense DFT matrices, so the
two sides sum in other orders.  Tolerances (the JAX suite's, tests/test_torch_fourier.py,
where the port meets JAX's dense DFT):
- outputs and objective terms 1e-5 relative to the largest magnitude: float32 rounding
  through two AEs and a 128-point transform on each axis;
- gradients 2e-5 of each leaf's largest magnitude: the backward adds another pass of
  the same sums;
- the Adam trajectory's losses 1e-5 and its parameters 1e-4 relative + 1e-6 (as
  portbench/tests/test_portbench_reference.py): Adam divides each update by its own
  gradient's size, so an entry whose gradient is rounding noise moves by another share
  of the learning rate;
- the reference's transform against the DFT's definition in float64 1e-12.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from lshm_tpu_torch.config import preset
from lshm_tpu_torch.kernels import reset_launches
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.models import cascade as port_cascade
from lshm_tpu_torch.train import Duals, LossWeights, cascade_objective, make_train_step
from lshm_tpu_torch.train import step as step_mod
from lshm_tpu_torch.train.step import TrainState, make_optimizer
from portbench.reference import fourier
from portbench.reference.model import Precision, Weights
from portbench.weights_fourier import init_params, shape_of

SEED = 2**31 + 77
CFG = preset("fourier_cascade")
SHAPE = shape_of(dataclasses.asdict(CFG.model))
GROUPS, NADMM, LR = 1, 2, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU steps under the suite's six workers: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 128, 128, 4)).astype(np.float32))
    uv = torch.from_numpy(np.repeat(rng.normal(size=(1, 2)) * 300, 2, axis=0)
                          .astype(np.float32))
    # non-zero duals, so the ADMM terms' linear parts count
    y1 = torch.from_numpy((rng.normal(size=x.shape) * 0.1).astype(np.float32))
    y2 = torch.from_numpy((rng.normal(size=(2, 128, 128, 8)) * 0.1).astype(np.float32))
    return x, uv, (y1, y2, torch.zeros(0))


@pytest.fixture(scope="module")
def params():
    return init_params(SHAPE, SEED, "cpu")


def _model(params) -> CascadedAE:
    m = CascadedAE(CFG.model)
    m.load_state_dict(params)
    return m


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def test_param_spec_is_the_ports():
    sd = CascadedAE(CFG.model).state_dict()
    got = [(n, tuple(s)) for n, s, _ in fourier.param_spec(SHAPE)]
    assert got == [(k, tuple(v.shape)) for k, v in sd.items()]
    assert SHAPE.total_latent == 288


def test_outputs_match_the_reference(batch, params):
    x, uv, _ = batch
    with torch.no_grad():
        out = _model(params)(x, uv)
        ref = fourier.cascade(params, x, uv, SHAPE, Precision())
    for k in ("x1", "yf_in", "yf_out", "Mu"):
        assert getattr(out, k).shape == ref[k].shape, k
        assert _rel(getattr(out, k), ref[k]) <= 1e-5, k


def test_objective_terms_and_gradients_match_the_reference(batch, params):
    x, uv, duals = batch
    model = _model(params)
    total, terms = cascade_objective(model, x, uv, Duals(*duals), LossWeights(), GROUPS,
                                     use_rica=CFG.model.rica, khm_order=CFG.model.khm_order,
                                     khm_backend=CFG.model.khm_backend)
    total.backward()
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    ref_total, ref_terms = fourier.objective(
        fourier.cascade(leaves, x, uv, SHAPE, Precision()), leaves["khm.M"], x, duals,
        Weights(), GROUPS, SHAPE)
    ref_total.backward()
    assert terms.keys() == ref_terms.keys()
    scale = max(abs(float(v.detach())) for v in ref_terms.values())
    for k, v in terms.items():
        assert abs(float(v.detach()) - float(ref_terms[k].detach())) <= 1e-5 * scale, k
    for n, p in model.named_parameters():
        assert _rel(p.grad, leaves[n].grad) <= 2e-5, n


def test_adam_trajectory_matches_the_reference(batch, params):
    """Two minibatches of 2 ADMM iterations: each an Adam update on the objective, then
    the dual update from a fresh forward; the duals restart at zero a minibatch."""
    x, uv, _ = batch
    cfg = CFG.replace(train=dataclasses.replace(CFG.train, admm_iters=NADMM))
    model = _model(params)
    state = TrainState(model, make_optimizer(cfg, model))
    step = make_train_step(cfg, GROUPS)
    losses = [step(state, x, uv, LossWeights())[1]["loss"] for _ in range(2)]
    names = list(params)
    ref = fourier.adam(params, [(x, uv)] * 2, names, SHAPE, Weights(), GROUPS, NADMM, LR,
                       Precision())
    torch.testing.assert_close(ref.losses, torch.stack(losses).double(), rtol=1e-5, atol=0)
    for n, v in model.state_dict().items():
        torch.testing.assert_close(ref.params[n], v, rtol=1e-4, atol=1e-6)


def test_dual_update_matches_the_reference(batch, params):
    from lshm_tpu_torch.train import dual_update

    x, uv, duals = batch
    got = dual_update(_model(params), x, uv, Duals(*duals), 1.0)
    with torch.no_grad():
        want = fourier.dual_update(fourier.cascade(params, x, uv, SHAPE, Precision()), x,
                                   duals, 1.0)
    for a, b in zip((got.y1, got.y2, got.y3), want):
        assert a.shape == b.shape
        if b.numel():
            assert _rel(a, b) <= 1e-5


def test_reference_transform_is_the_dft_in_float64():
    """torch.fft's orthonormal 2D transform, rolled by n // 2, against
    F[j, k] = exp(-2 pi i j k / n) / sqrt(n) applied on both spatial axes."""
    n = 16
    r = torch.from_numpy(np.random.default_rng(3).normal(size=(2, n, n, 3)))
    k = torch.arange(n, dtype=torch.float64)
    ang = -2.0 * math.pi * torch.outer(k, k) / n
    F = torch.complex(torch.cos(ang), torch.sin(ang)) / math.sqrt(n)
    z = torch.einsum("hj,njwc,wk->nhkc", F, r.to(torch.complex128), F)
    z = torch.roll(z, (n // 2, n // 2), dims=(1, 2))
    got = fourier.dft_shifted(r)
    assert got.dtype == torch.float64 and got.shape == (2, n, n, 6)
    assert _rel(got, torch.cat([z.real, z.imag], dim=-1)) <= 1e-12


class _Recorder:
    """Stand-in for ``torch.cuda.CUDAGraph`` on the CPU, as in
    tests/test_torch_graph_step.py: a replay runs nothing."""

    def replay(self):
        pass

    def pool(self):
        return None


class _Capturing:
    """Stand-in for ``torch.cuda.graph``: the capture runs its Python, as a real one."""

    def __init__(self, graph, pool=None, capture_error_mode="global"):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_dft_calls_count_an_eager_and_a_replayed_minibatch_alike(batch, params,
                                                                 monkeypatch):
    """An ADMM iteration runs the DFT forward twice (objective, dual update) and
    backward once.  ``CudaGraph`` takes back what the capture counted and adds it at
    each replay, so a replayed minibatch counts what an eager one does."""
    x, uv, _ = batch
    cfg = CFG.replace(train=dataclasses.replace(CFG.train, admm_iters=NADMM))
    want = {"dft_fwd": 2 * NADMM, "dft_bwd": NADMM}

    def minibatches(n):
        model = _model(params)
        state = TrainState(model, make_optimizer(cfg, model))
        step = make_train_step(cfg, GROUPS)
        counts = []
        for _ in range(n):
            reset_launches()
            step(state, x, uv, LossWeights())
            counts.append(dict(port_cascade.dft_calls))
        return counts

    assert minibatches(1) == [want]
    monkeypatch.setattr(step_mod, "graphs_engage", lambda x: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Recorder)
    monkeypatch.setattr(torch.cuda, "graph", _Capturing)
    step_mod.reset_graph_counts()
    # warm-up, capture + replays, replays
    assert minibatches(3) == [want] * 3
    assert step_mod.graph_counts() == {"captures": 1, "replays": 4 * NADMM,
                                       "eager_iters": NADMM}
    reset_launches()


def test_dft_and_fourier_ae_spans_under_a_profiler(batch, params):
    x, uv, _ = batch
    model = _model(params)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        model(x, uv)
        model(x, uv)
    names = [e.name for e in prof.events()]
    assert names.count("cascade.dft") == 2 and names.count("cascade.aef") == 2
    dft = [e for e in prof.events() if e.name == "cascade.dft"][0]
    inside = {c.name for c in dft.cpu_children}
    assert any("matmul" in n or "bmm" in n or "mm" in n for n in inside), inside
    assert "aten::roll" in inside, inside
