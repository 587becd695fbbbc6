"""The Adam step's CUDA graphs (``train/step.py``: ``_Iteration``, ``CudaGraph``,
``graph_counts``) on the CPU, at 2 patches.

The CPU never captures: the step is the eager loop it was.  The graph path (static
inputs, duals updated in place, the gradients G_fb's backward writes, the metric rows)
runs here with each graph replaced by a stand-in that runs its callable at the capture
and at each replay, and must reproduce the eager step bit for bit, also with two shapes
in turns, each replaying its own graphs.  The graphs follow their ``TrainState``, one
pair per key: capture at a state's second minibatch of a key, again after a new state
or (kind, group), a pair more for a new shape or new loss weights, and none after the
Trainer's revert."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from lshm_tpu_torch import config as tc
from lshm_tpu_torch.kernels import conv_head, launch_counts, reset_launches
from lshm_tpu_torch.train import (
    Duals,
    LossWeights,
    Trainer,
    cascade_objective,
    dual_update,
    init_train_state,
    make_train_step,
    step as step_mod,
)
from lshm_tpu_torch.train.step import graph_counts, reset_graph_counts
from lshm_tpu_torch.utils.metrics import MetricLogger

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU steps under the suite's six workers: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _counts():
    reset_graph_counts()
    yield


class RunsItsCallable:
    """Stand-in for ``CudaGraph`` on the CPU: the capture runs the callable once, as a
    real capture runs its Python (whose device work the step overwrites before it
    reads it: the duals reset, the first replay recomputes the gradients), and keeps
    it; each replay runs it."""

    def __init__(self, pool=None):
        self.fn = None

    def pool(self):
        return None

    def capture(self, fn):
        self.fn = fn
        fn()

    def replay(self):
        self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: engaged, each graph a ``RunsItsCallable``."""
    monkeypatch.setattr(step_mod, "graphs_engage", lambda x: True)
    monkeypatch.setattr(step_mod, "CudaGraph", RunsItsCallable)


def _cfg(admm_iters=2, **model_kw):
    return tc.Config(data=tc.DataConfig(batch_size=1),
                     model=tc.ModelConfig(**{**MODEL, **model_kw}),
                     optim=tc.OptimConfig(adam_lr=1e-3),
                     train=tc.TrainConfig(admm_iters=admm_iters, seed=3))


def _batches(n=3, patches=2):
    """``n`` minibatches of one baseline's ``patches`` patches."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        x = rng.normal(size=(patches, 128, 128, 4)).astype(np.float32)
        uv = np.repeat(rng.normal(size=(1, 2)) * 300, patches, axis=0).astype(np.float32)
        out.append((torch.from_numpy(x), torch.from_numpy(uv)))
    return out


def _train(cfg, batches, w=LossWeights()):
    state = init_train_state(cfg, "cpu")
    history = []
    for x, uv in batches:
        state, m = make_train_step(cfg, 1)(state, x, uv, w)
        history.append(m)
    return state, history


def _assert_same(a, b):
    """Two runs' states and metrics bit for bit: parameters, Adam's moments, steps."""
    (sa, ha), (sb, hb) = a, b
    assert sa.step == sb.step
    pb = sb.model.state_dict()
    for k, v in sa.model.state_dict().items():
        assert torch.equal(v, pb[k]), k
    oa, ob = sa.opt.state_dict()["state"], sb.opt.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)
    for ma, mb in zip(ha, hb, strict=True):
        assert ma.keys() == mb.keys()
        for k in ma:
            assert ma[k].dtype == mb[k].dtype and ma[k].is_contiguous(), k
            assert torch.equal(ma[k], mb[k]), k


def test_cpu_never_captures_and_keeps_the_eager_trajectory():
    """On the CPU every ADMM iteration runs eagerly (10 a minibatch at the default
    ``admm_iters``), no graph is made, and the trajectory is the eager ADMM loop's,
    written out here: zero the gradients, objective, backward, Adam, dual update."""
    cfg = _cfg(admm_iters=10)
    batches = _batches(2)
    got = _train(cfg, batches)
    assert graph_counts() == {"captures": 0, "replays": 0, "eager_iters": 20}
    assert got[0].graphs == {}

    state = init_train_state(cfg, "cpu")
    w, history = LossWeights(), []
    for x, uv in batches:
        duals, rows = Duals.zeros_like(x), []
        for _ in range(cfg.train.admm_iters):
            state.model.zero_grad(set_to_none=True)
            loss, metrics = cascade_objective(state.model, x, uv, duals, w, 1)
            loss.backward()
            state.opt.step()
            duals = dual_update(state.model, x, uv, duals, w.rho)
            rows.append({k: v.detach() for k, v in metrics.items()})
        state.step += 1
        history.append({k: torch.stack([r[k] for r in rows]) for k in rows[0]})
    _assert_same(got, (state, history))


VARIANTS = [{}, {"compute_dtype": "bfloat16_full"}, {"fourier_variant": True}]


@pytest.mark.parametrize("model_kw", VARIANTS, ids=["float32", "bfloat16_full", "fourier"])
def test_partitioned_iteration_is_the_eager_step(model_kw, stand_in, monkeypatch):
    """Three minibatches (eager, capture, replay) through the partition reproduce the
    eager step bit for bit, from the same initial state: the static inputs take each
    minibatch (bf16 cast included), the duals reset and update in place, Adam reads
    the gradients G_fb's backward wrote, and the metric rows come back fresh."""
    cfg = _cfg(**model_kw)
    batches = _batches(3)
    got = _train(cfg, batches)
    nadmm = cfg.train.admm_iters
    assert graph_counts() == {"captures": 1, "replays": 2 * nadmm * 2,
                              "eager_iters": nadmm}
    g, = got[0].graphs.values()
    duals = (g.duals.y1, g.duals.y2, g.duals.y3)
    assert len({y.data_ptr() for y in duals if y.numel()}) == (2 if model_kw.get(
        "fourier_variant") else 3)                     # no two duals alias
    bf16 = model_kw.get("compute_dtype") == "bfloat16_full"
    assert g.x.dtype == (torch.bfloat16 if bf16 else torch.float32)
    # the last minibatch's input sits in the static buffer, and each minibatch's
    # metrics are tensors of its own, not the static row the next one overwrites
    assert torch.equal(g.x, step_mod._input_cast(cfg)(batches[-1][0]))
    ptrs = {m["loss"].data_ptr() for m in got[1]} | {g.row.data_ptr()}
    assert len(ptrs) == len(got[1]) + 1

    monkeypatch.undo()
    reset_graph_counts()
    want = _train(cfg, batches)
    assert graph_counts()["eager_iters"] == 3 * nadmm
    _assert_same(got, want)


class KeepsItsGradients(RunsItsCallable):
    """``RunsItsCallable`` that leaves the parameters' gradients as a CUDA graph's
    replay does: the replay writes the gradient tensors its capture left on the
    parameters, and the parameters keep the ones they held before it."""

    def __init__(self, params, pool=None):
        super().__init__()
        self.params = params

    def capture(self, fn):
        super().capture(fn)
        self.grads = [p.grad for p in self.params]

    def replay(self):
        before = [p.grad for p in self.params]
        self.fn()
        for p, mine, b in zip(self.params, self.grads, before):
            if mine is not None and p.grad is not mine:
                mine.copy_(p.grad)
            p.grad = b


def test_two_shapes_in_turns_replay_their_own_graphs(monkeypatch):
    """Minibatches of two shapes in turns (eager, eager, capture, capture, replay,
    replay): each key keeps its own pair of graphs and gradients, and the step points
    Adam at the pair it replays, so the trajectory is the eager step's bit for bit."""
    cfg = _cfg()
    nadmm = cfg.train.admm_iters
    (x, uv), (x2, uv2) = _batches(2)
    batches = [(x, uv), (x2[:1], uv2[:1])] * 3

    state = init_train_state(cfg, "cpu")
    params = list(state.model.parameters())
    monkeypatch.setattr(step_mod, "graphs_engage", lambda x: True)
    monkeypatch.setattr(step_mod, "CudaGraph",
                        lambda pool=None: KeepsItsGradients(params))
    history = []
    for xb, uvb in batches:
        state, m = make_train_step(cfg, 1)(state, xb, uvb, LossWeights())
        history.append(m)
    assert graph_counts() == {"captures": 2, "replays": 2 * nadmm * 4,
                              "eager_iters": 2 * nadmm}
    assert len(state.graphs) == 2
    grads = [g.grads for g in state.graphs.values()]
    assert all(a is not b for a, b in zip(*grads))

    monkeypatch.undo()
    _assert_same((state, history), _train(cfg, batches))


def test_static_duals_are_updated_in_place(stand_in):
    """A replayed minibatch leaves in the static duals, the same tensors as before,
    what the eager loop's duals hold after its trailing dual update, from the same
    parameters and Adam state."""
    cfg = _cfg()
    x, uv = _batches(1)[0]
    w = LossWeights()
    state = init_train_state(cfg, "cpu")
    step = make_train_step(cfg, 1)
    for _ in range(2):
        state, _ = step(state, x, uv, w)
    eager = init_train_state(cfg, "cpu")
    eager.model.load_state_dict(state.model.state_dict())
    eager.opt.load_state_dict(copy.deepcopy(state.opt.state_dict()))   # no aliasing
    g, = state.graphs.values()
    ptrs = [y.data_ptr() for y in (g.duals.y1, g.duals.y2, g.duals.y3)]
    step(state, x, uv, w)
    assert ptrs == [y.data_ptr() for y in (g.duals.y1, g.duals.y2, g.duals.y3)]

    duals = Duals.zeros_like(x)
    for _ in range(cfg.train.admm_iters):
        eager.model.zero_grad(set_to_none=True)
        cascade_objective(eager.model, x, uv, duals, w, 1)[0].backward()
        eager.opt.step()
        duals = dual_update(eager.model, x, uv, duals, w.rho)
    for mine, want in zip((g.duals.y1, g.duals.y2, g.duals.y3),
                          (duals.y1, duals.y2, duals.y3)):
        assert torch.equal(mine, want)


def test_capture_at_the_second_minibatch_of_a_key(stand_in):
    """The first minibatch of a state warms up eagerly, the second captures, later ones
    replay; a new shape or new loss weights is a new key (eager, then capture), and
    the first key's graphs replay again when it comes back."""
    cfg = _cfg()
    nadmm = cfg.train.admm_iters
    state = init_train_state(cfg, "cpu")
    step = make_train_step(cfg, 1)
    (x, uv), (x2, uv2) = _batches(2)
    w = LossWeights()
    counts = []
    w2 = dataclasses.replace(w, alpha=0.5)
    for xb, uvb, wb in ((x, uv, w), (x, uv, w), (x2, uv2, w),   # warm, capture, replay
                        (x[:1], uv[:1], w), (x[:1], uv[:1], w),  # a new shape
                        (x, uv, w2), (x, uv, w2),                # new loss weights
                        (x2, uv2, w), (x[:1], uv[:1], w)):       # back: replays
        state, _ = step(state, xb, uvb, wb)
        counts.append(graph_counts())
    assert [c["captures"] for c in counts] == [0, 1, 1, 1, 2, 2, 3, 3, 3]
    assert [c["eager_iters"] for c in counts] == [nadmm, nadmm, nadmm, 2 * nadmm,
                                                  2 * nadmm, 3 * nadmm, 3 * nadmm,
                                                  3 * nadmm, 3 * nadmm]
    assert counts[-1]["replays"] == 2 * nadmm * 6
    assert len(state.graphs) == 3


def test_a_new_train_state_captures_again(stand_in, tmp_path):
    """Through the Trainer: a (kind, group) switch and ``load`` build a new
    ``TrainState``, whose first minibatch runs eagerly and whose second captures;
    ``_restore`` (the non-finite revert) keeps the graphs, and the minibatch replayed
    after it repeats the one before it bit for bit."""
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    (x, uv), = _batches(1)
    w = LossWeights()

    def steps(n, group="all"):
        out = None
        for _ in range(n):
            trainer._ensure_state("adam", group)
            trainer.state, out = trainer._step("adam", group, 1)(trainer.state, x, uv, w)
        return out

    steps(2)
    assert graph_counts()["captures"] == 1
    first = trainer.state
    snap = trainer._snapshot()
    before = steps(1)
    trainer._restore(snap)
    again = steps(1)
    assert trainer.state is first and graph_counts()["captures"] == 1
    for k in before:
        assert torch.equal(before[k], again[k]), k

    steps(1, group="ae2d")                      # a switch: a new state, eager
    assert trainer.state is not first and graph_counts()["captures"] == 1
    steps(1, group="ae2d")
    assert graph_counts()["captures"] == 2

    trainer.save(str(tmp_path), step=7)
    trainer.load(str(tmp_path))
    steps(1, group="ae2d")
    assert graph_counts()["captures"] == 2
    steps(1, group="ae2d")
    assert graph_counts()["captures"] == 3


def test_fused_and_data_parallel_steps_stay_eager(stand_in):
    """Where the graphs engage, the fused step and a step with ``grad_mean`` still
    run every iteration eagerly and keep no graphs."""
    cfg = _cfg()
    x, uv = _batches(1)[0]
    for kw in ({"fused": True}, {"grad_mean": lambda grads: None}):
        state = init_train_state(cfg, "cpu")
        step = make_train_step(cfg, 1, **kw)
        for _ in range(2):
            state, _ = step(state, x, uv, LossWeights())
        assert state.graphs == {}
    assert graph_counts() == {"captures": 0, "replays": 0,
                              "eager_iters": 4 * cfg.train.admm_iters}


def test_graph_counts_each_kernel_launch_once_per_replay(monkeypatch):
    """``CudaGraph`` takes back the launches counted while it captures (nothing ran)
    and adds them at each replay, so the kernels' counters count what the card ran."""

    class Recorder:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

        def pool(self):
            return "pool"

    class Capturing:
        def __init__(self, graph, pool=None, capture_error_mode="global"):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Recorder)
    monkeypatch.setattr(torch.cuda, "graph", Capturing)

    def fn():
        conv_head.launches["head_fwd"] += 2
        conv_head.launches["head_bwd"] += 1

    reset_launches()
    g = step_mod.CudaGraph()
    g.capture(fn)
    assert launch_counts()["head_fwd"] == 0 and launch_counts()["head_bwd"] == 0
    for _ in range(3):
        g.replay()
    assert g.graph.replays == 3
    assert launch_counts()["head_fwd"] == 6 and launch_counts()["head_bwd"] == 3
    assert step_mod.CudaGraph(pool=g.pool()).shared_pool == "pool"
    reset_launches()
