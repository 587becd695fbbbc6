"""The ADMM minibatch steps (port of ``lshm_tpu/train/step.py``: the Adam
``make_train_step``, unfused or fused, and ``make_lbfgs_train_step``; reference:
src/kharmonic_lofar.py:93,115-202).

One call = one minibatch = ``admm_iters`` inner iterations of {optimizer update on the
full augmented-Lagrangian objective, then the Lagrange-multiplier update}.  PyTorch runs
eagerly, so the ADMM loop is a Python loop whichever of ``train.admm_unroll`` and
``train.admm_unroll_lbfgs`` the config holds (in JAX they choose how the loop is
lowered, with the same math); metrics come back as stacked [admm_iters] tensors per
term, like the JAX steps.  Under ``compute_dtype="bfloat16_full"`` both steps cast the
minibatch to bf16 once at entry (``_input_cast``).  Under ``model.fourier_variant`` the
second dual is shaped like the Fourier residual (``Duals.zeros_like``).  Under
``train.remat`` the forward is recomputed in the backward (``_remat``) at JAX's three
places: the unfused objective, the fused step's forward and the L-BFGS closure.  Under
a profiler each eager Adam ADMM iteration records the spans ``admm.forward`` (in the
fused step with the dual update), ``admm.backward``, ``admm.optimizer`` and, unfused,
``admm.dual`` (``utils/spans.py``).

The unfused Adam iteration is two device parts around the eager Adam update
(``parts``): ``fb``, the objective's forward and backward, and ``dual``, the dual update
added in place.  On the CPU, under ``grad_mean`` and in a key's first minibatch they
are called directly.  On a CUDA device the single-process step keeps CUDA graphs of
them on the ``TrainState``, one pair per key (the shapes and dtypes of x and uv,
``num_groups``, the loss weights): a key's first minibatch runs eagerly, which
initialises Adam's state, cuDNN's plans and the cached constants; its second captures
``G_fb`` and ``G_dual`` (span ``admm.capture``), and every minibatch of the key from
then on replays them (span ``admm.replay``, twice an iteration; ``admm.optimizer``
stays around Adam).  The graphs run the same kernels on the same float32 (or bf16)
math.  Each pair owns the gradients its capture allocated, which its replays write:
the step points the optimizer's parameters at them before it replays.  A new state
captures again.  The fused, data-parallel and L-BFGS steps stay eager.
``graph_counts`` says how often each way ran.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from lshm_tpu_torch.config import Config
from lshm_tpu_torch.kernels import add_launches, launch_counts
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.optim import LBFGSState, lbfgs_init, make_lbfgs_step, value_and_grad
from lshm_tpu_torch.train.objective import (
    Duals,
    LossWeights,
    cascade_objective,
    dual_update_,
    dual_update_from_outputs,
    loss_from_outputs,
    metrics_and_dual_update,
)
from lshm_tpu_torch.train.schedule import group_mask
from lshm_tpu_torch.utils.spans import span


@dataclass
class TrainState:
    """The model and its optimizer: Adam (``make_train_step``), or an ``LBFGSState``
    over the active group's parameters (``make_lbfgs_train_step``; JAX's
    ``LBFGSTrainState``).  Both have ``state_dict``/``load_state_dict``, which the
    Trainer's revert and checkpoint use for either kind.  ``opt`` is None between a
    params-only ``Trainer.load`` and the first step.  ``graphs``: the Adam step's CUDA
    graphs by key, an ``_Iteration`` once captured, None while the key warms up."""
    model: CascadedAE
    opt: torch.optim.Optimizer | LBFGSState | None
    step: int = 0
    graphs: dict[tuple, _Iteration | None] = field(default_factory=dict, repr=False,
                                                   compare=False)


def _input_cast(cfg: Config) -> Callable:
    """The minibatch cast of the full-bf16 data path (``lshm_tpu/train/step.py:38-49``):
    under ``bfloat16_full`` the batch becomes bf16, and with it the AE outputs, the
    residuals and the duals (``Duals.zeros_like(x)``); the losses still sum in float32
    and the parameters and optimizer state stay float32."""
    if cfg.model.compute_dtype == "bfloat16_full":
        return lambda a: a.to(torch.bfloat16)
    return lambda a: a


def _remat(cfg: Config, fn: Callable) -> Callable:
    """``fn`` under ``train.remat`` (JAX's ``jax.checkpoint``): autograd keeps only its
    inputs and runs it again in the backward, so its kernels (K1 and K3 in the
    objective) launch once more per backward.  The forward draws no random numbers, so
    no RNG state is stashed."""
    if not cfg.train.remat:
        return fn
    return lambda *args, **kw: checkpoint(fn, *args, use_reentrant=False,
                                          preserve_rng_state=False, **kw)


def _loss_kw(cfg: Config) -> dict:
    return dict(use_rica=cfg.model.rica, khm_order=cfg.model.khm_order,
                khm_backend=cfg.model.khm_backend)


def make_optimizer(cfg: Config, model: torch.nn.Module, group: str = "all") -> torch.optim.Adam:
    """Adam over the parameters of ``group`` only (optax.adam's defaults: betas 0.9 /
    0.999, eps 1e-8).  The JAX optimizer gives frozen groups ``set_to_zero`` updates;
    torch's Adam would still move a parameter whose gradient is zero through its
    moments, so frozen parameters are simply not handed to the optimizer."""
    named = dict(model.named_parameters())
    mask = group_mask(named, group)
    params = [p for n, p in named.items() if mask[n]]
    return torch.optim.Adam(params, lr=cfg.optim.adam_lr, betas=(0.9, 0.999), eps=1e-8)


def init_model(cfg: Config, device: torch.device | str) -> CascadedAE:
    """Model initialised from ``cfg.train.seed`` (drawn on the CPU, so the weights do
    not depend on the device), moved to ``device``."""
    g = torch.Generator().manual_seed(cfg.train.seed)
    return CascadedAE(cfg.model, generator=g).to(device)


def init_train_state(cfg: Config, device: torch.device | str, group: str = "all") -> TrainState:
    """``init_model`` with its Adam optimizer."""
    model = init_model(cfg, device)
    return TrainState(model=model, opt=make_optimizer(cfg, model, group))


def make_train_step(cfg: Config, num_groups: int, fused: bool = False,
                    grad_mean: Callable | None = None) -> Callable:
    """(state, x, uv, weights) -> (state, metrics); ``state`` is updated in place.
    ``num_groups`` = baselines per minibatch (the augmentation grouping).

    ``fused=True`` is JAX's fused step (``lshm_tpu/train/step.py:175-201``): each ADMM
    iteration runs one forward, takes the dual update from its outputs (skipped at
    t = 0, where the duals are zero) and the objective's gradient from the same
    outputs.  The trailing dual update after the last optimizer step is dropped: the
    duals reset per minibatch, so it is unobservable.  The same math as the default,
    with one forward (one K3 launch) per iteration instead of two.

    ``grad_mean``: the data-parallel reduction (``parallel.AllReduceMean``), applied to
    the gradients of the optimizer's parameters between ``backward`` and the update.

    Unfused, without ``grad_mean`` and on a CUDA device, the step runs on CUDA graphs
    from a state's second minibatch of a key on (the module's docstring)."""
    nadmm = cfg.train.admm_iters
    kw = _loss_kw(cfg)
    cast_in = _input_cast(cfg)
    objective = _remat(cfg, cascade_objective)
    forward = _remat(cfg, lambda model, x, uv: model(x, uv))

    def fused_step(state: TrainState, x: torch.Tensor, uv: torch.Tensor, w: LossWeights):
        model, opt = state.model, state.opt
        x = cast_in(x)
        duals = Duals.zeros_like(x, fourier=cfg.model.fourier_variant)
        history = []
        for t in range(nadmm):
            model.zero_grad(set_to_none=True)
            with span("admm.forward"):
                out = forward(model, x, uv)
                if t > 0:
                    duals = dual_update_from_outputs(out, x, duals, w.rho)
                loss, metrics = loss_from_outputs(out, model.khm.M, x, duals, w,
                                                  num_groups, **kw)
            with span("admm.backward"):
                loss.backward()
            with span("admm.optimizer"):
                if grad_mean is not None:
                    grad_mean([p.grad for g in opt.param_groups for p in g["params"]])
                opt.step()
            history.append({k: v.detach() for k, v in metrics.items()})
        _graph_counts["eager_iters"] += nadmm
        state.step += 1
        return state, _stack(history)

    def parts(model: CascadedAE, it: _Iteration, w: LossWeights):
        """The iteration's two device parts over ``it``'s inputs, called directly or
        captured: ``fb`` (the gradients dropped, so that a capture's backward allocates
        the ones its replays write; the objective; its backward; the metrics stacked
        into ``it.row``) and ``dual`` (the dual update added into ``it.duals``)."""

        def fb():
            model.zero_grad(set_to_none=True)
            with span("admm.forward"):
                loss, metrics = objective(model, it.x, it.uv, it.duals, w, num_groups, **kw)
            with span("admm.backward"):
                loss.backward()
            it.names = list(metrics)
            it.row = torch.stack([v.detach() for v in metrics.values()])

        def dual():
            with span("admm.dual"):
                dual_update_(model, it.x, it.uv, it.duals, w.rho)

        return fb, dual

    def capture(model: CascadedAE, params: list, x, uv, w: LossWeights) -> _Iteration:
        """Static inputs and duals, and both parts captured (``G_fb``, then ``G_dual``
        in its pool), with the gradients G_fb's replays write."""
        it = _Iteration(torch.empty_like(x), torch.empty_like(uv),
                        _distinct_duals(x, cfg.model.fourier_variant))
        fb, dual = parts(model, it, w)
        g_fb = CudaGraph()
        g_fb.capture(fb)
        g_dual = CudaGraph(pool=g_fb.pool())
        g_dual.capture(dual)
        it.fb, it.dual = _replayed(g_fb), _replayed(g_dual)
        it.grads = [p.grad for p in params]
        _graph_counts["captures"] += 1
        return it

    def unfused_step(state: TrainState, x: torch.Tensor, uv: torch.Tensor,
                     w: LossWeights):
        """The ADMM loop, each iteration ``fb``, Adam and ``dual``: the parts called
        directly (eagerly), or replayed from the state's graphs of this minibatch's
        key, whose gradients Adam is pointed at first."""
        model, opt = state.model, state.opt
        params = [p for g in opt.param_groups for p in g["params"]]
        x = cast_in(x)
        it = None
        if grad_mean is None and graphs_engage(x):
            key = (tuple(x.shape), x.dtype, tuple(uv.shape), uv.dtype, num_groups, w)
            if key not in state.graphs:
                state.graphs[key] = None         # this minibatch warms the key up
            elif state.graphs[key] is None:
                with span("admm.capture"):
                    state.graphs[key] = capture(model, params, x, uv, w)
            it = state.graphs[key]
        if it is None:
            it = _Iteration(x, uv, _distinct_duals(x, cfg.model.fourier_variant))
            it.fb, it.dual = parts(model, it, w)
            _graph_counts["eager_iters"] += nadmm
        else:
            it.x.copy_(x)
            it.uv.copy_(uv)
            for y in (it.duals.y1, it.duals.y2, it.duals.y3):
                y.zero_()
            for p, grad in zip(params, it.grads):
                p.grad = grad
            _graph_counts["replays"] += 2 * nadmm
        rows = None
        for t in range(nadmm):
            it.fb()
            if rows is None:                     # fresh: settled after the next step
                rows = it.row.new_empty((len(it.names), nadmm))
            rows[:, t].copy_(it.row)
            with span("admm.optimizer"):
                if grad_mean is not None:
                    grad_mean([p.grad for p in params])
                opt.step()
            it.dual()
        state.step += 1
        return state, dict(zip(it.names, rows))

    return fused_step if fused else unfused_step


def _stack(history: list[dict]) -> dict[str, torch.Tensor]:
    """Per-iteration metrics as [admm_iters] tensors per term."""
    return {k: torch.stack([m[k] for m in history]) for k in history[0]} if history else {}


def _distinct_duals(x: torch.Tensor, fourier: bool) -> Duals:
    """``Duals.zeros_like(x)`` with no two duals aliasing one another (it shares one
    zero tensor among the three), so that each can be updated in place."""
    if fourier:
        return Duals.zeros_like(x, fourier=True)
    return Duals(*(torch.zeros_like(x) for _ in range(3)))


# ------------------------------------------------------------------- CUDA graphs

_graph_counts = {"captures": 0, "replays": 0, "eager_iters": 0}


def graph_counts() -> dict[str, int]:
    """Since the last reset: ``captures`` (both graphs of a state and key, once),
    ``replays`` (of either graph) and ``eager_iters`` (ADMM iterations the Adam step
    ran eagerly, on any path)."""
    return dict(_graph_counts)


def reset_graph_counts() -> None:
    for k in _graph_counts:
        _graph_counts[k] = 0


def graphs_engage(x: torch.Tensor) -> bool:
    """Whether the unfused single-process Adam step runs on CUDA graphs: on a CUDA
    device.  (Tests replace it to run the graph path on the CPU or the eager one on
    the card.)"""
    return x.device.type == "cuda"


class CudaGraph:
    """One CUDA graph: ``capture(fn)`` records fn's device work without running it,
    ``replay()`` runs it on the current stream.  The kernels' launch counters count
    what runs: the launches counted during the capture are taken back and added at
    each replay.  The capture leaves other threads free to call CUDA (the prefetcher
    decodes on its own stream meanwhile)."""

    def __init__(self, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        self.shared_pool = pool           # another graph's memory pool, or None
        self.launches: dict[str, int] = {}

    def pool(self):
        return self.graph.pool()

    def capture(self, fn: Callable[[], None]) -> None:
        before = launch_counts()
        with torch.cuda.graph(self.graph, pool=self.shared_pool,
                              capture_error_mode="thread_local"):
            fn()
        after = launch_counts()
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


def _replayed(graph: CudaGraph) -> Callable[[], None]:
    def replay():
        with span("admm.replay"):
            graph.replay()
    return replay


@dataclass(eq=False)
class _Iteration:
    """One ADMM iteration's inputs and parts: ``x``, ``uv`` and ``duals`` (updated in
    place), ``fb`` and ``dual`` (``parts``, or their graphs' replays), ``row`` the
    metrics ``fb`` stacked (in ``names``' order) and, captured, ``grads``: the
    optimizer's gradients that G_fb's replays write."""
    x: torch.Tensor
    uv: torch.Tensor
    duals: Duals
    fb: Callable[[], None] | None = None
    dual: Callable[[], None] | None = None
    names: list[str] = field(default_factory=list)
    row: torch.Tensor | None = None
    grads: list[torch.Tensor | None] = field(default_factory=list)


# ------------------------------------------------------------------------- L-BFGS

def active_params(model: torch.nn.Module, group: str) -> dict[str, torch.Tensor]:
    """{name: detached parameter} of the parameters that ``group`` trains."""
    named = dict(model.named_parameters())
    mask = group_mask(named, group)
    return {n: p.detach() for n, p in named.items() if mask[n]}


def init_lbfgs_train_state(cfg: Config, device: torch.device | str,
                           group: str = "all") -> TrainState:
    """``init_model`` with a fresh L-BFGS state over the parameters of ``group``."""
    model = init_model(cfg, device)
    return TrainState(model=model, opt=lbfgs_init(active_params(model, group),
                                                  cfg.optim.lbfgs))


def lbfgs_objective(cfg: Config, num_groups: int) -> Callable:
    """The L-BFGS closure: (params, model, frozen, x, uv, duals, w) -> loss, the model
    evaluated on ``params`` (the active group's parameters) and ``frozen`` (the others,
    detached); under ``train.remat`` its forward is recomputed in the backward."""
    kw = _loss_kw(cfg)

    def value_fn(params, model, frozen, x, uv, duals, w):
        full = {**frozen, **params}
        out = functional_call(model, full, (x, uv))
        return loss_from_outputs(out, full["khm.M"], x, duals, w, num_groups, **kw)[0]

    return _remat(cfg, value_fn)


def make_lbfgs_train_step(cfg: Config, num_groups: int, group: str = "all",
                          grad_mean: Callable | None = None) -> Callable:
    """L-BFGS minibatch step, (state, x, uv, weights) -> (state, metrics), ``state``
    updated in place: each of the ``admm_iters`` inner iterations runs one full
    ``optimizer.step(closure)`` (up to ``max_iter`` L-BFGS iterations with line search)
    followed by ``metrics_and_dual_update`` — the structure of the reference's L-BFGS
    training mode (reference: src/kharmonic_lofar.py:93,131-202).

    Alternating groups (the structural freeze of the JAX step): the closure evaluates
    the model on the active group's parameters, which L-BFGS moves, and on detached
    values of the frozen groups', which take no gradient, so no backward runs into
    them (K4 does not run in ``ae1d`` or ``khm`` epochs).  The L-BFGS state spans the
    active parameters only.  In JAX it spans every parameter and its entries for the
    frozen groups stay exactly zero, so every dot product, norm and step is the same
    math; the sums run in another order.

    ``grad_mean``: the data-parallel reduction (``parallel.AllReduceMean``), applied to
    every closure evaluation: value and gradient in one call, or the value alone."""
    nadmm = cfg.train.admm_iters
    kw = _loss_kw(cfg)
    value_fn = lbfgs_objective(cfg, num_groups)
    vg_fn = value_and_grad(value_fn)
    if grad_mean is not None:
        value_fn, vg_fn = _mean_closures(value_fn, vg_fn, grad_mean)
    lbfgs_step = make_lbfgs_step(vg_fn, value_fn, cfg.optim.lbfgs)
    cast_in = _input_cast(cfg)

    def train_step(state: TrainState, x: torch.Tensor, uv: torch.Tensor,
                   w: LossWeights):
        model = state.model
        x = cast_in(x)
        named = dict(model.named_parameters())
        params = active_params(model, group)
        frozen = {n: p.detach() for n, p in named.items() if n not in params}
        duals = Duals.zeros_like(x, fourier=cfg.model.fourier_variant)
        history = []
        for _ in range(nadmm):
            res = lbfgs_step(params, state.opt, model, frozen, x, uv, duals, w)
            params, state.opt = res.x, res.state
            with torch.no_grad():
                for n, v in params.items():
                    named[n].copy_(v)
            metrics, duals = metrics_and_dual_update(model, x, uv, duals, w, num_groups,
                                                     **kw)
            history.append(metrics)
        state.step += 1
        return state, _stack(history)

    return train_step


def _mean_closures(value_fn: Callable, vg_fn: Callable, mean: Callable):
    """The L-BFGS closures with their results replaced by the ranks' mean, so that
    every rank takes the same line-search branches."""

    def mean_value(*args):
        loss = value_fn(*args).detach()
        mean([loss])
        return loss

    def mean_vg(*args):
        loss, grads = vg_fn(*args)
        mean([loss, *grads.values()])
        return loss, grads

    return mean_value, mean_vg
