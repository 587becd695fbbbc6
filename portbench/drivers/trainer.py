"""Driver of the training cells: the port's ``Trainer.run`` with Adam on a synthetic
extract.

Traffic parameters (``traffic/<mix>.json``):
- ``stations``: the extract's stations; its baselines, autocorrelations included, are
  the pool each minibatch of ``data.batch_size`` distinct baselines is drawn from;
- ``check_steps``: the minibatches that set-up drives and the reference follows
  (their baselines all differ);
- ``profile_units``: the whole minibatches that ``--trace 1`` profiles after the window;
- ``overrides``: {"section.key": value} applied to the configuration (such as an
  epoch longer than any window, so that no epoch ends inside it).

Set-up makes the extract and the parameters from the seed, hands the parameters to a
``Trainer`` through ``Trainer.load`` of a parameters-only checkpoint, and drives that
Trainer's ``run()`` through ``check_steps`` minibatches, recording what the
reference follows.  The window is a second ``run()`` of the same Trainer, ended by the
harness's logger at the first minibatch settled past the deadline: the rate is the
patches of the minibatches settled in the window over the window's seconds.  There the
parameters and Adam's moments are copied to the host, and one more minibatch runs
through the same ``run()``: the reference follows it from that state, so that a path
which only starts once warm is checked too.  Then the Trainer is freed and the
reference follows the checked minibatches and the late one.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from portbench import compare, data, spec, trace, weights
from portbench.drivers import Phases, load_trainer, peak_bytes, release, sync
from portbench.reference import train as ref_train
from portbench.reference.model import Precision, Weights
from portbench.rooflines import model_flops


class Stop(Exception):
    """Raised by the harness's logger to end a ``run()``."""


def run(ctx) -> dict:
    from lshm_tpu_torch.data import MinibatchSampler, RawMinibatch
    from lshm_tpu_torch.utils.metrics import MetricLogger

    traffic, dev = ctx.cell.traffic, torch.device(ctx.device)
    conf = spec.resolved(ctx.cell.config, {**traffic.get("overrides", {}), **ctx.overrides})
    cfg = spec.port_config(conf)
    if cfg.optim.optimizer != "adam":
        raise ValueError(f"the training driver runs Adam, not {cfg.optim.optimizer!r}")
    assumed = ctx.cell.config["assumed"]
    ntime, nfreq = ctx.sizes.get("ntime", assumed["ntime"]), ctx.sizes.get("nfreq", assumed["nfreq"])
    stations = ctx.sizes.get("stations", traffic["stations"])
    checks = traffic["check_steps"]
    B, admm = cfg.data.batch_size, cfg.train.admm_iters

    phases = Phases(ctx.t_start)
    tree = data.synth_sap(stations, ntime, nfreq, ctx.seed, dev)
    phases.mark("data")
    shape = weights.shape_of(conf["model"])
    params0 = weights.init_params(shape, ctx.seed, dev)
    phases.mark("weights")
    px, py = data.grid(ntime, nfreq, cfg.data.patch_size)
    nbase = tree["measurement"]["saps"]["0"]["visibilities"].shape[0]
    if checks * B > nbase:
        raise ValueError(f"{checks} checked minibatches of {B} distinct baselines need "
                         f"{checks * B} baselines; the extract has {nbase}")

    class Sampler(MinibatchSampler):
        """The traffic: minibatches of distinct baselines from the seed, the checked
        ones all different; every ``sample_raw`` timed on the prefetch thread.  The
        prefetcher takes them in the order drawn."""

        def __init__(self):
            super().__init__([tree], ["0"], cfg.data, seed=0, process_index=0,
                             use_native=False)
            g = data.sap(tree)
            self.vis, self.scl = g["visibilities"], g["visibility_scale_factors"]
            self.uv = data.uv_of(tree, range(nbase))
            self.order = np.random.default_rng([ctx.seed, 7])
            first = self.order.permutation(nbase)[:checks * B]
            self.queue = [first[i * B:(i + 1) * B] for i in range(checks)]
            self.drawn, self.times = [], []

        def reseed(self, epoch):        # one stream for the whole process
            pass

        def sample_raw(self):
            t0 = time.perf_counter()
            ids = (self.queue.pop(0) if self.queue
                   else self.order.choice(nbase, B, replace=False))
            mb = RawMinibatch(vis=self.vis[ids], scales=self.scl[ids], uv=self.uv[ids],
                              flip_flags=np.zeros((B, 2), bool), patchx=px, patchy=py,
                              num_baselines=B)
            self.drawn.append(ids)
            self.times.append((t0, time.perf_counter() - t0))
            return mb

    class Logger(MetricLogger):
        def __init__(self):
            super().__init__(echo=False)
            self.hook = None

        def log_step(self, epoch, it, metrics, patches=None):
            super().log_step(epoch, it, metrics, patches=patches)
            self.hook(metrics)

    sampler, logger = Sampler(), Logger()
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = load_trainer(cfg, params0, dev, logger)
    phases.mark("load")

    # every minibatch step the Trainer takes, counted: a record is written only once the
    # next minibatch is fetched and before it steps, so at a record the count holds the
    # minibatches settled, those reverted as non-finite included
    steps = {"n": 0}
    make_step = trainer._step

    def counted(*args):
        real = make_step(*args)

        def step(*a):
            steps["n"] += 1
            return real(*a)
        return step

    trainer._step = counted

    # ---- set-up: the checked minibatches, through the window's own call and feed
    cap = {"losses": [], "first": None}
    active = [n for n, _ in trainer.model.named_parameters()]

    def on_check(metrics):
        cap["losses"].append(metrics["loss"].detach().double().cpu())
        if len(cap["losses"]) == checks:
            cap["params"] = compare.to_host(dict(trainer.model.named_parameters()))
            raise Stop

    logger.hook = on_check
    restore = _capture_first_gradient(trainer, cap)
    try:
        trainer.run(sampler)
    except Stop:
        pass
    finally:
        restore()
    if len(cap["losses"]) != checks or steps["n"] != checks or cap["first"] is None:
        raise RuntimeError("set-up did not settle the checked minibatches")
    checked = [sampler.drawn[i] for i in range(checks)]

    # ---- the window
    base, s0 = len(sampler.drawn), steps["n"]     # the window's j-th minibatch: drawn[base + j]
    win = {"phase": "window", "records": 0, "stretch": None, "profiled": 0, "late": None}
    sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    phases.mark("warm_up")
    deadline = t0 + ctx.seconds

    def on_window(metrics):
        now = time.perf_counter()
        if win["phase"] == "window":
            win["records"] += 1
            if now >= deadline:
                win["end"], win["attempted"] = now, steps["n"] - s0
                win["late"] = {"index": steps["n"] - s0, **_host_state(trainer)}
                win["phase"] = "late"
            return
        if win["phase"] == "late":
            late = win["late"]
            if steps["n"] - s0 == late["index"] + 1:  # the late minibatch, not reverted
                late["losses"] = metrics["loss"].detach().double().cpu()
                late["after"] = compare.to_host(dict(trainer.model.named_parameters()))
            if not ctx.trace:
                raise Stop
            win["phase"] = "trace"
            win["stretch"] = trace.Stretch(dev)
            win["stretch"].start()
            return
        win["profiled"] += 1
        if win["profiled"] == traffic["profile_units"]:
            win["stretch"].stop()
            raise Stop

    logger.hook = on_window
    try:
        trainer.run(sampler)
    except Stop:
        pass
    if "end" not in win:
        raise RuntimeError("the Trainer's run ended before the window closed")
    if win["stretch"] is not None and win["stretch"].wall_s is None:
        win["stretch"].stop()
    peak = peak_bytes(dev)
    n, attempted, seconds = win["records"], win["attempted"], win["end"] - t0
    late = win["late"]
    late_ids = sampler.drawn[base + late["index"]]
    samples = [s * 1e3 for t, s in sampler.times if t0 <= t <= win["end"]]
    stretch = win["stretch"].summary() if win["stretch"] is not None else None
    del trainer, sampler, logger
    release(dev)

    # ---- the reference follows the checked minibatches and the late one
    batch = lambda ids: _batch(tree, ids, cfg.data.patch_size, cfg.data.clamp, dev)
    batches, late_batch = [batch(ids) for ids in checked], [batch(late_ids)]
    w = Weights(**{k: conf["loss"][k] for k in ("alpha", "beta", "gamma", "rho", "rica_lambda")})
    lr = conf["optim"]["adam_lr"]
    moments = (late["exp_avg"], late["exp_avg_sq"], late["step"])
    late_params0 = {k: v.to(dev, torch.float32) for k, v in late["params"].items()}

    def follow(q, half=False):
        cut = (lambda bs: [(x[: x.shape[0] // 2], uv[: uv.shape[0] // 2]) for x, uv in bs]
               if half else bs)
        g = B // 2 if half else B
        early = ref_train.adam(params0, cut(batches), active, shape, w, g, admm, lr, q)
        later = ref_train.adam(late_params0, cut(late_batch), active, shape, w, g, admm,
                               lr, q, moments)
        return early, later

    prec = Precision(conf["model"]["compute_dtype"])
    ref, ref_late = follow(prec)

    def gaps(losses, first, params, late_losses, late_params):
        step, out1 = compare.step_gap(params, ref.params, params0, ref.first_grad, active)
        if late_params is None:
            late_step, out2 = float("inf"), []
        else:
            late_step, out2 = compare.step_gap(late_params, ref_late.params, late["params"],
                                               ref_late.first_grad, active)
        numbers = {"loss_gap": compare.loss_gap(losses, ref.losses),
                   "grad_gap": compare.grad_gap(first, ref.first_grad, active),
                   "step_gap": step,
                   "late_loss_gap": (compare.loss_gap(late_losses[None], ref_late.losses)
                                     if late_losses is not None else float("inf")),
                   "late_step_gap": late_step}
        return numbers, {"step_gap": out1, "late_step_gap": out2}

    numbers, left_out = gaps(torch.stack(cap["losses"]), cap["first"], cap["params"],
                             late.get("losses"), late.get("after"))
    readings = {}
    if ctx.control:
        as_program = lambda t, tl: gaps(t.losses, t.first_grad, t.params, tl.losses[0],
                                        tl.params)[0]
        readings["control"] = as_program(*_lower(conf, follow))
        readings["half_batch"] = as_program(*follow(prec, half=True))

    ppb = px * py
    patches = n * B * ppb
    rate = patches / seconds if seconds > 0 else 0.0
    flops = model_flops.count(shape, B * ppb, cfg.data.patch_size, B, active)
    record = {
        "admm_iters": admm, "window_units": n, "window_s": seconds,
        "flops": flops, "sample_ms": statistics.median(samples) if samples else None,
        "stretch": stretch, "profiled_units": traffic["profile_units"],
        "head": {"batches": B * ppb, "patch": cfg.data.patch_size,
                 "channels": cfg.data.num_channels,
                 "itemsize": 4 if conf["model"]["compute_dtype"] == "float32" else 2},
        "khm": {"n": B * ppb, "k": shape.clusters, "d": shape.total_latent},
    }
    return {
        "setup_s": setup_s, "setup_phases": dict(phases), "attempted": attempted,
        "failed": attempted - n, "e2e": {traffic["rate_metric"]: rate},
        "memory_peak_bytes": peak, "numbers": numbers, "left_out": left_out,
        "readings": readings, "record": record,
        "breakdown": stretch["breakdown"] if stretch else None,
        "busy_s": stretch["busy_s"] if stretch else None,
        "trace_window_s": stretch["wall_s"] if stretch else None,
    }


def _named_moments(trainer):
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    opt = trainer.state.opt
    return [(names[id(p)], g, opt.state[p]) for g in opt.param_groups for p in g["params"]]


def _capture_first_gradient(trainer, cap: dict):
    """Record the first gradient the optimizer receives, from its state after its first
    update (exp_avg / (1 - beta1)).  Returns the function that removes the capture."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    def post(opt, args, kwargs):
        if cap["first"] is None:
            cap["first"] = {n: (st["exp_avg"] / (1.0 - g["betas"][0]))
                            .detach().to("cpu", torch.float64)
                            for n, g, st in _named_moments(trainer)}

    return register_optimizer_step_post_hook(post).remove


def _host_state(trainer) -> dict:
    """The parameters and Adam's moments and step count, copied to the host."""
    moments = _named_moments(trainer)
    steps = {float(st["step"]) for _, _, st in moments}
    if len(steps) != 1:
        raise RuntimeError(f"Adam's leaves have taken different numbers of steps: {steps}")
    return {"params": compare.to_host(dict(trainer.model.named_parameters())),
            "exp_avg": {n: st["exp_avg"].detach().to("cpu", torch.float64)
                        for n, _, st in moments},
            "exp_avg_sq": {n: st["exp_avg_sq"].detach().to("cpu", torch.float64)
                           for n, _, st in moments},
            "step": steps.pop()}


def _batch(tree, ids, patch: int, clamp: float, dev):
    g = data.sap(tree)
    ids = list(ids)
    x = data.decode(torch.from_numpy(g["visibilities"][ids]).to(dev),
                    torch.from_numpy(g["visibility_scale_factors"][ids]).to(dev),
                    patch, clamp)
    uv = torch.from_numpy(data.uv_of(tree, ids)).to(dev)
    return x, uv.repeat_interleave(x.shape[0] // len(ids), dim=0)


def _lower(conf: dict, follow):
    """The control: the reference with TF32 on, the precision below the configuration's
    float32, put in the program's place."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return follow(Precision(conf["model"]["compute_dtype"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
