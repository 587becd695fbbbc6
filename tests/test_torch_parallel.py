"""The port's data-parallel steps (``lshm_tpu_torch/train/parallel.py``) and its fused
ADMM step, against the JAX steps on the CPU.

Two gloo ranks run as child processes (``tools/ranks.py``, a ``file://`` store in
``tmp_path``, a timeout on every child), each stepping its half of a global batch of 8
patches (4 baselines of 2) with its own 2 augmentation groups.  Both must hold
bit-identical parameters, and both must agree with JAX's ``make_train_step`` on the whole
batch (``num_groups`` = 4) at JAX's sharded-against-single gates (metrics ``rtol`` 2e-4,
parameters ``atol`` 2e-4, ``tests/test_train_step.py:275-295``), and with the port's own
single-process step there.  The JAX references run in this process while the ranks run.
The fused step is held to the unfused one at JAX's 1e-5 / 1e-7
(``tests/test_train_step.py:296-310``, marked slow there; here in the tier-1 set) and
to JAX's fused step.  ``tests/test_torch_lbfgs_train.py`` holds the data-parallel
L-BFGS step to JAX's the same way, with this file's ``start_ranks``.
"""

import dataclasses
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import config as jc
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.train import LossWeights as JLossWeights
from lshm_tpu.train import TrainState as JTrainState
from lshm_tpu.train import make_train_step as jax_make_train_step
from lshm_tpu.train.step import make_optimizer as jax_make_optimizer
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.params import to_flax
from lshm_tpu_torch.train import LossWeights, init_train_state, make_train_step
from lshm_tpu_torch.train.parallel import shard_batch
from lshm_tpu_torch.train.schedule import group_mask
from lshm_tpu_torch.tools.ranks import check_ranks, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4)
WORLD = 2
GROUPS = 4                     # baselines in the global batch, 2 patches each
RANK_TIMEOUT = 240             # seconds for the ranks of one job

# One job = a list of cases, each run by every rank from the same initial state on its
# own rows of the global batch; results saved per rank.
CHILD = r"""
import sys, torch
torch.set_num_threads(2)
from lshm_tpu_torch.train import LossWeights, init_lbfgs_train_state, init_train_state
from lshm_tpu_torch.train.distributed import init_distributed
from lshm_tpu_torch.train.parallel import (AllReduceMean, make_data_parallel_step,
                                           replicate_state, shard_batch, world_and_rank)

store, job_path, out = sys.argv[1:4]
assert init_distributed(store) == 2             # WORLD_SIZE and RANK from the launcher
world, rank = world_and_rank()
job = torch.load(job_path, weights_only=False)
x, uv = shard_batch(job["x"], job["uv"], rank, world)
results = {}
for case in job["cases"]:
    cfg, kind, group = case["cfg"], case["kind"], case["group"]
    init = init_train_state if kind == "adam" else init_lbfgs_train_state
    state = init(cfg, "cpu", group)
    if rank == 0:                               # the others take rank 0's by broadcast
        state.model.load_state_dict(case["init"])
    replicate_state(state)
    mean = AllReduceMean()
    step = make_data_parallel_step(cfg, job["groups"] // world, mean, kind, group,
                                   case.get("fused", False))
    state, metrics = step(state, x, uv, LossWeights())
    res = {"metrics": metrics, "params": state.model.state_dict(), "calls": mean.calls,
           "values": mean.values}
    if kind == "lbfgs":
        res.update(func_evals=state.opt.func_evals, host_syncs=state.opt.host_syncs)
    results[case["name"]] = res
torch.save(results, out.format(rank=rank))
"""


def cfg_of(mod, **kw):
    """The small configuration of these tests in either package (``kw`` replaces
    fields of the optimizer section).  Adam's rate is the port's step tests' 1e-4
    (``tests/test_torch_train.py``): at 1e-3 Adam's normalised step turns float32
    rounding in a near-zero gradient into parameter gaps of a few 1e-6."""
    return mod.Config(data=mod.DataConfig(batch_size=2),
                      model=mod.ModelConfig(**MODEL),
                      optim=mod.OptimConfig(adam_lr=1e-4, **kw),
                      train=mod.TrainConfig(admm_iters=2, seed=3))


def global_batch():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2 * GROUPS, 128, 128, 4)).astype(np.float32)
    uv = np.repeat(rng.normal(size=(GROUPS, 2)) * 300, 2, axis=0).astype(np.float32)
    return x, uv


def start_ranks(tmp_path, cases: list[dict], x: np.ndarray, uv: np.ndarray,
                groups: int):
    """Run ``cases`` on two gloo ranks in the background, each on its half of the
    global batch (x, uv) of ``groups`` baselines; the future's result is
    {rank: {case name: result}}."""
    job = tmp_path / "job.pt"
    torch.save({"x": torch.tensor(x), "uv": torch.tensor(uv), "groups": groups,
                "cases": cases}, job)
    child = tmp_path / "child.py"
    child.write_text(CHILD)
    out = str(tmp_path / "rank{rank}.pt")
    argv = [sys.executable, str(child), f"file://{tmp_path / 'store'}", str(job), out]
    env = {"LSHM_PLATFORM": "cpu", "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}

    def run():
        check_ranks(run_ranks(argv, WORLD, RANK_TIMEOUT, env=env, cwd=ROOT))
        return {r: torch.load(out.format(rank=r), weights_only=False)
                for r in range(WORLD)}

    pool = ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def init_state_dict(init_fn, cfg, group="all") -> dict:
    return {k: v.clone() for k, v in init_fn(cfg, "cpu", group).model.state_dict().items()}


def leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_params_close(got_sd: dict, want: dict, **tol) -> None:
    got = leaves(to_flax(got_sd))
    assert got.keys() == want.keys()
    for name, v in want.items():
        np.testing.assert_allclose(got[name], v, err_msg=name, **tol)


def assert_metrics_close(got: dict, want: dict, **tol) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), err_msg=k, **tol)


def assert_ranks_identical(ranks: dict, name: str) -> None:
    a, b = ranks[0][name], ranks[1][name]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k in a["metrics"]:
        assert torch.equal(a["metrics"][k], b["metrics"][k]), k


def port_step(cfg, init_sd: dict, fused: bool = False, group: str = "all",
              groups: int = GROUPS):
    """The port's single-process Adam step on the global batch's first ``groups``
    baselines (all of them by default)."""
    state = init_train_state(cfg, "cpu", group)
    state.model.load_state_dict(init_sd)
    x, uv = (a[:2 * groups] for a in global_batch())
    state, metrics = make_train_step(cfg, groups, fused=fused)(
        state, torch.tensor(x), torch.tensor(uv), LossWeights())
    return {k: v.numpy() for k, v in metrics.items()}, state.model.state_dict()


def jax_adam_step(init_sd: dict, fused: bool):
    """JAX's Adam step (jitted: about 10 s to compile here, where the eager step pays
    about 60 s for its first call) on the global batch, from the port's initial
    parameters: (metrics, flax params as {path: array})."""
    cfg = cfg_of(jc)                   # plain XLA convs and the XLA KHM expression
    params = jax.tree.map(jnp.asarray, to_flax(init_sd))
    tx = jax_make_optimizer(cfg, params, "all")
    state = JTrainState(params=params, opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    step = jax_make_train_step(JCascadedAE(cfg=cfg.model), tx, cfg, num_groups=GROUPS,
                               donate=False, fused=fused)
    x, uv = global_batch()
    new, metrics = step(state, jnp.asarray(x), jnp.asarray(uv), JLossWeights())
    return jax.device_get(metrics), leaves(jax.device_get(new.params))


CASES = ("unfused", "fused")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The two ranks' results of the Adam step, unfused and fused; meanwhile the JAX
    steps and the port's single-process steps on the global batch."""
    cfg = cfg_of(tc)
    init_sd = init_state_dict(init_train_state, cfg)
    future = start_ranks(tmp_path_factory.mktemp("ranks"), [
        {"name": n, "cfg": cfg, "kind": "adam", "group": "all", "init": init_sd,
         "fused": n == "fused"} for n in CASES], *global_batch(), GROUPS)
    want = {n: jax_adam_step(init_sd, n == "fused") for n in CASES}
    single = {n: port_step(cfg, init_sd, n == "fused") for n in CASES}
    return future.result(), want, single


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_bit_identical_parameters(results, case):
    ranks, _, _ = results
    assert_ranks_identical(ranks, case)


@pytest.mark.parametrize("case", CASES)
def test_data_parallel_step_matches_jax_on_the_global_batch(results, case):
    ranks, want, _ = results
    metrics, params = want[case]
    got = ranks[0][case]
    assert_metrics_close(got["metrics"], metrics, rtol=2e-4)
    assert_params_close(got["params"], params, atol=2e-4)


@pytest.mark.parametrize("case", CASES)
def test_data_parallel_step_matches_the_single_process_port(results, case):
    ranks, _, single = results
    metrics, params = single[case]
    got = ranks[0][case]
    assert_metrics_close(got["metrics"], metrics, rtol=2e-4)
    assert_params_close(got["params"], leaves(to_flax(params)), atol=2e-4)


@pytest.mark.parametrize("case", CASES)
def test_one_gradient_all_reduce_per_admm_iteration(results, case):
    """admm_iters all-reduces of every trainable gradient, and one of the stacked
    metrics (9 terms x admm_iters)."""
    ranks, _, single = results
    nadmm = cfg_of(tc).train.admm_iters
    n_params = sum(v.numel() for v in single[case][1].values())
    got = ranks[1][case]
    assert got["calls"] == nadmm + 1
    assert got["values"] == nadmm * n_params + len(got["metrics"]) * nadmm


def test_fused_step_matches_jax_fused(results):
    """The port's single-process fused step against JAX's fused step, at the port's
    step gates (``tests/test_torch_train.py``)."""
    _, want, single = results
    assert_metrics_close(single["fused"][0], want["fused"][0], rtol=1e-5)
    assert_params_close(single["fused"][1], want["fused"][1], rtol=1e-5, atol=1e-6)


FOURIER = dict(latent_dim=16, latent_dim_fourier=8, num_clusters=4, fourier_variant=True)


@pytest.mark.parametrize("variant,group", [("full_khm", "all"), ("full_khm", "ae1d"),
                                           ("fourier", "all")])
def test_fused_step_matches_unfused(variant, group):
    """JAX's fused-against-unfused test (rtol 1e-5, atol 1e-7 on every metric and
    parameter) on the port, for the Adam step on every parameter, on a frozen group and
    on the Fourier cascade, on 2 baselines of 2 patches."""
    cfg = cfg_of(tc)
    if variant == "fourier":
        cfg = dataclasses.replace(cfg, model=tc.ModelConfig(**FOURIER))
    init_sd = init_state_dict(init_train_state, cfg, group)
    m1, p1 = port_step(cfg, init_sd, False, group, groups=2)
    m2, p2 = port_step(cfg, init_sd, True, group, groups=2)
    assert_metrics_close(m2, m1, rtol=1e-5, atol=1e-7)
    for k in p1:
        np.testing.assert_allclose(p2[k].numpy(), p1[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_fused_step_launches_one_forward_per_admm_iteration(monkeypatch):
    """The fused step runs the cascade once per ADMM iteration, the unfused twice (the
    objective's forward and the dual update's): K3's launches on the card."""
    cfg = cfg_of(tc)                                   # 2 ADMM iterations
    calls = {"n": 0}
    forward = CascadedAE.forward

    def counting(self, *a, **k):
        calls["n"] += 1
        return forward(self, *a, **k)

    monkeypatch.setattr(CascadedAE, "forward", counting)
    x, uv = (a[:4] for a in global_batch())
    for fused, want in ((False, 4), (True, 2)):
        calls["n"] = 0
        make_train_step(cfg, 2, fused=fused)(
            init_train_state(cfg, "cpu"), torch.tensor(x), torch.tensor(uv),
            LossWeights())
        assert calls["n"] == want, (fused, calls)


@pytest.mark.parametrize("group,values", [("all", 1_725_716), ("ae2d", 1_250_300),
                                          ("ae1d", 472_856), ("khm", 2_560)])
def test_the_gradient_buffer_at_full_width(group, values):
    """The values one ADMM iteration all-reduces at full width (``full_khm``): every
    gradient of the active group (float32; 6.9 MB for ``all``)."""
    model = CascadedAE(tc.ModelConfig())
    named = dict(model.named_parameters())
    mask = group_mask(named, group)
    assert sum(p.numel() for n, p in named.items() if mask[n]) == values


def test_shard_batch_takes_contiguous_rows():
    x = torch.arange(8.0).reshape(8, 1)
    uv = torch.arange(16.0).reshape(8, 2)
    parts = [shard_batch(x, uv, r, 2) for r in range(2)]
    assert torch.equal(torch.cat([p[0] for p in parts]), x)
    assert torch.equal(parts[1][1], uv[4:])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(x[:7], uv[:7], 0, 2)
