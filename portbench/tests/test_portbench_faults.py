"""A run of each cell, on the CPU at a small size and without the look for a card,
with the timed path broken underneath: ``correct`` comes out false for each fault the
cell can have (a step that returns its state unchanged; half the batch left out and the
mean taken over the rest), from the first minibatch on or only once warm, after the
checked ones, against the cell's own limits.  The sound run comes out correct."""

import time

import pytest
import torch

from portbench import run, spec

SIZES = {"stations": 3, "ntime": 192, "nfreq": 128}      # 6 baselines, 2 patches each
OVERRIDES = {"data.batch_size": 2, "train.admm_iters": 2, "data.device_decode": True}
BENCH = spec.benchmark()
CHECKS = 2


def _run(name, seed=2**31 + 5, seconds=0.5, overrides=None):
    cell = spec.cell(name, BENCH)
    cell.traffic = {**cell.traffic, "check_steps": CHECKS, "profile_units": 1}
    ctx = run.Context(cell=cell, seed=seed, seconds=seconds, trace=False, device="cpu",
                      t_start=time.perf_counter(), overrides={**OVERRIDES, **(overrides or {})},
                      sizes=SIZES)
    return run.measure(ctx)


def _broken(monkeypatch, wrap, after: int):
    """The Trainer's step, broken by ``wrap`` from its ``after``-th minibatch on."""
    from lshm_tpu_torch.train.trainer import Trainer

    orig = Trainer._step
    calls = {"n": 0}

    def _step(self, kind, group, nb):
        sound, broken = orig(self, kind, group, nb), wrap(orig, self, kind, group, nb)

        def step(*a):
            calls["n"] += 1
            return (broken if calls["n"] > after else sound)(*a)
        return step

    monkeypatch.setattr(Trainer, "_step", _step)


def _unchanged(orig, self, kind, group, nb):
    real = orig(self, kind, group, nb)

    def step(state, x, uv, w):
        keep = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        state, metrics = real(state, x, uv, w)
        state.model.load_state_dict(keep)
        return state, metrics
    return step


def _half_batch(orig, self, kind, group, nb):
    real = orig(self, kind, group, nb // 2)
    return lambda state, x, uv, w: real(state, x[: x.shape[0] // 2], uv[: uv.shape[0] // 2], w)


@pytest.mark.parametrize("after", [0, CHECKS], ids=["from_the_start", "once_warm"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_fault_is_not_correct(monkeypatch, name, fault, after):
    torch.manual_seed(0)
    _broken(monkeypatch, fault, after)
    r = _run(name)
    assert r["correct"] is False, r["checks"]
    if after:      # the checked minibatches were sound: the late check caught it
        assert all(c["value"] <= c["limit"] for k, c in r["checks"].items()
                   if not k.startswith("late_")), r["checks"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["left_out"]) == {"step_gap", "late_step_gap"}


def test_minibatches_are_counted_across_epochs():
    """With epochs of 1 minibatch the window crosses an epoch boundary at every
    minibatch; every minibatch it settles is attempted once and none is counted as
    failed."""
    r = _run("full_khm.adam", seconds=6.0,
             overrides={"train.iters_per_epoch": 1, "train.num_epochs": 1000})
    assert r["attempted"] >= 2 and r["failed"] == 0, r
