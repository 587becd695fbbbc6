"""On the card: the control of each cell (the reference in the precision below the
configuration's, put in the program's place) fails the cell's limits, while the
program passes them, at a size a test run holds: 4 baselines a minibatch, 3 ADMM
iterations, 2 checked minibatches, 3 seeds.  The full-size readings that set the limits
come from ``python -m portbench.calibrate`` (PERF.md)."""

import time

import pytest

from portbench import compare, run, spec

BENCH = spec.benchmark()
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_and_the_program_passes(card, name):
    cell = spec.cell(name, BENCH)
    cell.traffic = {**cell.traffic, "check_steps": 2}
    for seed in SEEDS:
        ctx = run.Context(cell=cell, seed=seed, seconds=1.0, trace=False, device="cuda",
                          t_start=time.perf_counter(), control=True,
                          overrides={"data.batch_size": 4, "train.admm_iters": 3})
        r = run.measure(ctx)
        assert r["correct"], r["checks"]
        ok, checks = compare.judge(r["readings"]["control"], cell.limits)
        assert not ok, checks
