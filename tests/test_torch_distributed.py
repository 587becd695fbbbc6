"""The port's multi-process bootstrap and data-parallel Trainer on the CPU:
``init_distributed`` (``lshm_tpu_torch/train/distributed.py``) with JAX's contract, the
``train.mesh_shape`` rules of JAX's ``Trainer.mesh`` for one process per card, the
sampler's default ``process_index``, a two-rank ``Trainer`` run mirroring
``tests/test_multihost.py:158-187`` (bit-identical parameters, an equal loss, one
checkpoint reloaded bit for bit on both ranks, the device decode refused), and the CLI's
``train --coordinator ... --num-processes 2 --process-id r`` as two processes.  The
ranks are child processes with a timeout each (``tools/ranks.py``)."""

import ast
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract, write_synthetic_h5
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.train.distributed import init_distributed
from lshm_tpu_torch.train.parallel import data_parallel_layout
from lshm_tpu_torch.tools.ranks import check_ranks, run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"LSHM_PLATFORM": "cpu", "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "2"}
SMALL = ["--set", "data.batch_size=2", "--set", "model.latent_dim=16",
         "--set", "model.latent_dim_1d=8", "--set", "model.num_clusters=4"]
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LSHM_PLATFORM", "cpu")
    return monkeypatch


def test_init_distributed_is_a_no_op_for_one_process(no_launcher):
    assert init_distributed() == 1
    assert init_distributed(num_processes=1) == 1
    # torchrun --nproc-per-node 1 sets the address and a world of 1
    no_launcher.setenv("MASTER_ADDR", "localhost")
    no_launcher.setenv("MASTER_PORT", "29500")
    no_launcher.setenv("WORLD_SIZE", "1")
    assert init_distributed() == 1
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("args,env", [
    (dict(coordinator="localhost:1234"), {}),
    (dict(coordinator="localhost:1234", num_processes=1), {}),
    (dict(num_processes=2, process_id=0), {}),
    ({}, {"WORLD_SIZE": "2", "RANK": "0"}),
    ({}, {"MASTER_ADDR": "localhost", "MASTER_PORT": "1234"}),
], ids=["coordinator", "coordinator-one-process", "num_processes", "env-world",
        "env-address"])
def test_a_half_given_configuration_raises(no_launcher, args, env):
    """JAX's ValueError: proceeding single-process would train diverging replicas."""
    for k, v in env.items():
        no_launcher.setenv(k, v)
    with pytest.raises(ValueError, match="incomplete multi-host configuration"):
        init_distributed(**args)


@pytest.mark.parametrize("args,match", [
    (dict(coordinator="localhost:1234", num_processes=2), "process_id"),
    (dict(coordinator="localhost:1234", num_processes=2, process_id=2), "not in"),
    (dict(coordinator="localhost", num_processes=2, process_id=0), "host:port"),
])
def test_a_malformed_configuration_raises(no_launcher, args, match):
    with pytest.raises(ValueError, match=match):
        init_distributed(**args)


def test_a_rank_without_its_card_raises(no_launcher):
    """On cards (LSHM_PLATFORM unset) a rank whose LOCAL_RANK has no card raises before
    it joins the group: it never moves to another device or to the CPU."""
    no_launcher.delenv("LSHM_PLATFORM")
    no_launcher.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="LOCAL_RANK=0 has no card"):
        init_distributed("localhost:1234", 2, 0)
    no_launcher.setattr(torch.cuda, "is_available", lambda: True)
    no_launcher.setattr(torch.cuda, "device_count", lambda: 1)
    no_launcher.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1 has no card"):
        init_distributed("localhost:1234", 2, 1)


_ALONE = """
import datetime, sys
from lshm_tpu_torch.train.distributed import init_distributed
init_distributed(sys.argv[1], 2, 0, timeout=datetime.timedelta(seconds=3))
"""


def test_a_group_that_cannot_form_raises_within_its_timeout(tmp_path):
    """Rank 0 of two, alone: the rendezvous gives up after its 3 s timeout, with an
    error, instead of waiting for the missing peer."""
    r = subprocess.run([sys.executable, "-c", _ALONE, f"file://{tmp_path / 'store'}"],
                       env={**os.environ, **ENV}, cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "imeout" in r.stderr or "imed out" in r.stderr, r.stderr[-2000:]


@pytest.mark.parametrize("shape,world,want", [
    ((1,), 1, 1), ((), 1, 1), ((-1,), 1, 1), ((1, 1), 1, 1),
    ((1,), 4, 4), ((-1,), 4, 4), ((4,), 4, 4), ((1, 1), 4, 4), ((4, 1), 4, 4),
    ((-1, 1), 2, 2),
    ((2,), 4, "does not cover the 4 global devices"),
    ((8,), 4, "does not cover"),
    ((4,), 1, "one process per card"),
    ((2, 2), 4, "every other axis must be 1"),
    ((1, 4), 4, "every other axis must be 1"),
])
def test_mesh_shape_rules(shape, world, want):
    """JAX's ``Trainer.mesh`` (``lshm_tpu/train/trainer.py:60-86``) with one process per
    card: a product of 1 or a -1 spans every rank on the first axis, a product equal
    to the world size too, any other raises; one process with a product above 1 raises
    naming the launch; multi-axis shapes need every axis but the first to be 1."""
    if isinstance(want, int):
        assert data_parallel_layout(shape, world) == want
    else:
        with pytest.raises(ValueError, match=want):
            data_parallel_layout(shape, world)


def test_one_process_trainer_refuses_a_mesh():
    """``train.mesh_shape=(4,)`` in one process: the Trainer raises (it used to be an
    unported field) and ``check_supported`` lets the field through."""
    cfg = tc.Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, mesh_shape=(4,)))
    tc.check_supported(cfg)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        Trainer(cfg, device="cpu")
    multi = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, mesh_shape=(1, 1), mesh_axes=("data", "model")))
    assert Trainer(multi, device="cpu").world_size == 1


def test_sampler_process_index_defaults_to_zero_without_a_group():
    cfg = tc.DataConfig(batch_size=2)
    tree = synth_extract(nstations=4, ntime=192, nfreq=192)
    assert MinibatchSampler([tree], ["0"], cfg)._process_index == 0
    assert MinibatchSampler([tree], ["0"], cfg, process_index=3)._process_index == 3


_TRAINER = r"""
import dataclasses, hashlib, json, sys, torch
torch.set_num_threads(2)
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.train.distributed import init_distributed
from lshm_tpu_torch.utils.metrics import MetricLogger

store, ckpt, out = sys.argv[1:4]
assert init_distributed(store) == 2
rank = torch.distributed.get_rank()
cfg = tc.Config(data=tc.DataConfig(batch_size=2, prefetch=2),
                model=tc.ModelConfig(latent_dim=16, latent_dim_1d=8, num_clusters=4),
                optim=tc.OptimConfig(adam_lr=1e-3),
                train=tc.TrainConfig(num_epochs=1, iters_per_epoch=2, admm_iters=2,
                                     seed=3, checkpoint_dir=ckpt))
tree = synth_extract(nstations=4, ntime=192, nfreq=192)

def digest(model):
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode() + v.detach().cpu().numpy().tobytes())
    return h.hexdigest()

sampler = MinibatchSampler([tree], ["0"], cfg.data, seed=0)
twin = MinibatchSampler([tree], ["0"], cfg.data, seed=0)
twin.reseed(0)
mb = twin.sample()
first, local = float(abs(mb.x).sum()), mb.x.shape[0]
t = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
summary = t.run(sampler)
t2 = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
t2.load(ckpt)
refused = ""
dd = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, device_decode=True))
try:
    Trainer(dd, device="cpu", logger=MetricLogger(echo=False)).run(sampler)
except ValueError as e:
    refused = str(e)
json.dump({"world": t.world_size, "rank": t.rank, "process_index": sampler._process_index,
           "first": first, "local": local, "digest": digest(t.model), "loaded": digest(t2.model),
           "step": t2.state.step, "summary": summary,
           "losses": [h["loss"] for h in t.logger.history],
           "patches": [h["patches"] for h in t.logger.history], "refused": refused},
          open(out.format(rank=rank), "w"))
"""


def test_two_rank_trainer(tmp_path):
    """Two gloo ranks, each a Trainer on its own sampler stream: the ranks' parameters
    bit-identical after 2 minibatches x 2 ADMM iterations and their losses equal (the
    reduced metrics); the global batch's patches logged; rank 0's checkpoint loaded
    bit for bit by a fresh Trainer on each rank; ``data.device_decode=True`` refused."""
    child = tmp_path / "child.py"
    child.write_text(_TRAINER)
    out = str(tmp_path / "rank{rank}.json")
    ckpt = tmp_path / "ckpt"
    check_ranks(run_ranks([sys.executable, str(child), f"file://{tmp_path / 'store'}",
                           str(ckpt), out], 2, 240, env=ENV, cwd=ROOT))
    r0, r1 = (json.load(open(out.format(rank=r))) for r in range(2))
    assert (r0["world"], r0["rank"], r1["rank"]) == (2, 0, 1)
    assert (r0["process_index"], r1["process_index"]) == (0, 1)
    assert r0["first"] != r1["first"]              # disjoint minibatch streams
    assert r0["digest"] == r1["digest"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    assert all(np.isfinite(v) for v in r0["summary"].values())
    assert r0["patches"] == [2 * r0["local"]] * 2
    assert r0["loaded"] == r1["loaded"] == r0["digest"] and r0["step"] == 2
    assert sorted(os.listdir(ckpt)) == ["ckpt_2.pt", "extras_2.json"]
    for r in (r0, r1):
        assert "data.device_decode=True needs an unsharded mesh" in r["refused"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_trains_on_two_processes(tmp_path):
    """``train --coordinator localhost:<port> --num-processes 2 --process-id r`` on the
    CPU: both print JAX's ``distributed: 2 process(es)`` and the layout, rank 0 alone
    prints the metrics and writes the JSONL log, and both end with the same summary."""
    data = tmp_path / "data"
    write_synthetic_h5(str(data / "L000001.MS_extract.h5"), nstations=4, ntime=192,
                       nfreq=192, seed=0)
    log = tmp_path / "log.jsonl"
    argv = [sys.executable, "-m", "lshm_tpu_torch.cli", "train", "--data-dir", str(data),
            "--coordinator", f"localhost:{_free_port()}", "--num-processes", "2",
            "--process-id", "{rank}", "--log-jsonl", str(log), *SMALL,
            "--set", "train.num_epochs=1", "--set", "train.iters_per_epoch=2",
            "--set", "train.admm_iters=1", "--set", f"train.checkpoint_dir={tmp_path}/ck"]
    outs = check_ranks(run_ranks(argv, 2, 240, env=ENV, cwd=ROOT))
    for rank, text in enumerate(outs):
        lines = text.splitlines()
        assert lines[0] == "distributed: 2 process(es)"
        assert lines[1] == f"data parallel: {{'data': 2}} over 2 rank(s); rank {rank} on cpu"
        assert lines[-1].startswith("done: {")
        assert len(lines[2:-1]) == (2 if rank == 0 else 0), lines     # the metrics
    summaries = [ast.literal_eval(text.splitlines()[-1][len("done: "):]) for text in outs]
    for summary in summaries:
        summary.pop("t")                       # each rank's own clock
    assert summaries[0] == summaries[1]
    records = [json.loads(ln) for ln in open(log)]
    assert [r["iter"] for r in records] == [0, 1]
    assert os.path.exists(tmp_path / "ck" / "ckpt_2.pt")

