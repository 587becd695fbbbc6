"""The port's command line (``python -m lshm_tpu_torch.cli``) against the JAX package's
(``lshm_tpu/cli.py``), modelled on ``test_cli_synth_and_train``
(``tests/test_trainer.py``) and ``test_cli_export`` (``tests/test_export.py``).  On the
CPU (``LSHM_PLATFORM=cpu``) at small widths.

``synth`` writes what JAX's writes; ``train`` logs JAX's JSONL keys, its losses equal a
direct ``Trainer.run`` bit for bit, ``--resume`` equals the uninterrupted run bit for
bit and ``--profile-dir`` writes a trace; ``eval`` writes JAX's files; ``import-torch``
takes ``.model`` files written from a seed; ``export``'s artifact lies within 1e-6 of
the eager model (relative to the largest value); ``demo`` draws JAX's PNG pixel for
pixel; every subcommand lists JAX's options; what is not ported exits naming its
ROADMAP item."""

import json
import os
import re
import shutil

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from lshm_tpu import cli as jcli
from lshm_tpu.utils.metrics import MetricLogger as JMetricLogger
from lshm_tpu_torch import cli
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.eval import load_exported
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.utils import MetricLogger, restore_checkpoint

SMALL = ["--set", "data.batch_size=2", "--set", "model.latent_dim=16",
         "--set", "model.latent_dim_1d=8", "--set", "model.num_clusters=3"]
TERMS = ("loss0", "loss1", "loss2", "loss3", "kdist", "aug", "sim", "rica", "loss")
JSONL_KEYS = {"epoch", "iter", "t", "patches", *TERMS}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on a few cores, and
    the many small operators here slow down badly when their threads oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv("LSHM_PLATFORM", "cpu")
    monkeypatch.setenv("LSHM_JAX_CACHE_DIR", "")    # JAX's CLI: no compile cache


def _train_argv(data_dir, ckpt, epochs, *extra):
    return ["train", "--data-dir", data_dir, "--preset", "full_khm", "--quiet",
            "--set", f"train.num_epochs={epochs}", "--set", "train.iters_per_epoch=2",
            "--set", "train.admm_iters=1", *SMALL, "--set", f"train.checkpoint_dir={ckpt}",
            *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A synthetic extract (4 stations, 10 baselines) and one epoch trained through the
    CLI with a JSONL log and a profile."""
    root = tmp_path_factory.mktemp("cli")
    data, ckpt = str(root / "data"), str(root / "ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LSHM_PLATFORM", "cpu")
        cli.main(["synth", "--out", data, "--nstations", "4"])
        cli.main(_train_argv(data, ckpt, 1, "--log-jsonl", str(root / "log.jsonl"),
                             "--profile-dir", str(root / "prof")))
    return root, data, ckpt


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _params(ckpt, step=None):
    return restore_checkpoint(ckpt, step)[0]["params"]


def test_synth_writes_what_jax_writes(tmp_path, capsys):
    args = ["--nstations", "3", "--ntime", "128", "--nfreq", "160", "--seed", "2"]
    jcli.main(["synth", "--out", str(tmp_path / "jax"), *args])
    cli.main(["synth", "--out", str(tmp_path / "port"), *args])
    assert capsys.readouterr().out.count("wrote") == 2
    name = "L000001.MS_extract.h5"
    with h5py.File(tmp_path / "jax" / name) as a, h5py.File(tmp_path / "port" / name) as b:
        names = []
        a.visit(names.append)
        got = []
        b.visit(got.append)
        assert sorted(got) == sorted(names)
        for n in names:
            if isinstance(a[n], h5py.Dataset):
                assert a[n].dtype == b[n].dtype, n
                np.testing.assert_array_equal(a[n][...], b[n][...], err_msg=n)


def test_train_logs_jax_keys_and_equals_a_direct_run(trained, capsys):
    root, data, _ = trained
    recs = _records(root / "log.jsonl")
    assert [(r["epoch"], r["iter"]) for r in recs] == [(0, 0), (0, 1)]
    assert all(set(r) == JSONL_KEYS for r in recs)
    cfg = tc._apply_overrides(tc.preset("full_khm"), [
        f"data.data_dir={data}", "train.num_epochs=1", "train.iters_per_epoch=2",
        "train.admm_iters=1", *SMALL[1::2]])
    direct = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    direct.run()
    assert len(direct.logger.history) == len(recs)
    for want, got in zip(direct.logger.history, recs):
        assert {k: v for k, v in got.items() if k != "t"} == {
            k: v for k, v in want.items() if k != "t"}


def test_train_resume_equals_the_uninterrupted_run(trained, tmp_path, capsys):
    root, data, ckpt = trained
    cut = str(tmp_path / "cut")
    shutil.copytree(ckpt, cut)
    log = str(tmp_path / "resumed.jsonl")
    cli.main(_train_argv(data, cut, 2, "--resume", "--log-jsonl", log))
    assert "done:" in capsys.readouterr().out
    assert [(r["epoch"], r["iter"]) for r in _records(log)] == [(1, 0), (1, 1)]
    full = str(tmp_path / "full")
    cli.main(_train_argv(data, full, 2))
    got, want = _params(cut, 4), _params(full, 4)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_profile_dir_writes_a_trace(trained):
    root = trained[0]
    assert os.listdir(root / "prof") == ["trace_epoch_0.json"]
    with open(root / "prof" / "trace_epoch_0.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    # the program's spans (lshm_tpu_torch/utils/spans.py) are in it too
    assert {"trainer.step", "admm.backward"} <= {e.get("name") for e in events}


def _reference_files(tmp_path, seed=0):
    """The reference's four ``.model`` files (``{'model_state_dict': ...}``) of a
    cascade made from a seed."""
    model = CascadedAE(tc.ModelConfig(latent_dim=16, latent_dim_1d=8, num_clusters=3),
                       generator=torch.Generator().manual_seed(seed))
    sd = model.state_dict()
    paths = {}
    for flag, prefix in (("--net", "ae2d"), ("--net-t", "aeT"), ("--net-f", "aeF"),
                         ("--khm", "khm")):
        part = {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}
        paths[flag] = str(tmp_path / f"{prefix}.model")
        torch.save({"model_state_dict": part}, paths[flag])
    return sd, paths


def test_import_torch_then_eval_writes_jax_files(trained, tmp_path, capsys):
    _, data, _ = trained
    sd, paths = _reference_files(tmp_path)
    ckpt, out = str(tmp_path / "imported"), tmp_path / "eval"
    cli.main(["import-torch", *[a for kv in paths.items() for a in kv], "--out", ckpt])
    assert "imported reference checkpoints" in capsys.readouterr().out
    params = _params(ckpt)
    assert params.keys() == sd.keys()
    assert all(torch.equal(params[k], sd[k]) for k in sd)
    cli.main(["eval", "--data-dir", data, "--ckpt", ckpt, "--out", str(out), *SMALL,
              "--hard-clusters", "3", "--montages"])
    assert "evaluated 10 baselines; soft cluster histogram:" in capsys.readouterr().out
    files = set(os.listdir(out))
    # JAX's evaluate_sap: X.mat, M.mat, M.png, the scatter plots, a montage per baseline
    assert {"X.mat", "M.mat", "M.png", "scatter.png", "clusters.png"} <= files
    assert len([f for f in files if re.fullmatch(r"b\d+_\d+\.png", f)]) == 10


def test_export_matches_eager(trained, tmp_path, capsys):
    _, _, ckpt = trained
    out = str(tmp_path / "fwd.pt2")
    cli.main(["export", "--ckpt", ckpt, "--out", out, *SMALL])
    assert "exported forward (batch=symbolic)" in capsys.readouterr().out
    with open(out, "rb") as f:
        fn = load_exported(f.read())
    cfg = tc._apply_overrides(tc.preset("full_khm"), SMALL[1::2])
    t = Trainer(cfg, device="cpu")
    t.load(ckpt)
    g = torch.Generator().manual_seed(3)
    x, uv = torch.randn(3, 128, 128, 4, generator=g), torch.randn(3, 2, generator=g)
    xr, mu, dists = fn(x, uv)
    with torch.inference_mode():
        out = t.model(x, uv)
    for got, want in ((xr, out.xrecon), (mu, out.Mu)):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-6
    assert dists.shape == (3, 3) and torch.isfinite(dists).all()
    assert cli.build_parser().parse_args(["export", "--ckpt", "c"]).out == "lshm_forward.pt2"


def test_demo_png_equals_jax(tmp_path, capsys):
    jcli.main(["demo", "--out", str(tmp_path / "jax.png")])
    cli.main(["demo", "--out", str(tmp_path / "port.png")])
    a = np.asarray(Image.open(tmp_path / "jax.png"))
    b = np.asarray(Image.open(tmp_path / "port.png"))
    assert a.shape == (128, 256, 3)
    np.testing.assert_array_equal(a, b)


def _help(main, sub, capsys) -> set[str]:
    with pytest.raises(SystemExit) as e:
        main([sub, "--help"])
    assert e.value.code == 0
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


@pytest.mark.parametrize("sub", ["synth", "train", "eval", "import-torch", "graph", "demo",
                                 "rica", "export", "bench"])
def test_each_subcommand_lists_jax_options(sub, capsys):
    want = _help(jcli.main, sub, capsys)
    assert want <= _help(cli.main, sub, capsys)


@pytest.mark.parametrize("kind", ["line", "station"])
def test_graph_runs_on_the_cpu(trained, kind, capsys):
    """``graph`` (ROADMAP A8) is ported: two epochs over the trained checkpoint print
    JAX's result line with finite losses (tests/test_torch_graph_e2e.py holds the
    graphs and losses to JAX's)."""
    _, data, ckpt = trained
    cli.main(["graph", kind, "--data-dir", data, "--ckpt", ckpt, *SMALL, "--epochs", "2",
              "--steps-per-graph", "3"])
    out = capsys.readouterr().out.strip()
    want = (r"line graph: 10 nodes, 58 edges" if kind == "line" else
            r"station graph: 4 stations, 2 rebuilt graphs x 3 steps")
    m = re.fullmatch(want + r"; loss (\S+) -> (\S+)", out)
    assert m and all(np.isfinite(float(v)) for v in m.groups()), out


@pytest.mark.parametrize("argv,item", [
    (["bench"], "C.8"),
])
def test_unported_commands_exit_naming_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert str(e.value.code).startswith("error:") and f"ROADMAP {item}" in str(e.value.code)


@pytest.mark.parametrize("flags", [["--num-processes", "2"],
                                   ["--coordinator", "localhost:1234"]],
                         ids=["num-processes", "coordinator"])
def test_a_half_given_multi_host_configuration_exits_with_error(flags, monkeypatch):
    """The multi-host flags are ported (ROADMAP A9): half of them exit with JAX's
    message (``tests/test_torch_distributed.py`` trains on two processes)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--data-dir", "d", *flags])
    assert str(e.value.code).startswith("error: incomplete multi-host configuration")


@pytest.mark.parametrize("override", ["foo.bar=1", "model.packed_conv2d=two",
                                      "model.compute_dtype=float16"])
def test_a_bad_set_exits_with_error(override):
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--data-dir", "d", "--set", override])
    assert str(e.value.code).startswith("error:")


def test_platform_choice(monkeypatch):
    """LSHM_PLATFORM unset means the card, and raises without one; any value but cpu
    is an error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("LSHM_PLATFORM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--data-dir", "d"])
    monkeypatch.setenv("LSHM_PLATFORM", "tpu")
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--data-dir", "d"])
    assert "LSHM_PLATFORM" in str(e.value.code)


def test_metric_logger_records_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    steps = [{k: rng.uniform(0.1, 2.0, size=3).astype(np.float32) for k in TERMS}
             for _ in range(3)]
    port = MetricLogger(jsonl_path=str(tmp_path / "port.jsonl"), echo=False)
    jax_log = JMetricLogger(jsonl_path=str(tmp_path / "jax.jsonl"), echo=False)
    for i, m in enumerate(steps):
        port.log_step(0, i, {k: torch.from_numpy(v) for k, v in m.items()}, patches=8)
        jax_log.log_step(0, i, m, patches=8)
    got, want = _records(tmp_path / "port.jsonl"), _records(tmp_path / "jax.jsonl")
    assert len(got) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert {k: v for k, v in g.items() if k != "t"} == {
            k: v for k, v in w.items() if k != "t"}
    MetricLogger(jsonl_path=str(tmp_path / "port.jsonl"), echo=False)   # truncates
    assert _records(tmp_path / "port.jsonl") == []
    port.plot(str(tmp_path / "loss.png"))
    assert Image.open(tmp_path / "loss.png").size == (900, 500)
