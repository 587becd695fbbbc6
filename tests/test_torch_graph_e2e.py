"""The port's graph construction and station training from a cascade's latents,
against the JAX package's, on the ``synth_h5`` fixture (4 stations, 10 baselines, 4 patches each).

A small port ``CascadedAE`` (latent 16, 1D latent 8, 4 clusters, RICA on) is bridged to
JAX with ``params.to_flax``.  ``build_line_graph_data``: ``x`` within 1e-5 and ``y``
within 1e-4 (relative to the largest value: the evaluation's gates), the same edges.
``build_station_graph_data`` with the same ``rng`` seed: features and labels within
1e-5, the same edges and mask.  ``train_station_graph_epochs`` over two SAP files: the
same SAP draws and losses within 1e-4 from the same initial GNN weights.  Then
``draw_graph`` and the CLI's ``graph line`` and ``graph station`` on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.data.synthetic import write_synthetic_h5
from lshm_tpu.graph import gnn as jgnn
from lshm_tpu.graph import train as jtrain
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu_torch import cli
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import read_metadata
from lshm_tpu_torch.graph import (
    build_line_graph_data,
    build_station_graph_data,
    draw_graph,
    station_graph_maps,
    train_line_graph,
    train_station_graph_epochs,
)
from lshm_tpu_torch.graph import train as gtrain
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.params import gnn_from_flax, to_flax
from lshm_tpu_torch.utils.checkpoint import save_checkpoint

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4, rica=True)
SMALL = ["--set", "model.latent_dim=16", "--set", "model.latent_dim_1d=8",
         "--set", "model.num_clusters=4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


@pytest.fixture(scope="module")
def models():
    port = CascadedAE(tc.ModelConfig(**MODEL), generator=torch.Generator().manual_seed(4))
    port.eval()
    params = jax.tree.map(jnp.asarray, to_flax(port.state_dict()))
    return port, JCascadedAE(cfg=JModelConfig(**MODEL)), params


@pytest.fixture(scope="module")
def maps(synth_h5):
    baselines, _ = read_metadata(synth_h5, "0", give_baselines=True)
    return station_graph_maps([baselines])


@pytest.fixture(scope="module")
def line_data(models, synth_h5):
    port, jmodel, params = models
    return (build_line_graph_data(port, synth_h5, "0", device="cpu"),
            jtrain.build_line_graph_data(jmodel, params, synth_h5, "0"))


def test_line_graph_data_matches_jax(line_data):
    got, want = line_data
    assert got.x.shape == (10, 32) and got.y.shape == (10, 4)
    assert got.x.dtype == got.y.dtype == np.float32
    assert _rel(got.x, want.x) < 1e-5
    assert _rel(got.y, want.y) < 1e-4
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    assert got.edge_attr is None and got.node_mask is None


def test_station_graph_data_matches_jax(models, synth_h5, maps):
    port, jmodel, params = models
    stations, bmap = maps
    rng, jrng = np.random.default_rng(6), np.random.default_rng(6)
    got = build_station_graph_data(port, synth_h5, "0", stations, bmap, rng=rng,
                                   device="cpu")
    want = jtrain.build_station_graph_data(jmodel, params, synth_h5, "0", stations, bmap,
                                           rng=jrng)
    assert got.x.shape == (4, 32) and got.edge_attr.shape == (len(bmap), 32)
    assert got.node_mask.sum() == 4
    for name in ("x", "edge_attr", "y"):
        assert _rel(getattr(got, name), getattr(want, name)) < 1e-5, name
    np.testing.assert_array_equal(got.edge_index, want.edge_index)
    np.testing.assert_array_equal(got.node_mask, want.node_mask)
    assert rng.bit_generator.state == jrng.bit_generator.state   # the same draws


@pytest.mark.parametrize("kind", ["line", "station"])
def test_an_in_memory_extract_builds_the_same_graph(kind, models, line_data, synth_h5, maps):
    """Both graph constructors read an in-memory extract (the card's machine has no
    h5py) as they read its H5 file: the same graph bit for bit."""
    from lshm_tpu_torch.data import synth_extract

    port = models[0]
    tree = synth_extract(nstations=4, ntime=192, nfreq=192, seed=7)
    if kind == "line":
        got, want = build_line_graph_data(port, tree, "0", device="cpu"), line_data[0]
    else:
        got, want = (build_station_graph_data(port, src, "0", *maps, device="cpu")
                     for src in (tree, synth_h5))
    for name in ("x", "edge_index", "y", "edge_attr", "node_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_station_epochs_follow_jax(models, synth_h5, tmp_path, monkeypatch):
    """Three rebuilds x 12 steps over two SAP files from one seed, the port's GNN
    started from JAX's initial weights: the same SAP each epoch, losses within 1e-4."""
    port, jmodel, params = models
    second = str(tmp_path / "L000002.MS_extract.h5")
    write_synthetic_h5(second, nstations=4, ntime=192, nfreq=192, seed=11)
    files, saps = [synth_h5, second], ["0", "0"]
    stations, bmap = station_graph_maps(
        [read_metadata(f, s, give_baselines=True)[0] for f, s in zip(files, saps)])
    hidden = (16, 8)

    drawn = {"port": [], "jax": []}
    for mod, key in ((gtrain, "port"), (jtrain, "jax")):
        real = mod.build_station_graph_data
        monkeypatch.setattr(mod, "build_station_graph_data",
                            lambda m, *a, _real=real, _key=key, **k:
                            drawn[_key].append(a[1 if _key == "jax" else 0]) or
                            _real(m, *a, **k))
    _, _, want = jtrain.train_station_graph_epochs(
        jmodel, params, files, saps, stations, bmap, epochs=3, steps_per_graph=12,
        edge_mlp_hidden=hidden, seed=5)
    init = jgnn.StationGraphNet(out_features=4, edge_mlp_hidden=hidden).init(
        jax.random.PRNGKey(5), jnp.zeros((4, 32)), jnp.zeros((2, len(bmap)), jnp.int32),
        jnp.zeros((len(bmap), 32)))
    _, got = train_station_graph_epochs(
        port, files, saps, stations, bmap, epochs=3, steps_per_graph=12,
        edge_mlp_hidden=hidden, seed=5, device="cpu", init_state=gnn_from_flax(init))
    assert drawn["port"] == drawn["jax"] and len(drawn["port"]) == 3
    assert len(got) == 36 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_draw_graph_writes_both_pngs(models, line_data, synth_h5, maps, tmp_path):
    port = models[0]
    out = draw_graph(line_data[0], str(tmp_path / "line.png"), title="line")
    assert out == str(tmp_path / "line.png") and os.path.getsize(out) > 0
    sdata = build_station_graph_data(port, synth_h5, "0", *maps, device="cpu")
    draw_graph(sdata, str(tmp_path / "stat.png"), directed=True)
    with open(tmp_path / "stat.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def ckpt(models, tmp_path_factory):
    """The port model as a params-only checkpoint, as ``import-torch`` writes one."""
    path = str(tmp_path_factory.mktemp("graph_ckpt"))
    save_checkpoint(path, {"params": models[0].state_dict()}, step=0)
    return path


@pytest.mark.parametrize("kind", ["line", "station"])
def test_cli_graph_on_the_cpu(kind, models, line_data, maps, ckpt, synth_h5, tmp_path,
                              capsys, monkeypatch):
    """``graph line|station`` prints JAX's result line with the losses of the same
    functions called directly, and ``--plot`` writes the PNG."""
    monkeypatch.setenv("LSHM_PLATFORM", "cpu")
    png = str(tmp_path / f"{kind}.png")
    cli.main(["graph", kind, "--data-dir", os.path.dirname(synth_h5), "--ckpt", ckpt,
              *SMALL, "--epochs", "3", "--steps-per-graph", "4", "--plot", png])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0] == f"wrote {png}" and os.path.getsize(png) > 0
    if kind == "line":
        _, losses = train_line_graph(line_data[0], epochs=3, device="cpu")
        want = f"line graph: 10 nodes, 58 edges; loss {losses[0]:.5f} -> {losses[-1]:.5f}"
    else:
        _, losses = train_station_graph_epochs(models[0], [synth_h5], ["0"], *maps,
                                               epochs=3, steps_per_graph=4, device="cpu")
        want = (f"station graph: 4 stations, 3 rebuilt graphs x 4 steps; "
                f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    assert lines[1] == want
