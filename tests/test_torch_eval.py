"""The port's clustering evaluation (``lshm_tpu_torch.eval``) and its readers against the
JAX package's, on the ``synth_h5`` fixture (4 stations, 10 baselines, 4 patches each).

Both packages run ``baseline_distance_matrix(..., device_decode=False)`` (the host
decode; ``tests/test_torch_device_decode.py`` holds the device decode, the default)
from the port's weights bridged with ``params.to_flax``: latents
within 1e-5 and X within 1e-4 (relative to the largest value), the same soft
assignment.  Given JAX's distance matrix, the port's host stage gives the same labels,
an embedding within 1e-6 and the files JAX writes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lshm_tpu.eval.clustering as jclustering
from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.data import h5io as jh5io
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import h5io, synth_extract
from lshm_tpu_torch.eval import clustering
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.params import to_flax

MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4, rica=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on a few cores, and
    the many small operators here slow down badly when their threads oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


@pytest.fixture(scope="module")
def models():
    port = CascadedAE(tc.ModelConfig(**MODEL), generator=torch.Generator().manual_seed(4))
    port.eval()
    params = jax.tree.map(jnp.asarray, to_flax(port.state_dict()))
    return port, JCascadedAE(cfg=JModelConfig(**MODEL)), params


@pytest.fixture(scope="module")
def jax_matrix(models, synth_h5):
    _, jmodel, params = models
    return jclustering.baseline_distance_matrix(
        jmodel, params, synth_h5, "0", order=4, baselines_per_batch=4,
        device_decode=False)


def _port_matrix(port, source, **kw):
    kw = {"order": 4, "baselines_per_batch": 4, "device": "cpu", "device_decode": False,
          **kw}
    return clustering.baseline_distance_matrix(port, source, "0", **kw)


@pytest.mark.parametrize("source", ["path", "memory"])
def test_distance_matrix_matches_jax(models, jax_matrix, synth_h5, source):
    port = models[0]
    src = synth_h5 if source == "path" else synth_extract(nstations=4, ntime=192,
                                                          nfreq=192, seed=7)
    X, lat = _port_matrix(port, src)
    want_X, want_lat = jax_matrix
    assert X.shape == (4, 10) and lat.shape == (10, 32)
    assert _rel(lat, want_lat) < 1e-5
    assert _rel(X, want_X) < 1e-4
    np.testing.assert_array_equal(np.argmin(X, axis=0), np.argmin(want_X, axis=0))


def test_pipelined_matches_serial(models, synth_h5):
    port = models[0]
    ser_X, ser_lat = _port_matrix(port, synth_h5, decode_lookahead=0)
    for la in (1, 2, 4):
        X, lat = _port_matrix(port, synth_h5, decode_lookahead=la)
        np.testing.assert_array_equal(X, ser_X)
        np.testing.assert_array_equal(lat, ser_lat)


def test_chunk_sizes_agree(models, synth_h5):
    """1, 3 and 8 baselines a chunk (no padding of the tail chunk) and a subset of
    baseline ids give the same rows."""
    port = models[0]
    ref_X, ref_lat = _port_matrix(port, synth_h5, baselines_per_batch=10)
    for bpb in (1, 3, 8):
        X, lat = _port_matrix(port, synth_h5, baselines_per_batch=bpb)
        np.testing.assert_allclose(X, ref_X, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(lat, ref_lat, rtol=1e-5, atol=1e-6)
    X, lat = _port_matrix(port, synth_h5, baseline_ids=[7, 2, 9])
    np.testing.assert_allclose(X, ref_X[:, [7, 2, 9]], rtol=1e-5, atol=1e-6)


def test_host_stage_and_files_match_jax(models, jax_matrix, synth_h5, tmp_path,
                                        monkeypatch):
    """Both evaluate_sap calls take JAX's raw distance matrix: the port's t-SNE,
    scaling and agglomerative pass give JAX's labels and embedding, and the port
    writes the files JAX writes."""
    port, jmodel, params = models
    monkeypatch.setattr(jclustering, "baseline_distance_matrix",
                        lambda *a, **k: jax_matrix)
    monkeypatch.setattr(clustering, "baseline_distance_matrix",
                        lambda *a, **k: jax_matrix)
    want = jclustering.evaluate_sap(jmodel, params, synth_h5, "0", num_hard_clusters=3,
                                    out_dir=str(tmp_path / "jax"), montages=True)
    got = clustering.evaluate_sap(port, synth_h5, "0", num_hard_clusters=3,
                                  out_dir=str(tmp_path / "port"), montages=True,
                                  device="cpu")
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.soft_assign, want.soft_assign)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.embedding, want.embedding, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.X.mean(axis=1), 0.0, atol=1e-6)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert {"X.mat", "M.mat", "M.png", "scatter.png", "clusters.png"} <= set(files)
    assert len([f for f in files if f.startswith("b")]) == 10
    from scipy.io import loadmat

    for name in ("X", "M"):
        np.testing.assert_array_equal(loadmat(tmp_path / "port" / f"{name}.mat")[name],
                                      loadmat(tmp_path / "jax" / f"{name}.mat")[name])


def test_evaluate_sap_end_to_end(models, synth_h5):
    port = models[0]
    res = clustering.evaluate_sap(port, synth_h5, "0", num_hard_clusters=3,
                                  run_tsne=False, device="cpu")
    assert res.X.shape == (4, 10) and res.labels is None and res.embedding is None
    assert res.mean_latents.shape == (10, 32) and np.all(np.isfinite(res.X))


@pytest.mark.parametrize("fourier", [False, True], ids=["cascade", "fourier"])
def test_save_recon_panels(synth_h5, tmp_path, fourier):
    cfg = tc.ModelConfig(**MODEL, latent_dim_fourier=8, fourier_variant=fourier)
    port = CascadedAE(cfg, generator=torch.Generator().manual_seed(5))
    jmodel = JCascadedAE(cfg=JModelConfig(**MODEL, latent_dim_fourier=8,
                                          fourier_variant=fourier))
    params = jax.tree.map(jnp.asarray, to_flax(port.state_dict()))
    clustering.save_recon_panels(port, synth_h5, "0", [0, 3], str(tmp_path / "port"),
                                 device="cpu")
    jclustering.save_recon_panels(jmodel, params, synth_h5, "0", [0, 3],
                                  str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == ["xx_0.png", "xx_3.png"]


def test_nmi_matches_jax():
    a = np.array([0, 0, 1, 1, 2, 2])
    rng = np.random.default_rng(0)
    for b in (a, np.array([2, 2, 0, 0, 1, 1]), np.array([0, 1, 0, 1, 0, 1]),
              rng.integers(0, 3, 6)):
        assert clustering.nmi(a, b) == jclustering.nmi(a, b)
    assert clustering.nmi(a, a) == 1.0


@pytest.mark.parametrize("ids", [[0], [3, 1, 8]])
def test_readers_match_jax(synth_h5, ids):
    tree = synth_extract(nstations=4, ntime=192, nfreq=192, seed=7)
    want = jh5io.read_baselines_patches_batch(synth_h5, "0", ids, 128, 4, uvdist=True,
                                              give_baselines=True, use_native=False)
    for src in (synth_h5, tree):
        got = h5io.read_baselines_patches_batch(src, "0", ids, 128, 4, uvdist=True,
                                                give_baselines=True, use_native=False)
        assert got[:2] == want[:2]
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g, w)
        for b in ids:
            g1 = h5io.read_baseline_patches(src, "0", b, 128, 4, give_baseline=True,
                                            uvdist=True)
            w1 = jh5io.read_baseline_patches(synth_h5, "0", b, 128, 4, give_baseline=True,
                                             uvdist=True)
            assert g1[:2] == w1[:2] and g1[4] == w1[4]
            np.testing.assert_array_equal(g1[2], w1[2])
            np.testing.assert_array_equal(g1[3], w1[3])
            np.testing.assert_array_equal(h5io.read_baseline_flat(src, "0", b),
                                          jh5io.read_baseline_flat(synth_h5, "0", b))
