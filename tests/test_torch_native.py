"""The port's native host decoder (``lshm_tpu_torch/native``) against the JAX package's
numpy path, modelled on ``tests/test_native.py``: the fused decode and patchify against
the numpy oracle (``lshm_tpu.data.patches.patchify``) at JAX's 1e-5, the clamp, the
batch reader on an H5 file and on an in-memory tree, the sampler's native stream against
JAX's numpy sampler with the rng in the same state after, ``patches_per_baseline``, and
the ``use_native`` rule (no compiler: numpy; a compiler that fails: raise).

The JAX package's own binding builds inside its tree; these tests never call it."""

import os
import re

import numpy as np
import pytest

from lshm_tpu.config import DataConfig as JDataConfig
from lshm_tpu.data import h5io as jh5io
from lshm_tpu.data.patches import patchify as jpatchify
from lshm_tpu.data.sampler import MinibatchSampler as JSampler
from lshm_tpu_torch import native
from lshm_tpu_torch.config import DataConfig
from lshm_tpu_torch.data import (MinibatchSampler, read_baselines_patches_batch,
                                 synth_extract)
from lshm_tpu_torch.kernels import _build

GATE = dict(rtol=1e-5, atol=1e-5)              # tests/test_native.py:45
SYNTH = dict(nstations=4, ntime=192, nfreq=192, seed=7)   # the synth_h5 fixture's


def _numpy_oracle(vis, scales, pols, patch, clamp, normalize):
    """The numpy pipeline (decode -> pad -> patchify -> clamp -> z-norm) of
    ``tests/test_native.py``, through the JAX package's ``patchify``."""
    nb, ntime, nfreq, _, _ = vis.shape
    x = np.zeros((nb, max(ntime, patch), max(nfreq, patch), 2 * len(pols)), np.float32)
    for i in range(nb):
        for ci, p in enumerate(pols):
            s = scales[i, :, p][None, :]
            x[i, :ntime, :nfreq, 2 * ci] = vis[i, :, :, p, 0].astype(np.float32) * s
            x[i, :ntime, :nfreq, 2 * ci + 1] = vis[i, :, :, p, 1].astype(np.float32) * s
    patches, dims = jpatchify(x, patch)
    patches = np.clip(patches, -clamp, clamp)
    if normalize:
        std = patches.std()
        patches = (patches - patches.mean()) / (std if std > 0 else 1.0)
    return patches, dims


def _inputs(ntime, nfreq, nb=3, seed=0):
    rng = np.random.default_rng(seed)
    vis = rng.integers(-127, 128, size=(nb, ntime, nfreq, 4, 2), dtype=np.int8)
    scales = rng.uniform(0.01, 2.0, size=(nb, nfreq, 4)).astype(np.float32)
    return vis, scales


@pytest.mark.parametrize("pols", [(0, 3), (0, 1, 2, 3)])
@pytest.mark.parametrize("tf", [(192, 192), (100, 256), (90, 90)])
def test_native_matches_numpy_oracle(pols, tf):
    vis, scales = _inputs(*tf)
    got, gdims = native.decode_patchify(vis, scales, pols, 128, 1e3, normalize=True)
    want, wdims = _numpy_oracle(vis, scales, pols, 128, 1e3, normalize=True)
    assert gdims == wdims and got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **GATE)


@pytest.mark.parametrize("pols", [(0, 3), (0, 1, 2, 3)])
def test_native_without_normalisation_is_bit_for_bit(pols):
    """Decode, pad, patchify and clamp alone make the same float32 products."""
    vis, scales = _inputs(100, 256)
    got, _ = native.decode_patchify(vis, scales, pols, 128, 50.0, normalize=False)
    want, _ = _numpy_oracle(vis, scales, pols, 128, 50.0, normalize=False)
    np.testing.assert_array_equal(got, want)


def test_native_clamp():
    vis = np.full((1, 128, 128, 4, 2), 100, np.int8)
    scales = np.full((1, 128, 4), 50.0, np.float32)  # values 5000 > clamp 1000
    got, _ = native.decode_patchify(vis, scales, (0, 3), 128, 1e3, normalize=False)
    assert got.max() == 1e3
    got, _ = native.decode_patchify(-vis, scales, (0, 3), 128, 1e3, normalize=False)
    assert got.min() == -1e3


def test_native_rejects_bad_shapes():
    vis, scales = _inputs(128, 128, nb=1)
    with pytest.raises(ValueError, match="scales"):
        native.decode_patchify(vis, scales[:, :64], (0, 3), 128, 1e3)
    with pytest.raises(ValueError, match="pols"):
        native.decode_patchify(vis, scales, (0, 4), 128, 1e3)


def test_library_is_built_in_the_port_tree():
    """The library sits in ``lshm_tpu_torch/_build`` under a digest name, built with
    JAX's flags (OpenMP with this compiler)."""
    lib = native.library()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    info = native.build_info()
    assert re.fullmatch(r"libpatchio-[0-9a-f]{16}\.so", info["library"])
    assert os.path.basename(path) == info["library"]
    assert {"-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp"} <= set(info["flags"])
    assert info["openmp"] and info["omp_threads"] >= 1


def test_a_compiler_without_openmp_builds_serially(monkeypatch, tmp_path):
    """A compiler whose installation lacks the OpenMP runtime (it refuses -fopenmp)
    builds the same source without it: the same floats before the z-norm, the z-norm
    within JAX's gate."""
    gxx = native.compiler()
    cxx = tmp_path / "c++-without-openmp"
    cxx.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] && "
                   "{ echo \"cannot read spec file 'libgomp.spec'\" >&2; exit 1; }; done\n"
                   f"exec {gxx} \"$@\"\n")
    cxx.chmod(0o755)
    vis, scales = _inputs(192, 192)
    want_raw, _ = native.decode_patchify(vis, scales, (0, 3), 128, 1e3, normalize=False)
    want, _ = native.decode_patchify(vis, scales, (0, 3), 128, 1e3)
    monkeypatch.setenv("CXX", str(cxx))
    info = native.build_info()
    assert not info["openmp"] and info["omp_threads"] == 1
    assert "-fopenmp" not in info["flags"]
    got_raw, _ = native.decode_patchify(vis, scales, (0, 3), 128, 1e3, normalize=False)
    got, _ = native.decode_patchify(vis, scales, (0, 3), 128, 1e3)
    np.testing.assert_array_equal(got_raw, want_raw)
    np.testing.assert_allclose(got, want, **GATE)


@pytest.mark.parametrize("kind", ["h5", "tree"])
@pytest.mark.parametrize("ids", [[0], [3, 1, 8]])
def test_batch_reader_native_equals_jax_numpy(synth_h5, kind, ids):
    """One native call per baseline keeps the z-norm per baseline: the port's native
    reader against JAX's numpy reader (patches 1e-5; uv and station pairs exactly), and
    against the port's own numpy path."""
    src = synth_h5 if kind == "h5" else synth_extract(**SYNTH)
    want = jh5io.read_baselines_patches_batch(synth_h5, "0", ids, uvdist=True,
                                              give_baselines=True, use_native=False)
    got = read_baselines_patches_batch(src, "0", ids, uvdist=True, give_baselines=True,
                                       use_native=True)
    mine = read_baselines_patches_batch(src, "0", ids, uvdist=True, give_baselines=True,
                                        use_native=False)
    assert got[:2] == want[:2]
    np.testing.assert_allclose(got[2], want[2], **GATE)
    np.testing.assert_allclose(got[2], mine[2], **GATE)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("augment", [False, True])
def test_sampler_native_matches_jax_numpy(synth_h5, augment):
    """The port's native sampler against JAX's ``use_native=False`` sampler from the same
    seed, through ``reseed`` and ``skip``: x within 1e-5, uv exactly, the rng in the same
    state after every draw."""
    j = JSampler([synth_h5], ["0"], JDataConfig(batch_size=3, augment=augment), seed=5,
                 use_native=False, process_index=0)
    t = MinibatchSampler([synth_extract(**SYNTH)], ["0"],
                         DataConfig(batch_size=3, augment=augment), seed=5, use_native=True)
    assert t.use_native

    def same():
        a, b = j.sample(), t.sample()
        np.testing.assert_allclose(b.x, a.x, **GATE)
        np.testing.assert_array_equal(b.uv, a.uv)
        assert (b.patchx, b.patchy, b.num_baselines) == (a.patchx, a.patchy, a.num_baselines)
        assert t.rng.bit_generator.state == j.rng.bit_generator.state

    same()
    j.reseed(2), t.reseed(2)
    j.skip(2), t.skip(2)
    same()
    same()


def test_sampler_twins_draw_the_same_stream():
    """Native and numpy twins of the port's sampler: the same minibatches within 1e-5,
    the same rng state after; native repeats bit for bit."""
    cfg = DataConfig(batch_size=4, augment=True)
    tree = synth_extract(**SYNTH)
    a, b, c = (MinibatchSampler([tree], ["0"], cfg, seed=9, use_native=u)
               for u in (True, False, True))
    for _ in range(3):
        x, y, z = a.sample(), b.sample(), c.sample()
        np.testing.assert_allclose(x.x, y.x, **GATE)
        np.testing.assert_array_equal(x.uv, y.uv)
        np.testing.assert_array_equal(x.x, z.x)
        assert a.rng.bit_generator.state == b.rng.bit_generator.state


@pytest.mark.parametrize("use_native", [True, False])
def test_patches_per_baseline(use_native):
    """Mirrors tests/test_data.py:148-173: 4 patches per baseline of 192 x 192, 8 with
    augment, uv constant within a baseline's group, the global z-norm."""
    tree = synth_extract(**SYNTH)
    mb = MinibatchSampler([tree], ["0"], DataConfig(batch_size=3), seed=0,
                          use_native=use_native).sample()
    assert mb.x.shape == (12, 128, 128, 4) and mb.uv.shape == (12, 2)
    assert mb.patches_per_baseline == 4
    assert abs(mb.x.mean()) < 1e-5 and abs(mb.x.std() - 1.0) < 1e-3
    for b in range(3):
        assert np.all(mb.uv[b * 4:(b + 1) * 4] == mb.uv[b * 4])
    mb = MinibatchSampler([tree], ["0"], DataConfig(batch_size=2, augment=True), seed=0,
                          use_native=use_native).sample()
    assert mb.x.shape[0] == 16 and mb.uv.shape[0] == 16
    assert mb.patches_per_baseline == 8


def test_default_is_native_where_a_compiler_is():
    assert native.available()
    tree = synth_extract(**SYNTH)
    assert MinibatchSampler([tree], ["0"], DataConfig(batch_size=2)).use_native


def test_without_a_compiler_none_chooses_numpy(monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    assert native.compiler() is None and not native.available()
    tree = synth_extract(**SYNTH)
    s = MinibatchSampler([tree], ["0"], DataConfig(batch_size=2), seed=1)
    assert s.use_native is False
    want = MinibatchSampler([tree], ["0"], DataConfig(batch_size=2), seed=1,
                            use_native=False).sample()
    np.testing.assert_array_equal(s.sample().x, want.x)
    got = read_baselines_patches_batch(tree, "0", [0, 2])
    np.testing.assert_array_equal(got[2], read_baselines_patches_batch(
        tree, "0", [0, 2], use_native=False)[2])
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        MinibatchSampler([tree], ["0"], DataConfig(batch_size=2), use_native=True)
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        read_baselines_patches_batch(tree, "0", [0], use_native=True)


def test_a_compiler_that_fails_raises(monkeypatch, tmp_path):
    """A compiler on the path that fails is an error with its output, under None as
    under True; never a fallback to numpy.  False still decodes in numpy."""
    cxx = tmp_path / "broken-c++"
    cxx.write_text("#!/bin/sh\necho 'broken compiler: no luck' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    assert native.available()
    tree = synth_extract(**SYNTH)
    for use_native in (None, True):
        with pytest.raises(RuntimeError, match="broken compiler: no luck"):
            MinibatchSampler([tree], ["0"], DataConfig(batch_size=2), use_native=use_native)
        with pytest.raises(RuntimeError, match="broken compiler: no luck"):
            read_baselines_patches_batch(tree, "0", [0], use_native=use_native)
    assert MinibatchSampler([tree], ["0"], DataConfig(batch_size=2),
                            use_native=False).sample().x.shape == (8, 128, 128, 4)
    assert not list(_build.BUILD_DIR.glob(f"*.{os.getpid()}.tmp"))
