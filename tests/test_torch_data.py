"""Data layer of the PyTorch port against the JAX package: the in-memory synthetic
extract equals the H5 file the JAX generator writes, and the port's sampler draws
bit-identical minibatches (x, uv) from the same seed, through reseed() and skip()."""

import h5py
import numpy as np
import pytest
import torch

from lshm_tpu.config import DataConfig as JDataConfig
from lshm_tpu.data import MinibatchSampler as JSampler
from lshm_tpu.data.synthetic import write_synthetic_h5 as jax_write_h5
from lshm_tpu_torch.config import DataConfig
from lshm_tpu_torch.data import (
    MinibatchSampler,
    PrefetchIterator,
    compute_uv,
    read_metadata,
    scan_files,
    synth_extract,
    write_synthetic_h5,
)

SYNTH = dict(nstations=4, ntime=192, nfreq=192, seed=7)


@pytest.fixture(scope="module")
def jax_h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_data") / "L1.MS_extract.h5"
    return jax_write_h5(str(path), **SYNTH)


def _h5_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[...])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_synth_extract_equals_jax_h5(jax_h5):
    want = _h5_tree(jax_h5)
    got = _flat(synth_extract(**SYNTH))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_writer_round_trips(tmp_path, jax_h5):
    path = write_synthetic_h5(str(tmp_path / "L2.MS_extract.h5"), **SYNTH)
    want = _h5_tree(jax_h5)
    got = _h5_tree(path)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert scan_files(str(tmp_path)) == ([path], ["0"])


def test_readers_take_a_path_or_a_tree(jax_h5):
    tree = synth_extract(**SYNTH)
    assert read_metadata(tree, "0") == read_metadata(jax_h5, "0")
    ids = [0, 3, 7]
    np.testing.assert_array_equal(compute_uv(tree, "0", ids), compute_uv(jax_h5, "0", ids))


@pytest.mark.parametrize("augment", [False, True])
def test_sampler_stream_matches_jax(jax_h5, augment):
    jcfg = JDataConfig(batch_size=3, augment=augment)
    cfg = DataConfig(batch_size=3, augment=augment)
    j = JSampler([jax_h5], ["0"], jcfg, seed=5, use_native=False, process_index=0)
    t = MinibatchSampler([synth_extract(**SYNTH)], ["0"], cfg, seed=5, use_native=False)

    def same():
        a, b = j.sample(), t.sample()
        np.testing.assert_array_equal(b.x, a.x)
        np.testing.assert_array_equal(b.uv, a.uv)
        assert (b.patchx, b.patchy, b.num_baselines) == (a.patchx, a.patchy, a.num_baselines)

    same()                      # draw 1
    j.reseed(2), t.reseed(2)
    j.skip(2), t.skip(2)
    same()                      # draw 2: epoch 2, iteration 2
    same()                      # draw 3


def test_prefetch_on_cpu_yields_the_sampler_stream():
    cfg = DataConfig(batch_size=2)
    tree = synth_extract(**SYNTH)
    ref = MinibatchSampler([tree], ["0"], cfg, seed=1)
    with PrefetchIterator(MinibatchSampler([tree], ["0"], cfg, seed=1), 2, "cpu") as it:
        for _ in range(3):
            a, b = ref.sample(), next(it)
            assert isinstance(b.x, torch.Tensor)
            np.testing.assert_array_equal(b.x.numpy(), a.x)
            np.testing.assert_array_equal(b.uv.numpy(), a.uv)


def test_prefetch_surfaces_producer_errors():
    class Broken:
        def sample(self):
            raise OSError("disk gone")

    it = PrefetchIterator(Broken(), 1, "cpu")
    with pytest.raises(RuntimeError, match="prefetch failed"):
        next(it)
    it.close()
