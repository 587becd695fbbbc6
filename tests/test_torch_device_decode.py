"""The port's decode on the device (``lshm_tpu_torch.data.device_decode``, the raw sampler
path, ``DeviceDecodePrefetcher`` and the evaluation's ``device_decode=True``) against the
JAX package's (``lshm_tpu/data/device_decode.py``, ``sample_raw``), mirroring
``tests/test_device_decode.py``.  All on the CPU, from int8 and scales made with numpy
from a seed.

Tolerances: with the normalisation off the decode is exact (int8 -> float32, one
product with the scale, a pad, a clamp), so it equals JAX's bit for bit; the tensor
patchify equals ``patchify_jax`` bit for bit.  With the z-norm on, the mean and std are
summed in another order than XLA's: 1e-5 relative and 1e-5 absolute (measured: at most
2.1e-5 absolute on values up to 4.2, 0.53 of that gate; the eval decode at most 0.19 of
it, 0.14 where the clamp bites).  Against the numpy host path,
JAX's own gates: 2e-4 relative and 2e-5 absolute.  The evaluation: latents within 1e-5 and X
within 1e-4 (relative to the largest value) of JAX's, the same soft assignment, as in
``tests/test_torch_eval.py``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lshm_tpu.data.device_decode as jdd
import lshm_tpu.eval.clustering as jclustering
from lshm_tpu.config import DataConfig as JDataConfig
from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.data.patches import patchify_jax
from lshm_tpu.data.sampler import MinibatchSampler as JMinibatchSampler
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import (DeviceDecodePrefetcher, MinibatchSampler,
                                 PrefetchIterator, device_decode_patchify,
                                 device_decode_train, patchify_torch, synth_extract)
from lshm_tpu_torch.eval import clustering
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.params import to_flax
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.train import trainer as trainer_mod
from lshm_tpu_torch.utils import MetricLogger

TREE = synth_extract(nstations=4, ntime=192, nfreq=192, seed=7)   # synth_h5's contents
# (B, T, F): square; T != F with 2 x 4 patches; ragged, padded up to 128 in both
SHAPES = {"square": (3, 192, 192), "t_ne_f": (2, 192, 320), "ragged": (2, 100, 90)}
HOST_GATE = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several pytest workers on a few cores, and
    the many small operators here slow down badly when their threads oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(shape, seed=0):
    rng = np.random.default_rng(seed)
    b, t, f = shape
    vis = rng.integers(-127, 128, size=(b, t, f, 4, 2)).astype(np.int8)
    scales = rng.uniform(1e-3, 2.0, size=(b, f, 4)).astype(np.float32)
    flags = rng.random((b, 2)) < 0.5
    return vis, scales, flags


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_tensor_patchify_equals_patchify_jax(shape):
    b, t, f = SHAPES[shape]
    t, f = max(t, 128), max(f, 128)
    x = np.random.default_rng(1).normal(size=(b, t, f, 3)).astype(np.float32)
    got, grid = patchify_torch(torch.from_numpy(x), 128)
    want, jgrid = patchify_jax(jnp.asarray(x), 128)
    assert grid == jgrid
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spikes", [False, True])
@pytest.mark.parametrize("channels", [4, 8])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_patchify_decode_matches_jax(shape, channels, spikes):
    """With ``spikes``, 2 % of the scales are 2e4, as for channels hit by interference:
    their values reach 2.5e6, so the +-1e6 clamp bites."""
    vis, scales, _ = _raw(SHAPES[shape])
    if spikes:
        hit = np.random.default_rng(3).random(scales.shape) < 0.02
        scales = np.where(hit, np.float32(2e4), scales)
    got = device_decode_patchify(*_t(vis, scales), num_channels=channels)
    want = np.asarray(jdd.device_decode_patchify(
        jnp.asarray(vis), jnp.asarray(scales), num_channels=channels))
    assert got.shape == want.shape
    decoded = np.abs(vis.astype(np.float32) * scales[:, None, :, :, None])
    assert (decoded.max() > 1e6) == spikes
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


TRAIN_CASES = [(s, 4, n, a) for s in sorted(SHAPES) for n in (False, True)
               for a in (False, True)]
TRAIN_CASES += [("square", 8, False, True), ("t_ne_f", 8, True, True)]


@pytest.mark.parametrize("shape,channels,normalize,augment", TRAIN_CASES)
def test_train_decode_matches_jax(shape, channels, normalize, augment):
    vis, scales, flags = _raw(SHAPES[shape], seed=2)
    got = device_decode_train(*_t(vis, scales, flags), num_channels=channels,
                              normalize=normalize, augment=augment).numpy()
    want = np.asarray(jdd.device_decode_train(
        jnp.asarray(vis), jnp.asarray(scales), jnp.asarray(flags), num_channels=channels,
        normalize=normalize, augment=augment))
    assert got.shape == want.shape
    if normalize:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def _data_cfg(augment, **kw):
    return tc.DataConfig(batch_size=3, augment=augment, **kw)


@pytest.mark.parametrize("augment", [False, True])
def test_sample_raw_equals_jax(synth_h5, augment):
    """The same H5 file, the same seed: JAX's sample_raw and the port's draw the same
    bytes, scales, uv and flags, and leave the rng in the same state."""
    port = MinibatchSampler([synth_h5], ["0"], _data_cfg(augment), seed=11)
    jax_s = JMinibatchSampler([synth_h5], ["0"],
                              JDataConfig(data_dir=os.path.dirname(synth_h5), batch_size=3,
                                          augment=augment),
                              seed=11, use_native=False, process_index=0)
    for _ in range(3):
        got, want = port.sample_raw(), jax_s.sample_raw()
        for k in ("vis", "scales", "uv", "flip_flags"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
            assert getattr(got, k).dtype == getattr(want, k).dtype, k
        assert (got.patchx, got.patchy, got.num_baselines) == (
            want.patchx, want.patchy, want.num_baselines)
        assert port.rng.bit_generator.state == jax_s.rng.bit_generator.state


@pytest.mark.parametrize("augment", [False, True])
def test_sample_raw_stream_and_decode_equal_sample(augment):
    """After each of N draws, sample_raw() leaves the rng where sample() does, and its
    decode matches sample()'s minibatch (x within JAX's gates, uv exactly)."""
    s_host = MinibatchSampler([TREE], ["0"], _data_cfg(augment), seed=11)
    s_raw = MinibatchSampler([TREE], ["0"], _data_cfg(augment), seed=11)
    for _ in range(3):
        mb, raw = s_host.sample(), s_raw.sample_raw()
        assert s_host.rng.bit_generator.state == s_raw.rng.bit_generator.state
        x = device_decode_train(*_t(raw.vis, raw.scales, raw.flip_flags), clamp=1e3,
                                augment=augment).numpy()
        assert x.shape == mb.x.shape
        np.testing.assert_allclose(x, mb.x, **HOST_GATE)
        ppb = raw.patchx * raw.patchy * (2 if augment else 1)
        np.testing.assert_array_equal(np.repeat(raw.uv, ppb, axis=0), mb.uv)


def test_prefetcher_matches_host_sampler():
    s_host = MinibatchSampler([TREE], ["0"], _data_cfg(True), seed=3)
    s_raw = MinibatchSampler([TREE], ["0"], _data_cfg(True), seed=3)
    with DeviceDecodePrefetcher(s_raw, size=1, device="cpu") as pre:
        for _ in range(2):
            want, got = s_host.sample(), next(pre)
            np.testing.assert_allclose(got.x.numpy(), want.x, **HOST_GATE)
            np.testing.assert_array_equal(got.uv.numpy(), want.uv)
            assert (got.patchx, got.patchy) == (want.patchx, want.patchy)


def test_custom_augment_is_refused():
    def my_augment(rng, patches):
        rng.random()
        return patches

    s = MinibatchSampler([TREE], ["0"], _data_cfg(True), augment_fn=my_augment)
    assert not s.supports_device_decode
    with pytest.raises(RuntimeError, match="custom augment_fn"):
        s.sample_raw()
    with DeviceDecodePrefetcher(s, device="cpu") as pre:
        with pytest.raises(RuntimeError, match="prefetch failed") as err:
            next(pre)
    assert "custom augment_fn" in str(err.value.__cause__)
    assert MinibatchSampler([TREE], ["0"], _data_cfg(False),
                            augment_fn=my_augment).supports_device_decode


def _cfg(device_decode, prefetch=2, ckpt="", **train_kw):
    return tc.Config(
        data=tc.DataConfig(batch_size=2, augment=True, prefetch=prefetch,
                           device_decode=device_decode),
        model=tc.ModelConfig(latent_dim=8, latent_dim_1d=4, num_clusters=2),
        train=tc.TrainConfig(**{"num_epochs": 1, "iters_per_epoch": 2, "admm_iters": 1,
                                "checkpoint_dir": ckpt, **train_kw}),
    )


def _run(cfg, trainer=None):
    t = trainer or Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    t.run(MinibatchSampler([TREE], ["0"], cfg.data, seed=cfg.train.seed))
    return t


@pytest.mark.parametrize("device_decode,kind", [(None, PrefetchIterator),
                                                (False, PrefetchIterator),
                                                (True, DeviceDecodePrefetcher)])
def test_trainer_picks_the_decode(device_decode, kind):
    """On the CPU None means the host decode (on the card it means the device's)."""
    t = Trainer(_cfg(device_decode), device="cpu", logger=MetricLogger(echo=False))
    source = t._source(MinibatchSampler([TREE], ["0"], t.cfg.data))
    try:
        assert type(source) is kind
    finally:
        source.close()


def test_device_decode_requires_prefetch():
    with pytest.raises(ValueError, match="prefetch"):
        _run(_cfg(True, prefetch=0))


def test_trainer_device_decode_matches_host_decode():
    """JAX's gate (tests/test_device_decode.py): the last loss within 5e-3."""
    losses = {dd: _run(_cfg(dd)).logger.summary()["loss"] for dd in (False, True)}
    np.testing.assert_allclose(losses[True], losses[False], rtol=5e-3)


def _same_params(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_device_decode_resumes_bit_for_bit_mid_epoch(tmp_path):
    ckpt = str(tmp_path / "ck")
    cfg = _cfg(True, ckpt=ckpt, iters_per_epoch=3, save_every_iters=1)
    cfg_full = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir="", save_every_iters=0))
    full = _run(cfg_full)
    _run(cfg)
    t = Trainer(cfg_full, device="cpu", logger=MetricLogger(echo=False))
    t.load(ckpt, step=1)
    assert (t._resume_epoch, t._resume_iter) == (0, 1)
    _run(cfg_full, t)
    assert [h["iter"] for h in t.logger.history] == [1, 2]
    _same_params(full, t)


def test_host_checkpoint_resumed_with_device_decode_sees_the_same_stream(
        tmp_path, monkeypatch):
    """A run cut mid-epoch with the host decode and resumed with the device decode
    trains on the minibatches of the uninterrupted host-decode run (within the
    decodes' gates: a desynchronised stream would differ by O(1))."""
    seen = []
    real = trainer_mod.make_train_step

    def recording(cfg, nb):
        step = real(cfg, nb)

        def run(state, x, uv, w):
            seen.append(x.clone())
            return step(state, x, uv, w)

        return run

    monkeypatch.setattr(trainer_mod, "make_train_step", recording)
    ckpt = str(tmp_path / "ck")
    host = _cfg(False, ckpt=ckpt, num_epochs=2, save_every_iters=1)
    _run(host)
    stream = list(seen)                     # 4 minibatches, 2 epochs x 2
    seen.clear()
    dev = _cfg(True, num_epochs=2)
    t = Trainer(dev, device="cpu", logger=MetricLogger(echo=False))
    t.load(ckpt, step=1)                     # epoch 0, after its first minibatch
    _run(dev, t)
    assert len(seen) == 3
    for got, want in zip(seen, stream[1:]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **HOST_GATE)


MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=4, rica=True)


@pytest.fixture(scope="module")
def models():
    port = CascadedAE(tc.ModelConfig(**MODEL), generator=torch.Generator().manual_seed(4))
    port.eval()
    params = jax.tree.map(jnp.asarray, to_flax(port.state_dict()))
    return port, JCascadedAE(cfg=JModelConfig(**MODEL)), params


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def test_distance_matrix_device_decode_matches_jax(models, synth_h5):
    """Both packages decode on the device (the default); 10 baselines in chunks of 4, a
    tail chunk of 2 (JAX pads it, the port does not), serial and pipelined."""
    port, jmodel, params = models
    want_X, want_lat = jclustering.baseline_distance_matrix(
        jmodel, params, synth_h5, "0", order=4, baselines_per_batch=4, device_decode=True)
    for lookahead in (0, 2):
        X, lat = clustering.baseline_distance_matrix(
            port, synth_h5, "0", order=4, baselines_per_batch=4,
            decode_lookahead=lookahead, device="cpu")
        assert X.shape == (4, 10) and lat.shape == (10, 32)
        assert _rel(lat, want_lat) < 1e-5
        assert _rel(X, want_X) < 1e-4
        np.testing.assert_array_equal(np.argmin(X, axis=0), np.argmin(want_X, axis=0))
