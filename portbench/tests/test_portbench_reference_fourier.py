"""The benchmark's own pieces of the Fourier cell on the CPU: the reference's weights
and Adam continuation, the cell's files resolved by name, and the DFT's bounds, model
FLOPs and metric readers against hand-worked values.  The port against the plain
Fourier reference: tests/test_torch_fourier_reference.py."""

import dataclasses

import pytest
import torch

from portbench import data, spec
from portbench.reference import fourier
from portbench.reference.model import Precision, Weights
from portbench.reference.rebound import rebound
from portbench.rooflines import PEAK_BYTES_S, dft, model_flops_fourier
from portbench.weights_fourier import init_params, shape_of

SEED = 2**31 + 77
CELL = "fourier_cascade.adam"


@pytest.fixture(scope="module")
def batch():
    tree = data.synth_sap(3, 192, 128, SEED, "cpu")
    ids = [1, 4]
    g = data.sap(tree)
    x = data.decode(torch.from_numpy(g["visibilities"][ids]),
                    torch.from_numpy(g["visibility_scale_factors"][ids]), 128, 1e3)
    uv = torch.from_numpy(data.uv_of(tree, ids)).repeat_interleave(2, dim=0)
    return x, uv


def _cfg():
    from lshm_tpu_torch.config import preset

    return preset("fourier_cascade")


def _shape():
    return shape_of(dataclasses.asdict(_cfg().model))


def test_shape_of_refuses_the_1d_cascade():
    with pytest.raises(ValueError):
        shape_of({"fourier_variant": False})


def test_adam_from_moments_continues_the_trajectory(batch):
    x, uv = batch
    s = _shape()
    p = init_params(s, SEED, "cpu")
    run = lambda p0, bs, moments=None: fourier.adam(p0, bs, list(p), s, Weights(), 2, 2,
                                                    1e-4, Precision(), moments)
    whole = run(p, [(x, uv)] * 2)
    one = run(p, [(x, uv)])
    rest = run(one.params, [(x, uv)], one.moments)
    torch.testing.assert_close(rest.losses[0], whole.losses[1], rtol=0, atol=0)
    for n in p:
        torch.testing.assert_close(rest.params[n], whole.params[n], rtol=0, atol=0)


def test_the_cell_resolves_to_its_files():
    from lshm_tpu_torch.config import preset

    c = spec.cell(CELL, spec.benchmark())
    assert spec.driver(c.traffic).__name__ == "portbench.drivers.trainer_fourier"
    assert c.traffic["driver"] == "trainer_fourier" and c.config["name"] == "fourier_cascade"
    assert c.config["reduced"] == [] and c.entry["chips"] == 1
    assert spec.port_config(spec.resolved(c.config)).model == preset("fourier_cascade").model
    assert set(c.limits) == {"loss_gap", "grad_gap", "step_gap", "late_loss_gap",
                             "late_step_gap"}
    names = {m["name"] for m in c.per_layer}
    assert {"dft_ms_per_iter.train", "dft_roofline.train", "mfu.train",
            "khm_roofline.train", "head_roofline.train"} <= names
    # trace.py files the DFT's cuBLAS products (named xmma) under convolution
    assert "conv_ms_per_iter.train" not in names
    assert {m["name"] for m in c.end_to_end} == {"train_patches_per_s", "setup_s"}


def test_rebound_swaps_only_the_names_given():
    def f():
        return Precision, Weights

    assert rebound(f, Weights=int)() == (Precision, int)
    with pytest.raises(KeyError):
        rebound(f, no_such_name=1)


def test_dft_bounds_at_the_cell_shapes():
    # 420 patches of 128 x 128 x 4: 110.1 MB in, 220.2 MB out, 42.28 GFLOP, bytes-bound
    nbytes, flops = dft.fwd(420, 128, 4, 4)
    assert nbytes == 4 * 420 * 128 * 128 * 12
    # C_h, S_h over [128, 512] a patch; C_w, S_w on both over 128 rows of [128, 4]
    assert flops == 420 * 2 * (2 * 128 * 128 * 512 + 4 * 128 * 128 * 4 * 128)
    assert dft.bwd(420, 128, 4, 4) == (nbytes, flops)
    assert dft.bound("fwd", 420, 128, 4, 4) == pytest.approx(nbytes / PEAK_BYTES_S)
    assert dft.bound("fwd", 420, 128, 4, 4) * 1e3 == pytest.approx(0.0986, rel=1e-3)


def test_model_flops_count_the_transform_as_an_fft_once_each_way():
    # 5 N log2 N a complex N-point FFT: N = 128 * 128 points, 4 channels a patch
    transform = model_flops_fourier.fft2(4, 128, 4)
    assert transform == 4 * 4 * 5 * 128 * 128 * 14
    s = _shape()
    names = [n for n, _, _ in fourier.param_spec(s)]
    with_ae2d = model_flops_fourier.count(s, 4, 128, 2, names)
    without = model_flops_fourier.count(s, 4, 128, 2, [n for n in names if n.startswith("aef.")])
    cascade_only = model_flops_fourier.count(s, 4, 128, 2, [], loss=False)
    assert with_ae2d["fwd"] == without["fwd"] > cascade_only["fwd"] > transform
    # the backward reaches the transform only through the 2D AE's parameters; the
    # difference also holds the 2D AE's own gradients
    assert with_ae2d["bwd"] - without["bwd"] > transform
    assert model_flops_fourier.count(s, 4, 128, 2, [])["bwd"] == 0.0


def _record(**stretch):
    base = {"wall_s": 1.0, "busy_s": 0.9, "categories": {},
            "kernels": {"dft_tc_kernel<float>": [60, 0.012], "cudnn::dgrad_engine": [100, 0.5]},
            "dft_calls": {"dft_fwd": 40, "dft_bwd": 20}}
    base.update(stretch)
    return {"admm_iters": 10, "profiled_units": 2, "stretch": base,
            "dft": {"batches": 420, "patch": 128, "channels": 4, "itemsize": 4}}


def test_dft_readers():
    ms = spec.reader("dft_ms_per_iter.train")
    share = spec.reader("dft_roofline.train")
    rec = _record()
    assert ms(rec) == pytest.approx(12.0 / 20)
    least = 60 * dft.bound("fwd", 420, 128, 4, 4)
    assert share(rec) == pytest.approx(100 * least / 0.012)
    # the parent's port has no counters: the share reads nothing, the time still reads
    assert share(_record(dft_calls=None)) is None and ms(_record(dft_calls=None)) == ms(rec)
    # no DFT kernel in the stretch, or no stretch: nothing
    none = _record(kernels={"cudnn::dgrad_engine": [100, 0.5]})
    assert ms(none) is None and share(none) is None
    assert ms({**rec, "stretch": None}) is None and share({**rec, "stretch": None}) is None
