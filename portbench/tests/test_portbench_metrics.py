"""The benchmark's metric arithmetic against hand-worked values."""

import math

import pytest

from portbench import readers, trace
from portbench.rooflines import PEAK_BYTES_S, PEAK_FLOP_S, bound_s
from portbench.rooflines import head, khm


def test_union_of_intervals():
    assert trace.union_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert trace.union_us([]) == 0.0
    assert trace.union_us([(3, 4), (0, 10)]) == 10.0


@pytest.mark.parametrize("name,cat", [
    ("khm_fwd_cluster_kernel", "port kernels"),
    ("lshm::reduce_partials_kernel", "port kernels"),
    ("cudnn::detail::dgrad_engine", "convolution"),
    ("sm80_xmma_fprop_implicit_gemm", "convolution"),
    ("ampere_sgemm_128x64_nn", "matrix product"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("at::native::vectorized_elementwise_kernel", "elementwise and reduction"),
    ("something_else", "other"),
])
def test_categories(name, cat):
    assert trace.category(name) == cat


def test_head_bounds_at_the_main_shapes():
    # K3 float32 at [420, 128, 128, 4]: 110.1 MB in + 20.6 MB out, bytes bound
    nbytes, flops = head.fwd(420, 128, 4, 4)
    assert nbytes == 4 * (420 * 128 * 128 * 4 + (8 * 64 + 8 + 12 * 128 + 12) + 420 * 32 * 32 * 12)
    assert flops == 2 * 420 * 64 * 64 * 8 * 64 + 2 * 420 * 32 * 32 * 12 * 128
    assert head.bound("fwd", 420, 128, 4, 4) == pytest.approx(nbytes / 3.35e12)
    assert head.bound("fwd", 420, 128, 4, 4) * 1e3 == pytest.approx(0.03903, rel=1e-3)
    # K4: both stages' forward, dW1, the stage-0 cotangent, dW0
    a0, a1 = 2 * 420 * 64 * 64 * 8 * 64, 2 * 420 * 32 * 32 * 12 * 128
    assert head.bwd(420, 128, 4, 4)[1] == 2 * a0 + 3 * a1
    # bf16 halves the bytes
    assert head.fwd(420, 128, 4, 2)[0] * 2 == nbytes


def test_khm_bounds():
    nbytes, flops = khm.fwd(420, 10, 256)
    assert nbytes == 4 * (420 * 256 + 10 * 256 + 421)
    assert khm.bound("fwd", 420, 10, 256) == pytest.approx(nbytes / PEAK_BYTES_S)
    assert bound_s(0, 989e12) == pytest.approx(1.0)
    assert PEAK_FLOP_S == 989e12


def _record(**kw):
    rec = {"admm_iters": 10, "window_units": 4, "window_s": 2.0,
           "flops": {"fwd": 1e10, "bwd": 2e10}, "sample_ms": 3.5,
           "profiled_units": 2,
           "stretch": {"wall_s": 1.3, "busy_s": 0.75,
                       "kernels": {"head_fwd_tc_kernel": [40, 0.01],
                                   "head_bwd_f32_tc_kernel": [20, 0.01],
                                   "reduce_partials_kernel": [20, 0.001],
                                   "khm_fwd_cluster_kernel": [20, 0.0002],
                                   "khm_bwd_cluster_kernel": [20, 0.0004],
                                   "cudnn::dgrad_engine": [100, 0.5]},
                       "categories": {"convolution": 0.5}},
           "head": {"batches": 420, "patch": 128, "channels": 4, "itemsize": 4},
           "khm": {"n": 420, "k": 10, "d": 256}}
    rec.update(kw)
    return rec


def test_readers():
    rec = _record()
    # 0.375 s busy a minibatch in the stretch, 0.5 s a minibatch in the untraced window;
    # the stretch's own (slowed) wall time is not read
    assert readers.idle_share(rec) == pytest.approx(25.0)
    assert readers.mfu(rec) == pytest.approx(100 * 4 * 10 * 3e10 / 2.0 / 989e12)
    least = 40 * head.bound("fwd", 420, 128, 4, 4) + 20 * head.bound("bwd", 420, 128, 4, 4)
    assert readers.head_roofline(rec) == pytest.approx(100 * least / 0.021)
    kl = 20 * khm.bound("fwd", 420, 10, 256) + 20 * khm.bound("bwd", 420, 10, 256)
    assert readers.khm_roofline(rec) == pytest.approx(100 * kl / 0.0006)
    assert readers.conv_ms_per_iter(rec) == pytest.approx(500.0 / 20)
    assert readers.launches_per_iter(rec) == pytest.approx(220 / 20)
    assert readers.sample_ms(rec) == 3.5


def test_readers_find_nothing_off_the_card():
    rec = _record(stretch={"wall_s": 1.0, "busy_s": 0.0, "kernels": {}, "categories": {}})
    for fn in (readers.idle_share, readers.head_roofline, readers.khm_roofline,
               readers.conv_ms_per_iter, readers.launches_per_iter):
        assert fn(rec) is None
    assert not math.isnan(readers.mfu(rec))
    assert readers.idle_share(_record(stretch=None)) is None
    assert readers.mfu(_record(window_units=0)) is None


def test_idle_gaps_named_by_the_innermost_host_op():
    kern = [(0, 10, "a"), (50, 60, "b"), (200, 210, "c")]
    host = [(0, 300, "outer"), (15, 45, "aten::item"), (100, 190, "aten::copy_")]
    gaps = dict(trace.idle_gaps(kern, host))
    assert gaps == {"aten::item": pytest.approx(40e-6), "aten::copy_": pytest.approx(140e-6)}


def test_kernel_families_match_by_base_name():
    """The profiler reports kernels with their namespaces and template arguments."""
    assert readers.base_name("tc::head_fwd_tc_kernel<4, float>") == "head_fwd_tc_kernel"
    assert readers.base_name("lshm::reduce_partials_kernel") == "reduce_partials_kernel"
    assert readers.base_name("khm_bwd_cluster_kernel<true>") == "khm_bwd_cluster_kernel"
    rec = _record()
    rec["stretch"]["kernels"] = {"tc::head_fwd_tc_kernel<4, float>": [40, 0.01],
                                 "tc::head_bwd_f32_tc_kernel": [20, 0.01],
                                 "lshm::reduce_partials_kernel": [20, 0.001]}
    least = 40 * head.bound("fwd", 420, 128, 4, 4) + 20 * head.bound("bwd", 420, 128, 4, 4)
    assert readers.head_roofline(rec) == pytest.approx(100 * least / 0.021)
