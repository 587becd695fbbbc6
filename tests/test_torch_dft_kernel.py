"""The Fourier cascade's DFT kernel (``lshm_tpu_torch/kernels/dft.py``) on the CPU: its
plain version, which repeats the CUDA kernel's arithmetic (packed channel pairs, the
four-step radix-2 split, the shift, the adjoint's Hermitian parts), against torch.fft
and against the dense path (``models/cascade.py::fft2_dense``), the adjoint identity,
the autograd function, the dispatch in ``fft2_shifted`` and the launch counters.  The
kernel itself runs on the card only (``chip_smoke.py``'s ``dft`` phase).

Tolerances: 1e-5 of the largest magnitude against torch.fft and the dense products
(measured at most 1.9e-7 and 5.1e-7); the adjoint identity to 1e-5 of |f(x)| |g|
(float32 rounding of both sides; measured at most 4.1e-9).
"""

import numpy as np
import pytest
import torch

from lshm_tpu_torch.kernels import add_launches, dft, launch_counts, reset_launches
from lshm_tpu_torch.models import cascade
from lshm_tpu_torch.models.cascade import dft_calls, dft_mats, fft2_dense, fft2_shifted

SHAPES = [(p, n, c) for p in (128, 64, 8) for n in (1, 3) for c in (4, 8)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / float(np.max(np.abs(b)))


def _inputs(p, n, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, p, p, c, generator=g), torch.randn(n, p, p, 2 * c, generator=g)


def _torch_fft(x):
    z = torch.fft.fftshift(torch.fft.fft2(x.double(), dim=(1, 2), norm="ortho"), dim=(1, 2))
    return torch.cat([z.real, z.imag], dim=-1)


def _torch_ifft(g):
    c = g.shape[-1] // 2
    z = torch.fft.ifftshift(torch.complex(g[..., :c].double(), g[..., c:].double()),
                            dim=(1, 2))
    return torch.fft.ifft2(z, dim=(1, 2), norm="ortho").real


def _dense_as_before(x):
    """The dense transform as the port computed it before the kernel: six products
    with ``dft_mats``, the cat and the roll."""
    n, h, w, c = x.shape
    Ch, Sh = dft_mats(h, x.dtype, x.device)
    Cw, Sw = dft_mats(w, x.dtype, x.device)
    xh = x.reshape(n, h, w * c)
    yre = (Ch @ xh).view(n * h, w, c)
    yim = (Sh @ xh).view(n * h, w, c)
    z = torch.cat([Cw @ yre - Sw @ yim, Sw @ yre + Cw @ yim], dim=-1).view(n, h, w, 2 * c)
    return torch.roll(z, (h // 2, w // 2), dims=(1, 2))


@pytest.mark.parametrize("p,n,c", SHAPES)
def test_plain_forward_matches_torch_fft_and_the_dense_path(p, n, c):
    x, _ = _inputs(p, n, c)
    got = dft.dft2_forward_plain(x)
    assert got.dtype == torch.float32 and got.shape == (n, p, p, 2 * c)
    assert _rel(got, _torch_fft(x)) <= 1e-5
    assert _rel(got, fft2_dense(x)) <= 1e-5
    assert torch.equal(dft.dft2_forward(x), got)        # the wrapper on the CPU


@pytest.mark.parametrize("p,n,c", SHAPES)
def test_plain_adjoint_matches_torch_ifft_and_the_dense_backward(p, n, c):
    x, g = _inputs(p, n, c, seed=1)
    got = dft.dft2_adjoint_plain(g)
    assert got.dtype == torch.float32 and got.shape == (n, p, p, c)
    assert _rel(got, _torch_ifft(g)) <= 1e-5
    xr = x.clone().requires_grad_()
    (dense,) = torch.autograd.grad(fft2_dense(xr), xr, g)
    assert _rel(got, dense) <= 1e-5
    assert torch.equal(dft.dft2_adjoint(g), got)


@pytest.mark.parametrize("p,c", [(128, 4), (64, 8), (8, 4), (8, 2)])
def test_adjoint_identity(p, c):
    """<f(x), g> = <x, f^T(g)>, both sides from the float32 plain versions."""
    x, g = _inputs(p, 2, c, seed=2)
    fx, ftg = dft.dft2_forward_plain(x), dft.dft2_adjoint_plain(g)
    lhs = float((fx.double() * g.double()).sum())
    rhs = float((x.double() * ftg.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * float(fx.double().norm() * g.double().norm())


def test_autograd_function_runs_the_adjoint_and_saves_nothing():
    x, g = _inputs(16, 2, 4, seed=3)
    xr = x.clone().requires_grad_()
    y = dft.dft2_shifted(xr)
    assert type(y.grad_fn).__name__ == "DFT2Backward"
    assert len(y.grad_fn.saved_tensors) == 0
    (got,) = torch.autograd.grad(y, xr, g)
    assert torch.equal(got, dft.dft2_adjoint_plain(g))
    assert torch.equal(y.detach(), dft.dft2_forward_plain(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_and_bf16_inputs_take_the_dense_path_bit_for_bit(monkeypatch, dtype):
    def refuse(x):
        raise AssertionError("the kernel's path was taken")

    monkeypatch.setattr(dft, "dft2_shifted", refuse)
    x, _ = _inputs(128, 2, 4, seed=4)
    x = x.to(getattr(torch, dtype))
    reset_launches()
    got = fft2_shifted(x)
    assert got.dtype == x.dtype
    assert torch.equal(got, _dense_as_before(x))
    assert torch.equal(got, fft2_dense(x))
    counts = launch_counts()
    assert counts["dft_fwd"] == 1 and counts["dft2_fwd"] == counts["dft2_adj"] == 0


def test_takes_what_the_kernel_computes():
    f32 = lambda *s: torch.empty(s)                                       # noqa: E731
    for shape in ((3, 128, 128, 4), (1, 64, 64, 8), (2, 8, 8, 2), (1, 16, 16, 4)):
        assert dft.takes(f32(*shape)), shape
    for shape in ((3, 12, 12, 4), (3, 128, 64, 4), (1, 256, 256, 4), (1, 4, 4, 4),
                  (2, 8, 8, 3), (2, 8, 8, 6), (2, 8, 8, 16), (8, 8, 4)):
        assert not dft.takes(f32(*shape)), shape
    assert not dft.takes(torch.empty(2, 8, 8, 4, dtype=torch.bfloat16))
    assert not dft.takes(torch.empty(2, 8, 8, 4, dtype=torch.float64))


@pytest.mark.parametrize("shape,error", [
    ((2, 12, 12, 4), ValueError), ((2, 16, 8, 4), ValueError), ((1, 256, 256, 4), ValueError),
    ((2, 4, 4, 4), ValueError), ((2, 8, 8, 3), ValueError), ((2, 8, 8, 6), ValueError),
    ((8, 8, 4), ValueError)])
def test_the_wrapper_refuses_other_sizes(shape, error):
    with pytest.raises(error):
        dft.dft2_forward(torch.zeros(shape))


def test_the_wrapper_refuses_other_dtypes_layouts_and_cotangents():
    with pytest.raises(TypeError):
        dft.dft2_forward(torch.zeros(2, 8, 8, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        dft.dft2_forward(torch.zeros(2, 8, 4, 8).transpose(2, 3))        # not contiguous
    with pytest.raises(ValueError):
        dft.dft2_adjoint(torch.zeros(2, 8, 8, 6))                        # 2C with C odd
    with pytest.raises(ValueError):
        dft.dft2_adjoint(torch.zeros(2, 8, 8, 12))                       # C = 6
    with pytest.raises(ValueError):
        dft.dft2_adjoint(torch.zeros(2, 12, 12, 8))


def test_launch_counters_are_distinct_from_the_transforms_calls():
    assert set(dft.launches).isdisjoint(dft_calls)
    reset_launches()
    counts = launch_counts()
    assert {"dft2_fwd", "dft2_adj", "dft_fwd", "dft_bwd"} <= set(counts)
    add_launches({"dft2_fwd": 1, "dft2_adj": 1, "dft_fwd": 1, "dft_bwd": 1})   # a replay
    assert all(launch_counts()[k] == 1 for k in ("dft2_fwd", "dft2_adj", "dft_fwd", "dft_bwd"))
    reset_launches()


def test_the_cascade_counts_forwards_and_backwards_on_the_dense_path():
    x, g = _inputs(8, 2, 4, seed=5)
    xr = x.clone().requires_grad_()
    reset_launches()
    (fft2_shifted(xr) * g).sum().backward()
    with torch.no_grad():
        cascade.fft2_shifted(x)
    counts = launch_counts()
    assert (counts["dft_fwd"], counts["dft_bwd"]) == (2, 1)
    assert counts["dft2_fwd"] == counts["dft2_adj"] == 0
