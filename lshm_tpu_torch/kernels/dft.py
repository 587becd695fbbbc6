"""The Fourier cascade's shifted orthonormal 2D DFT, forward and adjoint, as one CUDA
kernel each (``csrc/dft.cu``; its header comment gives the design and the bound).

Replaces no TPU kernel: the JAX package computes the transform with dense DFT matrices
(``lshm_tpu/models/cascade.py:66-90``), as ``models/cascade.py::fft2_shifted`` still does
off the card, in bfloat16 and at the shapes the kernel does not take.

    forward  x [N, P, P, C] -> [N, P, P, 2C]: fftshift(F x), real | imag channels
    adjoint  g [N, P, P, 2C] -> [N, P, P, C]: Re(F^H ifftshift(g_re + i g_im))

F is the orthonormal DFT over the two spatial axes; float32, P a power of two from 8 to
128, C in (2, 4, 8) (``takes``).  ``dft2_forward`` and ``dft2_adjoint`` are the kernel wrappers:
for a CUDA tensor they launch the kernel on the current stream (or raise), for a CPU
tensor they run the plain version beside them (``dft2_forward_plain``,
``dft2_adjoint_plain``), which repeats the kernel's arithmetic: two channels packed as
one complex plane, each axis's transform split as P = R1 R2 into radix-2 FFTs of R1 and
R2 points with the twiddles W_P^(n2 k1) between, the spectra separated by conjugate
symmetry (forward) or the Hermitian parts packed (adjoint), the 1/P scale and the shift.
``dft2_shifted`` is the autograd function: one launch forward, one backward, nothing
saved; the wrappers allocate the outputs only, so a CUDA graph can capture it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from lshm_tpu_torch.kernels import _build

# launches of each CUDA kernel since the last reset (kernels.reset_launches); keys of
# their own: models/cascade.py::dft_calls counts the transform's calls as dft_fwd and
# dft_bwd, and a shared key would be added twice on a graph's replay
launches = {"dft2_fwd": 0, "dft2_adj": 0}
MIN_P, MAX_P = 8, 128
CHANNELS = (2, 4, 8)               # a cluster of C / 2 CTAs a patch

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("dft")
    for fn in (lib.dft2_fwd, lib.dft2_adj):
        fn.argtypes = [_P, _I, _I, _I, _P, _P]
        fn.restype = _I
    return lib


def _fits(h: int, w: int, c: int) -> bool:
    return h == w and MIN_P <= h <= MAX_P and h & (h - 1) == 0 and c in CHANNELS


def takes(x: torch.Tensor) -> bool:
    """Whether the kernel computes the transform of ``x``: float32 NHWC [N, P, P, C]
    with P a power of two in [MIN_P, MAX_P] and C in ``CHANNELS`` (any device)."""
    return x.dim() == 4 and x.dtype == torch.float32 and _fits(*x.shape[1:])


def _check(name: str, t: torch.Tensor, per: int) -> None:
    """Raise unless the kernel takes ``t``, whose last dim is ``per`` times C."""
    if t.dim() != 4:
        raise ValueError(f"{name}: the DFT kernel takes NHWC [N, P, P, C], got "
                         f"{tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the DFT kernel takes float32, got {t.dtype}")
    _, h, w, c = t.shape
    if c % per or not _fits(h, w, c // per):
        raise ValueError(f"{name}: the DFT kernel takes P x P with P a power of two in "
                         f"[{MIN_P}, {MAX_P}] and C in {CHANNELS} ({per} C channels), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the DFT kernel takes a contiguous tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


# ------------------------------------------------------------------ plain versions

def radices(p: int) -> tuple[int, int]:
    """(R1, R2): the four-step split P = R1 R2 of each axis, R1 >= R2."""
    r1 = 1 << (p.bit_length() // 2)
    return r1, p // r1


@functools.cache
def _roots(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i m / n), m in [0, n), from float64, each part rounded once to
    float32 (the kernel's W_P^m table and its 16th roots of unity), on ``device``."""
    m = torch.arange(n)
    ang = m.double() * (2.0 * math.pi / n)
    c, s = torch.cos(ang), torch.sin(ang)
    quarter = (4 * m) % n == 0                   # exactly 0 and +-1 there, as sincospi
    c[quarter], s[quarter] = c[quarter].round(), s[quarter].round()
    return torch.complex(c.float(), -s.float()).to(device)


def _bit_reversed(r: int) -> list[int]:
    bits = r.bit_length() - 1
    return [int(f"{k:0{bits}b}"[::-1], 2) if bits else 0 for k in range(r)]


def _fft_reg(v: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The radix-2 FFT over the last dim (R points), decimation in frequency, as the
    kernel's ``fft_reg``; returned in natural order."""
    r = v.shape[-1]
    lead = v.shape[:-1]
    half = r // 2
    while half >= 1:
        w = _roots(16, v.device)[torch.arange(half, device=v.device) * (8 // half)]
        if inverse:
            w = w.conj()
        v = v.reshape(*lead, r // (2 * half), 2, half)
        a, b = v[..., 0, :], v[..., 1, :]
        v = torch.stack([a + b, (a - b) * w], dim=-2).reshape(*lead, r)
        half //= 2
    return v[..., _bit_reversed(r)]


def _fft_axis(z: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    """The unnormalised DFT (inverse: conjugate twiddles) along ``axis`` of complex z,
    by the kernel's split: over n1 of the points R2 n1 + n2, W_P^(n2 k1), over n2."""
    z = z.movedim(axis, -1)
    p = z.shape[-1]
    r1, r2 = radices(p)
    lead = z.shape[:-1]
    v = _fft_reg(z.reshape(*lead, r1, r2).transpose(-1, -2), inverse)     # [n2, k1]
    tw = _roots(p, z.device)[torch.outer(torch.arange(r2), torch.arange(r1)).to(z.device)]
    v = v * (tw.conj() if inverse else tw)
    v = _fft_reg(v.transpose(-1, -2), inverse)                              # [k1, k2]
    return v.transpose(-1, -2).reshape(*lead, p).movedim(-1, axis)          # k1 + R1 k2


def _mirror(t: torch.Tensor) -> torch.Tensor:
    """t at (-h, -w) mod P on axes 1 and 2."""
    return torch.roll(t.flip(1, 2), (1, 1), dims=(1, 2))


def dft2_forward_plain(x: torch.Tensor) -> torch.Tensor:
    """The forward with the kernel's arithmetic, in plain PyTorch."""
    n, p, _, c = x.shape
    z = _fft_axis(_fft_axis(torch.complex(x[..., 0::2], x[..., 1::2]), 2, False), 1, False)
    m = _mirror(z)
    s = 0.5 / p
    re = torch.stack([s * (z.real + m.real), s * (z.imag + m.imag)], -1)
    im = torch.stack([s * (z.imag - m.imag), s * (m.real - z.real)], -1)
    out = torch.cat([re.reshape(n, p, p, c), im.reshape(n, p, p, c)], dim=-1)
    return torch.roll(out, (p // 2, p // 2), dims=(1, 2))


def dft2_adjoint_plain(g: torch.Tensor) -> torch.Tensor:
    """The adjoint with the kernel's arithmetic, in plain PyTorch."""
    n, p, _, c2 = g.shape
    c = c2 // 2
    g = torch.roll(g, (-(p // 2), -(p // 2)), dims=(1, 2))
    re, im = g[..., :c], g[..., c:]
    rm, imm = _mirror(re), _mirror(im)
    ar, br, ai, bi = re[..., 0::2], re[..., 1::2], im[..., 0::2], im[..., 1::2]
    amr, bmr, ami, bmi = rm[..., 0::2], rm[..., 1::2], imm[..., 0::2], imm[..., 1::2]
    y = torch.complex(0.5 * ((ar + amr) - (bi - bmi)), 0.5 * ((ai - ami) + (br + bmr)))
    y = _fft_axis(_fft_axis(y, 2, True), 1, True)
    return torch.stack([y.real / p, y.imag / p], -1).reshape(n, p, p, c)


# ---------------------------------------------------------------- kernel wrappers

def _launch(name: str, t: torch.Tensor, out: torch.Tensor, c: int) -> torch.Tensor:
    """Launch ``name`` (``dft2_fwd`` or ``dft2_adj``) from t into out for C = c."""
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(_lib(), name)(t.data_ptr(), t.shape[0], t.shape[1], c,
                                           out.data_ptr(), stream), name)
    launches[name] += 1
    return out


def dft2_forward(x: torch.Tensor) -> torch.Tensor:
    """[N, P, P, 2C]: the kernel for a CUDA tensor, the plain version on the CPU."""
    _check("x", x, 1)
    if x.device.type == "cpu":
        return dft2_forward_plain(x)
    n, p, _, c = x.shape
    return _launch("dft2_fwd", x, torch.empty((n, p, p, 2 * c), dtype=x.dtype,
                                              device=x.device), c)


def dft2_adjoint(g: torch.Tensor) -> torch.Tensor:
    """[N, P, P, C] for the cotangent g [N, P, P, 2C]."""
    _check("g", g, 2)
    if g.device.type == "cpu":
        return dft2_adjoint_plain(g)
    n, p, _, c2 = g.shape
    return _launch("dft2_adj", g, torch.empty((n, p, p, c2 // 2), dtype=g.dtype,
                                              device=g.device), c2 // 2)


class DFT2(torch.autograd.Function):
    """The transform with the adjoint as its backward; nothing saved (it is linear)."""

    @staticmethod
    def forward(ctx, x):
        return dft2_forward(x)

    @staticmethod
    def backward(ctx, g):
        return dft2_adjoint(g.contiguous())


def dft2_shifted(x: torch.Tensor) -> torch.Tensor:
    """fftshift(F x) as real | imag channels, differentiable; x as ``takes`` says."""
    return DFT2.apply(x)
