"""The arithmetic of the standalone first-stage kernel on the tensor cores (K6,
``lshm_tpu_torch/csrc/conv0.cu::conv0_tc_kernel``), in bfloat16 and float32, emulated
on the CPU and held against the probe's JAX reference ``conv0_xla``
(benchmarks/pallas_conv_probe.py:104, loaded by path), the plain version and float64.

The kernel computes elu(conv0(x) + b), k=4, s=2, p=1, C -> 8, as a product per m-tile
of 16 consecutive output pixels of one row: A is the implicit im2col of the input
window, its rows in (ky, kx, c) order, in k-steps of 16 (one per ky at C = 4, two at
C = 8); each k-step's product starts from zero and is added to the float32 sum in
k-step order; then the bias, elu in float32 and one rounding to the storage type.
bf16 operands are exact; float32 ones go in three exact bf16 pieces and each k-step
through the six piece pairs (``product`` with PAIRS6).  ``emulate`` repeats that sum.
``TileLayout`` transliterates the kernel's shared-memory addressing (the window's
pixel pairs as ldmatrix rows, the C = 8 swizzle) and the ldmatrix and mma fragment
semantics per lane, and runs one m-tile through them.

Measured on the CPU at the tests' seeds (relative to the largest magnitude):
- float32 against ``conv0_elu_plain``: 3.3e-7 (C = 4, P = 128) and 3.1e-7 (C = 8,
  P = 36); gate 1e-5.  Against float64: the emulation 1.2e-7 and 1.0e-7, the plain
  version 3.4e-7 and 3.9e-7; three piece pairs 5.2e-6 and 4.8e-6, more than twice
  the plain version's distance (the card's float64 rule), so they fail it;
- bf16 against ``conv0_elu_plain`` at B = 4, P = 128 (131,072 outputs), over eight
  seeds (the tests run four): 0 to 7 outputs differ at C = 4 (shares 0 to 5.3e-5) and
  2 to 8 at C = 8 (1.5e-5 to 6.1e-5), each by one bf16 ulp of its own value: a float32
  sum near a bf16 tie rounds the other way when summed in another order.
  SHARE_GATE, the card's gate too, is 1e-4.  From float64 (on the same bf16 inputs)
  the emulation and the plain version lie equally far, 2.4e-3 (C = 4) and 2.5e-3
  (C = 8): within half a bf16 ulp of the largest value.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lshm_tpu_torch.kernels import conv0 as k6
from tests.test_torch_head_bwd_f32_tc import PAIRS1, PAIRS3, PAIRS6, product

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F0 = 8
TOL_F32 = 1e-5               # chip_smoke.py's float32 K6 gate (relative)
F64_FACTOR = 2               # within twice the plain version's distance from float64
SHARE_GATE = 1e-4            # chip_smoke.py's bf16 gate: share of outputs that differ


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _fma(a, b, c) -> torch.Tensor:
    """fmaf on float32 values: the product exact in float64, the sum rounded to float32
    (through float64, so a tie may round twice; rare, and below the tests' tolerances)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


TAYLOR = (2.48015873e-5, 1.98412698e-4, 1.38888889e-3, 8.33333333e-3, 4.16666667e-2,
          1.66666667e-1, 0.5)                 # 1/8!, 1/7!, ..., 1/2 as the kernel has them


def elu_fast(a: torch.Tensor) -> torch.Tensor:
    """conv0.cu's elu_fast on float32 a, transliterated: expm1 of the non-positive part
    by t = rint(a log2 e) (the 1.5 * 2^23 addition), z = a - t ln2 (two parts) and a
    Taylor polynomial to z^8, scaled by 2^t; a itself where a > 0."""
    b = a.clamp(max=0.0).clamp(min=-87.0)
    r = _fma(b, _f32(1.44269504), _f32(12582912.0))
    t = r - _f32(12582912.0)
    z = _fma(t, _f32(-1.42860677e-6), _fma(t, _f32(-0.693145752), b))
    p = _f32(TAYLOR[0]).expand_as(z)
    for c in TAYLOR[1:]:
        p = _fma(p, z, _f32(c))
    p = _fma(p * z, z, z)
    s = torch.exp2(t)                         # 2^t, exact
    return torch.where(a <= 0, _fma(s, p, s - 1.0), a)


def emulate(x, w, b, pairs=None):
    """K6's sum on inputs of one dtype (x NHWC, w OIHW, b): NHWC [B, P/2, P/2, 8] in
    x's dtype.  bf16: exact bf16 products, one piece pair; float32: six pairs."""
    bf16 = x.dtype == torch.bfloat16
    pairs = pairs or (PAIRS1 if bf16 else PAIRS6)
    x, w, b = (t.float() for t in (x, w, b))
    B, P, _, C = x.shape
    H = P // 2
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = xp.unfold(1, 4, 2).unfold(2, 4, 2)              # [B, H, H, C, ky, kx]
    a = cols.permute(0, 1, 2, 4, 5, 3).reshape(B * H * H, 16 * C)   # (ky, kx, c)
    wk = w.permute(2, 3, 1, 0).reshape(16 * C, F0)
    y = elu_fast(product(a, wk, pairs) + b)
    return y.view(B, H, H, F0).to(torch.bfloat16 if bf16 else torch.float32)


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_probe", os.path.join(ROOT, "benchmarks", "pallas_conv_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(B, P, C, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, P, P, C)).astype(np.float32),
            (rng.normal(size=(F0, C, 4, 4)) * 0.1).astype(np.float32),
            (rng.normal(size=F0) * 0.1).astype(np.float32))


def _args(B, P, C, seed, dtype):
    return [torch.from_numpy(a).to(dtype) for a in _data(B, P, C, seed)]


def _f64(x, w, b):
    """elu(conv0(x) + b) in float64 on the same (bf16 or float32) inputs."""
    x, w, b = (t.double() for t in (x, w, b))
    y = F.elu(F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=2, padding=1))
    return y.permute(0, 2, 3, 1)


def _rel(a, b) -> float:
    a, b = (torch.as_tensor(t).double() for t in (a, b))
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _one_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def test_elu_fast_within_one_ulp_of_expm1():
    """The kernel's ELU against expm1 in float64 over [-100, 0] (uniform, log-spaced
    down to 1e-30, dense around the reduction's ln2 / 2): within 0.9 ulp, as expm1f's
    documented 1 ulp; positive values, -0.0 and NaN pass through as they are."""
    rng = np.random.default_rng(0)
    a = np.concatenate([-rng.uniform(0, 100, 200_000), -10 ** rng.uniform(-30, 0, 200_000),
                        -rng.uniform(0.3, 0.4, 100_000), -rng.uniform(0, 0.4, 100_000),
                        [0.0, -87.0, -87.5, -104.0, -1e-45]]).astype(np.float32)
    got = elu_fast(torch.from_numpy(a)).double().numpy()
    want = np.expm1(a.astype(np.float64))
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert float(np.max(np.abs(got - want) / ulp)) <= 0.9
    pos = torch.tensor([1e-30, 0.5, 3.0, float("inf"), float("nan")])
    assert torch.equal(elu_fast(pos)[:4], pos[:4]) and torch.isnan(elu_fast(pos)[4])


# ------------------------------------------------- the kernel's addressing, per lane

class TileLayout:
    """conv0.cu's shared-memory addressing for one C, in bytes of a bf16 window (or
    piece), transliterated: ``Cfg`` (R, the window's rows and row bytes), ``pix_off``,
    the warp's ``lane_off`` and ``base``."""

    TW, WW, WARPS, MCOLS = 64, 130, 8, 4

    def __init__(self, C: int):
        self.C = C
        self.R = 8 if C == 4 else 4
        self.rows = 2 * self.R + 2
        self.row_b = self.WW * C * 2
        self.rpw = self.R * self.MCOLS // self.WARPS
        self.steps = C // 4

    def pix_off(self, p: int) -> int:
        return 8 * p if self.C == 4 else 16 * (p ^ ((p >> 3) & 1))

    def lane_off(self, mcol: int, s: int, lane: int) -> int:
        j, kh = 16 * mcol + lane % 16, lane // 16
        return self.pix_off(2 * j + 2 * kh) if self.C == 4 else \
            self.pix_off(2 * j + 2 * s + kh)

    def window(self, img: np.ndarray) -> np.ndarray:
        """The window [rows, 130, C] (image rows and columns from -1, zeros outside)
        stored as the loads store it: one element per 2 bytes."""
        smem = np.full(self.rows * self.row_b // 2, np.nan)
        for r in range(self.rows):
            for p in range(self.WW):
                off = (r * self.row_b + self.pix_off(p)) // 2
                assert np.isnan(smem[off:off + self.C]).all(), "two pixels, one place"
                iy, ix = r - 1, p - 1
                inside = 0 <= iy < img.shape[0] and 0 <= ix < img.shape[1]
                smem[off:off + self.C] = img[iy, ix] if inside else 0.0
        assert not np.isnan(smem).any()
        return smem

    def ldsm_x4(self, smem: np.ndarray, addrs: list[int]) -> np.ndarray:
        """ldmatrix .x4: lane l gives the row address of row l % 8 of matrix l / 8;
        lane 4 g + q receives, from each matrix m, row g's elements 2q and 2q + 1.
        Returns [32 lanes, 4 registers, 2 elements]."""
        out = np.empty((32, 4, 2))
        for lane in range(32):
            g, q = divmod(lane, 4)
            for m in range(4):
                e = (addrs[8 * m + g] + 4 * q) // 2
                out[lane, m] = smem[e:e + 2]
        return out

    def bank_groups(self, addrs: list[int]) -> list[int]:
        """For each of the four matrices, the number of distinct 16-byte bank groups
        among its 8 row addresses (8: no bank conflict)."""
        return [len({(a // 16) % 8 for a in addrs[8 * m:8 * m + 8]}) for m in range(4)]


def _mma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k16 from zero on per-lane fragments (a [32, 4, 2], b [32, 2, 2]):
    D [16 x 8] as the lanes' c registers [32, 4]."""
    A, Bm = np.empty((16, 16)), np.empty((16, 8))
    for lane in range(32):
        g, q = divmod(lane, 4)
        A[g, 2 * q:2 * q + 2], A[g + 8, 2 * q:2 * q + 2] = a[lane, 0], a[lane, 1]
        A[g, 2 * q + 8:2 * q + 10], A[g + 8, 2 * q + 8:2 * q + 10] = a[lane, 2], a[lane, 3]
        Bm[2 * q:2 * q + 2, g], Bm[2 * q + 8:2 * q + 10, g] = b[lane, 0], b[lane, 1]
    D = A @ Bm
    return np.stack([np.concatenate([D[lane // 4, 2 * (lane % 4):2 * (lane % 4) + 2],
                                     D[lane // 4 + 8, 2 * (lane % 4):2 * (lane % 4) + 2]])
                     for lane in range(32)])


def _b_fragments(w: np.ndarray, C: int) -> np.ndarray:
    """conv0.cu's bw: per k-step s and lane (g, q), B[2q, 2q + 1][g] and B[2q + 8,
    2q + 9][g] with B[k][f] = w[f, k % C, tap = k / C] (w OIHW flattened to [8, C, 16])."""
    wf = w.reshape(F0, C, 16)
    W = lambda k, f: wf[f, k % C, k // C]          # noqa: E731
    out = np.empty((C, 32, 2, 2))
    for s in range(C):
        for lane in range(32):
            g, q = divmod(lane, 4)
            k = 16 * s + 2 * q
            out[s, lane] = [[W(k, g), W(k + 1, g)], [W(k + 8, g), W(k + 9, g)]]
    return out


def lane_tile(img: np.ndarray, w: np.ndarray, C: int, warp: int, group: int):
    """One warp's m-tiles of the tile at the image's corner, through the kernel's
    addresses and fragments, its output rows taken ``group`` at a time (bf16 two,
    float32 all of them): the pre-activations [rpw rows, 16 columns, 8] by output row
    of the warp and column of its m-tile, the m-tile column and the first row."""
    L = TileLayout(C)
    smem = L.window(img)
    bw = _b_fragments(w, C)
    mcol, row0 = warp % L.MCOLS, warp // L.MCOLS * L.rpw
    acc = np.zeros((L.rpw, 32, 4))
    for r0 in range(row0, row0 + L.rpw, group):
        base = 2 * r0 * L.row_b
        for r in range(2 * group + 2):
            a = [L.ldsm_x4(smem, [base + r * L.row_b + L.lane_off(mcol, s, lane)
                                  for lane in range(32)]) for s in range(L.steps)]
            for o in range(group):
                ky = r - 2 * o
                if 0 <= ky <= 3:
                    for s in range(L.steps):
                        acc[r0 - row0 + o] += _mma(a[s], bw[ky * L.steps + s])
    out = np.empty((L.rpw, 16, F0))
    for lane in range(32):
        g, q = divmod(lane, 4)
        for h in range(2):
            out[:, g + 8 * h, 2 * q:2 * q + 2] = acc[:, lane, 2 * h:2 * h + 2]
    return out, mcol, row0


@pytest.mark.parametrize("C", [4, 8])
def test_ldmatrix_rows_are_free_of_bank_conflicts(C):
    """Every matrix of every ldmatrix the warps issue reads 8 distinct bank groups:
    at C = 4 eight consecutive pairs, at C = 8 eight pixels 32 bytes apart through
    the swizzle.  Without the swizzle, C = 8 would conflict two ways."""
    L = TileLayout(C)
    for mcol in range(4):
        for s in range(L.steps):
            addrs = [L.lane_off(mcol, s, lane) for lane in range(32)]
            assert L.bank_groups(addrs) == [8, 8, 8, 8]
            assert all(a % 16 == 0 for a in addrs)
    if C == 8:
        plain = [16 * (2 * (lane % 16) + lane // 16) for lane in range(32)]
        assert L.bank_groups(plain) == [4, 4, 4, 4]


@pytest.mark.parametrize("C", [4, 8])
def test_float32_split_writes_the_pixel_layout(C):
    """A thread copies and splits the window a pixel pair at a time: pair i is raw's
    16-byte chunks [i C / 2, (i + 1) C / 2), and chunk h of it goes to r * row_b +
    pix_off(p + h / (C/4)) + 8 (h mod C/4) in each piece.  That is where the bf16 loads
    put the same channels (byte pix_off(p) + 2c of the row), and the pairs cover the
    window once."""
    L = TileLayout(C)
    seen = set()
    for i in range(L.rows * L.WW // 2):
        r, p = i // (L.WW // 2), 2 * (i % (L.WW // 2))
        for h in range(C // 2):
            chunk = i * (C // 2) + h
            off = r * L.row_b + L.pix_off(p + h // (C // 4)) + 8 * (h % (C // 4))
            pix, c0 = divmod(4 * chunk, C)           # raw is [rows][130][C] float32
            rr, pp = divmod(pix, L.WW)
            for e in range(4):
                assert off + 2 * e == rr * L.row_b + L.pix_off(pp) + 2 * (c0 + e)
                seen.add(off + 2 * e)
    assert seen == set(range(0, L.rows * L.row_b, 2))


@pytest.mark.parametrize("C, warp, group", [(4, 0, 2), (4, 7, 2), (4, 5, 4), (4, 3, 1),
                                            (8, 2, 2), (8, 5, 1)])
def test_one_warp_through_lane_fragments_matches_the_convolution(C, warp, group):
    """The warp's A rows (pixel pairs j, j + 1 of each input row), B fragments and C
    fragments give the convolution of the tile's corner, with the zero padding from
    the window's first row and column; its rows two at a time (bf16), all together
    (float32) or one at a time."""
    rng = np.random.default_rng(C + warp)
    L = TileLayout(C)
    img = rng.normal(size=(2 * L.R, 2 * L.TW, C))      # the tile's inputs, from (0, 0)
    w = rng.normal(size=(F0, C, 4, 4))
    got, mcol, row0 = lane_tile(img, w, C, warp, group)
    xp = np.pad(img, ((1, 1), (1, 1), (0, 0)))
    for o in range(L.rpw):
        for j in range(16):
            oy, ox = row0 + o, 16 * mcol + j
            patch = xp[2 * oy:2 * oy + 4, 2 * ox:2 * ox + 4]      # [ky, kx, c]
            want = np.einsum("yxc,fcyx->f", patch, w)
            np.testing.assert_allclose(got[o, j], want, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------ the arithmetic

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C, B, P", [(4, 2, 128), (8, 3, 36)])
def test_emulation_matches_the_probes_xla_reference(C, B, P, dtype):
    """Against conv0_xla in float32 on the same (bf16-rounded) inputs: float32 within
    1e-5; bf16, the reference rounded once to bf16, within one ulp of the largest."""
    x, w, b = _args(B, P, C, C + P, dtype)
    w4 = w.float().permute(2, 3, 1, 0).numpy()                        # HWIO
    want = np.asarray(_probe_module().conv0_xla(jnp.asarray(x.float().numpy()),
                                                jnp.asarray(w4), jnp.asarray(b.float().numpy())))
    got = emulate(x, w, b)
    assert got.shape == (B, P // 2, P // 2, F0) and got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        want_bf16 = torch.from_numpy(want.copy()).to(torch.bfloat16).float()
        assert float((got.float() - want_bf16).abs().max()) <= _one_ulp(
            float(want_bf16.abs().max()))


@pytest.mark.parametrize("C, B, P", [(4, 2, 128), (8, 3, 36)])
def test_float32_emulation_matches_plain_and_float64(C, B, P):
    x, w, b = _args(B, P, C, 10 + C + P, torch.float32)
    plain = k6.conv0_elu_plain(x, w, b)
    got = emulate(x, w, b)
    f64 = _f64(x, w, b)
    assert _rel(got, plain) <= TOL_F32
    assert _rel(got, f64) <= F64_FACTOR * _rel(plain, f64)


@pytest.mark.parametrize("C, B, P", [(4, 2, 128), (8, 3, 36)])
def test_three_pairs_fail_the_float64_rule(C, B, P):
    """A kernel that dropped hi.lo, mid.mid and lo.hi keeps only about 16 of float32's
    24 bits: farther from float64 than twice the plain version, though still within
    the 1e-5 parity gate's reach of it."""
    x, w, b = _args(B, P, C, 10 + C + P, torch.float32)
    f64 = _f64(x, w, b)
    plain = _rel(k6.conv0_elu_plain(x, w, b), f64)
    assert _rel(emulate(x, w, b, PAIRS3), f64) > F64_FACTOR * plain
    assert _rel(emulate(x, w, b, PAIRS6), f64) <= F64_FACTOR * plain


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("C", [4, 8])
def test_bf16_share_and_one_ulp_at_full_patch_size(C, seed):
    """The plain version sums in another order, so an output whose float32 sum lies
    near a bf16 tie may round the other way: a few outputs differ, by one ulp each,
    and both lie as close to float64."""
    x, w, b = _args(4, 128, C, 70 + C + 100 * seed, torch.bfloat16)
    plain = k6.conv0_elu_plain(x, w, b)
    got = emulate(x, w, b)
    diff = (got.float() - plain.float()).abs()
    assert float((got != plain).float().mean()) <= SHARE_GATE
    assert float(diff.max()) <= _one_ulp(float(plain.float().abs().max()))
    f64 = _f64(x, w, b)
    half_ulp = _one_ulp(float(f64.abs().max())) / 2 / float(f64.abs().max())
    assert _rel(got, f64) <= half_ulp and _rel(plain, f64) <= half_ulp


def test_bf16_share_gate_catches_a_rounded_preactivation():
    """A kernel that rounded the pre-activation to bf16 before the ELU (as a bf16
    convolution would) differs from the plain version in far more outputs."""
    x, w, b = _args(2, 64, 4, 5, torch.bfloat16)
    plain = k6.conv0_elu_plain(x, w, b)
    xf, wf = x.float(), w.float()
    a = F.conv2d(xf.permute(0, 3, 1, 2), wf, b.float(), stride=2, padding=1)
    twice = F.elu(a.to(torch.bfloat16).float()).permute(0, 2, 3, 1).to(torch.bfloat16)
    assert float((emulate(x, w, b) != plain).float().mean()) <= SHARE_GATE
    assert float((twice != plain).float().mean()) >= 100 * SHARE_GATE
