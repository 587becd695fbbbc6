"""The arithmetic of the float32 weight-gradient kernel (K4 float32,
``lshm_tpu_torch/csrc/conv_head.cu::head_bwd_f32_tc_kernel``), emulated in PyTorch on
the CPU and held against the plain version, the JAX head and the head in float64.

The kernel is K4 bf16's decomposition (``tests/test_torch_head_bwd_tc.py``: tiles,
stage-0 rows in four parity classes, the d e0 gather as a product) with every float32
operand in three exact bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo = the rest:
the window x, w0, w1, e0 (not rounded to bf16), dpre1 and dpre0.  Each product of two
split operands runs, per k-step of 16, the six piece pairs of order 2^-16 and above:
hi.hi into a partial from zero, hi.mid, hi.lo, mid.hi, mid.mid and lo.hi chained into a
second partial from zero, and their sum added to the float32 sum.  ``product`` below
forms every sum that way (one piece-pair product of 16 terms is exact in float32 but
for its one rounding, as on the tensor cores, up to their truncation):
- stage 0  a0 = A0 [384 x 16C] W0, k-steps over (ky, kx, c);
- stage 1  a1 = A1 [64 x 128] W1 [128 x 16], k-steps of two taps by f0;
- dW1     += A1^T dpre1, k-steps of 16 stage-1 outputs;
- d e0     per class, one k-step (the 16 padded f1) per tap slot, four slots summed;
- dW0     += A0^T dpre0, k-steps of one class m-tile of 16 positions.

Errors measured on the CPU (relative to the largest magnitude of each gradient, worst
of dW0, db0, dW1, db1, at the tests' seeds):
- against ``head_grads_plain`` in float32: 4.9e-7 (C = 4, P = 32), 9.4e-7 (C = 8),
  4.8e-7 (C = 4, P = 36, a ragged edge of stage-1 tiles); the gate is the card's 2e-5;
- against the JAX head (Pallas in interpret mode, float32, C = 4): 4.1e-7;
- against the head in float64: the emulation 1.7e-7 (C = 4) and 1.8e-7 (C = 8), the
  plain float32 version 5.0e-7 and 4.3e-7; at another seed six pairs 2.1e-7, all nine
  1.5e-7, the plain version 5.5e-7, the three pairs hi.hi, hi.mid, mid.hi 1.4e-5 (3.0e-5
  at a third seed, outside the gate).  One stage-0 product (M 384, K 64, N 8) alone:
  hi.hi 2.4e-3, three pairs 5.4e-6, six 7.9e-8, nine 7.9e-8, a float32 product 2.4e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv_head as tk
from tests.test_torch_head_bwd_tc import (
    CLASS_ROWS,
    F0,
    F1,
    F1P,
    T0,
    T1,
    XW,
    _class_rows,
    _data,
    _elu_grad,
    _rel,
    split,
)

TOL_GATE = 2e-5                  # chip_smoke.py's gate on float32 K4
F64_FACTOR = 2                   # and its gate: within twice the plain version's
                                 # distance from the float64 head
PAIRS1 = ((0, 0),)
PAIRS3 = ((0, 0), (0, 1), (1, 0))
PAIRS6 = ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (2, 0))   # the kernel's, in its order
PAIRS9 = PAIRS6 + ((1, 2), (2, 1), (2, 2))


def product(a: torch.Tensor, b: torch.Tensor, pairs=PAIRS6) -> torch.Tensor:
    """a [..., M, K] @ b [..., K, N] as the kernel sums it: per k-step of 16, the
    piece pairs (i, j) of a and b, the first (hi.hi) into a partial from zero, the rest
    chained into a second, their sum added to the float32 sum."""
    pa, pb = split(a), split(b)
    acc = None
    for k0 in range(0, a.shape[-1], 16):
        parts = [pa[i][..., k0:k0 + 16] @ pb[j][..., k0:k0 + 16, :] for i, j in pairs]
        lo = torch.zeros_like(parts[0])
        for p in parts[1:]:
            lo = lo + p
        step = parts[0] + lo
        acc = step if acc is None else acc + step
    return acc


def emulate(x, w0, b0, w1, b1, g1, pairs=PAIRS6):
    """K4 float32's decomposition on float32 inputs (x NHWC, weights OIHW, g1 NHWC):
    (dW0, db0, dW1, db1)."""
    B, P, _, C = x.shape
    H0, H1 = P // 2, P // 4
    tps = -(-H1 // T1)

    # windows [ntiles, 38, 38, C]; the zero padding is the loads outside the image
    hi = 32 * tps + 3 - P
    xp = F.pad(x, (0, 0, 3, hi, 3, hi))
    win = xp.unfold(1, XW, 32).unfold(2, XW, 32).permute(0, 1, 2, 4, 5, 3)
    win = win.reshape(-1, XW, XW, C)
    nt = win.shape[0]
    ty = torch.arange(tps).repeat_interleave(tps).repeat(B)
    tx = torch.arange(tps).repeat(B * tps)

    valid, py, px, prow, tap = _class_rows()
    valid_t, py_t, px_t = (torch.from_numpy(a) for a in (valid, py, px))

    # stage 0, rows in class order; k = (ky, kx, c); e0 not rounded
    ky, kx, c = np.meshgrid(np.arange(4), np.arange(4), np.arange(C), indexing="ij")
    ky, kx, c = ky.ravel(), kx.ravel(), c.ravel()
    rows_y = torch.from_numpy(2 * py[:, None] + ky[None])
    rows_x = torch.from_numpy(2 * px[:, None] + kx[None])
    chans = torch.from_numpy(np.tile(c, (len(py), 1)))
    a0_op = win[:, rows_y, rows_x, chans]
    W0 = w0.permute(2, 3, 1, 0).reshape(16 * C, F0)
    a0 = product(a0_op, W0, pairs) + b0
    y0 = 16 * ty[:, None] - 1 + py_t[None]
    x0 = 16 * tx[:, None] - 1 + px_t[None]
    inside = valid_t[None] & (y0 >= 0) & (y0 < H0) & (x0 >= 0) & (x0 < H0)
    e0 = torch.where(inside[..., None], F.elu(a0), 0.0)
    d0 = torch.where(inside[..., None], _elu_grad(a0), 0.0)

    e0t = torch.zeros(nt, T0 * T0, F0)
    e0t[:, torch.from_numpy(py * T0 + px)[valid_t]] = e0[:, valid_t]
    e0t = e0t.view(nt, T0, T0, F0)

    # stage 1; k = (ky, kx, f0)
    oyl, oxl = np.divmod(np.arange(T1 * T1), T1)
    tky, tkx = np.divmod(np.arange(16), 4)
    a1_op = e0t[:, torch.from_numpy(2 * oyl[:, None] + tky[None]),
                torch.from_numpy(2 * oxl[:, None] + tkx[None])]
    a1_op = a1_op.reshape(nt, T1 * T1, 16 * F0)
    W1 = F.pad(w1.permute(2, 3, 1, 0).reshape(16 * F0, F1), (0, F1P - F1))
    a1 = product(a1_op, W1, pairs) + F.pad(b1, (0, F1P - F1))
    oy = T1 * ty[:, None] + torch.from_numpy(oyl)[None]
    ox = T1 * tx[:, None] + torch.from_numpy(oxl)[None]
    in1 = (oy < H1) & (ox < H1)
    g1t = F.pad(g1, (0, F1P - F1, 0, T1 * tps - H1, 0, T1 * tps - H1))
    g1t = g1t.view(B, tps, T1, tps, T1, F1P).permute(0, 1, 3, 2, 4, 5)
    g1t = g1t.reshape(nt, T1 * T1, F1P)
    dpre1 = torch.where(in1[..., None], g1t * _elu_grad(a1), 0.0)
    dpre1[..., F1:] = 0.0

    dW1 = product(a1_op.transpose(1, 2), dpre1, pairs).sum(0)
    db1 = dpre1.sum((0, 1))

    # d e0 by class: one k-step per tap slot, rows of dpre1 gathered (row 64 is zero)
    W1tap = F.pad(w1.permute(2, 3, 0, 1).reshape(16, F1, F0), (0, 0, 0, F1P - F1))
    padded = torch.cat([dpre1, torch.zeros(nt, 1, F1P)], 1)
    de0 = torch.zeros(nt, 4 * CLASS_ROWS, F0)
    for cls in range(4):
        rows = slice(cls * CLASS_ROWS, (cls + 1) * CLASS_ROWS)
        for s in range(4):
            gathered = padded[:, torch.from_numpy(prow[rows, s])]
            de0[:, rows] = de0[:, rows] + product(gathered, W1tap[tap[cls, s]], pairs)
    dpre0 = de0 * d0
    dW0 = product(a0_op.transpose(1, 2), dpre0, pairs).sum(0)
    db0 = dpre0.sum((0, 1))

    return (dW0.reshape(4, 4, C, F0).permute(3, 2, 0, 1), db0,
            dW1.reshape(4, 4, F0, F1P)[..., :F1].permute(3, 2, 0, 1), db1[:F1])


def _args(B, P, C, seed):
    return [torch.from_numpy(a) for a in _data(B, P, C, seed)]


def _grads_f64(x, w0, b0, w1, b1, g1):
    with torch.enable_grad():
        ins = [t.double().requires_grad_() for t in (x, w0, b0, w1, b1)]
        y = tk._head_f32(*ins, round_e0=False)
        return torch.autograd.grad(y, ins[1:], g1.double())


def _worst(got, want) -> float:
    return max(_rel(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("P, C", [(32, 4), (32, 8), (36, 4)])
def test_emulation_matches_plain_version(P, C):
    args = _args(2, P, C, seed=C + P)
    want = tk.head_grads_plain(*args)
    got = emulate(*args)
    for name, a, b in zip(("dw0", "db0", "dw1", "db1"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= TOL_GATE, name


@pytest.mark.parametrize("C", [4, 8])
def test_emulation_as_close_to_float64_as_plain_float32(C):
    args = _args(2, 32, C, seed=40 + C)
    f64 = _grads_f64(*args)
    err = _worst([g.double() for g in emulate(*args)], f64)
    err_plain = _worst([g.double() for g in tk.head_grads_plain(*args)], f64)
    assert err <= err_plain


def test_three_pairs_fall_short_of_six():
    args = _args(2, 32, 4, seed=36)
    f64 = _grads_f64(*args)
    err3 = _worst([g.double() for g in emulate(*args, pairs=PAIRS3)], f64)
    err6 = _worst([g.double() for g in emulate(*args, pairs=PAIRS6)], f64)
    err_plain = _worst([g.double() for g in tk.head_grads_plain(*args)], f64)
    assert err3 > TOL_GATE / 10 and err3 > 20 * err6 and err3 > 10 * err_plain
    assert err6 <= F64_FACTOR * err_plain < err3     # the card's float64 gate


def test_six_pairs_match_nine():
    """The three pairs left out move the gradients by less than float32's own error:
    six and nine lie equally close to float64, each closer than the plain version."""
    args = _args(2, 32, 4, seed=36)
    f64 = _grads_f64(*args)
    g6, g9 = emulate(*args, pairs=PAIRS6), emulate(*args, pairs=PAIRS9)
    err_plain = _worst([g.double() for g in tk.head_grads_plain(*args)], f64)
    assert _worst([g.double() for g in g6], f64) <= err_plain
    assert _worst([g.double() for g in g9], f64) <= err_plain
    assert _worst(g6, g9) <= err_plain


@pytest.mark.parametrize("pairs, lo, hi", [(PAIRS1, 5e-4, 1e-2), (PAIRS3, 1e-6, 2e-5),
                                           (PAIRS6, 0.0, 4e-7), (PAIRS9, 0.0, 4e-7)])
def test_one_stage0_product_by_pairs(pairs, lo, hi):
    """One stage-0 product (M 384, K 64, N 8; the window's values by weights x 0.2)
    through the given pairs, against float64: hi.hi alone keeps bf16's accuracy, three
    pairs fall between, six and nine reach float32's."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(384, 64)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(64, 8)) * 0.2).astype(np.float32))
    want = a.double() @ b.double()
    err = _rel(product(a, b, pairs).double(), want)
    assert lo <= err <= hi
    if pairs in (PAIRS6, PAIRS9):        # no worse than one float32 product
        assert err <= _rel((a @ b).double(), want)


def test_emulation_matches_jax_head_interpret():
    x, w0, b0, w1, b1, ct = _data(2, 32, 4, seed=4)
    hwio = lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    jargs = [jnp.asarray(a) for a in (x, hwio(w0), b0, hwio(w1), b1)]
    jg = jax.grad(lambda *w: jnp.sum(jax_enc_head(jargs[0], *w, interpret=True) * ct),
                  argnums=(0, 1, 2, 3))(*jargs[1:])
    oihw = lambda g: np.asarray(g).transpose(3, 2, 0, 1)
    want = (oihw(jg[0]), np.asarray(jg[1]), oihw(jg[2]), np.asarray(jg[3]))
    got = emulate(*(torch.from_numpy(a) for a in (x, w0, b0, w1, b1, ct)))
    for name, a, b in zip(("w0", "b0", "w1", "b1"), got, want):
        assert _rel(a.numpy(), b) <= TOL_GATE, name
