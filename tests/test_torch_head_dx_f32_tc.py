"""The arithmetic of the float32 input-gradient kernel (K5 float32,
``lshm_tpu_torch/csrc/conv_head.cu::dpre1_tc_kernel<C, float>`` and
``::head_dx_tc_kernel<C, float>``), emulated in PyTorch on the CPU and held against the
plain version, the JAX head and the head in float64.

The kernel is bf16 K5's two passes (``tests/test_torch_head_dx_tc.py``) with every
float32 operand in three exact bf16 pieces, as in float32 K3 and K4
(``tests/test_torch_head_bwd_f32_tc.py``): the window x, w0, w1, the unrounded e0,
dpre1 and dpre0.  Each product of two split operands runs, per k-step of 16, the six
piece pairs of order 2^-16 and above (``product``):
- pass 1, per 8 x 8 tile of stage-1 outputs (float32 K3's kernel): stage 0 on the
  18 x 18 halo tile in four parity classes, k-steps over (ky, kx, c); stage 1 as
  A1 [64 x 128] W1 [128 x 16], k-steps of two taps by f0; dpre1 = g1 * elu'(a1) in
  float32 over the image;
- pass 2, per 32 x 32 input tile: stage 0 again (the same a0), elu'(a0) kept; d e0 per
  class, one k-step (the 16 padded f1) per tap slot of the dpre1 halo rows picked by
  address, four slots summed; dpre0 = d e0 * elu'(a0) at all 324 positions; dx per
  parity class (ry, rx mod 2) of the 32 x 32 pixels, two k-steps each pairing taps
  (ty, 0) and (ty, 1) (K = 2 x 8 f0) against w0 [16 x C], the sum stored unrounded.

Errors measured on the CPU, relative to dx's largest magnitude, at the tests' seeds:
- against ``head_grads_plain(..., input_grad=True)``: 6.4e-7 (C = 4, P = 32), 4.6e-7
  (C = 8), 2.3e-7 (C = 4, P = 36, a ragged edge of tiles); the gate is the card's 2e-5;
- against the JAX head's float32 input gradient (Pallas in interpret mode): 3.0e-7
  (C = 4) and 2.5e-7 (C = 8);
- against the head in float64 (C = 4, seed 44), by the piece pairs of every product:
  one (hi.hi) 6.3e-3, three (hi.hi, hi.mid, mid.hi) 9.7e-6, six 1.9e-7, all nine
  1.3e-7; the plain float32 version 4.2e-7.  At C = 8 six pairs 1.7e-7 against the
  plain version's 3.4e-7; at seeds 45-47 three pairs 9.5e-6 to 1.4e-5 against the
  plain version's 1.9e-7 to 2.8e-7.  Three pairs fail the card's rule (within twice
  the plain version's distance); six pass it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv_head as tk
from tests.test_torch_head_bwd_f32_tc import (
    F64_FACTOR,
    PAIRS1,
    PAIRS3,
    PAIRS6,
    PAIRS9,
    TOL_GATE,
    product,
)
from tests.test_torch_head_dx_tc import (
    CLASS_ROWS,
    F0,
    F1,
    F1P,
    T0,
    T1,
    TD,
    TX,
    XW,
    _data,
    _elu_grad,
    _rel,
    _tiles,
    _untile,
    dx_rows,
    stage0_rows,
)


def emulate(x, w0, b0, w1, b1, g1, pairs=PAIRS6) -> torch.Tensor:
    """K5 float32's decomposition on float32 inputs (x NHWC, weights OIHW, g1 NHWC):
    dx."""
    B, P, _, C = x.shape
    H0, H1 = P // 2, P // 4
    tps = -(-H1 // T1)
    win = _tiles(x, tps, XW, 32, 3, 32 * tps + 6)
    nt = win.shape[0]
    valid, py, px, hrow, tap = stage0_rows()
    valid_t = torch.from_numpy(valid)
    at = torch.from_numpy(py * T0 + px)[valid_t]       # tile positions of valid rows

    # stage 0 in class order, k = (ky, kx, c); both passes compute the same a0
    ky, kx, c = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(4), np.arange(C),
                                                indexing="ij"))
    a0_op = win[:, torch.from_numpy(2 * py[:, None] + ky[None]),
                torch.from_numpy(2 * px[:, None] + kx[None]),
                torch.from_numpy(np.tile(c, (len(py), 1)))]
    a0 = product(a0_op, w0.permute(2, 3, 1, 0).reshape(16 * C, F0), pairs) + b0
    ty = torch.arange(tps).repeat_interleave(tps).repeat(B)
    tx = torch.arange(tps).repeat(B * tps)
    y0 = 16 * ty[:, None] - 1 + torch.from_numpy(py)[None]
    x0 = 16 * tx[:, None] - 1 + torch.from_numpy(px)[None]
    inside = valid_t[None] & (y0 >= 0) & (y0 < H0) & (x0 >= 0) & (x0 < H0)

    # pass 1: e0 unrounded (0 on the ring), stage 1, dpre1 over the image
    e0t = torch.zeros(nt, T0 * T0, F0)
    e0t[:, at] = torch.where(inside[..., None], F.elu(a0), 0.0)[:, valid_t]
    e0t = e0t.view(nt, T0, T0, F0)
    oyl, oxl = np.divmod(np.arange(T1 * T1), T1)
    tky, tkx = np.divmod(np.arange(16), 4)
    a1_op = e0t[:, torch.from_numpy(2 * oyl[:, None] + tky[None]),
                torch.from_numpy(2 * oxl[:, None] + tkx[None])].reshape(nt, T1 * T1, -1)
    W1 = F.pad(w1.permute(2, 3, 1, 0).reshape(16 * F0, F1), (0, F1P - F1))
    a1 = (product(a1_op, W1, pairs) + F.pad(b1, (0, F1P - F1)))[..., :F1]
    g1t = _tiles(g1, tps, T1, T1, 0, T1 * tps).reshape(nt, T1 * T1, F1)
    dpre1 = _untile((g1t * _elu_grad(a1)).view(nt, T1, T1, F1), B, tps, H1)

    # pass 2: d e0 gathered per class from the dpre1 halo, dpre0 at every position
    halo = F.pad(_tiles(dpre1, tps, TD, T1, 1, T1 * tps + 2).reshape(nt, TD * TD, F1),
                 (0, F1P - F1))
    W1tap = F.pad(w1.permute(2, 3, 0, 1).reshape(16, F1, F0), (0, 0, 0, F1P - F1))
    de0 = torch.zeros(nt, 4 * CLASS_ROWS, F0)
    for cls in range(4):
        rows = slice(cls * CLASS_ROWS, (cls + 1) * CLASS_ROWS)
        for s in range(4):
            gathered = halo[:, torch.from_numpy(hrow[rows, s])]
            de0[:, rows] = de0[:, rows] + product(gathered, W1tap[tap[cls, s]], pairs)
    dpre0 = de0 * torch.where(inside[..., None], _elu_grad(a0), 0.0)
    dp0 = torch.zeros(nt, T0 * T0, F0)
    dp0[:, at] = dpre0[:, valid_t]

    # dx per parity class: k-step ty pairs taps (ty, 0) and (ty, 1)
    pos, kyx = dx_rows()
    dxt = torch.zeros(nt, TX, TX, C)
    for cls in range(4):
        a_op = torch.cat([dp0[:, torch.from_numpy(pos[cls, :, t // 2, t % 2])]
                          for t in range(4)], -1)                # [nt, 256, (ty, tx, f0)]
        wk = torch.cat([w0[:, :, kyx[cls, t // 2, t % 2, 0], kyx[cls, t // 2, t % 2, 1]]
                        for t in range(4)])                      # [(ty, tx, f0), C]
        dxt[:, cls >> 1::2, cls & 1::2] = product(a_op, wk, pairs).view(nt, 16, 16, C)
    return _untile(dxt, B, tps, P)


def _args(B, P, C, seed):
    return [torch.from_numpy(a) for a in _data(B, P, C, seed)]


def _dx_f64(x, w0, b0, w1, b1, g1):
    with torch.enable_grad():
        ins = [t.double().requires_grad_() for t in (x, w0, b0, w1, b1)]
        y = tk._head_f32(*ins, round_e0=False)
        return torch.autograd.grad(y, ins[0], g1.double())[0]


def _plain(args):
    return tk.head_grads_plain(*args, input_grad=True)[0]


@pytest.mark.parametrize("P, C", [(32, 4), (32, 8), (36, 4)])
def test_emulation_matches_plain_version(P, C):
    args = _args(2, P, C, seed=C + P)
    want = _plain(args)
    got = emulate(*args)
    assert got.shape == want.shape == args[0].shape
    assert _rel(got, want) <= TOL_GATE


@pytest.mark.parametrize("C", [4, 8])
def test_emulation_near_float64(C):
    """The card's rule: no farther from the head in float64 than twice the plain
    version; six pairs come closer than the plain version itself."""
    args = _args(2, 32, C, seed=40 + C)
    f64 = _dx_f64(*args)
    err = _rel(emulate(*args).double(), f64)
    err_plain = _rel(_plain(args).double(), f64)
    assert err <= F64_FACTOR * err_plain      # the card's rule
    assert err <= err_plain                   # six pairs: closer than the plain version


def test_three_pairs_fail_the_float64_rule():
    args = _args(2, 32, 4, seed=44)
    f64 = _dx_f64(*args)
    err_plain = _rel(_plain(args).double(), f64)
    err3 = _rel(emulate(*args, pairs=PAIRS3).double(), f64)
    err6 = _rel(emulate(*args, pairs=PAIRS6).double(), f64)
    assert err6 <= F64_FACTOR * err_plain < err3
    assert err3 > 20 * err6


@pytest.mark.parametrize("pairs, lo, hi", [(PAIRS1, 1e-3, 1e-2), (PAIRS3, 4e-6, 4e-5),
                                           (PAIRS6, 0.0, 4e-7), (PAIRS9, 0.0, 4e-7)])
def test_pair_sets_against_float64(pairs, lo, hi):
    """dx through the given piece pairs against the head in float64: hi.hi alone keeps
    bf16's accuracy, three pairs fall between, six and nine reach float32's (and
    closer than the plain float32 version)."""
    args = _args(2, 32, 4, seed=44)
    f64 = _dx_f64(*args)
    err = _rel(emulate(*args, pairs=pairs).double(), f64)
    assert lo <= err <= hi
    if pairs in (PAIRS6, PAIRS9):
        assert err <= _rel(_plain(args).double(), f64)


def test_six_pairs_match_nine():
    """The three pairs left out move dx by less than float32's own error."""
    args = _args(2, 32, 4, seed=44)
    f64 = _dx_f64(*args)
    err_plain = _rel(_plain(args).double(), f64)
    assert _rel(emulate(*args, pairs=PAIRS6), emulate(*args, pairs=PAIRS9)) <= err_plain


@pytest.mark.parametrize("C", [4, 8])
def test_emulation_matches_jax_head_interpret(C):
    x, w0, b0, w1, b1, ct = _data(2, 32, C, seed=10 + C)
    hwio = lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    jw = [jnp.asarray(a) for a in (hwio(w0), b0, hwio(w1), b1)]
    want = jax.grad(lambda v: jnp.sum(jax_enc_head(v, *jw, interpret=True) * ct))(
        jnp.asarray(x))
    assert want.dtype == jnp.float32
    got = emulate(*(torch.from_numpy(a) for a in (x, w0, b0, w1, b1, ct)))
    assert _rel(got.numpy(), np.asarray(want)) <= TOL_GATE
