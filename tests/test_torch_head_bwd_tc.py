"""The arithmetic of the bfloat16 weight-gradient kernel (K4 bf16,
``lshm_tpu_torch/csrc/conv_head.cu::head_bwd_tc_kernel``), emulated in PyTorch on the
CPU and held against the plain version and against the JAX head.

The kernel runs every per-tile sum as a tensor-core product (``mma.sync`` m16n8k16,
bf16 operands, float32 accumulators).  ``emulate`` below repeats its decomposition with
float32 matrix products of bf16 values (a bf16 product is exact in float32):
- one tile is one sample's 8 x 8 block of stage-1 outputs, its 18 x 18 stage-0 halo
  tile and its 38 x 38 input window at image pixel (32 ty - 3, 32 tx - 3);
- the stage-0 positions go in four parity classes of 81 (py mod 2, px mod 2), each
  padded to 96 rows (six m-tiles of 16), so the positions of one m-tile share the
  stage-1 taps that reach them;
- stage 0: a0 = A0 [384 x 16C] W0 (A0 the implicit im2col of the window); e0 rounded
  to bf16, elu'(a0) kept in float32, both 0 on the padding ring;
- stage 1: a1 = A1 [64 x 128] W1 [128 x 16] (f1 padded 12 -> 16), A1 e0's taps;
  dpre1 = g1 * elu'(a1), 0 outside the image;
- dW1 += A1^T dpre1;
- d e0 gathered per class: four tap slots, each a product of dpre1's rows at the
  stage-1 outputs that reach the position (a zero row where none does) with that
  tap's w1 [16 x 8]; dpre0 = d e0 * elu'(a0);
- dW0 += A0^T dpre0, K = the 384 class rows (the padding rows zero);
- dpre1 and dpre0, the only inexact operands, split into bf16 pieces
  hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), one product per piece
  into the same float32 sum.

Errors measured on the CPU (relative to the largest magnitude of each gradient,
worst of dW0, db0, dW1, db1, at the tests' seeds):
- three pieces against ``head_grads_plain``: 4.2e-7 (C = 4, P = 32), 6.2e-7 (C = 8),
  5.3e-7 (C = 4, P = 36, a ragged edge of stage-1 tiles); the gate is the card's 1e-4;
- two pieces: 2.3e-6 (C = 4), held under 2e-5; one piece (a single bf16 rounding):
  1.9e-3, outside the gate.  Three keep the sums at float32 accuracy and are the
  kernel's choice;
- against the JAX head in interpret mode (bf16 gradients, C = 4): dW0 4.6e-3, db0,
  dW1 and db1 0.0, inside ``tests/test_torch_bf16_head.py``'s TOL_DW0 and TOL_GRAD
  (the JAX dW0 is a bf16 sum of four rounded phase blocks, see that file).
The plain version may round one e0 the other way where a0 lies near a bf16 tie and is
summed in another order, so bit equality is not asked.  The errors above show no such
tie at these sizes; at the card's sizes ``chip_smoke.py`` prints how far the kernel and
the plain version each lie from the head computed in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv_head as tk

F0, F1, F1P = 8, 12, 16           # F1 padded to the n-tile width
T1, T0, XW = 8, 18, 38            # stage-1 tile, stage-0 halo tile, window edges
CLASS_ROWS = 96                   # 81 positions of a parity class padded to 6 m-tiles
TOL_GATE = 1e-4                   # chip_smoke.py's gate on K4 bf16's float32 sums
TOL_TWO_PIECES = 2e-5
TOL_GRAD, TOL_DW0 = 8e-3, 2e-2    # tests/test_torch_bf16_head.py


def split(v: torch.Tensor, pieces: int = 3) -> list[torch.Tensor]:
    """float32 v as bf16 pieces (held as float32), each the rounding of what the
    earlier ones left: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)."""
    out, rest = [], v
    for _ in range(pieces):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p               # exact in float32
    return out


def _elu_grad(a):
    return torch.where(a > 0, torch.ones_like(a), torch.exp(torch.clamp(a, max=0.0)))


def _class_rows():
    """For each of the 384 stage-0 rows in class order: valid, py, px and, per tap
    slot s, (ky, kx) and the stage-1 output (oyl, oxl) that reaches it."""
    valid = np.zeros(4 * CLASS_ROWS, bool)
    py = np.zeros(4 * CLASS_ROWS, int)
    px = np.zeros(4 * CLASS_ROWS, int)
    prow = np.full((4 * CLASS_ROWS, 4), T1 * T1, int)       # 64: the zero row
    tap = np.zeros((4, 4), int)                             # [class, slot]
    for cls in range(4):
        a, b = cls >> 1, cls & 1
        for s in range(4):
            tap[cls, s] = (a + 2 * (s >> 1)) * 4 + b + 2 * (s & 1)
        for i in range(81):
            r = cls * CLASS_ROWS + i
            qy, qx = divmod(i, 9)
            valid[r], py[r], px[r] = True, a + 2 * qy, b + 2 * qx
            for s in range(4):
                oyl, oxl = qy - (s >> 1), qx - (s & 1)
                if 0 <= oyl < T1 and 0 <= oxl < T1:
                    prow[r, s] = oyl * T1 + oxl
    return valid, py, px, prow, tap


def emulate(x, w0, b0, w1, b1, g1, pieces: int = 3):
    """K4 bf16's decomposition on bf16 inputs (x NHWC, weights OIHW, g1 NHWC):
    float32 (dW0, db0, dW1, db1)."""
    B, P, _, C = x.shape
    H0, H1 = P // 2, P // 4
    tps = -(-H1 // T1)
    xf, gf = x.float(), g1.float()
    w0f, b0f, w1f, b1f = (t.float() for t in (w0, b0, w1, b1))

    # windows [ntiles, 38, 38, C]; the zero padding is the loads outside the image
    hi = 32 * tps + 3 - P
    xp = F.pad(xf, (0, 0, 3, hi, 3, hi))
    win = xp.unfold(1, XW, 32).unfold(2, XW, 32).permute(0, 1, 2, 4, 5, 3)
    win = win.reshape(-1, XW, XW, C)
    nt = win.shape[0]
    ty = torch.arange(tps).repeat_interleave(tps).repeat(B)
    tx = torch.arange(tps).repeat(B * tps)

    valid, py, px, prow, tap = _class_rows()
    valid_t, py_t, px_t = (torch.from_numpy(a) for a in (valid, py, px))

    # stage 0, rows in class order; k = (ky, kx, c)
    ky, kx, c = np.meshgrid(np.arange(4), np.arange(4), np.arange(C), indexing="ij")
    ky, kx, c = ky.ravel(), kx.ravel(), c.ravel()
    rows_y = torch.from_numpy(2 * py[:, None] + ky[None])
    rows_x = torch.from_numpy(2 * px[:, None] + kx[None])
    chans = torch.from_numpy(np.tile(c, (len(py), 1)))
    a0_op = win[:, rows_y, rows_x, chans]
    W0 = w0f.permute(2, 3, 1, 0).reshape(16 * C, F0)
    a0 = a0_op @ W0 + b0f
    y0 = 16 * ty[:, None] - 1 + py_t[None]
    x0 = 16 * tx[:, None] - 1 + px_t[None]
    inside = valid_t[None] & (y0 >= 0) & (y0 < H0) & (x0 >= 0) & (x0 < H0)
    e0 = torch.where(inside[..., None], F.elu(a0).to(torch.bfloat16).float(), 0.0)
    d0 = torch.where(inside[..., None], _elu_grad(a0), 0.0)

    # e0 on the 18 x 18 tile (the ring stays 0)
    e0t = torch.zeros(nt, T0 * T0, F0)
    e0t[:, torch.from_numpy(py * T0 + px)[valid_t]] = e0[:, valid_t]
    e0t = e0t.view(nt, T0, T0, F0)

    # stage 1; k = (ky, kx, f0)
    oyl, oxl = np.divmod(np.arange(T1 * T1), T1)
    tky, tkx = np.divmod(np.arange(16), 4)
    a1_op = e0t[:, torch.from_numpy(2 * oyl[:, None] + tky[None]),
                torch.from_numpy(2 * oxl[:, None] + tkx[None])]
    a1_op = a1_op.reshape(nt, T1 * T1, 16 * F0)
    W1 = F.pad(w1f.permute(2, 3, 1, 0).reshape(16 * F0, F1), (0, F1P - F1))
    a1 = a1_op @ W1 + F.pad(b1f, (0, F1P - F1))
    oy = T1 * ty[:, None] + torch.from_numpy(oyl)[None]
    ox = T1 * tx[:, None] + torch.from_numpy(oxl)[None]
    in1 = (oy < H1) & (ox < H1)
    g1t = F.pad(gf, (0, F1P - F1, 0, T1 * tps - H1, 0, T1 * tps - H1))
    g1t = g1t.view(B, tps, T1, tps, T1, F1P).permute(0, 1, 3, 2, 4, 5)
    g1t = g1t.reshape(nt, T1 * T1, F1P)
    dpre1 = torch.where(in1[..., None], g1t * _elu_grad(a1), 0.0)
    dpre1[..., F1:] = 0.0
    pcs1 = split(dpre1, pieces)

    dW1 = sum(a1_op.transpose(1, 2) @ p for p in pcs1).sum(0)
    db1 = dpre1.sum((0, 1))

    # d e0 by class: four tap slots, rows of dpre1 gathered (row 64 is zero)
    W1tap = F.pad(w1f.permute(2, 3, 0, 1).reshape(16, F1, F0), (0, 0, 0, F1P - F1))
    de0 = torch.zeros(nt, 4 * CLASS_ROWS, F0)
    for piece in pcs1:
        padded = torch.cat([piece, torch.zeros(nt, 1, F1P)], 1)
        for cls in range(4):
            rows = slice(cls * CLASS_ROWS, (cls + 1) * CLASS_ROWS)
            for s in range(4):
                gathered = padded[:, torch.from_numpy(prow[rows, s])]
                de0[:, rows] += gathered @ W1tap[tap[cls, s]]
    dpre0 = de0 * d0
    pcs0 = split(dpre0, pieces)
    dW0 = sum(a0_op.transpose(1, 2) @ p for p in pcs0).sum(0)
    db0 = dpre0.sum((0, 1))

    return (dW0.reshape(4, 4, C, F0).permute(3, 2, 0, 1), db0,
            dW1.reshape(4, 4, F0, F1P)[..., :F1].permute(3, 2, 0, 1), db1[:F1])


def _data(B, P, C, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return (f(B, P, P, C), f(8, C, 4, 4, scale=0.2), f(8, scale=0.1),
            f(12, 8, 4, 4, scale=0.2), f(12, scale=0.1), f(B, P // 4, P // 4, 12))


def _bf16_args(B, P, C, seed):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in _data(B, P, C, seed)]


def _rel(a, b) -> float:
    a, b = (torch.tensor(np.asarray(t, np.float32)) for t in (a, b))
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def test_three_pieces_reconstruct_float32_exactly():
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-20, 30, size=20000)   # pieces stay normal in bf16
    v = (rng.normal(size=20000) * mag).astype(np.float32)
    v[:4] = [0.0, -0.0, 1e-30, -3.0e38]
    v = torch.from_numpy(np.concatenate([v, rng.normal(size=2000).astype(np.float32)]))
    hi, mid, lo = split(v, 3)
    for p in (hi, mid, lo):
        assert torch.equal(p.to(torch.bfloat16).float(), p)         # each piece is bf16
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    # two pieces leave up to 2^-17 of |v|: what the third one carries
    rest = (v.double() - hi.double() - mid.double()).abs()
    assert bool((rest <= v.double().abs() * 2.0 ** -16).all())


@pytest.mark.parametrize("P, C", [(32, 4), (32, 8), (36, 4)])
def test_emulation_matches_plain_version(P, C):
    args = _bf16_args(2, P, C, seed=C + P)
    want = tk.head_grads_plain(*args)
    got = emulate(*args)
    for name, a, b in zip(("dw0", "db0", "dw1", "db1"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, b) <= TOL_GATE, name


def test_two_pieces_within_stated_error():
    args = _bf16_args(2, 32, 4, seed=36)
    want = tk.head_grads_plain(*args)
    errs = [_rel(a, b) for a, b in zip(emulate(*args, pieces=2), want)]
    assert max(errs) <= TOL_TWO_PIECES
    # one piece (a single bf16 rounding of the cotangents) is far outside the gate
    errs1 = [_rel(a, b) for a, b in zip(emulate(*args, pieces=1), want)]
    assert max(errs1) > TOL_GATE


def test_emulation_matches_jax_head_interpret():
    x, w0, b0, w1, b1, ct = _data(2, 32, 4, seed=4)
    hwio = lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    jargs = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, hwio(w0), b0, hwio(w1), b1)]
    jct = jnp.asarray(ct, dtype=jnp.bfloat16).astype(jnp.float32)
    jg = jax.grad(lambda *w: jnp.sum(jax_enc_head(jargs[0], *w, interpret=True)
                                     .astype(jnp.float32) * jct),
                  argnums=(0, 1, 2, 3))(*jargs[1:])
    oihw = lambda g: np.asarray(g.astype(jnp.float32)).transpose(3, 2, 0, 1)
    want = (oihw(jg[0]), np.asarray(jg[1].astype(jnp.float32)), oihw(jg[2]),
            np.asarray(jg[3].astype(jnp.float32)))
    got = emulate(*(torch.from_numpy(a).to(torch.bfloat16)
                    for a in (x, w0, b0, w1, b1, ct)))
    got = [g.to(torch.bfloat16).float().numpy() for g in got]    # EncHead's cast
    for name, a, b, tol in zip(("w0", "b0", "w1", "b1"), got, want,
                               (TOL_DW0, TOL_GRAD, TOL_GRAD, TOL_GRAD)):
        assert _rel(a, b) <= tol, name
