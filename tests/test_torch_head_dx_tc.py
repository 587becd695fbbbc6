"""The arithmetic of the bfloat16 input-gradient kernel (K5 bf16,
``lshm_tpu_torch/csrc/conv_head.cu::dpre1_tc_kernel`` and ``::head_dx_tc_kernel``),
emulated in PyTorch on the CPU and held against the plain version and the JAX head.

The kernel runs every per-tile sum as a tensor-core product (``mma.sync`` m16n8k16,
bf16 operands, float32 accumulators).  ``emulate`` below repeats its decomposition with
float32 matrix products of bf16 values (a bf16 product is exact in float32):
- pass 1, per 8 x 8 tile of stage-1 outputs: stage 0 on the 18 x 18 halo tile in four
  parity classes of 81 positions, each padded to 96 rows (e0 rounded to bf16, 0 on
  conv1's padding ring), stage 1 as A1 [64 x 128] W1 [128 x 16]; dpre1 = g1 * elu'(a1)
  in float32 over the image;
- pass 2, per 32 x 32 input tile (the inputs of the same stage-1 tile): dpre1's 10 x 10
  halo (zeros outside the image) in bf16 pieces; stage 0 again in class order, elu'(a0)
  kept; d e0 per class: four tap slots, each a product of the halo rows
  (qy + 1 - s / 2, qx + 1 - s % 2) with that tap's w1 [16 x 8]; dpre0 = d e0 * elu'(a0)
  in pieces at all 324 positions; dx per parity class (ry, rx mod 2) of the 32 x 32
  pixels, two k-steps each pairing taps (ty, 0) and (ty, 1) (K = 2 x 8 f0) against w0
  [16 x C], one product per piece and k-step added in float32.
- dpre1 and dpre0, the only inexact operands, split into bf16 pieces hi = bf16(v),
  mid = bf16(v - hi), lo = bf16(v - hi - mid).

Errors measured on the CPU, at the tests' seeds:
- the float32 dx before rounding against ``head_grads_plain(..., input_grad=True)``,
  relative to its largest magnitude: 1.5e-7 (C = 4, P = 32), 2.4e-7 (C = 8), 1.9e-7
  (C = 4, P = 36, a ragged edge of tiles); held under 2e-5, the gradient tolerance of
  the port's float32 tests;
- two pieces: 3.0e-6 (C = 4), held under 2e-5 too; one piece (a single bf16 rounding
  of each cotangent): 2.0e-3, more than 10x outside the gate.  Three keep dpre1 and
  dpre0 at float32 accuracy, as the TPU kernel's float32 scratch does, and are the
  kernel's choice, as in K4 bf16;
- rounded to bf16, within one bf16 ulp of the plain version's largest value (the card's
  gate in ``chip_smoke.py``): 6.1e-5, 2.0e-3 and 1.5e-5 against ulps of 1/32, 1/64
  and 1/32, with 2.4e-4, 1.8e-4 and 2.9e-4 of the elements differing (values near a
  rounding tie, summed in another order);
- against the JAX head's bf16 input gradient in interpret mode: 0.0 (C = 4) and 4.0e-6
  (C = 8), inside ``tests/test_torch_bf16_dx_conv0.py``'s 8e-3 (one ulp at the low end
  of a binade, relative to the largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv_head as tk
from lshm_tpu_torch.tools.measure import bf16_ulp

F0, F1, F1P = 8, 12, 16           # F1 padded to the n-tile width
T1, T0, XW = 8, 18, 38            # stage-1 tile, stage-0 halo tile, window edges
TD, TX = 10, 32                   # dpre1 halo edge, input tile edge
CLASS_ROWS = 96                   # 81 positions of a parity class padded to 6 m-tiles
TOL = 2e-5                        # float32 dx before rounding, relative to its largest
TOL_JAX = 8e-3                    # tests/test_torch_bf16_dx_conv0.py


def split(v: torch.Tensor, pieces: int = 3) -> list[torch.Tensor]:
    """float32 v as bf16 pieces (held as float32), each the rounding of what the
    earlier ones left."""
    out, rest = [], v
    for _ in range(pieces):
        p = rest.to(torch.bfloat16).float()
        out.append(p)
        rest = rest - p               # exact in float32
    return out


def _elu_grad(a):
    return torch.where(a > 0, torch.ones_like(a), torch.exp(torch.clamp(a, max=0.0)))


def stage0_rows():
    """The 384 stage-0 rows in class order: valid, (py, px), and per tap slot s the
    dpre1 halo row that reaches the position; tap [class, slot].  Padding rows read
    the halo rows of position (0, 0) of their class, as the kernel does."""
    valid = np.zeros(4 * CLASS_ROWS, bool)
    py = np.zeros(4 * CLASS_ROWS, int)
    px = np.zeros(4 * CLASS_ROWS, int)
    hrow = np.zeros((4 * CLASS_ROWS, 4), int)
    tap = np.zeros((4, 4), int)
    for cls in range(4):
        a, b = cls >> 1, cls & 1
        for s in range(4):
            tap[cls, s] = (a + 2 * (s >> 1)) * 4 + b + 2 * (s & 1)
        for i in range(CLASS_ROWS):
            r = cls * CLASS_ROWS + i
            qy, qx = divmod(i, 9) if i < 81 else (0, 0)
            valid[r], py[r], px[r] = i < 81, a + 2 * qy, b + 2 * qx
            for s in range(4):
                hrow[r, s] = (qy + 1 - (s >> 1)) * TD + qx + 1 - (s & 1)
    return valid, py, px, hrow, tap


def dx_rows():
    """For each parity class (cy, cx) = (ry % 2, rx % 2) and its 256 pixels (a, b) in
    row order (ry = 2a + cy, rx = 2b + cx): the stage-0 position of tap (ty, tx),
    [class, pixel, ty, tx], and the tap's (ky, kx), [class, ty, tx]."""
    pos = np.zeros((4, 256, 2, 2), int)
    kyx = np.zeros((4, 2, 2, 2), int)
    for cls in range(4):
        cy, cx = cls >> 1, cls & 1
        for ty in range(2):
            for tx in range(2):
                kyx[cls, ty, tx] = 1 - cy + 2 * ty, 1 - cx + 2 * tx
                for a in range(16):
                    for b in range(16):
                        pos[cls, 16 * a + b, ty, tx] = ((a + 1 + cy - ty) * T0
                                                        + b + 1 + cx - tx)
    return pos, kyx


def _tiles(t: torch.Tensor, tps: int, edge: int, step: int, lo: int, fill_to: int):
    """[B, H, H, ch] -> [B * tps * tps, edge, edge, ch]: the tiles at stride ``step``
    starting at row -lo, zeros outside."""
    hi = fill_to - lo - t.shape[1]
    tp = F.pad(t, (0, 0, lo, hi, lo, hi))
    out = tp.unfold(1, edge, step).unfold(2, edge, step).permute(0, 1, 2, 4, 5, 3)
    return out.reshape(-1, edge, edge, t.shape[-1])


def _untile(t: torch.Tensor, B: int, tps: int, size: int) -> torch.Tensor:
    """[B * tps * tps, e, e, ch] -> the image [B, size, size, ch]."""
    e, ch = t.shape[1], t.shape[-1]
    img = t.view(B, tps, tps, e, e, ch).permute(0, 1, 3, 2, 4, 5)
    return img.reshape(B, tps * e, tps * e, ch)[:, :size, :size]


def _stage0(win, w0f, b0f, tps, B, H0):
    """Stage 0 of every tile in class order: the im2col rows (bf16 values), a0, and
    whether each row is a position inside the image."""
    C = win.shape[-1]
    valid, py, px, _, _ = stage0_rows()
    ky, kx, c = (a.ravel() for a in np.meshgrid(np.arange(4), np.arange(4), np.arange(C),
                                                indexing="ij"))
    a0_op = win[:, torch.from_numpy(2 * py[:, None] + ky[None]),
                torch.from_numpy(2 * px[:, None] + kx[None]),
                torch.from_numpy(np.tile(c, (len(py), 1)))]
    a0 = a0_op @ w0f.permute(2, 3, 1, 0).reshape(16 * C, F0) + b0f
    ty = torch.arange(tps).repeat_interleave(tps).repeat(B)
    tx = torch.arange(tps).repeat(B * tps)
    y0 = 16 * ty[:, None] - 1 + torch.from_numpy(py)[None]
    x0 = 16 * tx[:, None] - 1 + torch.from_numpy(px)[None]
    inside = torch.from_numpy(valid)[None] & (y0 >= 0) & (y0 < H0) & (x0 >= 0) & (x0 < H0)
    return a0, inside


def emulate(x, w0, b0, w1, b1, g1, pieces: int = 3) -> torch.Tensor:
    """K5 bf16's decomposition on bf16 inputs (x NHWC, weights OIHW, g1 NHWC): the
    float32 dx before its rounding to bf16."""
    B, P, _, C = x.shape
    H0, H1 = P // 2, P // 4
    tps = -(-H1 // T1)
    w0f, b0f, w1f, b1f = (t.float() for t in (w0, b0, w1, b1))
    win = _tiles(x.float(), tps, XW, 32, 3, 32 * tps + 6)
    nt = win.shape[0]
    valid, py, px, hrow, tap = stage0_rows()
    a0, inside = _stage0(win, w0f, b0f, tps, B, H0)

    # pass 1: e0 on the 18 x 18 tile (the ring 0), stage 1, dpre1 over the image
    e0 = torch.where(inside[..., None], F.elu(a0).to(torch.bfloat16).float(), 0.0)
    e0t = torch.zeros(nt, T0 * T0, F0)
    e0t[:, torch.from_numpy(py * T0 + px)[valid]] = e0[:, torch.from_numpy(valid)]
    e0t = e0t.view(nt, T0, T0, F0)
    oyl, oxl = np.divmod(np.arange(T1 * T1), T1)
    tky, tkx = np.divmod(np.arange(16), 4)
    a1_op = e0t[:, torch.from_numpy(2 * oyl[:, None] + tky[None]),
                torch.from_numpy(2 * oxl[:, None] + tkx[None])].reshape(nt, T1 * T1, -1)
    W1 = F.pad(w1f.permute(2, 3, 1, 0).reshape(16 * F0, F1), (0, F1P - F1))
    a1 = (a1_op @ W1 + F.pad(b1f, (0, F1P - F1)))[..., :F1]
    g1t = _tiles(g1.float(), tps, T1, T1, 0, T1 * tps).reshape(nt, T1 * T1, F1)
    dpre1 = _untile((g1t * _elu_grad(a1)).view(nt, T1, T1, F1), B, tps, H1)

    # pass 2: the dpre1 halo in pieces, d e0 gathered per class, dpre0 in pieces
    halo = _tiles(dpre1, tps, TD, T1, 1, T1 * tps + 2).reshape(nt, TD * TD, F1)
    pcs1 = split(F.pad(halo, (0, F1P - F1)), pieces)
    W1tap = F.pad(w1f.permute(2, 3, 0, 1).reshape(16, F1, F0), (0, 0, 0, F1P - F1))
    de0 = torch.zeros(nt, 4 * CLASS_ROWS, F0)
    for cls in range(4):
        rows = slice(cls * CLASS_ROWS, (cls + 1) * CLASS_ROWS)
        for s in range(4):
            for piece in pcs1:
                de0[:, rows] += piece[:, torch.from_numpy(hrow[rows, s])] @ W1tap[tap[cls, s]]
    dpre0 = de0 * torch.where(inside[..., None], _elu_grad(a0), 0.0)
    dp0 = torch.zeros(nt, T0 * T0, F0)
    dp0[:, torch.from_numpy(py * T0 + px)[valid]] = dpre0[:, torch.from_numpy(valid)]
    pcs0 = split(dp0, pieces)

    # dx per parity class: two k-steps of paired taps, one product per piece
    pos, kyx = dx_rows()
    dxt = torch.zeros(nt, TX, TX, C)
    for cls in range(4):
        acc = torch.zeros(nt, 256, C)
        for ty in range(2):
            wk = torch.cat([w0f[:, :, kyx[cls, ty, tx, 0], kyx[cls, ty, tx, 1]]
                            for tx in range(2)])                 # [16 = (tx, f0), C]
            for piece in pcs0:
                a_op = torch.cat([piece[:, torch.from_numpy(pos[cls, :, ty, tx])]
                                  for tx in range(2)], -1)       # [nt, 256, 16]
                acc = acc + a_op @ wk
        dxt[:, cls >> 1::2, cls & 1::2] = acc.view(nt, 16, 16, C)
    return _untile(dxt, B, tps, P)


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


def test_tap_tables_cover_each_tap_once():
    """Every pixel of a 32 x 32 tile takes each of its four taps once, at a stage-0
    position inside the 18 x 18 halo tile; every stage-0 position takes its four
    stage-1 taps from rows inside the 10 x 10 dpre1 halo."""
    pos, kyx = dx_rows()
    seen = np.zeros((TX, TX, 4, 4), int)
    for cls in range(4):
        cy, cx = cls >> 1, cls & 1
        for i in range(256):
            ry, rx = 2 * (i // 16) + cy, 2 * (i % 16) + cx
            for ty in range(2):
                for tx in range(2):
                    ky, kx = kyx[cls, ty, tx]
                    p0y, p0x = divmod(pos[cls, i, ty, tx], T0)
                    # conv0: input row 32 ty_tile + ry = 2 (16 ty_tile - 1 + p0y) - 1 + ky
                    assert ry == 2 * p0y - 3 + ky and rx == 2 * p0x - 3 + kx
                    seen[ry, rx, ky, kx] += 1
    for ry in range(TX):
        for rx in range(TX):
            want = np.zeros((4, 4), int)
            want[(ry + 1) % 2::2, (rx + 1) % 2::2] = 1   # taps of the pixel's parity
            assert (seen[ry, rx] == want).all()
    valid, py, px, hrow, tap = stage0_rows()
    assert hrow.min() >= 0 and hrow.max() < TD * TD
    for r in np.flatnonzero(valid):
        for s in range(4):
            ky, kx = divmod(tap[r // CLASS_ROWS, s], 4)
            qy, qx = divmod(hrow[r, s], TD)
            # conv1: stage-0 row 16 ty - 1 + py = 2 (8 ty - 1 + qy) - 1 + ky
            assert py[r] == 2 * qy - 2 + ky and px[r] == 2 * qx - 2 + kx


@pytest.mark.parametrize("P, C", [(32, 4), (32, 8), (36, 4)])
def test_emulation_matches_plain_version(P, C):
    args = _bf16_args(2, P, C, seed=C + P)
    want = tk.head_grads_plain(*args, input_grad=True)[0]
    got = emulate(*args)
    assert got.shape == want.shape == args[0].shape
    assert _rel(got, want) <= TOL
    # rounded once to bf16, as the kernel stores it: the card's gate
    got_bf, want_bf = got.to(torch.bfloat16).float(), want.to(torch.bfloat16).float()
    assert float((got_bf - want_bf).abs().max()) <= bf16_ulp(float(want_bf.abs().max()))


def test_fewer_pieces_within_stated_error():
    args = _bf16_args(2, 32, 4, seed=36)
    want = tk.head_grads_plain(*args, input_grad=True)[0]
    assert _rel(emulate(*args, pieces=2), want) <= TOL
    # one piece (a single bf16 rounding of the cotangents) is far outside the gate
    assert _rel(emulate(*args, pieces=1), want) > 10 * TOL


@pytest.mark.parametrize("C", [4, 8])
def test_emulation_matches_jax_head_interpret(C):
    x, w0, b0, w1, b1, ct = _data(2, 32, C, seed=10 + C)
    hwio = lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    jx, *jw = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, hwio(w0), b0, hwio(w1), b1)]
    jct = jnp.asarray(ct, dtype=jnp.bfloat16).astype(jnp.float32)
    want = jax.grad(lambda v: jnp.sum(jax_enc_head(v, *jw, interpret=True)
                                      .astype(jnp.float32) * jct))(jx)
    assert want.dtype == jnp.bfloat16
    got = emulate(*(torch.from_numpy(a).to(torch.bfloat16)
                    for a in (x, w0, b0, w1, b1, ct))).to(torch.bfloat16)
    assert _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= TOL_JAX
