"""The arithmetic of the fused head's forward kernel on the tensor cores (K3,
``lshm_tpu_torch/csrc/conv_head.cu::head_fwd_tc_kernel``), in bfloat16 and float32,
emulated in PyTorch on the CPU and held against the plain version, the JAX head and
the head in float64.

The kernel runs K4's stage 0 and stage 1 (``tests/test_torch_head_bwd_tc.py``,
``tests/test_torch_head_bwd_f32_tc.py``) and stores out = elu(a1 + b1) rounded to the
storage type:
- one tile is one sample's 8 x 8 block of stage-1 outputs, its 18 x 18 stage-0 halo
  tile (rows in four parity classes of 81) and its 38 x 38 input window;
- stage 0  a0 = A0 [384 x 16C] W0, k-steps of 16 over (ky, kx, c), each k-step's
  product from zero and added in float32; e0 = elu(a0 + b0), 0 on conv1's padding
  ring, rounded to bf16 in bf16;
- stage 1  a1 = A1 [64 x 128] W1 [128 x 16], k-steps of two taps by f0;
- float32: every operand (x, w0, w1, the unrounded e0) in three exact bf16 pieces and
  each k-step through the six piece pairs of order 2^-16 and above (``product``).

Errors measured on the CPU at the tests' seeds (relative to the largest magnitude):
- float32 against ``enc_head_plain``: 3.9e-7 (C = 4, P = 32), 4.7e-7 (C = 8), 3.2e-7
  (C = 4, P = 36, a ragged edge of stage-1 tiles); gate 1e-5.  Against the float64
  head (B = 4, P = 64): the emulation 1.4e-7 (C = 4 and 8), the plain version 3.3e-7
  and 3.5e-7; against the JAX head in interpret mode 1.8e-7 (the plain version 6.0e-7);
- bf16 against ``enc_head_plain``: at B = 2, P = 32 and 36 no output differs; at B = 4,
  P = 128 (49,152 outputs) 0 to 18 differ over six seeds at either C, shares 0 to
  3.7e-4 (C = 4: 4.1e-5, 4.1e-5, 3.7e-4, 2.4e-4, 1.2e-4, 0; C = 8: 2.0e-4, 4.1e-5,
  8.1e-5, 6.1e-5, 3.7e-4, 2.4e-4), each output by one bf16 ulp of its own value.  One
  e0 rounded the other way moves the outputs of up to four stage-1 positions, so the
  share comes in lumps.  SHARE_GATE, the card's gate too, is 5e-4.
  Without the rounding of e0 (stage 1 over the unrounded e0) 35 % (C = 4) and 32 %
  (C = 8) of the outputs differ.  Against the float64 head (e0 still rounded to bf16):
  the emulation and the plain version both 2.4e-3 (C = 4) and 2.1e-3 (C = 8), half an
  ulp of the largest value or less; against the JAX head 0.0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv_head as tk
from tests.test_torch_head_bwd_f32_tc import PAIRS1, PAIRS6, product
from tests.test_torch_head_bwd_tc import F0, F1, F1P, T0, T1, XW, _class_rows, _data

TOL_F32 = 1e-5                # chip_smoke.py's float32 K3 gates
TOL_BF16 = 4e-3               # and its bf16 ones: relative error,
SHARE_GATE = 5e-4             # share of the outputs that differ from the plain version
F64_FACTOR = 2                # within twice the plain version's distance from float64


def emulate(x, w0, b0, w1, b1, round_e0: bool | None = None):
    """K3's decomposition on inputs of one dtype (x NHWC, weights OIHW): the output
    NHWC [B, P/4, P/4, 12] in x's dtype.  bf16: exact bf16 products, one piece pair;
    float32: three pieces, six pairs.  ``round_e0`` (default: bf16 inputs) rounds e0 to
    bf16 between the stages."""
    bf16 = x.dtype == torch.bfloat16
    pairs = PAIRS1 if bf16 else PAIRS6
    if round_e0 is None:
        round_e0 = bf16
    x, w0, b0, w1, b1 = (t.float() for t in (x, w0, b0, w1, b1))
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

    valid, py, px, _, _ = _class_rows()
    valid_t, py_t, px_t = (torch.from_numpy(a) for a in (valid, py, px))

    # stage 0, rows in class order; k = (ky, kx, c)
    ky, kx, c = np.meshgrid(np.arange(4), np.arange(4), np.arange(C), indexing="ij")
    ky, kx, c = ky.ravel(), kx.ravel(), c.ravel()
    a0_op = win[:, torch.from_numpy(2 * py[:, None] + ky[None]),
                torch.from_numpy(2 * px[:, None] + kx[None]),
                torch.from_numpy(np.tile(c, (len(py), 1)))]
    a0 = product(a0_op, w0.permute(2, 3, 1, 0).reshape(16 * C, F0), pairs) + b0
    y0 = 16 * ty[:, None] - 1 + py_t[None]
    x0 = 16 * tx[:, None] - 1 + px_t[None]
    inside = valid_t[None] & (y0 >= 0) & (y0 < H0) & (x0 >= 0) & (x0 < H0)
    e0 = F.elu(a0)
    if round_e0:
        e0 = e0.to(torch.bfloat16).float()
    e0 = torch.where(inside[..., None], e0, 0.0)

    e0t = torch.zeros(nt, T0 * T0, F0)
    e0t[:, torch.from_numpy(py * T0 + px)[valid_t]] = e0[:, valid_t]
    e0t = e0t.view(nt, T0, T0, F0)

    # stage 1; k = (ky, kx, f0), a k-step two taps
    oyl, oxl = np.divmod(np.arange(T1 * T1), T1)
    tky, tkx = np.divmod(np.arange(16), 4)
    a1_op = e0t[:, torch.from_numpy(2 * oyl[:, None] + tky[None]),
                torch.from_numpy(2 * oxl[:, None] + tkx[None])]
    a1_op = a1_op.reshape(nt, T1 * T1, 16 * F0)
    W1 = F.pad(w1.permute(2, 3, 1, 0).reshape(16 * F0, F1), (0, F1P - F1))
    # one piece would round e0 to bf16 itself: an unrounded e0 goes in three
    pairs1 = pairs if round_e0 or not bf16 else PAIRS6
    out = F.elu(product(a1_op, W1, pairs1) + F.pad(b1, (0, F1P - F1)))[..., :F1]

    # the tiles' outputs inside the image, NHWC
    out = out.view(B, tps, tps, T1, T1, F1).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(B, T1 * tps, T1 * tps, F1)[:, :H1, :H1]
    return out.to(torch.bfloat16 if bf16 else torch.float32).contiguous()


def _rel(a, b) -> float:
    """Largest difference relative to the largest magnitude of b, in float64."""
    a, b = (torch.as_tensor(t).double() for t in (a, b))
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def _args(B, P, C, seed, dtype):
    return [torch.from_numpy(a).to(dtype) for a in _data(B, P, C, seed)[:5]]


def _head_f64(x, w0, b0, w1, b1):
    """The head with its convolutions in float64; on bf16 inputs e0 still rounded to
    bf16 between the stages (chip_smoke.py's reference)."""
    ins = [t.double() for t in (x, w0, b0, w1, b1)]
    return tk._head_f32(*ins, round_e0=x.dtype == torch.bfloat16)


def _share(a, b) -> float:
    return float((a != b).float().mean())


def _within_one_ulp(got, want) -> bool:
    top = float(want.float().abs().max())
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    return float((got.float() - want.float()).abs().max()) <= ulp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P, C", [(32, 4), (32, 8), (36, 4)])
def test_emulation_matches_plain_version(P, C, dtype):
    args = _args(2, P, C, C + P, dtype)
    want = tk.enc_head_plain(*args)
    got = emulate(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.float32:
        assert _rel(got, want) <= TOL_F32
    else:
        assert _rel(got.float(), want.float()) <= TOL_BF16
        assert _share(got, want) <= SHARE_GATE
        assert _within_one_ulp(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("C", [4, 8])
def test_bf16_share_at_full_patch_size(C, seed):
    """At P = 128 the tensor cores' order of summing a0 rounds a few e0 near a bf16 tie
    the other way than the plain version: a few outputs differ, by one ulp each."""
    args = _args(4, 128, C, 50 + C + 100 * seed, torch.bfloat16)
    want = tk.enc_head_plain(*args)
    got = emulate(*args)
    assert _share(got, want) <= SHARE_GATE
    assert _within_one_ulp(got, want)
    assert _rel(got.float(), want.float()) <= TOL_BF16


def test_dropping_e0_rounding_fails_share_gate():
    """A kernel that dropped (or moved) the rounding of e0 differs from the plain
    version in far more outputs than the gate allows."""
    args = _args(2, 64, 4, 7, torch.bfloat16)
    want = tk.enc_head_plain(*args)
    assert _share(emulate(*args), want) <= SHARE_GATE
    assert _share(emulate(*args, round_e0=False), want) >= 10 * SHARE_GATE


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [4, 8])
def test_emulation_as_close_to_float64_as_plain(C, dtype):
    args = _args(4, 64, C, 60 + C, dtype)
    f64 = _head_f64(*args)
    err = _rel(emulate(*args).double(), f64)
    err_plain = _rel(tk.enc_head_plain(*args).double(), f64)
    assert err <= F64_FACTOR * err_plain
    if dtype == torch.float32:
        assert err <= TOL_F32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulation_matches_jax_head_interpret(dtype):
    x, w0, b0, w1, b1, _ = _data(2, 32, 4, seed=4)
    hwio = lambda w: np.ascontiguousarray(w.transpose(2, 3, 1, 0))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = [jnp.asarray(a, dtype=jdt) for a in (x, hwio(w0), b0, hwio(w1), b1)]
    want = np.array(jax_enc_head(*jargs, interpret=True).astype(jnp.float32))
    got = emulate(*(torch.from_numpy(a).to(dtype) for a in (x, w0, b0, w1, b1)))
    assert _rel(got.float().numpy(), want) <= (TOL_BF16 if dtype == torch.bfloat16
                                               else TOL_F32)
