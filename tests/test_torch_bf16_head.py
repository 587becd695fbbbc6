"""The port's fused conv head in bfloat16 (K3/K4; their plain versions on the CPU)
against the JAX ``enc_head`` on the same bf16 arrays, its Pallas kernels in interpret
mode, at B = 2, P = 32, C in {4, 8}.  Compared in the working type, bf16 on both sides.

Tolerances, relative to the largest magnitude, with the errors measured on the CPU
beside them (the test's seeds, C = 4 and 8, and seeds 0-2 of each):
- output 4e-3 (one bf16 ulp of the largest value; measured 0.0: both sum exact bf16
  products in float32 and round e0 and the output at the same places);
- dW1, db0, db1 8e-3 (one bf16 ulp at the low end of a binade; measured at most
  4e-5, 0.0 and 0.0);
- dW0 2e-2 (measured 4.6e-3 at the test's seeds, 4.1e-3 - 9.7e-3 over all eight).
  The JAX head packs w0 into kron(I_4, w0) in bf16, so its dW0 is the bf16 sum of
  four bf16-rounded phase blocks of the kernel's float32 dW0big (the kron's
  backward); the port rounds the float32 dW0 once.  2e-2 allows those two extra
  roundings (2.5 ulps of the largest entry) and is far inside JAX's own bf16 gate,
  0.05 |a| + 5e-3 (tests/test_bf16.py:61).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv_head as tk

TOL_OUT, TOL_GRAD, TOL_DW0 = 4e-3, 8e-3, 2e-2


def _data(B, P, C, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    # HWIO for JAX; the port takes OIHW
    return (f(B, P, P, C), f(4, 4, C, 8, scale=0.2), f(8, scale=0.1),
            f(4, 4, 8, 12, scale=0.2), f(12, scale=0.1), f(B, P // 4, P // 4, 12))


def _oihw(w):
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


@pytest.mark.parametrize("C", [4, 8])
def test_bf16_head_matches_jax_interpret(C):
    x, w0, b0, w1, b1, ct = _data(2, 32, C, seed=C)
    jargs = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, w0, b0, w1, b1)]
    want = jax_enc_head(*jargs, interpret=True)
    jg = jax.grad(lambda *w: jnp.sum(jax_enc_head(jargs[0], *w, interpret=True)
                                     .astype(jnp.float32) * ct),
                  argnums=(0, 1, 2, 3))(*jargs[1:])
    assert want.dtype == jnp.bfloat16 and all(g.dtype == jnp.bfloat16 for g in jg)

    tw = [_bf16(_oihw(w0)), _bf16(b0), _bf16(_oihw(w1)), _bf16(b1)]
    for t in tw:
        t.requires_grad_()
    got = tk.enc_head(_bf16(x), *tw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 8, 8, 12)
    assert _rel(got, want) <= TOL_OUT
    tg = torch.autograd.grad(torch.sum(got.float() * torch.from_numpy(ct)), tw)
    assert all(g.dtype == torch.bfloat16 for g in tg)
    want_g = (_oihw(_f32(jg[0])), jg[1], _oihw(_f32(jg[2])), jg[3])
    for name, a, b, tol in zip(("w0", "b0", "w1", "b1"), tg, want_g,
                               (TOL_DW0, TOL_GRAD, TOL_GRAD, TOL_GRAD)):
        assert _rel(a, b) <= tol, name


def test_bf16_weight_grads_are_float32_sums_cast_once():
    """head_weight_grads returns the float32 sums; enc_head's backward casts them to the
    weights' dtype once, as the JAX custom VJP does."""
    x, w0, b0, w1, b1, ct = _data(2, 16, 4, seed=5)
    args = [_bf16(x), _bf16(_oihw(w0)), _bf16(b0), _bf16(_oihw(w1)), _bf16(b1), _bf16(ct)]
    exact = tk.head_weight_grads(*args)
    ws = [t.clone().requires_grad_() for t in args[1:5]]
    cast = torch.autograd.grad(tk.enc_head(args[0], *ws), ws, args[5])
    for e, c in zip(exact, cast):
        assert e.dtype == torch.float32 and c.dtype == torch.bfloat16
        assert torch.equal(e.to(torch.bfloat16), c)


def test_bf16_plain_head_rounds_e0_between_the_stages():
    """The plain version on bf16 inputs is the float32 head with e0 rounded to bf16 and
    the output rounded: not the float32 head rounded once at the end."""
    x, w0, b0, w1, b1, _ = _data(2, 16, 4, seed=6)
    xs = [_bf16(x), _bf16(_oihw(w0)), _bf16(b0), _bf16(_oihw(w1)), _bf16(b1)]
    got = tk.enc_head_plain(*xs)
    f = [t.float() for t in xs]
    e0 = torch.nn.functional.elu(torch.nn.functional.conv2d(
        f[0].permute(0, 3, 1, 2), f[1], f[2], stride=2, padding=1))
    e0 = e0.to(torch.bfloat16).float()
    y = torch.nn.functional.elu(torch.nn.functional.conv2d(e0, f[3], f[4], stride=2,
                                                           padding=1))
    assert torch.equal(got, y.permute(0, 2, 3, 1).to(torch.bfloat16))


def test_wrappers_refuse_mixed_dtypes_and_bf16_input_gradient():
    x, w0, b0, w1, b1, ct = _data(2, 16, 4, seed=7)
    xb, w0t, b0t, w1t, b1t = (_bf16(x), torch.tensor(_oihw(w0)), torch.tensor(b0),
                              torch.tensor(_oihw(w1)), torch.tensor(b1))
    with pytest.raises(TypeError):
        tk.head_forward(xb, w0t, b0t, w1t, b1t)                 # bf16 x, f32 weights
    bw = [t.to(torch.bfloat16) for t in (w0t, b0t, w1t, b1t)]
    with pytest.raises(TypeError):
        tk.head_weight_grads(xb, *bw, torch.tensor(ct))         # f32 g1
    with pytest.raises(TypeError):
        tk.head_input_grad(xb, w0t, b0t, w1t, b1t, _bf16(ct))   # bf16 x, f32 weights
    with pytest.raises(TypeError):
        tk.head_input_grad(xb, *bw, torch.tensor(ct))           # f32 g1
    xr = xb.clone().requires_grad_()
    with pytest.raises(TypeError):
        tk.enc_head(xr, w0t, b0t, w1t, b1t).float().sum().backward()
