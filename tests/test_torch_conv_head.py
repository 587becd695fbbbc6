"""The port's fused conv head (kernels K3/K4/K5, plain versions on the CPU) against the
JAX Pallas kernels in interpret mode, at the prime batch of tests/test_models.py
(B = 11, P = 32): forward, weight gradients and input gradient to 2e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu.models.autoencoders import elu as jax_elu
from lshm_tpu_torch.kernels import conv_head as tk


def _data(B, P, C, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    # HWIO for JAX; the port takes OIHW
    return (f(B, P, P, C), f(4, 4, C, 8, scale=0.2), f(8, scale=0.1),
            f(4, 4, 8, 12, scale=0.2), f(12, scale=0.1))


def _oihw(w):
    return torch.tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def _jax_ref(x, w0, b0, w1, b1):
    conv = lambda v, w: jax.lax.conv_general_dilated(
        v, w, (2, 2), ((1, 1), (1, 1)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jax_elu(conv(jax_elu(conv(x, w0) + b0), w1) + b1)


def test_enc_head_matches_jax_interpret():
    x, w0, b0, w1, b1 = _data(11, 32, 4)
    ct = np.random.default_rng(1).normal(size=(11, 8, 8, 12)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, w0, b0, w1, b1)]
    want = np.asarray(jax_enc_head(*jargs, interpret=True))

    tw = [_oihw(w0), torch.tensor(b0), _oihw(w1), torch.tensor(b1)]
    for t in tw:
        t.requires_grad_()
    got = tk.enc_head(torch.tensor(x), *tw)
    assert tuple(got.shape) == (11, 8, 8, 12)
    assert _rel(got.detach().numpy(), want) < 2e-5

    jg = jax.grad(lambda *w: jnp.sum(jax_enc_head(jargs[0], *w, interpret=True) * ct),
                  argnums=(0, 1, 2, 3))(*jargs[1:])
    tg = torch.autograd.grad(torch.sum(got * torch.from_numpy(ct)), tw)
    oihw = lambda g: np.asarray(g).transpose(3, 2, 0, 1)
    for name, a, b in zip(("w0", "b0", "w1", "b1"), tg,
                          (oihw(jg[0]), jg[1], oihw(jg[2]), jg[3])):
        assert _rel(a.numpy(), np.asarray(b)) < 2e-5, name


@pytest.mark.parametrize("C,P", [(8, 32), (4, 20)])
def test_enc_head_other_shapes_match_strided_convs(C, P):
    """8 input channels, and a patch whose stage-1 map (5 x 5) is not a whole tile."""
    x, w0, b0, w1, b1 = _data(3, P, C, seed=C + P)
    want = np.asarray(_jax_ref(*[jnp.asarray(a) for a in (x, w0, b0, w1, b1)]))
    got = tk.enc_head(torch.tensor(x), _oihw(w0), torch.tensor(b0), _oihw(w1),
                      torch.tensor(b1))
    assert _rel(got.numpy(), want) < 2e-5


def test_input_gradient_on_cpu_matches_jax():
    """dx through EncHead (K5's plain version on the CPU) against jax.grad of the
    strided convolutions."""
    x, w0, b0, w1, b1 = _data(2, 16, 4, seed=5)
    ct = np.random.default_rng(2).normal(size=(2, 4, 4, 12)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, w0, b0, w1, b1)]
    want = jax.grad(lambda v: jnp.sum(_jax_ref(v, *jargs[1:]) * ct))(jargs[0])
    xt = torch.tensor(x, requires_grad=True)
    y = tk.enc_head(xt, _oihw(w0), torch.tensor(b0), _oihw(w1), torch.tensor(b1))
    (dx,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(ct)), xt)
    assert _rel(dx.numpy(), np.asarray(want)) < 2e-5


@pytest.mark.parametrize("C,B,P", [(4, 11, 32), (8, 3, 20)])
def test_input_gradient_matches_jax_dx_kernel_interpret(C, B, P):
    """head_input_grad (K5) against jax.grad w.r.t. x of the JAX enc_head in interpret
    mode, which runs the TPU kernel _dx_kernel; also with 8 channels and a patch whose
    stage-1 map is not a whole tile."""
    x, w0, b0, w1, b1 = _data(B, P, C, seed=7 + C)
    ct = np.random.default_rng(3).normal(size=(B, P // 4, P // 4, 12)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, w0, b0, w1, b1)]
    want = jax.grad(lambda v: jnp.sum(jax_enc_head(v, *jargs[1:], interpret=True) * ct))(
        jargs[0])
    got = tk.head_input_grad(torch.tensor(x), _oihw(w0), torch.tensor(b0), _oihw(w1),
                             torch.tensor(b1), torch.from_numpy(ct))
    assert got.shape == x.shape
    assert _rel(got.numpy(), np.asarray(want)) < 2e-5


def test_backward_computes_only_what_is_asked():
    """EncHead's backward: dx alone when only the input needs a gradient, the weights'
    alone when only they do (the training path, where the input is data)."""
    x, w0, b0, w1, b1 = _data(2, 16, 4, seed=9)
    ct = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 4, 4, 12))
                          .astype(np.float32))
    ws = [_oihw(w0), torch.tensor(b0), _oihw(w1), torch.tensor(b1)]
    xt = torch.tensor(x, requires_grad=True)
    tk.enc_head(xt, *ws).mul(ct).sum().backward()
    assert xt.grad is not None and all(w.grad is None for w in ws)
    want = tk.head_grads_plain(torch.tensor(x), *ws, ct, input_grad=True)
    assert torch.equal(xt.grad, want[0])
    for w in ws:
        w.requires_grad_()
    tk.enc_head(torch.tensor(x), *ws).mul(ct).sum().backward()
    for w, g in zip(ws, want[1:]):
        assert torch.equal(w.grad, g)


def test_padding_ring_is_zero_not_elu_b0():
    """conv1 pads the stage-0 activation with zeros: with a zero input and zero conv0
    weights stage 0 is elu(b0) everywhere inside, and the border outputs differ from
    the interior ones only through that zero ring."""
    x = torch.zeros(1, 16, 16, 4)
    w0 = torch.zeros(8, 4, 4, 4)
    b0 = torch.full((8,), 0.5)
    w1 = torch.ones(12, 8, 4, 4) * 0.01
    b1 = torch.zeros(12)
    y = tk.head_forward(x, w0, b0, w1, b1)
    e = 0.5 * 0.01 * 8
    assert torch.allclose(y[0, 1, 1], torch.full((12,), 16 * e))     # interior: 16 taps
    assert torch.allclose(y[0, 0, 0], torch.full((12,), 9 * e))      # corner: 3 x 3 taps
