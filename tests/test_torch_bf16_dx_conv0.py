"""K5 (the head's input gradient) and K6 (the standalone first stage) in bfloat16: their
plain versions on the CPU against the JAX functions they replace.

- K5: ``jax.grad`` w.r.t. x of ``enc_head(..., interpret=True)`` on bf16 arrays, at
  B = 2, P = 32, C in {4, 8}, against ``head_input_grad`` and ``enc_head``'s backward.
  Both form dx as a float32 sum (the TPU kernel keeps dpre1 = g1 * elu'(a1) in float32)
  and round it once to bf16; they sum in other orders, so an element may differ by an
  ulp.  Tolerance: one bf16 ulp at the low end of a binade relative to the largest
  magnitude, 8e-3 (measured 6.8e-6 and 2.3e-4 for C = 4 and 8: 1.2e-4 and 1.8e-4 of
  the elements differ, each by one ulp of a small value).
- K6: the probe's ``conv0_xla`` (benchmarks/pallas_conv_probe.py:104) on the upcast
  bf16 inputs, the bias rounded to bf16 and the output rounded once: the Pallas kernel's
  function (its dot sums bf16 products in float32 and its ELU runs in float32).
  ``conv0_xla`` on bf16 inputs would round the pre-activation before the ELU.
  Tolerance: one bf16 ulp of the largest value, 1/32 at these magnitudes (measured
  9.8e-4 at C = 4, one ulp of a value below 0.25 in 6e-6 of the elements; 0.0 at
  C = 8).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.kernels.conv2d_outer import enc_head as jax_enc_head
from lshm_tpu_torch.kernels import conv0 as k6
from lshm_tpu_torch.kernels import conv_head as tk
from lshm_tpu_torch.tools import conv0_probe
from lshm_tpu_torch.tools.measure import bf16_ulp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_probe", os.path.join(ROOT, "benchmarks", "pallas_conv_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(a):
    return torch.tensor(np.ascontiguousarray(a)).to(torch.bfloat16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a), _f32(b)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


@pytest.mark.parametrize("C", [4, 8])
def test_bf16_input_gradient_matches_jax_interpret(C):
    rng = np.random.default_rng(10 + C)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    x, w0, b0 = f(2, 32, 32, C), f(4, 4, C, 8, scale=0.2), f(8, scale=0.1)
    w1, b1, ct = f(4, 4, 8, 12, scale=0.2), f(12, scale=0.1), f(2, 8, 8, 12)
    jx, *jw = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (x, w0, b0, w1, b1)]
    want = jax.grad(lambda v: jnp.sum(jax_enc_head(v, *jw, interpret=True)
                                      .astype(jnp.float32) * ct))(jx)
    assert want.dtype == jnp.bfloat16

    oihw = lambda w: w.transpose(3, 2, 0, 1)
    tx = _bf16(x)
    tw = [_bf16(oihw(w0)), _bf16(b0), _bf16(oihw(w1)), _bf16(b1)]
    g1 = _bf16(ct)                    # JAX's cotangent after the output's bf16 cast
    got = tk.head_input_grad(tx, *tw, g1)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert _rel(got, want) <= 8e-3
    xr = tx.clone().requires_grad_()
    (dx,) = torch.autograd.grad(tk.enc_head(xr, *tw), xr, g1)
    assert dx.dtype == torch.bfloat16 and torch.equal(dx, got)


def test_bf16_input_gradient_is_a_float32_sum_rounded_once():
    """The plain K5 on bf16 is the float32 autograd gradient (e0 rounded with an
    identity gradient) rounded once to bf16."""
    rng = np.random.default_rng(3)
    ins = [_bf16(rng.normal(size=s) * sc) for s, sc in (
        ((2, 16, 16, 4), 1.0), ((8, 4, 4, 4), 0.2), ((8,), 0.1), ((12, 8, 4, 4), 0.2),
        ((12,), 0.1), ((2, 4, 4, 12), 1.0))]
    dx32 = tk.head_grads_plain(*ins, input_grad=True)[0]
    assert dx32.dtype == torch.float32
    assert torch.equal(tk.head_input_grad(*ins), dx32.to(torch.bfloat16))


@pytest.mark.parametrize("C,B,P", [(4, 5, 128), (8, 3, 36)])
def test_bf16_conv0_matches_the_probes_function(C, B, P):
    rng = np.random.default_rng(20 + C + P)
    x = rng.normal(size=(B, P, P, C)).astype(np.float32)
    w4 = (rng.normal(size=(4, 4, C, 8)) * 0.1).astype(np.float32)      # HWIO
    bias = (rng.normal(size=8) * 0.1).astype(np.float32)
    up = lambda a: jnp.asarray(a, dtype=jnp.bfloat16).astype(jnp.float32)
    want = _probe_module().conv0_xla(up(x), up(w4), up(bias)).astype(jnp.bfloat16)
    args = (_bf16(x), _bf16(w4.transpose(3, 2, 0, 1)), _bf16(bias))     # OIHW
    for fn in (k6.conv0_elu_plain, k6.conv0_elu):
        got = fn(*args)
        assert got.dtype == torch.bfloat16 and got.shape == (B, P // 2, P // 2, 8)
        top = float(np.max(np.abs(_f32(want))))
        assert float(np.max(np.abs(_f32(got) - _f32(want)))) <= bf16_ulp(top)


def test_probe_tool_takes_bf16_by_default():
    """The probe's default dtype is bfloat16, as in JAX, with half float32's bytes in
    its bound; on the CPU its parity step compares the plain version with itself."""
    row = conv0_probe.parity(torch.device("cpu"), batch=2)
    assert row["parity_dtype"] == "bfloat16" and row["parity_max_abs_err"] == 0.0
    b16, b32 = conv0_probe.bound(420), conv0_probe.bound(420, "float32")
    assert b16[1] == b32[1] == "bytes"
    assert abs(b16[0] * 2 - b32[0]) < 1e-9 and abs(b16[0] - 0.02465) < 5e-5
