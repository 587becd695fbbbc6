"""The port's standalone first stage (kernel K6, its plain version on the CPU) against
the probe's XLA reference ``conv0_xla`` (benchmarks/pallas_conv_probe.py:104), loaded
by path; and the port's probe tool on the CPU."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu_torch.kernels import conv0 as k6
from lshm_tpu_torch.tools import conv0_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_probe", os.path.join(ROOT, "benchmarks", "pallas_conv_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("C,B,P", [(4, 5, 128), (8, 3, 36)])
def test_conv0_elu_matches_the_probes_xla_reference(C, B, P):
    rng = np.random.default_rng(C + P)
    x = rng.normal(size=(B, P, P, C)).astype(np.float32)
    w4 = (rng.normal(size=(4, 4, C, 8)) * 0.1).astype(np.float32)      # HWIO
    bias = (rng.normal(size=8) * 0.1).astype(np.float32)
    want = np.asarray(_probe_module().conv0_xla(jnp.asarray(x), jnp.asarray(w4),
                                                jnp.asarray(bias)))
    w = torch.tensor(np.ascontiguousarray(w4.transpose(3, 2, 0, 1)))    # OIHW
    for fn in (k6.conv0_elu_plain, k6.conv0_elu):
        got = fn(torch.tensor(x), w, torch.tensor(bias)).numpy()
        assert got.shape == (B, P // 2, P // 2, 8)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_conv0_refuses_what_the_kernel_does_not_take():
    x, w, b = torch.randn(2, 16, 16, 4), torch.randn(8, 4, 4, 4), torch.zeros(8)
    with pytest.raises(TypeError):
        k6.conv0_elu(x.double(), w, b)
    with pytest.raises(TypeError):
        k6.conv0_elu(x.to(torch.bfloat16), w, b)         # bf16 x, float32 weights
    with pytest.raises(ValueError):
        k6.conv0_elu(x.permute(0, 2, 1, 3), w, b)
    with pytest.raises(ValueError):
        k6.conv0_elu(x[:, :, :15].contiguous(), w, b)
    with pytest.raises(ValueError):
        k6.conv0_elu(x, w[:, :2].contiguous(), b)


def test_probe_tool_parity_on_the_cpu_and_no_timing_without_a_card(monkeypatch):
    """The tool's parity step runs anywhere (on the CPU the wrapper is the plain
    version); its entry point times on the card and raises when there is none."""
    row = conv0_probe.parity(torch.device("cpu"), batch=2)
    assert row["parity_max_abs_err"] == 0.0 and row["parity_batch"] == 2
    assert conv0_probe.bound(420)[1] == "bytes"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conv0_probe.main(["--batch", "2"])
