"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX package, its entry
points refuse to fall back to the CPU, its kernel wrappers refuse inputs the kernels do
not take, unported config fields raise, and chip_smoke.py fails without a card."""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

from lshm_tpu_torch import config as tc
from lshm_tpu_torch.kernels import conv_head, khm
from lshm_tpu_torch.train import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import lshm_tpu_torch
for m in pkgutil.walk_packages(lshm_tpu_torch.__path__, "lshm_tpu_torch."):
    importlib.import_module(m.name)
bad = [k for k, m in sys.modules.items() if m is not None and (
       k == "lshm_tpu" or k.startswith("lshm_tpu.")
       or k.split(".")[0] in ("jax", "flax", "optax", "orbax"))]
assert not bad, bad
print("imported", len([k for k in sys.modules if k.startswith("lshm_tpu_torch")]))
"""


def test_port_imports_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "flax", "optax", "lshm_tpu"), name


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Here (no CUDA) and in a directory holding only chip_smoke.py, the script exits
    non-zero and prints no result line."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT), (str(alone), tmp_path)):
        r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_trainer_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tc.Config())


def _khm_inputs():
    return torch.randn(6, 16), torch.rand(3, 16)


def _head_inputs():
    return (torch.randn(2, 16, 16, 4), torch.randn(8, 4, 4, 4), torch.zeros(8),
            torch.randn(12, 8, 4, 4), torch.zeros(12))


@pytest.mark.parametrize("bad", ["float64", "non-contiguous"])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(bad):
    def spoil(t):
        return t.double() if bad == "float64" else t.t().contiguous().t()

    X, M = _khm_inputs()
    err = TypeError if bad == "float64" else ValueError
    with pytest.raises(err):
        khm.khm_forward(spoil(X), M, 4)
    _, e = khm.khm_forward(X, M, 4)
    with pytest.raises(err):
        khm.khm_backward(X, spoil(M), e, torch.tensor(1.0), 4)

    x, w0, b0, w1, b1 = _head_inputs()
    bad_x = x.double() if bad == "float64" else x.permute(0, 2, 1, 3)
    with pytest.raises(err):
        conv_head.head_forward(bad_x, w0, b0, w1, b1)
    g1 = torch.randn(2, 4, 4, 12)
    with pytest.raises(err):
        conv_head.head_weight_grads(x, w0, b0, w1, b1,
                                    g1.double() if bad == "float64" else g1.transpose(1, 2))


def test_kernel_wrappers_refuse_wrong_shapes():
    X, M = _khm_inputs()
    with pytest.raises(ValueError):
        khm.khm_forward(X, M[:, :8].contiguous(), 4)
    with pytest.raises(ValueError):
        khm.khm_forward(X, M, 3)                  # the kernel takes even p only
    x, w0, b0, w1, b1 = _head_inputs()
    with pytest.raises(ValueError):
        conv_head.head_forward(x[:, :, :15].contiguous(), w0, b0, w1, b1)
    with pytest.raises(ValueError):
        conv_head.head_forward(x, w0, b0, w1[:6].contiguous(), b1)


UNPORTED = {
    "model.fourier_variant": lambda c: _rep(c, "model", fourier_variant=True),
    "model.compute_dtype": lambda c: _rep(c, "model", compute_dtype="bfloat16"),
    "optim.optimizer": lambda c: _rep(c, "optim", optimizer="lbfgs"),
    "train.ramp": lambda c: _rep(c, "train", ramp=(tc.RampStage(optimizer="lbfgs"),)),
    "train.mesh_shape": lambda c: _rep(c, "train", mesh_shape=(4,)),
    "train.remat": lambda c: _rep(c, "train", remat=True),
    "data.device_decode": lambda c: _rep(c, "data", device_decode=True),
}


def _rep(cfg, section, **kw):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})


@pytest.mark.parametrize("field", sorted(UNPORTED))
def test_unported_fields_raise(field):
    cfg = UNPORTED[field](tc.Config())
    with pytest.raises(NotImplementedError, match=field):
        tc.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=field):
        Trainer(cfg, device="cpu")


def test_port_defaults_select_the_kernels():
    m = tc.Config().model
    assert m.khm_backend == "auto" and m.pallas_head is True
    tc.check_supported(tc.preset("full_khm"))
    assert tc._apply_overrides(tc.Config(), ["model.khm_backend=xla"]).model.khm_backend == "xla"
