"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX package (nor
sklearn, matplotlib, PIL or networkx at import: the functions that draw import them),
names no file of the JAX package's native decoder, its entry points refuse to fall back
to the CPU, its kernel wrappers refuse inputs the kernels do not take, unported config
fields and options raise, and chip_smoke.py fails without a card."""

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
       or k.split(".")[0] in ("jax", "flax", "optax", "orbax", "sklearn", "matplotlib",
                              "PIL", "networkx"))]
assert not bad, bad
for name in ("lshm_tpu_torch.cli", "lshm_tpu_torch.data.device_decode",
             "lshm_tpu_torch.graph", "lshm_tpu_torch.train.parallel",
             "lshm_tpu_torch.train.distributed", "lshm_tpu_torch.tools.ranks"):
    assert name in sys.modules, name
print("imported", len([k for k in sys.modules if k.startswith("lshm_tpu_torch")]))
"""

_CLI_HELP = """
import sys
sys.modules["jax"] = None          # any import of jax now raises
from lshm_tpu_torch import cli
for argv in (["--help"], *([c, "--help"] for c in (
        "synth", "train", "eval", "import-torch", "graph", "demo", "rica", "export",
        "bench"))):
    try:
        cli.main(argv)
    except SystemExit as e:
        assert e.code == 0, (argv, e.code)
bad = [k for k, m in sys.modules.items() if m is not None and (
       k == "lshm_tpu" or k.startswith("lshm_tpu.") or k.split(".")[0] in ("jax", "torch")
       or k.startswith("lshm_tpu_torch.kernels"))]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_cli_help_imports_neither_jax_nor_torch():
    """``--help`` of the CLI and of each subcommand imports no JAX, nothing of the JAX
    package, no torch and no kernel: the commands import what they use."""
    r = subprocess.run([sys.executable, "-c", _CLI_HELP], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-1] == "ok"


def test_port_never_names_the_jax_native_decoder():
    """The port builds, writes and loads its native decoder in its own tree: no file of
    the port, nor chip_smoke.py, names the JAX package's native directory, whose
    binding builds there during the JAX tests."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "lshm_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith((".py", ".cpp", ".cu",
                                                                   ".cuh"))]
    assert any(p.endswith(os.path.join("native", "patchio.cpp")) for p in paths)
    for path in paths:
        text = open(path).read()
        for name in ("lshm_tpu/native", "lshm_tpu.native", "lshm_tpu import native"):
            assert name not in text, (path, name)


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


def _eval_model():
    from lshm_tpu_torch.models import CascadedAE

    return CascadedAE(tc.ModelConfig(latent_dim=16, latent_dim_1d=8, num_clusters=4))


def test_evaluation_without_device_needs_a_card(monkeypatch):
    from lshm_tpu_torch.data import synth_extract
    from lshm_tpu_torch.eval import baseline_distance_matrix, save_recon_panels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = synth_extract()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        baseline_distance_matrix(_eval_model(), tree, "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        save_recon_panels(_eval_model(), tree, "0", [0], "unused")


def test_unported_decoders_raise_by_name():
    """Asking for the device-side decode (A5) where it cannot run raises, never a silent
    host fallback: without prefetch, or with a custom augment.  (The native host decoder,
    A6, is ported: ``tests/test_torch_native.py`` holds it and its ``use_native`` rule.)"""
    from lshm_tpu_torch.data import MinibatchSampler, synth_extract

    tree = synth_extract()
    cfg = _rep(_rep(tc.Config(), "data", device_decode=True, prefetch=0, batch_size=1),
               "model", latent_dim=16, latent_dim_1d=8, num_clusters=4)
    sampler = MinibatchSampler([tree], ["0"], cfg.data)
    with pytest.raises(ValueError, match="prefetch"):
        Trainer(cfg, device="cpu").run(sampler)
    cfg = _rep(cfg, "data", prefetch=1, augment=True)
    custom = MinibatchSampler([tree], ["0"], cfg.data, augment_fn=lambda rng, p: p)
    with pytest.raises(ValueError, match="augment"):
        Trainer(cfg, device="cpu").run(custom)


def test_evaluation_refuses_a_model_on_another_device():
    from lshm_tpu_torch.data import synth_extract
    from lshm_tpu_torch.eval import baseline_distance_matrix

    with pytest.raises(ValueError, match="move the model"):
        baseline_distance_matrix(_eval_model(), synth_extract(), "0", device="meta")


def _khm_inputs():
    return torch.randn(6, 16), torch.rand(3, 16)


def _head_inputs():
    return (torch.randn(2, 16, 16, 4), torch.randn(8, 4, 4, 4), torch.zeros(8),
            torch.randn(12, 8, 4, 4), torch.zeros(12))


@pytest.mark.parametrize("bad", ["float64", "non-contiguous", "mixed"])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(bad):
    """float64; a non-contiguous tensor; one tensor in bf16 among float32 ones (the
    KHM kernel takes float32 only, the head one dtype for all its tensors)."""
    cast = {"float64": torch.float64, "mixed": torch.bfloat16}.get(bad)

    def spoil(t):
        return t.to(cast) if cast else t.t().contiguous().t()

    X, M = _khm_inputs()
    err = TypeError if cast else ValueError
    with pytest.raises(err):
        khm.khm_forward(spoil(X), M, 4)
    _, e = khm.khm_forward(X, M, 4)
    with pytest.raises(err):
        khm.khm_backward(X, spoil(M), e, torch.tensor(1.0), 4)

    x, w0, b0, w1, b1 = _head_inputs()
    bad_x = x.to(cast) if cast else x.permute(0, 2, 1, 3)
    with pytest.raises(err):
        conv_head.head_forward(bad_x, w0, b0, w1, b1)
    g1 = torch.randn(2, 4, 4, 12)
    with pytest.raises(err):
        conv_head.head_weight_grads(x, w0, b0, w1, b1,
                                    g1.to(cast) if cast else g1.transpose(1, 2))


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


def _rep(cfg, section, **kw):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})


def _lbfgs_f32():
    cfg = tc.preset("full_khm_lbfgs")
    return _rep(cfg, "model", compute_dtype="float32")


@pytest.mark.parametrize("how", ["preset_float32", "lbfgs_ramp"])
def test_lbfgs_configs_are_supported(how):
    """The L-BFGS preset with float32 activations, and an Adam -> L-BFGS ramp."""
    if how == "preset_float32":
        cfg = _lbfgs_f32()
        assert cfg.optim.optimizer == "lbfgs"
        assert cfg.optim.group_schedule == ("ae2d", "ae1d", "khm")
    else:
        cfg = _rep(tc.Config(), "train", ramp=(
            tc.RampStage(epochs=1, optimizer="adam"),
            tc.RampStage(epochs=2, alpha=0.01, beta=0.01, gamma=0.01, optimizer="lbfgs")))
    tc.check_supported(cfg)
    assert Trainer(cfg, device="cpu").state is None


def test_lbfgs_preset_as_published_still_needs_bfloat16():
    """preset("full_khm_lbfgs") keeps the JAX preset's bfloat16 activations, and the
    port now runs them: the preset is supported as published and a Trainer builds."""
    cfg = tc.preset("full_khm_lbfgs")
    assert cfg.model.compute_dtype == "bfloat16"
    tc.check_supported(cfg)
    assert Trainer(cfg, device="cpu").state is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bfloat16_full", "float16"])
def test_compute_dtypes(dtype):
    """The three compute dtypes of the JAX package are supported; any other raises."""
    cfg = _rep(tc.Config(), "model", compute_dtype=dtype)
    if dtype == "float16":
        with pytest.raises(ValueError, match="compute_dtype"):
            tc.check_supported(cfg)
    else:
        tc.check_supported(cfg)


def test_input_gradient_wrapper_refuses_what_the_kernel_does_not_take():
    x, w0, b0, w1, b1 = _head_inputs()
    g1 = torch.randn(2, 4, 4, 12)
    with pytest.raises(TypeError):
        conv_head.head_input_grad(x, w0, b0, w1, b1, g1.double())
    with pytest.raises(ValueError):
        conv_head.head_input_grad(x, w0, b0, w1, b1, g1.transpose(1, 2))
    with pytest.raises(ValueError):
        conv_head.head_input_grad(x, w0, b0, w1, b1, g1[:, :3].contiguous())


def test_port_defaults_select_the_kernels():
    m = tc.Config().model
    assert m.khm_backend == "auto" and m.pallas_head is True
    tc.check_supported(tc.preset("full_khm"))
    assert tc._apply_overrides(tc.Config(), ["model.khm_backend=xla"]).model.khm_backend == "xla"
