"""Nothing the benchmark runs imports JAX, its libraries or the JAX package (top-level
names compared whole: ``lshm_tpu_torch`` is not ``lshm_tpu``), and the reference
imports nothing of the port."""

import ast
import subprocess
import sys

from portbench import spec
from portbench.run import FORBIDDEN, forbidden_modules

FILES = sorted(p for p in spec.HERE.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_anywhere():
    for path in FILES:
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((spec.HERE / "reference").rglob("*.py")):
        for mod in _imports(path):
            assert mod.split(".")[0] != "lshm_tpu_torch", (path, mod)
            if mod.split(".")[0] == "portbench":
                assert mod in ("portbench.data",) or mod.startswith("portbench.reference"), (path, mod)


def test_whole_names():
    sys.modules.setdefault("lshm_tpu_torch_fake_probe", sys)
    try:
        assert "lshm_tpu_torch_fake_probe" not in forbidden_modules()
    finally:
        del sys.modules["lshm_tpu_torch_fake_probe"]


def test_a_run_loads_no_jax():
    """Importing every module the harness runs, with the port, loads no JAX."""
    code = ("import sys, importlib; sys.path.insert(0, %r)\n"
            "from portbench import run, spec, data, compare, trace, readers, weights\n"
            "from portbench.drivers import trainer\n"
            "import lshm_tpu_torch.train\n"
            "print(run.forbidden_modules())" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"
