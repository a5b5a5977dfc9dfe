"""The port imports neither JAX, flax nor the JAX package ``semseg_tpu``.

Two checks: a static scan of every ``import``/``from`` statement in the
port's sources and ``chip_smoke.py``, and a fresh interpreter that imports
every port module and then lists what got loaded. The probe runs once with
SEMSEG_PLATFORM unset and once with it set (``semseg_tpu/__init__.py``
imports JAX whenever it is set, so importing ``semseg_tpu`` at all would show
up there); the test process itself has JAX loaded by conftest.
"""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "semseg_tpu_torch")
FORBIDDEN = ("semseg_tpu", "jax", "flax")

PROBE = r"""
import importlib, pkgutil, sys
import semseg_tpu_torch
names = ["semseg_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(semseg_tpu_torch.__path__, "semseg_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
top = {m.split(".")[0] for m in sys.modules}
print(len(names), sorted(m for m in ("jax", "flax", "semseg_tpu") if m in top))
"""


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        found += [(node.lineno, m) for m in mods if m.split(".")[0] in FORBIDDEN]
    return found


@pytest.mark.parametrize("relpath", _sources())
def test_source_imports_nothing_of_jax(relpath):
    assert _forbidden_imports(os.path.join(ROOT, relpath)) == []


def test_scan_finds_forbidden_imports(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom semseg_tpu.data import ValDataset\n"
                   "from flax import linen\nimport semseg_tpu_torch\n"
                   "def f():\n    from semseg_tpu import native\n")
    assert [m for _, m in _forbidden_imports(str(bad))] == [
        "jax.numpy", "semseg_tpu.data", "flax", "semseg_tpu"]


def _probe(env):
    proc = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.split(maxsplit=1)
    assert loaded.strip() == "[]"
    # package, subpackages and the ported modules (config, data and utils
    # copies included)
    assert int(count) >= 29


def test_port_imports_without_jax():
    _probe({k: v for k, v in os.environ.items() if k != "SEMSEG_PLATFORM"})


def test_port_imports_without_jax_with_platform_set():
    _probe(dict(os.environ, SEMSEG_PLATFORM="cpu"))


def test_serving_host_loads_no_model_code():
    """A serving host runs an exported bundle with no model zoo: importing
    ``semseg_tpu_torch.serving`` loads no ``semseg_tpu_torch.models`` module."""
    probe = ("import sys, semseg_tpu_torch.serving; "
             "print(sorted(m for m in sys.modules if m.startswith('semseg_tpu_torch.models')))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
