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
    # copies and the native library's bindings included)
    assert int(count) >= 50


def test_walk_reaches_the_multi_card_entry_points():
    """The scan and the probe reach the multi-card modules: the spawned
    ranks' entry point, the eval fan-out and the shard tool; the smoke's
    data-parallel rank is a top-level function (``spawn`` pickles it by
    name), and its imports are among those scanned above."""
    import importlib
    import pkgutil

    import semseg_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(semseg_tpu_torch.__path__,
                                                    "semseg_tpu_torch.")}
    assert {"semseg_tpu_torch.parallel.distributed", "semseg_tpu_torch.cli.eval_multipro",
            "semseg_tpu_torch.tools.combine_eval_shards"} <= names
    assert callable(importlib.import_module("semseg_tpu_torch.cli.train")._rank_main)
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    top = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"_dp_rank", "data_parallel_phase"} <= top


def test_walk_reaches_the_native_library_and_the_new_entry_points():
    """The scan and the probe reach the native host library's bindings and
    their CPU fingerprint, and the entry points of remat, ``cli.serve
    --devices`` and ``cli.eval --profile``."""
    import importlib
    import pkgutil

    import semseg_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(semseg_tpu_torch.__path__,
                                                    "semseg_tpu_torch.")}
    assert {"semseg_tpu_torch.native", "semseg_tpu_torch.utils.host"} <= names
    native = importlib.import_module("semseg_tpu_torch.native")
    assert callable(native.decode_jpeg_verified) and callable(native.build_info)
    assert callable(importlib.import_module("semseg_tpu_torch.cli.serve").serve_devices)
    assert callable(importlib.import_module("semseg_tpu_torch.models.layers").recomputing)
    eval_src = open(os.path.join(PORT, "cli", "eval.py")).read()
    assert '"--profile"' in eval_src and '"--spatial"' in eval_src


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
