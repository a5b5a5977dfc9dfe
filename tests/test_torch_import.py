"""Importing the port never imports JAX or flax.

Checked in a fresh interpreter with SEMSEG_PLATFORM unset (it would make
``semseg_tpu/__init__.py`` import JAX); the test process itself has JAX
loaded by conftest.
"""

import os
import subprocess
import sys

PROBE = r"""
import importlib, pkgutil, sys
import semseg_tpu_torch
names = ["semseg_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(semseg_tpu_torch.__path__, "semseg_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
print(len(names), sorted(m for m in ("jax", "flax") if m in sys.modules))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "SEMSEG_PLATFORM"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.split(maxsplit=1)
    assert loaded.strip() == "[]"
    assert int(count) >= 19  # package, subpackages and the 15 ported modules
