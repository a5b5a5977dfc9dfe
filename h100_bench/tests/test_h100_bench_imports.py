"""What the benchmark loads: nothing that ``run.py`` and its drivers load
imports JAX or the JAX package, and the plain reference imports nothing of
the program either. Top-level module names are compared whole, so
``semseg_tpu_torch`` is not ``semseg_tpu``."""

import ast
import json
import os
import subprocess
import sys

from h100_bench import harness

REFERENCE = os.path.join(harness.BENCH, "reference")


def _loaded(code: str) -> set:
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    done = subprocess.run([sys.executable, "-c", probe], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    return set(json.loads(done.stdout.strip().splitlines()[-1]))


def test_the_run_loads_neither_jax_nor_the_jax_package():
    metrics = [m["name"] for m in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
               ["per_layer"]]
    code = ("import runpy, sys; sys.argv = ['run.py', '--help']\n"
            "from h100_bench import harness, trace, data, frozen\n"
            "from h100_bench.drivers import eval_ms, train\n"
            "import semseg_tpu_torch.cli.eval, semseg_tpu_torch.models.builder\n"
            "import semseg_tpu_torch.parallel.train_step, semseg_tpu_torch.parallel.mesh\n"
            f"[harness.metric_reader(m) for m in {metrics!r}]\n")
    loaded = _loaded(code)
    assert "semseg_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import h100_bench.reference.model, h100_bench.reference.evaluate,"
                     " h100_bench.reference.train")
    assert not loaded & (set(harness.FORBIDDEN) | {"semseg_tpu_torch"})


def test_the_references_sources_import_nothing_of_the_program():
    for name in os.listdir(REFERENCE):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REFERENCE, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in set(harness.FORBIDDEN) | {"semseg_tpu_torch",
                                                                          "h100_bench"}, (name, n)


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["semseg_tpu_torch", "semseg_tpu_torch.engine",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["semseg_tpu.models", "jax.numpy", "jaxlib",
                                      "flax.linen"]) == ["flax", "jax", "jaxlib", "semseg_tpu"]
