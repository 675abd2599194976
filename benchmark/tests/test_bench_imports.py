"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (``speedseq_tpu_torch`` begins with
``speedseq_tpu``), and the plain reference imports nothing of the
program: an AST scan of the files, then a process that blocks ``jax``
and ``speedseq_tpu`` and runs a tiny cell on the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "speedseq_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def _files(top):
    for d, _, fs in os.walk(top):
        if "cache" in d.split(os.sep):
            continue
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    bad = [(p, m) for p in _files(BENCH) for m in _imports(p) if m in JAX]
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    bad = [(p, m) for p in _files(ref) for m in _imports(p)
           if m.startswith("speedseq")]
    assert not bad


def test_a_run_with_jax_blocked_loads_none_of_it(tmp_path):
    code = f"""
import sys
for m in {sorted(JAX)!r}:
    sys.modules[m] = None
sys.path.insert(0, {harness.ROOT!r})
from benchmark.tests.tiny import tiny_copy
from benchmark import harness
bench = tiny_copy({str(tmp_path)!r})
cell = harness.Cell(harness.load_manifest({str(tmp_path)!r}),
                    "germline-wgs30x.var", bench)
r = harness.run_cell(cell, 5, 0.01, False, "cpu")
loaded = {{m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}}
assert not loaded & set({sorted(JAX)!r}), loaded
assert "speedseq_tpu_torch" in loaded
print("OK", r["correct"])
"""
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK True"
