"""What the benchmark imports: nothing of JAX or the JAX package anywhere
(top-level names compared whole: the port's name begins with the JAX
package's), and nothing of the program in its yardstick."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "shapegan_tpu"}
# The yardstick: references, inputs, counts. The drivers and the tests call
# the program; these may not.
YARDSTICK = ("reference", "inputs", "counts.py", "seeds.py", "readers.py", "profiling.py",
             "harness.py", "peaks.json")


def _modules():
    for directory, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(directory, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, harness.BENCH_DIR))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"


def test_yardstick_imports_nothing_of_the_program():
    for path in _modules():
        rel = os.path.relpath(path, harness.BENCH_DIR)
        if rel.split(os.sep)[0] in YARDSTICK:
            tops = {name.split(".")[0] for name in _imports(path)}
            assert "shapegan_tpu_torch" not in tops, rel


GUARD = r"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "shapegan_tpu", "shapegan_tpu_torch"):
            raise ImportError(f"imported {name}")
sys.meta_path.insert(0, Refuse())
import benchmark.reference.sdf_net, benchmark.reference.critic, benchmark.reference.raymarch
import benchmark.reference.train_steps, benchmark.inputs.chair, benchmark.inputs.shapes
import benchmark.counts, benchmark.harness, benchmark.profiling, benchmark.readers
print("ok")
"""


def test_reference_loads_without_the_program():
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]


def test_run_refuses_a_machine_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "hpgan64.generate",
                           "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout
