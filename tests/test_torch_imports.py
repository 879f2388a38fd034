"""The port stands alone: every module of ``shapegan_tpu_torch`` and the
module of ``chip_smoke.py`` import in a fresh interpreter in which any
import of ``jax``, ``jaxlib`` or the JAX package ``shapegan_tpu`` raises."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED_IMPORTS = r"""
import importlib
import importlib.util
import pkgutil
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "shapegan_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, Refuse())
import shapegan_tpu_torch

names = [m.name for m in pkgutil.walk_packages(shapegan_tpu_torch.__path__, "shapegan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(names))
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", GUARDED_IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 30  # every module was walked
