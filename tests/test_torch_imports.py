"""The port stands alone: every module of ``shapegan_tpu_torch`` and the
module of ``chip_smoke.py`` import in a fresh interpreter in which any
import of ``jax``, ``jaxlib`` or the JAX package ``shapegan_tpu`` raises,
and in which starting a process (a compiler) raises: importing builds
neither the C++ libraries nor the CUDA kernels."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARDED_IMPORTS = r"""
import importlib
import importlib.util
import pkgutil
import subprocess
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "shapegan_tpu"):
            raise ImportError(f"the port imported {name}")
        return None


def refuse_process(*args, **kwargs):
    raise RuntimeError(f"a process was started while importing: {args}")


sys.meta_path.insert(0, Refuse())
subprocess.run = subprocess.Popen = refuse_process
import shapegan_tpu_torch

names = [m.name for m in pkgutil.walk_packages(shapegan_tpu_torch.__path__, "shapegan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(names))
print(" ".join(names))
"""


def test_port_imports_nothing_of_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", GUARDED_IMPORTS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    count, names = proc.stdout.splitlines()[-2:]
    assert int(count) >= 36  # every module was walked
    for module in ("models.point_sdf_net", "ops.point_gen_kernels", "train.point_gan",
                   "data.datasets", "data.synthetic", "models.gan", "train.hybrid_gan",
                   "train.hybrid_wgan", "train.point_gan_ref", "metrics", "gan_gate",
                   "render.viewer", "host_build", "data.mesh_io", "data.mesh_to_sdf",
                   "data.fixtures", "data.shapenet", "data.prepare", "prepare_data",
                   "prepare_shapenet_dataset", "run_fixture_corpus", "make_examples", "demo_gan",
                   "demo_autoencoder", "demo_training", "demo_latent_space", "embedding",
                   "render.binary_voxels", "render.panel", "render.png", "render.colormaps",
                   "render.font", "render.figure", "create_plot", "demo_data_preparation",
                   "parallel.mesh", "parallel.rank_checks", "dryrun_multichip"):
        assert f"shapegan_tpu_torch.{module}" in names.split(), module
