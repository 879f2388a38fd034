"""The port's generation slice — latent codes → SDF volumes → meshes →
frames — held against the JAX package on the CPU, with the bundled
weights (not a trained shape: about -0.02 everywhere), plus the guarantees
around it: no jax in the port, no silent CPU fallback, and a chip_smoke.py
that fails without a GPU."""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.train import hybrid_gan as jax_hybrid_gan
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.train.hybrid_gan import generate_volumes_inference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "shapegan_tpu", "examples")

# The port runs the kernels' bf16 plain versions on the CPU; the JAX side
# off a TPU is float32 XLA. On the bundled network the bf16 path stays
# within 2.3e-4 of float32 (all 8 bundled codes at 32^3; bf16's relative
# step is 2^-8); the bound leaves 4x room for other shapes and points.
BF16_VS_F32_ATOL = 1e-3


@functools.lru_cache(maxsize=1)
def _bundled():
    """(numpy params, numpy codes) from the bundled example checkpoints."""
    with np.load(os.path.join(EXAMPLES, "sdf_net.npz")) as data:
        params = {k: data[k].astype(np.float32) for k in data.files}
    with np.load(os.path.join(EXAMPLES, f"{LATENT_CODES_FILENAME}.npz")) as data:
        codes = data["array"].astype(np.float32)
    return params, codes


def test_checkpoint_fallback_reads_bundled_example(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no models/ here: both loads fall back
    np_params, np_codes = _bundled()
    params = checkpoints.load("sdf_net")
    assert set(params) == set(np_params)
    assert all(v.dtype == torch.float32 for v in params.values())
    np.testing.assert_array_equal(params["w2"].numpy(), np_params["w2"])
    codes = checkpoints.load_array(LATENT_CODES_FILENAME)
    assert codes.dtype == np.float32
    np.testing.assert_array_equal(codes, np_codes)
    assert checkpoints.get_filename("x", 3) == os.path.join("models", "checkpoints", "x-epoch-00003.npz")


def test_get_voxels_matches_jax():
    np_params, codes = _bundled()
    ref = JaxSDFNet().get_voxels({k: jnp.asarray(v) for k, v in np_params.items()},
                                 codes[0], voxel_resolution=16)
    net = SDFNet(checkpoints.load("sdf_net", base=EXAMPLES))
    out = net.get_voxels(torch.tensor(codes[0]), voxel_resolution=16)
    assert out.shape == (16, 16, 16) and out.dtype == torch.float32
    assert (out < 0).any() and (out == 1.0).any()  # a surface, and the sphere mask
    np.testing.assert_allclose(out.numpy(), ref, atol=BF16_VS_F32_ATOL)


def test_evaluate_chunks_match_unchunked():
    np_params, codes = _bundled()
    net = SDFNet(checkpoints.load("sdf_net", base=EXAMPLES))
    pts = torch.tensor(np.random.default_rng(0).uniform(-1, 1, (1000, 3)).astype(np.float32))
    whole = net.evaluate(pts, torch.tensor(codes[1]))
    chunked = net.evaluate(pts, torch.tensor(codes[1]), chunk_size=300)
    assert whole.shape == chunked.shape == (1000,)
    # One path (folded latent) for every size: chunking only splits the rows.
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)
    ref = np.asarray(JaxSDFNet().evaluate({k: jnp.asarray(v) for k, v in np_params.items()},
                                          pts.numpy(), codes[1], chunk_size=300))
    np.testing.assert_allclose(chunked.numpy(), ref, atol=BF16_VS_F32_ATOL)


def test_sdfnet_keeps_its_parameters_device():
    """SDFNet never moves the parameters it is given: they stay where they
    lie, and a ``device`` that disagrees with them raises."""
    on_cpu = checkpoints.load("sdf_net", base=EXAMPLES)
    params = {k: v.to("meta") for k, v in on_cpu.items()}
    assert SDFNet(params).device == torch.device("meta")
    assert SDFNet(params, device="meta").device == torch.device("meta")
    with pytest.raises(ValueError, match="lie on meta, not on cpu"):
        SDFNet(params, device="cpu")
    with pytest.raises(ValueError, match="several devices"):
        SDFNet({**params, "w2": on_cpu["w2"]})
    assert SDFNet().device == torch.device("cpu")
    assert SDFNet(device="meta").device == torch.device("meta")


def test_generate_volumes_inference_matches_jax():
    np_params, codes = _bundled()
    latents = codes[:4]
    grid = voxel_coordinates(16)
    ref = jax_hybrid_gan.generate_volumes_inference(
        JaxSDFNet(), {k: jnp.asarray(v) for k, v in np_params.items()},
        jnp.asarray(grid.numpy()), jnp.asarray(latents), 16)
    net = SDFNet(checkpoints.load("sdf_net", base=EXAMPLES))
    out = generate_volumes_inference(net, grid, torch.tensor(latents), 16)
    assert out.shape == (4, 16, 16, 16) and out.dtype == torch.float32
    assert torch.isfinite(out).all() and (out.abs() <= 1).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BF16_VS_F32_ATOL)


def test_get_mesh_matches_jax():
    np_params, codes = _bundled()
    ref = JaxSDFNet().get_mesh({k: jnp.asarray(v) for k, v in np_params.items()},
                               codes[2], voxel_resolution=16)
    mesh = SDFNet(checkpoints.load("sdf_net", base=EXAMPLES)).get_mesh(
        torch.tensor(codes[2]), voxel_resolution=16)
    assert mesh is not None and ref is not None
    # bf16 vs float32 SDF values: the triangle count may differ where a
    # corner value sits near the level, so compare the surfaces' extents.
    assert abs(len(mesh.faces) - len(ref.faces)) <= 0.05 * len(ref.faces)
    np.testing.assert_allclose(mesh.vertices.min(0), ref.vertices.min(0), atol=0.02)
    np.testing.assert_allclose(mesh.vertices.max(0), ref.vertices.max(0), atol=0.02)


def test_demo_mesh_mode_cpu(tmp_path, monkeypatch):
    from shapegan_tpu_torch import demo_sdf_net

    monkeypatch.chdir(tmp_path)
    counts = demo_sdf_net.main(["cpu", "mode=mesh", "samples=2", "frames_per_transition=1",
                                "resolution=64", "voxel_resolution=16"])
    assert len(counts) == 2 and all(c > 0 for c in counts)
    for i in range(2):
        with open(tmp_path / demo_sdf_net.OUT_DIR / f"frame-{i:05d}.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with pytest.raises(SystemExit, match="unknown mode"):
        demo_sdf_net.main(["cpu", "mode=voxels"])


def test_png_writer_roundtrip(tmp_path):
    import zlib

    from shapegan_tpu_torch.demo_sdf_net import write_png
    from shapegan_tpu_torch.render.png import read_png

    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(5, 1 + 7 * 3)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), img)
    # The reader gives the pixels back, and refuses what is not a PNG.
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    (tmp_path / "b.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(tmp_path / "b.png"))


def test_cli_device_selection():
    assert resolve_device(parse_cli(["cpu", "samples=3"])) == torch.device("cpu")
    cfg = parse_cli(["iteration=2", "--category", "planes", "continue", "seed=3", "g_every=2"])
    assert (cfg.iteration, cfg.category, cfg.resume) == (2, "planes", True)
    assert cfg.extras == {"g_every": 2}
    assert (cfg.seed, cfg.device) == (3, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(cfg)


def test_port_never_imports_jax(tmp_path):
    """Every port module imports, and a tiny get_mesh runs, with no jax in
    the process."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import shapegan_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from shapegan_tpu_torch import checkpoints\n"
        "from shapegan_tpu_torch.models.sdf_net import SDFNet\n"
        "net = SDFNet(checkpoints.load('sdf_net'))\n"
        "codes = checkpoints.load_array('sdf_net_latent_codes')\n"
        "mesh = net.get_mesh(torch.tensor(codes[0]), voxel_resolution=8)\n"
        "assert mesh is not None and len(mesh.faces) > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "print('NOJAX-OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX-OK" in proc.stdout


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and
    when it is alone in a directory without the repo."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("this host has a GPU")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        (tmp_path / "chip_smoke.py").write_bytes(open(script, "rb").read())
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
