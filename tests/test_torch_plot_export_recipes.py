"""The port's figure factory against the repo's root ``create_plot.py``:
the hybrid GAN's upscaling figure, the STL exports, the screenshot grids on
files Pillow writes and the SDF cross-section, on the same files. Volumes
and meshes are held at the bf16 bounds (the port's bf16 network against the
JAX package's float32 one), the frame by
``test_torch_plot_env.assert_frames_close``, the rest exactly."""

import glob
import os

import numpy as np
import pytest
from PIL import Image

import test_torch_plot_env as env
from test_torch_plot_env import in_plot_dir, jax_plot, plot_dir  # noqa: F401  (fixtures)
from shapegan_tpu.data.mesh_io import load_mesh as jax_load_mesh
from shapegan_tpu.ops.mesh_extract import extract_mesh as jax_extract_mesh
from shapegan_tpu_torch import create_plot
from shapegan_tpu_torch.data.mesh_io import load_mesh

# A volume of the bf16 network against float32 over its largest |SDF|
# (tests/test_torch_plot_recipes.py's BF16_VS_F32_REL).
BF16_VS_F32_REL = 1e-2
# Meshes of the bf16 network against float32: the triangle counts within
# 5 % and the extents within 0.02 (tests/test_torch_slice.py's get_mesh
# test; read here 0.4 % and 4e-3 at 64^3); and the port's extraction
# against the JAX package's on one volume (tests/test_torch_mesh_extract.py's
# atol).
MESH_FACES_SHARE = 0.05
MESH_EXTENT_ATOL = 0.02
EXTRACT_ATOL = 1e-5


def test_hybrid_gan_upscaling_matches_jax(jax_plot, monkeypatch):
    """The 32^3 volume, its x4 zoom and the voxel_res volume against the
    JAX recipe's at the bf16 bound, and the raymarched cell at the frame
    tolerance."""
    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.hybrid_gan_upscaling([], env.jax_config(**env.FRAMES))
    grid = env.port_main("hybrid_gan_upscaling", [], **env.FRAMES)
    want = record["grids"][0]
    for x, shape in ((0, (32,) * 3), (1, (118,) * 3), (2, (24,) * 3)):
        got, theirs = grid.cells[(x, 0)]["volume"], want.cells[(x, 0)]["volume"]
        assert got.shape == theirs.shape == shape
        assert np.abs(got - theirs).max() <= BF16_VS_F32_REL * np.abs(theirs).max()
        assert grid.cells[(x, 0)]["image"].shape[2] == 3
    env.assert_frames_close(grid.cells[(3, 0)]["image"], want.cells[(3, 0)]["image"])


def _stl_meshes(pattern):
    return {os.path.basename(p): load_mesh(p) for p in sorted(glob.glob(pattern))}


@pytest.mark.parametrize("recipe, args, pattern", [
    ("export_stl", ["2"], "plots/stl/*.stl"),
    ("deepsdf_interpolation_stl", [], "plots/mesh-*.stl"),
])
def test_stl_exports_match_jax(recipe, args, pattern, jax_plot, monkeypatch):
    """The same files; each welded mesh against the JAX recipe's (its
    triangle count and extent at the bf16 bounds); and each equal (at the extraction tolerance) to the JAX
    package's extraction of the port's own volume, padded and welded as the
    recipe does."""
    import torch

    from shapegan_tpu.data.mesh_io import TriangleMesh as JaxTriangleMesh

    for path in glob.glob(pattern):
        os.remove(path)
    config = env.port_config(voxel_res=16)
    getattr(jax_plot, recipe)(list(args), env.jax_config(voxel_res=16))
    theirs = {name: jax_load_mesh(path) for name, path in
              ((os.path.basename(p), p) for p in sorted(glob.glob(pattern)))}
    for path in glob.glob(pattern):
        os.remove(path)
    written = env.port_main(recipe, args, voxel_res=16)
    ours = _stl_meshes(pattern)
    assert sorted(ours) == sorted(theirs) == sorted(os.path.basename(p) for p in written)
    assert len(ours) >= 2
    net, codes = create_plot._load_sdf_net(config)
    if recipe == "export_stl":
        rng = np.random.default_rng(0)
        picks = [codes[rng.integers(len(codes))] for _ in range(2)]
        res, sphere_only = 64, True
    else:
        index = np.random.default_rng(0).choice(len(codes), 2, replace=False)
        picks = create_plot._interpolate(codes[index[0]], codes[index[1]], len(ours))
        res, sphere_only = 16, False
    for (name, mesh), code in zip(sorted(ours.items()), picks):
        want = theirs[name]
        # bf16 against float32 may flip a corner's sign near the surface,
        # which adds or drops small triangles there
        assert abs(len(mesh.faces) - len(want.faces)) <= MESH_FACES_SHARE * len(want.faces)
        np.testing.assert_allclose(mesh.vertices.min(0), want.vertices.min(0), atol=MESH_EXTENT_ATOL)
        np.testing.assert_allclose(mesh.vertices.max(0), want.vertices.max(0), atol=MESH_EXTENT_ATOL)
        volume = np.pad(net.get_voxels(torch.tensor(code, dtype=torch.float32), res,
                                       sphere_only=sphere_only).numpy(), 1, constant_values=1.0)
        vertices, faces = jax_extract_mesh(volume, level=0.0, spacing=2.0 / res)
        ref = JaxTriangleMesh(vertices - 1.0, faces).weld()
        np.testing.assert_array_equal(mesh.faces, ref.faces)
        np.testing.assert_allclose(mesh.vertices, ref.vertices, atol=EXTRACT_ATOL)


def test_screenshot_grids_match_jax(jax_plot, monkeypatch):
    """``wgan_results`` and ``shapenet_errors`` on screenshots Pillow
    writes (RGB, RGBA and a palette file, a content box over 200 pixels so
    the crop engages): each cell equal to the JAX recipe's."""
    rng = np.random.default_rng(9)
    for i in range(2):
        image = np.full((300, 280, 3), 255, np.uint8)
        image[20:260, 30:250] = rng.integers(0, 200, (240, 220, 3), dtype=np.uint8)
        Image.fromarray(image).save(f"screenshots/wgan/{i}.png")
        rgba = np.concatenate([image, np.full((300, 280, 1), 255, np.uint8)], axis=2)
        saved = Image.fromarray(rgba) if i == 0 else Image.fromarray(image).convert(
            "P", palette=Image.ADAPTIVE, colors=64)
        saved.save(f"screenshots/errors/error-{i + 1}.png")
    for recipe in ("wgan_results", "shapenet_errors"):
        record = env.record_jax(monkeypatch, jax_plot)
        getattr(jax_plot, recipe)([], env.jax_config())
        grid = env.port_main(recipe)
        want = record["grids"][0]
        for key, cell in grid.cells.items():
            theirs = want.cells[key]["image"]
            if theirs.ndim == 2:  # the JAX recipe crops the palette indices
                continue
            np.testing.assert_array_equal(cell["image"], theirs)
        assert grid.cells[(0, 0)]["image"].shape[:2] == (238, 238)


def test_sdf_slice_matches_jax(jax_plot, tmp_path):
    """The cross-section of a box mesh from the port's C++ engine against
    the JAX recipe's file (its engine, written by Pillow)."""
    from shapegan_tpu.data.mesh_io import TriangleMesh as JaxTriangleMesh
    from shapegan_tpu.data.mesh_io import save_obj
    from shapegan_tpu.data.synthetic import box_sdf
    from shapegan_tpu.ops.coords import voxel_coordinate_grid

    sdf = box_sdf(voxel_coordinate_grid(16)).astype(np.float32)
    vertices, faces = jax_extract_mesh(sdf, spacing=2.0 / 15, origin=(-1, -1, -1))
    mesh_path = str(tmp_path / "box.obj")
    save_obj(JaxTriangleMesh(vertices, faces), mesh_path)
    jax_plot.sdf_slice([mesh_path], env.jax_config(res=64))
    want = np.asarray(Image.open("plots/sdf_example.png"))
    got = env.port_main("sdf_slice", [mesh_path], res=64)
    assert got.shape == want.shape == (64, 64, 3)
    assert (got != want).any(axis=2).mean() <= 0.01
    assert (got == 0).all(axis=2).any() and (got[..., 0] == 255).any()
