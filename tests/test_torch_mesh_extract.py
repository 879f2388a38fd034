"""The port's marching tetrahedra (shapegan_tpu_torch.ops.mesh_extract)
against the JAX package's extract_mesh on the same volumes."""

import numpy as np
import pytest
import torch

from shapegan_tpu.ops.mesh_extract import extract_mesh as jax_extract_mesh
from shapegan_tpu_torch.ops.mesh_extract import extract_mesh


def _volume(kind, res=12, seed=0):
    rng = np.random.default_rng(seed)
    axis = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    if kind == "sphere":
        vol = np.sqrt(x**2 + y**2 + z**2) - 0.6
    elif kind == "noisy_box":
        vol = np.maximum(np.maximum(abs(x), abs(y)), abs(z)) - 0.5
        vol = vol + 0.05 * rng.normal(size=vol.shape)
    else:  # exact zeros on grid corners: the degenerate-triangle filter
        vol = np.round(x * 4) / 4
    return vol.astype(np.float32)


@pytest.mark.parametrize("kind, level, spacing, origin", [
    ("sphere", 0.0, 2.0 / 11, None),
    ("noisy_box", 0.02, 0.5, (0.1, -0.2, 0.3)),
    ("plane_on_corners", 0.0, 1.0, None),
])
def test_same_triangle_soup_as_jax(kind, level, spacing, origin):
    vol = _volume(kind)
    verts, faces = extract_mesh(torch.tensor(vol), level=level, spacing=spacing, origin=origin)
    ref_verts, ref_faces = jax_extract_mesh(vol, level=level, spacing=spacing, origin=origin)
    assert verts.dtype == np.float32 and faces.dtype == np.int32
    assert verts.shape == ref_verts.shape and verts.shape[0] > 0
    np.testing.assert_array_equal(faces, ref_faces)
    np.testing.assert_allclose(verts, ref_verts, atol=1e-5)


def test_empty_volume():
    verts, faces = extract_mesh(torch.ones(6, 6, 6))
    assert verts.shape == (0, 3) and faces.shape == (0, 3)
