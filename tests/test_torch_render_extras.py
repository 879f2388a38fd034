"""The port's small library pieces held against the JAX package, or the
library it calls, on the CPU with the same numpy inputs: uniform points in
the ball, the marching-cubes facade, the rematerialised grid evaluation,
binary voxel meshes (and the headless viewer's binary frame), Pillow's
Lanczos resize written out, and render_image's crop."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.ops import coords as jax_coords
from shapegan_tpu.ops import mesh_extract as jax_mesh_extract
from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.render import raymarching as jax_rm
from shapegan_tpu.render.binary_voxels import create_binary_voxel_mesh as jax_binary_mesh
from shapegan_tpu.render.viewer import MeshRenderer as JaxMeshRenderer
from shapegan_tpu.util import crop_image as jax_crop_image
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import coords, mesh_extract, sdf_mlp
from shapegan_tpu_torch.render import raymarching as rm
from shapegan_tpu_torch.render.binary_voxels import create_binary_voxel_mesh
from shapegan_tpu_torch.render.viewer import MeshRenderer
from shapegan_tpu_torch.util import resize_lanczos

# The ball's transform: the same float32 operations on the same draws
# (read 6e-8: XLA and torch take the norm's square root apart).
BALL_ATOL = 1e-6
# Uniform in the ball: P(|p| <= r) = r^3; the KS statistic of 20,000 radii
# (read 0.0060; its 1 % critical value is 0.0115).
BALL_KS = 0.02
# Face normals of the same triangle soup (read 0).
NORMALS_ATOL = 1e-5
# apply_grid_remat: float32 against JAX's float32 (read 3.8e-7 on values,
# 2.2e-7 on point gradients) and against the port's unchunked apply_grid
# (read 6.3e-8 and 0: a chunk's products block the sums otherwise).
REMAT_RTOL_JAX = 1e-5
REMAT_RTOL_PORT = 1e-6
# Pillow's fixed point written out: at most one level on any value, and
# nearly all values equal (read: all equal).
LANCZOS_MAX_LEVELS = 1
LANCZOS_EQUAL_SHARE = 0.99
# The whole-frame bounds of tests/test_torch_raymarch.py (bf16 port against
# the JAX package's float32 frame).
FRAME_MASK_DIFFER_PIXELS = 2
FRAME_MEAN_PIXEL_DIFF = 0.05
FRAME_MAX_PIXEL_DIFF = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test (the workers of pytest-xdist share the
    cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_unit_ball_transform_matches_jax_on_its_draws():
    """The port's transform of JAX's own two draws equals
    ``sample_unit_sphere`` of the key they came from."""
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    normal = np.asarray(jax.random.normal(k1, (2000, 3), dtype=jnp.float32))
    uniform = np.asarray(jax.random.uniform(k2, (2000, 1), dtype=jnp.float32))
    want = np.asarray(jax_coords.sample_unit_sphere(key, 2000))
    got = coords.unit_ball_from_draws(torch.tensor(normal), torch.tensor(uniform)).numpy()
    np.testing.assert_allclose(got, want, atol=BALL_ATOL, rtol=0)


def test_sample_unit_sphere_is_uniform_in_the_ball():
    n = 20000
    points = coords.sample_unit_sphere(n, torch.Generator().manual_seed(0))
    assert points.shape == (n, 3) and points.dtype == torch.float32
    radius = np.sort(torch.linalg.norm(points, dim=1).double().numpy())
    assert radius.max() <= 1.0 + 1e-6
    cdf = radius ** 3
    ks = max(np.max(np.arange(1, n + 1) / n - cdf), np.max(cdf - np.arange(n) / n))
    assert ks <= BALL_KS, ks
    again = coords.sample_unit_sphere(n, torch.Generator().manual_seed(0))
    assert torch.equal(points, again)


def _sphere(res=16):
    axis = np.linspace(-1, 1, res, dtype=np.float32)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.6).astype(np.float32)


def test_marching_cubes_matches_jax():
    vol = _sphere()
    got = mesh_extract.marching_cubes(torch.tensor(vol), level=0.0, spacing=2.0 / 15)
    want = jax_mesh_extract.marching_cubes(vol, level=0.0, spacing=2.0 / 15)
    verts, faces, normals, values = got
    assert verts.shape == want[0].shape and verts.shape[0] > 0
    np.testing.assert_array_equal(faces, want[1])
    np.testing.assert_allclose(verts, want[0], atol=1e-5)
    np.testing.assert_allclose(normals, want[2], atol=NORMALS_ATOL)
    np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-5)
    assert values.shape == (verts.shape[0],) and not values.any()
    with pytest.raises(NotImplementedError, match="anisotropic"):
        mesh_extract.marching_cubes(torch.tensor(vol), spacing=(1.0, 1.0, 2.0))


@functools.lru_cache(maxsize=1)
def _small_params():
    """A small-width network (L = 5, breadth 32) from the JAX init."""
    return {k: np.asarray(v) for k, v in jax_mlp.init(jax.random.PRNGKey(1), 5, 32).items()}


def test_apply_grid_remat_matches_jax_and_apply_grid():
    """Values and point gradients, B = 2, P = 1000, a chunk of 384 that does
    not divide P."""
    params = _small_params()
    rng = np.random.default_rng(0)
    points = rng.uniform(-1, 1, (1000, 3)).astype(np.float32)
    latents = rng.normal(size=(2, 5)).astype(np.float32)
    weights = rng.normal(size=(2, 1000)).astype(np.float32)

    def jax_loss(pts):
        out = jax_mlp.apply_grid_remat(params, pts, jnp.asarray(latents), chunk_size=384)
        return jnp.sum(out * weights), out

    (_, want), want_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(points))
    tparams = sdf_mlp.params_from_jax(params)
    outs, grads = [], []
    for fn in (lambda p: sdf_mlp.apply_grid_remat(tparams, p, torch.tensor(latents), chunk_size=384),
               lambda p: sdf_mlp.apply_grid(tparams, p, torch.tensor(latents))):
        pts = torch.tensor(points, requires_grad=True)
        out = fn(pts)
        (out * torch.tensor(weights)).sum().backward()
        outs.append(out.detach().numpy())
        grads.append(pts.grad.numpy())
    assert outs[0].shape == (2, 1000)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert rel(outs[0], np.asarray(want)) <= REMAT_RTOL_JAX
    assert rel(grads[0], np.asarray(want_grad)) <= REMAT_RTOL_JAX
    assert rel(outs[0], outs[1]) <= REMAT_RTOL_PORT
    assert rel(grads[0], grads[1]) <= REMAT_RTOL_PORT


@pytest.mark.parametrize("res, seed", [(8, 0), (13, 1)])
def test_binary_voxel_mesh_matches_jax(res, seed):
    """Random occupancies (about 40 %): the same welded vertices and faces."""
    vol = np.random.default_rng(seed).uniform(-0.6, 1.0, (res,) * 3).astype(np.float32)
    got = create_binary_voxel_mesh(vol)
    want = jax_binary_mesh(vol)
    assert got.faces.shape[0] > 0
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert torch.equal(torch.as_tensor(create_binary_voxel_mesh(torch.tensor(vol)).faces),
                       torch.as_tensor(got.faces))
    empty = create_binary_voxel_mesh(np.ones((4, 4, 4), np.float32))
    assert empty.vertices.shape == (0, 3) and empty.faces.shape == (0, 3)


def test_viewer_binary_voxels_match_jax():
    """``set_voxels(use_marching_cubes=False)``: the JAX viewer's mesh (its
    transform into [-1, 1]^3), and a frame of it."""
    vol = np.random.default_rng(4).uniform(-0.5, 1.0, (10, 10, 10)).astype(np.float32)
    ours, theirs = MeshRenderer(size=96, start_thread=False), JaxMeshRenderer(size=96, start_thread=False)
    theirs._gl_failed = True
    ours.set_voxels(vol, use_marching_cubes=False)
    theirs.set_voxels(vol, use_marching_cubes=False)
    np.testing.assert_array_equal(ours._vertices, theirs._vertices)
    np.testing.assert_array_equal(ours._normals, theirs._normals)
    assert ours.model_size == theirs.model_size == 1.4
    assert ours.ground_level == theirs.ground_level
    frame = ours.get_image()
    assert frame.shape == (96, 96, 3) and 0.05 < (frame != 255).any(axis=2).mean() < 0.9


@pytest.mark.parametrize("shape, size", [
    ((100, 100), (37, 37)),     # down by 2.7
    ((57, 91), (40, 23)),       # down by non-integer factors, odd sizes
    ((30, 50), (45, 50)),       # up on one axis only
    ((33, 17), (20, 40)),       # down on one axis, up on the other
    ((421, 400), (200, 200)),   # a crop box's shape to a frame
])
def test_resize_lanczos_matches_pil(shape, size):
    """Random uint8 RGB (and greyscale) images, resized by PIL's
    ``Image.LANCZOS`` and by the port."""
    rng = np.random.default_rng(sum(shape))
    image = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    smooth = np.clip(np.cumsum(rng.normal(0, 8, shape), axis=1) + 128, 0, 255).astype(np.uint8)
    for img, mode in ((image, "RGB"), (smooth, "L")):
        want = np.asarray(Image.fromarray(img, mode).resize((size[1], size[0]), Image.LANCZOS))
        got = resize_lanczos(img, size)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= LANCZOS_MAX_LEVELS
        assert (diff == 0).mean() >= LANCZOS_EQUAL_SHARE
    assert resize_lanczos(image, shape) is image  # nothing to resize


def _blob_frame(size=500, seed=0):
    """A white frame with a shaded disc off centre (a crop box of ~300 px)."""
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[:size, :size]
    r = np.hypot(rows - 0.55 * size, cols - 0.45 * size)
    frame = np.full((size, size, 3), 255, np.uint8)
    inside = r < 0.3 * size
    shade = (200 * (1 - r / (0.3 * size)))[..., None] * np.array([0.8, 0.1, 0.1])
    frame[inside] = np.clip(shade[inside] + rng.normal(0, 6, (inside.sum(), 3)), 0, 254).astype(np.uint8)
    return frame


def _jax_crop_path(pixels, resolution, ssaa):
    """``shapegan_tpu.render.raymarching.render_image``'s host part after
    the device frame (raymarching.py:677-690)."""
    pixels = jax_crop_image(pixels / 255.0, background=1)
    image = Image.fromarray(np.uint8(np.round(pixels * 255.0)), "RGB")
    if ssaa != 1:
        image = image.resize((resolution, resolution), Image.LANCZOS)
    return np.asarray(image)


@pytest.mark.parametrize("resolution, ssaa", [(250, 2), (200, 3), (500, 1)])
def test_crop_frame_matches_jax_host_path(resolution, ssaa):
    frame = _blob_frame(resolution * ssaa)
    got = rm.crop_frame(frame, resolution, ssaa)
    want = _jax_crop_path(frame, resolution, ssaa)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= LANCZOS_MAX_LEVELS
    if ssaa == 1:  # the crop box's size, not resolution^2
        assert got.shape[0] == got.shape[1] < resolution
    else:
        assert got.shape == (resolution, resolution, 3)


@pytest.mark.parametrize("resolution, ssaa", [(256, 2), (400, 1), (150, 3)])
def test_render_image_crop_wiring_matches_jax(monkeypatch, resolution, ssaa):
    """render_image(crop=True) of both packages with their device frame
    replaced by one synthetic frame whose box (~0.6 of the frame) is over
    crop_image's 200 px, so the crop runs: each package asks for a frame
    of resolution * ssaa with no device downsample, and the two results
    agree. (A real frame that large is not rendered here: a single-thread
    CPU render of one takes tens of seconds, and the fixture octahedron
    scaled to fill it meets the JAX package's float32 XLA frame only at
    bf16 distance; the chip check holds the real frame's crop.)"""
    asked = []

    def fake_render_pixels(*args, size, ssaa, **kwargs):
        asked.append((size, ssaa))
        return _blob_frame(size)[::ssaa, ::ssaa]  # a device downsample left on would show

    monkeypatch.setattr(rm, "_render_pixels",
                        lambda *a, **kw: torch.from_numpy(fake_render_pixels(*a, **kw).copy()))
    monkeypatch.setattr(jax_rm, "_render_pixels", fake_render_pixels)
    code = np.zeros(128, np.float32)
    got = rm.render_image(SDFNet(sdf_mlp.params_from_jax(octahedron_params())), code,
                          resolution=resolution, ssaa=ssaa, crop=True)
    want = np.asarray(jax_rm.render_image(JaxSDFNet(), None, code, resolution=resolution,
                                          ssaa=ssaa, crop=True))
    assert asked == [(resolution * ssaa, 1)] * 2
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want).max() <= LANCZOS_MAX_LEVELS
    if ssaa == 1:  # the crop box's size
        assert 200 < got.shape[0] == got.shape[1] < resolution
    else:
        assert got.shape == (resolution, resolution, 3)


def test_render_image_crop_matches_jax():
    """A whole crop frame of the octahedron, 24^2 x ssaa 2 (the 48^2 frame
    too small to crop, then Lanczos to 24^2), against the JAX package's."""
    params = octahedron_params()
    code = np.random.default_rng(2).normal(size=128).astype(np.float32)
    got = rm.render_image(SDFNet(sdf_mlp.params_from_jax(params)), code, resolution=24, ssaa=2,
                          crop=True)
    want = np.asarray(jax_rm.render_image(JaxSDFNet(), {k: jnp.asarray(v) for k, v in params.items()},
                                          code, resolution=24, ssaa=2, crop=True))
    assert got.shape == want.shape == (24, 24, 3) and got.dtype == np.uint8
    mask, want_mask = (got != 255).any(axis=2), (want != 255).any(axis=2)
    diff = np.abs(got.astype(np.float64) - want)
    assert (mask != want_mask).sum() <= FRAME_MASK_DIFFER_PIXELS
    assert diff.mean() <= FRAME_MEAN_PIXEL_DIFF, diff.mean()
    assert diff[mask & want_mask].max() <= FRAME_MAX_PIXEL_DIFF
    assert 0.05 < mask.mean() < 0.6
