"""The port's raymarcher (shapegan_tpu_torch.render.raymarching) and the
surface methods of its SDFNet, held against the JAX package on the CPU.

The network is built by hand at full width with an exact surface, the
octahedron (|x| + |y| + |z| - 0.45) / sqrt(3) (shapegan_tpu_torch.examples),
so no test needs training; both packages get its parameters and the same
numpy inputs. The port runs the kernels' plain versions (bf16), the JAX
package its float32 CPU path.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.render import raymarching as jax_rm
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.render import raymarching as rm
from shapegan_tpu_torch.render.png import read_png

# Normals (bf16 network, through the plain versions of the grid kernel and
# its backward) against the JAX package's float32 autodiff normals: measured
# cosine >= 0.9999999 at 4000 points in the radius-0.7 ball. Projected
# points (p - sdf * normal) for |sdf| < 0.1: measured distance <= 1.6e-3
# (median 4.2e-4), from the bf16 SDF (|d sdf| <= 2.4e-3).
NORMAL_COSINE = 0.99999
PROJECTION_DIST = 5e-3
# A whole 24^2 x ssaa 2 frame against the JAX package's float32 frame:
# measured identical (no pixel differs). Bounds: at most 2 pixels shaded in
# one frame and background in the other (bf16 may classify a silhouette
# pixel the other way), mean |d pixel| <= 0.05 over the frame, and
# |d pixel| <= 2 (of 255) on every pixel both frames shade. Wrong shading
# fails them: specular power 17 for 20, rim weight 0.15 for 0.3, or ground
# shadow 0.7 for 0.65 (mean |d pixel| 0.08-0.20); rim weight 0.27 moves no
# pixel of this frame by a level.
FRAME_MASK_DIFFER_PIXELS = 2
FRAME_MEAN_PIXEL_DIFF = 0.05
FRAME_MAX_PIXEL_DIFF = 2


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them (the trace's many small bf16 products then run ~100x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=1)
def _octahedron():
    params = octahedron_params()
    return params, {k: jnp.asarray(v) for k, v in params.items()}


def _net():
    return SDFNet(sdf_mlp.params_from_jax(_octahedron()[0]))


def _code(seed=0):
    return np.random.default_rng(seed).normal(size=128).astype(np.float32)


def test_camera_rays_match_jax():
    """numpy in: the same numpy math, exactly; torch in: against the JAX
    package's traced (float32) version, with and without a basis, the
    directions within 1e-6 (measured 1.2e-7) and the entered mask exactly;
    the entry points within 1e-5 (measured 3.0e-6: the entry distance
    -b - sqrt(disc) cancels in float32, so a few ulps of b grow)."""
    for size in (7, 32):
        for got, want in zip(rm.camera_rays(rm.CAMERA_POSITION, size, radius=1.3),
                             jax_rm.camera_rays(jax_rm.CAMERA_POSITION, size, radius=1.3)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rm.CAMERA_POSITION, jax_rm.CAMERA_POSITION)
    np.testing.assert_array_equal(rm.LIGHT_POSITION, jax_rm.LIGHT_POSITION)
    cam = np.asarray(rm.CAMERA_POSITION, np.float32)
    fwd = -cam / np.linalg.norm(cam)
    right = np.cross(fwd, [0.0, 1.0, 0.0]).astype(np.float32)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right).astype(np.float32)
    for basis in (None, (right, up, fwd)):
        got = rm.camera_rays(torch.tensor(cam), 40, basis=None if basis is None else
                             tuple(torch.tensor(b) for b in basis))
        want = jax_rm.camera_rays(jnp.asarray(cam), 40, xp=jnp, basis=basis)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("kind", ["primary", "shadow"])
def test_default_schedule_matches_jax(kind):
    for n in (100, 2048, 2049, 4096, 2304 * 4, 2_560_000):
        for iterations in (100, 101, 200, 1000):
            assert rm._default_schedule(kind, n, iterations) == \
                jax_rm._default_schedule(kind, n, iterations)


@pytest.mark.parametrize("size, radius", [(48, 1.0), (96, 1.0), (200, 1.6)])
def test_shadow_mask_capacity_matches_jax(size, radius):
    got = rm._shadow_mask_capacity(rm.CAMERA_POSITION, size, radius)
    assert got == jax_rm._shadow_mask_capacity(jax_rm.CAMERA_POSITION, size, radius)
    rm._shadow_mask_capacity(rm.CAMERA_POSITION, size, radius)
    assert rm._shadow_mask_capacity_cached.cache_info().hits >= 1


@pytest.mark.parametrize("factor", [2, 3])
def test_lanczos3_downsample_matches_jax(factor):
    """Two depthwise conv1d passes with edge replication against the JAX
    package's conv_general_dilated version: within 1e-6."""
    image = np.random.default_rng(factor).random((24 * factor, 20 * factor, 3)).astype(np.float32)
    got = rm._lanczos3_downsample(torch.tensor(image), factor)
    want = np.asarray(jax_rm._lanczos3_downsample(jnp.asarray(image), factor))
    assert got.shape == want.shape == (24, 20, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_normals_and_surface_projection_match_jax():
    """SDFNet.project_to_surface (bf16, B1 and B2's plain versions) against
    the JAX package's get_normals and its candidate projection
    (models/sdf_net.py:_surface_candidates_jit) on the same points; the
    chunked gradient equals the unchunked one."""
    params, jparams = _octahedron()
    net = _net()
    code = _code()
    rng = np.random.default_rng(3)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * rng.random((4000, 1)) ** (1 / 3) * 0.7).astype(np.float32)
    projected, normals, sdf = net.project_to_surface(torch.tensor(code), torch.tensor(pts))
    want_normals = np.asarray(JaxSDFNet().get_normals(jparams, code, pts))
    want_sdf = np.asarray(jax_mlp.apply_grid(jparams, jnp.asarray(pts), jnp.asarray(code)[None])[0])
    cosine = (normals.numpy() * want_normals).sum(1)
    assert cosine.min() >= NORMAL_COSINE, cosine.min()
    torch.testing.assert_close(net.get_normals(code, pts), normals)
    keep = np.abs(want_sdf) < 0.1
    assert keep.mean() > 0.1
    dist = np.linalg.norm(projected.numpy() - (pts - want_normals * want_sdf[:, None]), axis=1)
    assert dist[keep].max() <= PROJECTION_DIST, dist[keep].max()

    folded = sdf_mlp.fold_latent(net.param_dict(), torch.tensor(code))
    whole = K.points_value_and_gradient(folded, torch.tensor(pts), torch.zeros(0))
    chunked = K.points_value_and_gradient(folded, torch.tensor(pts), torch.zeros(0),
                                          chunk_size=999)
    torch.testing.assert_close(whole, chunked, rtol=0, atol=0)
    with pytest.raises(ValueError, match="chunk"):
        K.points_value_and_gradient(folded, torch.tensor(pts), torch.zeros(0),
                                    chunk_size=K.ROW_CAP + 1)


def test_surface_points_lie_on_the_octahedron():
    """get_surface_points (seeded generator) and its batched form land on
    |x| + |y| + |z| = 0.45; the mesh-sampled uniform points near it."""
    net = _net()
    code = _code(1)
    gen = torch.Generator().manual_seed(0)
    pts, normals = net.get_surface_points(code, sample_size=6000, return_normals=True,
                                          generator=gen)
    assert pts.shape[0] > 200 and normals.shape == pts.shape
    l1 = pts.abs().sum(1)
    assert float((l1 - 0.45).abs().median()) < 0.01
    again = net.get_surface_points(code, sample_size=6000, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(again, pts)
    batch = net.get_surface_points_in_batches(code, amount=400, generator=gen)
    assert batch.shape == (400, 3) and bool(batch.abs().sum(1).gt(0).all())
    # get_mesh's vertex frame (the reference's: spacing 2/res on a padded
    # grid) is off the evaluation grid by about a cell, 0.0625 at 32^3.
    uniform = net.get_uniform_surface_points(code, point_count=300, voxel_resolution=32)
    assert uniform.shape == (300, 3)
    assert np.abs(np.abs(uniform).sum(1) - 0.45).max() < 3 * 0.0625


def test_get_shadows_and_get_normals_match_jax():
    """The host-side helpers on numpy points: shadow rays from the ground
    under the octahedron and from its surface toward the light (a padded
    200-step shadow trace), and chunked normals, against the JAX package.
    Measured: the shadow flags agree on all 500 points (31.6 % shadowed),
    normals to cosine 0.9999999; bounds: 99 % and NORMAL_COSINE."""
    _, jparams = _octahedron()
    net, jnet = _net(), JaxSDFNet()
    code = _code(5)
    rng = np.random.default_rng(6)
    ground = np.stack([rng.uniform(-0.9, 0.9, 300), np.full(300, -0.46),
                       rng.uniform(-0.9, 0.9, 300)], axis=1)
    surface = rng.normal(size=(200, 3))
    surface = surface / np.abs(surface).sum(1, keepdims=True) * 0.455
    points = np.concatenate([ground, surface]).astype(np.float32)
    got = rm.get_shadows(net, code, points, rm.LIGHT_POSITION)
    want = jax_rm.get_shadows(jnet, jparams, code, points, jax_rm.LIGHT_POSITION)
    assert got.dtype == np.float32 and 0.05 < got.mean() < 0.95
    assert (got == want).mean() >= 0.99
    normals = rm.get_normals(net, code, points, batch_size=128)
    want_normals = jax_rm.get_normals(jnet, jparams, code, points, batch_size=128)
    assert (normals * want_normals).sum(1).min() >= NORMAL_COSINE


def test_render_image_matches_jax():
    """One whole frame, 24^2 x ssaa 2 (2304 rays: the compaction schedules
    engage), the port in bf16 against the JAX package in float32."""
    _, jparams = _octahedron()
    code = _code(2)
    got = rm.render_image(_net(), code, resolution=24, ssaa=2)
    want = np.asarray(jax_rm.render_image(JaxSDFNet(), jparams, code, resolution=24, ssaa=2))
    assert got.shape == want.shape == (24, 24, 3) and got.dtype == np.uint8
    mask, want_mask = (got != 255).any(axis=2), (want != 255).any(axis=2)
    diff = np.abs(got.astype(np.float64) - want)
    assert (mask != want_mask).sum() <= FRAME_MASK_DIFFER_PIXELS
    assert diff.mean() <= FRAME_MEAN_PIXEL_DIFF, diff.mean()
    assert diff[mask & want_mask].max() <= FRAME_MAX_PIXEL_DIFF, diff[mask & want_mask].max()
    assert 0.05 < mask.mean() < 0.5 and len(np.unique(got.reshape(-1, 3), axis=0)) > 10
    # With crop the 48^2 frame (too small to crop) is Lanczos-resized on the
    # host instead of downsampled on the device (test_torch_render_extras.py
    # holds it against the JAX package's crop frame).
    cropped = rm.render_image(_net(), code, resolution=24, ssaa=2, crop=True)
    assert cropped.shape == (24, 24, 3) and cropped.dtype == np.uint8
    assert np.abs(cropped.astype(int) - got).mean() <= 1.0


def test_render_image_sequence_and_cached_index(tmp_path, monkeypatch):
    """Frames in turn, in order, with on_frame streaming; the per-index
    render is cached on disk as a PNG and read back."""
    net = _net()
    codes = [_code(i) for i in range(3)]
    kw = dict(resolution=8, ssaa=1, iterations=8, sdf_offset=0.1)
    seq = [rm.render_image(net, c, **kw) for c in codes]
    seen = {}
    assert rm.render_image_sequence(net, codes, on_frame=seen.__setitem__, **kw) is None
    kept = rm.render_image_sequence(net, codes, **kw)
    for i in range(3):
        np.testing.assert_array_equal(seen[i], seq[i])
        np.testing.assert_array_equal(kept[i], seq[i])

    monkeypatch.chdir(tmp_path)
    calls = []

    def fake_render(net, code, resolution, crop):
        calls.append(resolution)
        return np.full((resolution, resolution, 3), 7, np.uint8)

    monkeypatch.setattr(rm, "render_image", fake_render)
    first = rm.render_image_for_index(net, codes, 1, resolution=16)
    second = rm.render_image_for_index(net, codes, 1, resolution=16)
    assert calls == [16]
    np.testing.assert_array_equal(first, second)
    assert (tmp_path / "screenshots" / "raymarching-examples" / "image-1-16.png").exists()


def test_demo_raymarch_mode_cpu(tmp_path, monkeypatch):
    """The demo's raymarch mode on the CPU, the octahedron saved into a
    temporary models/: one 24^2 frame (ssaa 2), a non-blank PNG."""
    from shapegan_tpu_torch import demo_sdf_net

    monkeypatch.chdir(tmp_path)
    params, _ = _octahedron()
    checkpoints.save(params, "sdf_net", base="models")
    checkpoints.save_array(np.stack([_code(3), _code(4)]), LATENT_CODES_FILENAME, base="models")
    counts = demo_sdf_net.main(["cpu", "mode=raymarch", "samples=1", "frames_per_transition=1",
                                "resolution=24"])
    image = read_png(str(tmp_path / demo_sdf_net.OUT_DIR / "frame-00000.png"))
    assert image.shape == (24, 24, 3)
    assert counts == [int((image != 255).any(axis=2).sum())] and counts[0] > 0.05 * 24 * 24
