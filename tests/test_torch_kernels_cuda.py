"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without CUDA each test skips (a CUDA kernel has no CPU
or interpret mode); on a machine with a GPU run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m gpu
"""

import os

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates

pytestmark = pytest.mark.gpu

# Same operands, same bf16 rounding points: kernel and plain version agree
# to float32 summation order in the head. Measured on an H100: max <= 3e-8
# with random weights at these shapes. A kernel with a rounding point wrong
# (no bf16 round before the bias add, layer-5 adds in float32, an fp16 or
# float32 trunk) reads max >= 1.4e-4, mean >= 2.3e-5 (PERF.md, section 6).
MAX_ABS = 1e-5
MEAN_ABS = 1e-6


# B2 (grid backward) against its plain version: relative errors per output,
# ||d||_2 / ||ref||_2 for every output, max|d| / max|ref| for the outputs
# summed over many rows (d_zz1, d_zz5, d_w, d_b, d_w8, d_b8). Each dz is
# rounded to bf16 and feeds the next layer, so a float32 sum in another
# order flips a few roundings and the flips spread; on the CPU the plain
# version with float32 against float64 products (same rounding points)
# reads L2 <= 3.4e-3 and max <= 1.5e-2 on these outputs (up to 0.16 max on
# the per-point d_pp1 / d_pp5, which the max bound therefore skips).
BWD_L2 = 1e-2
BWD_MAX = 5e-2
BWD_NAMES = ("d_pp1", "d_pp5", "d_zz1", "d_zz5", "d_w", "d_b", "d_w8", "d_b8")
BWD_SUMMED = BWD_NAMES[2:]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions stay float32
    return torch.device("cuda", 0)


def _bwd_close(got, want):
    torch.cuda.synchronize()
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        d = (a.double() - b.double())
        l2 = float(d.norm() / b.double().norm().clamp_min(1e-30))
        mx = float(d.abs().max() / b.double().abs().max().clamp_min(1e-30))
        print(f"  {name}: l2 {l2:.3e} max {mx:.3e}")
        assert l2 <= BWD_L2, (name, l2)
        assert name not in BWD_SUMMED or mx <= BWD_MAX, (name, mx)


def _setup(device, n_points, n_latents, seed=0):
    params = sdf_mlp.init(torch.Generator().manual_seed(seed), device=device)
    rng = np.random.default_rng(seed)
    pts = torch.tensor(rng.uniform(-1.1, 1.1, (n_points, 3)).astype(np.float32), device=device)
    lats = torch.tensor(rng.normal(size=(n_latents, 128)).astype(np.float32), device=device)
    return params, pts, lats


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got - want).abs()
    assert float(diff.max()) <= MAX_ABS and float(diff.mean()) <= MEAN_ABS, (
        float(diff.max()), float(diff.mean()))


@pytest.mark.parametrize("n_points, n_latents", [(3001, 3), (128, 2), (5000, 1), (16**3, 16)])
def test_grid_kernel_matches_plain(cuda, n_points, n_latents):
    params, pts, lats = _setup(cuda, n_points, n_latents)
    ops = K.grid_operands(params, pts, lats)
    before = K.grid_forward_cuda.launch_count
    out = K.grid_forward_cuda(*ops)
    assert K.grid_forward_cuda.launch_count == before + 1
    _close(out, K.grid_forward_plain(*ops))


@pytest.mark.parametrize("n_points, n_latents", [(37, 1), (64 * 7 + 1, 5), (5000, 1), (32**3, 16)])
def test_grid_kernel_persistent_sizes(cuda, n_points, n_latents):
    """B1's persistent grid on the wgmma trunk at a part of one tile, a tail
    tile with B=5 (tile pairs that do not divide over the SMs), B=1 (one
    shape: the tile order's modulus 1) and more tiles than the grid has
    warpgroups; two launches bit for bit. B5a (all seven positions) at the
    same shapes: its output B1's bit for bit, its planes the plain
    version's."""
    params, pts, lats = _setup(cuda, n_points, n_latents, seed=13)
    ops = K.grid_operands(params, pts, lats)
    out = K.grid_forward_cuda(*ops)
    assert torch.equal(out, K.grid_forward_cuda(*ops))
    _close(out, K.grid_forward_plain(*ops))
    stash = tuple(range(K.HIDDEN))
    got, planes = K.grid_forward_stash_cuda(*ops, stash)
    _, want_planes = K.grid_forward_stash_plain(*ops, stash)
    torch.cuda.synchronize()
    assert torch.equal(got, out)
    for j, a, b in zip(stash, planes, want_planes):
        share = float((a != b).float().mean())
        assert share <= STASH_PLANE_SHARE, (j, share)


@pytest.mark.parametrize("n_points, folded", [(3001, False), (3001, True), (127, True), (20**3, True)])
def test_points_kernel_matches_plain(cuda, n_points, folded):
    params, pts, lats = _setup(cuda, n_points, 1, seed=1)
    lat = lats[0]
    if folded:
        params, lat = sdf_mlp.fold_latent(params, lat), lat[:0]
    ops = K.points_operands(params, pts, lat)
    before = K.points_forward_cuda.launch_count
    out = K.points_forward_cuda(*ops)
    assert K.points_forward_cuda.launch_count == before + 1
    _close(out, K.points_forward_plain(*ops))


def test_apply_grid_best_launches_kernels(cuda):
    params, pts, lats = _setup(cuda, 1000, 2, seed=2)
    counts = (K.grid_forward_cuda.launch_count, K.points_forward_cuda.launch_count)
    K.apply_grid_best(params, pts, lats)
    K.apply_grid_best(params, pts, lats[:1])
    assert (K.grid_forward_cuda.launch_count, K.points_forward_cuda.launch_count) == (
        counts[0] + 1, counts[1] + 1)


def test_wrappers_reject_bad_operands(cuda):
    params, pts, lats = _setup(cuda, 256, 2, seed=3)
    pp1, pp5, zz1, zz5, w, b, w8 = K.grid_operands(params, pts, lats)
    with pytest.raises(ValueError, match="dtype"):
        K.grid_forward_cuda(pp1.float(), pp5, zz1, zz5, w, b, w8)
    with pytest.raises(ValueError, match="contiguous"):
        K.grid_forward_cuda(pp1, pp5, zz1, zz5, w.transpose(1, 2), b, w8)
    with pytest.raises(ValueError, match="shape"):
        K.grid_forward_cuda(pp1, pp5[:-1], zz1, zz5, w, b, w8)
    with pytest.raises(ValueError, match="on cpu"):
        K.points_forward_cuda(pts, *(t.cpu() for t in K.points_operands(params, pts, lats[0])[1:]))


@pytest.mark.parametrize("case", ["trained 16x64^3", "random B=3 P=3001"])
def test_grid_backward_kernel_matches_plain(cuda, case):
    if case.startswith("trained"):
        base = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "shapegan_tpu", "examples")
        params = checkpoints.load("sdf_net", base=base, device=cuda)
        rng = np.random.default_rng(4)
        pts = voxel_coordinates(64, device=cuda)
        lats = torch.tensor(rng.normal(0, 0.1, (16, 128)).astype(np.float32), device=cuda)
    else:
        params, pts, lats = _setup(cuda, 3001, 3, seed=4)
        rng = np.random.default_rng(5)
    g = torch.tensor(rng.normal(size=(lats.shape[0], pts.shape[0])).astype(np.float32), device=cuda)
    ops = K.grid_operands(params, pts, lats)
    before = K.grid_backward_cuda.launch_count
    got = K.grid_backward_cuda(*ops, g)
    assert K.grid_backward_cuda.launch_count == before + 1
    _bwd_close(got, K.grid_backward_plain(*ops, g))


def test_apply_grid_trainable_autograd_matches_plain(cuda):
    """Gradients through the kernels (B1 forward, B2 backward) on the card
    against the same autograd function on CPU copies (the plain versions)."""
    params, pts, lats = _setup(cuda, 16**3, 3, seed=6)
    pts = voxel_coordinates(16, device=cuda)
    cot = torch.tensor(np.random.default_rng(6).normal(size=(3, 16**3)).astype(np.float32))
    grads = []
    for device in (cuda, torch.device("cpu")):
        leaves = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
        grid = pts.detach().to(device).requires_grad_(True)
        latents = lats.detach().to(device).requires_grad_(True)
        counts = (K.grid_forward_cuda.launch_count, K.grid_backward_cuda.launch_count)
        K.apply_grid_trainable(leaves, grid, latents).backward(cot.to(device))
        launched = (K.grid_forward_cuda.launch_count - counts[0],
                    K.grid_backward_cuda.launch_count - counts[1])
        assert launched == ((1, 1) if device.type == "cuda" else (0, 0))
        grads.append([leaves[k].grad for k in sdf_mlp.PARAM_KEYS] + [grid.grad, latents.grad])
    for name, a, b in zip(list(sdf_mlp.PARAM_KEYS) + ["grid", "latents"], *grads):
        a = a.cpu().double()
        l2 = float((a - b.double()).norm() / b.double().norm())
        print(f"  {name}: l2 {l2:.3e}")
        assert l2 <= BWD_L2, (name, l2)


@pytest.mark.parametrize("n_points, n_latents", [(1, 1), (65, 2), (129, 3), (3001, 2)])
def test_grid_backward_kernel_tail_tiles(cuda, n_points, n_latents):
    """B2 on the Hopper rows kernel at one row, parts of a 64-row tile and a
    tail tile: its outputs against the plain version's, and two launches
    bit for bit (no atomics; a tile's rows do not depend on which
    warpgroup takes it)."""
    params, pts, lats = _setup(cuda, n_points, n_latents, seed=7)
    g = torch.tensor(np.random.default_rng(7).normal(size=(n_latents, n_points)).astype(np.float32),
                     device=cuda)
    ops = K.grid_operands(params, pts, lats)
    got = K.grid_backward_cuda(*ops, g)
    again = K.grid_backward_cuda(*ops, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_close(got, K.grid_backward_plain(*ops, g))


def test_points_gradient_two_chunks_matches_plain(cuda):
    """B = 1, P = 262,145 through points_value_and_gradient: two B2 chunks
    (262,144 points and one), the gradient against the plain versions'."""
    params, pts, lats = _setup(cuda, K.ROW_CAP + 1, 1, seed=9)
    before = K.grid_backward_cuda.launch_count
    _, grads = K.points_value_and_gradient(params, pts, lats[0])
    assert K.grid_backward_cuda.launch_count - before == 2
    want = []
    for chunk in pts.split(K.ROW_CAP):
        ops = K.grid_operands(params, chunk, lats[:1])
        d_pp1, d_pp5 = K.grid_backward_plain(*ops, torch.ones((1, chunk.shape[0]), device=cuda))[:2]
        want.append(d_pp1 @ params["w1p"].t() + d_pp5 @ params["w5p"].t())
    want = torch.cat(want).double()
    assert float((grads.double() - want).norm() / want.norm()) <= BWD_L2


# B2's rows pass alone against grid_backward_rows_plain, by chip_smoke.py's
# bounds: per h and dz plane the share of differing bf16 elements and their
# largest difference over the plane's largest value (a flipped mask moves a
# dz element by its whole value); dx1 and gz by max |d| over max |ref|.
ROWS_PLANE_SHARE = 1e-2
ROWS_PLANE_MAX = 1.0
ROWS_DX1_MAX = 0.5
ROWS_GZ_MAX = 1e-4


@pytest.mark.parametrize("n_points, n_latents", [(3001, 3), (16**3, 16)])
def test_grid_backward_rows_matches_plain(cuda, n_points, n_latents):
    params, pts, lats = _setup(cuda, n_points, n_latents, seed=10)
    g = torch.tensor(np.random.default_rng(10).normal(size=(n_latents, n_points)).astype(np.float32),
                     device=cuda)
    ops = K.grid_operands(params, pts, lats)
    before = K.grid_backward_rows_cuda.launch_count
    h, dz, dx1, gz = K.grid_backward_rows_cuda(*ops, g)
    assert K.grid_backward_rows_cuda.launch_count == before + 1
    assert torch.equal(h, K.grid_backward_rows_cuda(*ops, g)[0])
    ph, pdz, pdx1, pgz = K.grid_backward_rows_plain(*ops, g)
    torch.cuda.synchronize()
    for name, a, b in [(f"h{j + 1}", h[j], ph[j]) for j in range(7)] + [
            (f"dz{j + 2}", dz[j], pdz[j]) for j in range(6)]:
        share = float((a != b).float().mean())
        largest = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        print(f"  {name}: share {share:.3e} largest {largest:.3e}")
        assert share <= ROWS_PLANE_SHARE and largest <= ROWS_PLANE_MAX, (name, share, largest)
    for name, a, b, bound in (("dx1", dx1, pdx1, ROWS_DX1_MAX), ("gz", gz, pgz, ROWS_GZ_MAX)):
        rel = float((a - b).abs().max() / b.abs().max())
        print(f"  {name}: {rel:.3e}")
        assert torch.isfinite(a).all() and rel <= bound, (name, rel)


# B2's passes 2-4 alone against grid_backward_passes_plain (float64 sums) on
# the same planes, by chip_smoke.py's bounds: only the order of float32 sums
# differs (measured on the H100 <= 5.6e-5 relative).
PASSES_L2 = 1e-3
PASSES_MAX = 1e-3


@pytest.mark.parametrize("n_points, n_latents, s0", [(3001, 3, 0), (3001, 2, 1), (16**3, 16, 5)])
def test_grid_backward_passes_match_plain(cuda, n_points, n_latents, s0):
    """One chunk of n_latents shapes from shape s0 on, on the rows pass's
    planes; a second call gives the same bytes."""
    params, pts, lats = _setup(cuda, n_points, n_latents, seed=11)
    g = torch.tensor(np.random.default_rng(11).normal(size=(n_latents, n_points)).astype(np.float32),
                     device=cuda)
    planes = K.grid_backward_rows_cuda(*K.grid_operands(params, pts, lats), g)
    before = K.grid_backward_passes_cuda.launch_count
    got = K.grid_backward_passes_cuda(*planes, n_latents, n_points, s0)
    assert K.grid_backward_passes_cuda.launch_count == before + 1
    again = K.grid_backward_passes_cuda(*planes, n_latents, n_points, s0)
    want = K.grid_backward_passes_plain(*planes, n_latents, n_points, s0)
    torch.cuda.synchronize()
    for name, a, b, c in zip(BWD_NAMES, got, want, again):
        assert a.shape == b.shape and torch.isfinite(a).all() and torch.equal(a, c), name
        d = (a.double() - b.double()).abs()
        l2 = float(d.norm() / b.double().norm().clamp_min(1e-30))
        mx = float(d.max() / b.double().abs().max().clamp_min(1e-30))
        print(f"  {name}: l2 {l2:.3e} max {mx:.3e}")
        assert l2 <= PASSES_L2 and mx <= PASSES_MAX, (name, l2, mx)


# B4 (trace) against its plain version: the share of lanes whose status
# agrees, the largest |dp| over them and the share of them with |dp| > 1e-6
# (the bounds of chip_smoke.py; a flipped bf16 rounding of a lane's point
# after an ulp of difference moves it by ~1e-3, rarely).
TRACE_AGREE = 0.999
TRACE_MAX_DP = 0.01
TRACE_MOVED_SHARE = 1e-3


def _trace_operands(device, kind, n=3001, seed=7):
    """Octahedron weights, and N rays: inward from the unit sphere with
    every 10th lane pre-resolved (primary), or upward from inside the ball
    with escape heights 1.0 / 1.6 (shadow)."""
    from shapegan_tpu_torch.examples import octahedron_params

    params = sdf_mlp.params_from_jax(octahedron_params(), device=device)
    weights = K.point_weights(params, torch.zeros(128, device=device))
    rng = np.random.default_rng(seed)
    if kind == "primary":
        pts = rng.normal(size=(n, 3))
        pts /= np.linalg.norm(pts, axis=1, keepdims=True)
        dirs = rng.uniform(-0.3, 0.3, (n, 3)) - pts
        status = np.where(np.arange(n) % 10 == 3, K.TRACE_HIT,
                          np.where(np.arange(n) % 10 == 7, K.TRACE_MISS, K.TRACE_ACTIVE))
        escape = None
        kw = dict(k=30, shadow=False, threshold=0.005, step_clamp=0.05, sdf_offset=0.0, radius=1.0)
    else:
        pts = rng.uniform(-0.6, 0.6, (n, 3))
        dirs = np.concatenate([pts[:, :1] * 0.2, np.ones((n, 1)), pts[:, 2:] * 0.2], axis=1)
        status = np.zeros(n)
        escape = torch.tensor(np.where(np.arange(n) % 2 == 0, 1.0, 1.6), dtype=torch.float32,
                              device=device)
        kw = dict(k=30, shadow=True, threshold=0.001, step_clamp=0.1, sdf_offset=0.0, radius=1.0)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)

    return (t(pts), t(dirs), t(status, torch.int32), escape) + weights, kw


def _trace_close(got, want, ops):
    """B4 against its plain version by the bounds above; pre-resolved lanes
    keep their points and status exactly."""
    torch.cuda.synchronize()
    assert got[0].shape == want[0].shape and got[1].dtype == torch.int32
    same = got[1] == want[1]
    assert float(same.float().mean()) >= TRACE_AGREE
    dp = (got[0] - want[0]).abs().amax(1)[same]
    assert float(dp.max()) <= TRACE_MAX_DP and float((dp > 1e-6).float().mean()) <= TRACE_MOVED_SHARE
    resolved = ops[2] != K.TRACE_ACTIVE
    assert torch.equal(got[0][resolved], ops[0][resolved])
    assert torch.equal(got[1][resolved], ops[2][resolved])


@pytest.mark.parametrize("kind", ["primary", "shadow"])
def test_trace_kernel_matches_plain(cuda, kind):
    ops, kw = _trace_operands(cuda, kind)
    before = K.trace_steps_cuda.launch_count
    got = K.trace_steps_cuda(*ops, **kw)
    assert K.trace_steps_cuda.launch_count == before + 1
    _trace_close(got, K.trace_steps_plain(*ops, **kw), ops)
    assert float((got[1] != K.TRACE_ACTIVE).float().mean()) > 0.3  # the fixture resolves lanes


@pytest.mark.parametrize("k", [1, 37])
@pytest.mark.parametrize("n", [1, 127, 129, 3001])
def test_trace_kernel_lane_counts_and_steps(cuda, n, k):
    """B4 with fewer lanes than one block's 128 slots (1, 127), just more
    (129: a second block) and many (3001), one step and 37: every 10th lane
    pre-resolved (HIT or MISS, interleaved with active ones), the others
    resolving at staggered steps, so slots are refilled mid-launch."""
    ops, kw = _trace_operands(cuda, "primary", n=n, seed=n)
    kw = dict(kw, k=k)
    _trace_close(K.trace_steps_cuda(*ops, **kw), K.trace_steps_plain(*ops, **kw), ops)
    if n == 3001 and k == 37:  # lanes resolve at staggered steps
        early = K.trace_steps_plain(*ops, **dict(kw, k=20))[1]
        final = K.trace_steps_plain(*ops, **kw)[1]
        active = ops[2] == K.TRACE_ACTIVE
        assert (early[active] != K.TRACE_ACTIVE).any()
        assert ((early == K.TRACE_ACTIVE) & (final != K.TRACE_ACTIVE)).any()


def test_trace_kernel_launches_are_bitwise_equal(cuda):
    """Which block and slot takes a lane depends on the work counter's
    order; each lane's steps do not: two launches agree bit for bit."""
    ops, kw = _trace_operands(cuda, "shadow", n=50000, seed=11)
    a, b = K.trace_steps_cuda(*ops, **kw), K.trace_steps_cuda(*ops, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _trace_close(a, K.trace_steps_plain(*ops, **kw), ops)


@pytest.mark.parametrize("n", [127, 3001, 128**3])
def test_points_kernel_persistent_sizes(cuda, n):
    """B3's persistent grid at a part of one tile, a tail tile, and 128^3
    (more tiles than the grid has warpgroups); two launches bit for bit."""
    params, pts, lats = _setup(cuda, n, 1, seed=12)
    ops = K.points_operands(sdf_mlp.fold_latent(params, lats[0]), pts, lats[0, :0])
    out = K.points_forward_cuda(*ops)
    assert torch.equal(out, K.points_forward_cuda(*ops))
    _close(out, K.points_forward_plain(*ops))


def test_trace_wrapper_rejects_bad_operands(cuda):
    ops, kw = _trace_operands(cuda, "primary", n=300)
    pts, dirs, status, escape, *weights = ops
    with pytest.raises(ValueError, match="dtype"):
        K.trace_steps_cuda(pts, dirs, status.long(), escape, *weights, **kw)
    with pytest.raises(ValueError, match="shape"):
        K.trace_steps_cuda(pts, dirs[:-1], status, escape, *weights, **kw)
    with pytest.raises(ValueError, match="shadow rays only"):
        K.trace_steps_cuda(pts, dirs, status, torch.ones(300, device=cuda), *weights, **kw)
    with pytest.raises(ValueError, match="on cpu"):
        K.trace_steps_cuda(pts, dirs, status.cpu(), escape, *weights, **kw)
    with pytest.raises(ValueError, match="k must be"):
        K.trace_steps_cuda(pts, dirs, status, escape, *weights, **dict(kw, k=-1))


def test_points_gradient_chunked_matches_one_b2_call_per_chunk(cuda):
    """P > 262,144: the chunked value and gradient equal, bit for bit, one
    grid-kernel and one grid-backward call per chunk of ROW_CAP points."""
    params, pts, lats = _setup(cuda, K.ROW_CAP + 5001, 1, seed=8)
    params = sdf_mlp.fold_latent(params, lats[0])
    latent = lats[0, :0]
    counts = (K.grid_forward_cuda.launch_count, K.grid_backward_cuda.launch_count)
    values, grads = K.points_value_and_gradient(params, pts, latent)
    assert (K.grid_forward_cuda.launch_count - counts[0],
            K.grid_backward_cuda.launch_count - counts[1]) == (2, 2)
    want_values, want_grads = [], []
    for chunk in pts.split(K.ROW_CAP):
        ops = K.grid_operands(params, chunk, latent[None])
        want_values.append(K.grid_forward_cuda(*ops)[0])
        d_pp1, d_pp5 = K.grid_backward_cuda(*ops, torch.ones((1, chunk.shape[0]), device=cuda))[:2]
        want_grads.append(d_pp1 @ params["w1p"].t() + d_pp5 @ params["w5p"].t())
    torch.testing.assert_close(values, torch.cat(want_values), rtol=0, atol=0)
    torch.testing.assert_close(grads, torch.cat(want_grads), rtol=0, atol=0)


def test_render_frame_runs_points_or_trace_kernel(cuda, monkeypatch):
    """A 64^2 frame of the octahedron on the card: with the fused switch
    off every trace iteration is a points-kernel launch, with it on the
    trace kernel runs; the normals run B1 and B2; the frames agree."""
    from shapegan_tpu_torch.examples import octahedron_params
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.render import raymarching as rm

    net = SDFNet(sdf_mlp.params_from_jax(octahedron_params(), device=cuda))
    code = np.zeros(128, np.float32)
    frames = {}
    for fused in (False, True):
        monkeypatch.setattr(rm, "_FORCE_FUSED_TRACE", fused)
        counters = (K.points_forward_cuda, K.trace_steps_cuda, K.grid_forward_cuda,
                    K.grid_backward_cuda)
        before = [c.launch_count for c in counters]
        frames[fused] = rm.render_image(net, code, resolution=64, ssaa=1)
        points, trace, grid, grid_bwd = (c.launch_count - b for c, b in zip(counters, before))
        # (with the switch on, buckets under FUSED_MIN_LANES still take B3)
        assert trace > 0 if fused else (trace == 0 and points > 0)
        assert grid >= 1 and grid_bwd >= 1
    assert frames[True].shape == (64, 64, 3)
    assert float((frames[True] != frames[False]).any(axis=2).mean()) <= 0.01
    assert 0.05 < float((frames[True] != 255).any(axis=2).mean()) < 0.6


# B6b (rowwise backward) against its plain version: the bounds of B2 above,
# with the per-row dzz1 / dzz5 exempt from the max bound. Measured on an
# H100 (chip_smoke.py, N=3001 and 20,000): L2 <= 7.0e-3 (the plain version
# with float64 sums reads 5.2e-3 there), max <= 1.7e-2 on the summed outputs.
ROWWISE_BWD_NAMES = ("dzz1", "dzz5", "d_w", "d_b", "d_w8", "d_b8")
ROWWISE_SUMMED = ROWWISE_BWD_NAMES[2:]


def _rowwise_ops(device, n, seed):
    params, pts, lats = _setup(device, n, 1, seed)
    rows = torch.tensor(np.random.default_rng(seed).normal(size=(n, 128)).astype(np.float32) * 0.1,
                        device=device)
    zz1, zz5 = K.latent_terms(params, rows)
    g = torch.tensor(np.random.default_rng(seed + 1).normal(size=n).astype(np.float32), device=device)
    return K.rowwise_operands(params, pts, zz1, zz5), g


@pytest.mark.parametrize("n", [3001, 128, 20000, 1, 63, 65, 129])
def test_rowwise_kernels_match_plain(cuda, n):
    """B6a and B6b against their plain versions (3001: a padded tail; B6b's
    64-row tiles: 1 and 63 a tail inside one tile, 65 and 129 a one-row
    tail, all fewer tiles than the consumer warpgroups)."""
    ops, g = _rowwise_ops(cuda, n, seed=n)
    _close(K.rowwise_forward_cuda(*ops), K.rowwise_forward_plain(*ops))
    got, want = K.rowwise_backward_cuda(*ops, g), K.rowwise_backward_plain(*ops, g)
    torch.cuda.synchronize()
    for name, a, b in zip(ROWWISE_BWD_NAMES, got, want):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        d = a.double() - b.double()
        l2 = float(d.norm() / b.double().norm().clamp_min(1e-30))
        mx = float(d.abs().max() / b.double().abs().max().clamp_min(1e-30))
        print(f"  {name}: l2 {l2:.3e} max {mx:.3e}")
        assert l2 <= BWD_L2, (name, l2)
        assert name not in ROWWISE_SUMMED or mx <= BWD_MAX, (name, mx)


def test_rowwise_backward_launches_are_bitwise_equal(cuda):
    """B6b's sums run in one fixed order (no atomics): two launches give the
    same bytes."""
    ops, g = _rowwise_ops(cuda, 20000, seed=5)
    a, b = K.rowwise_backward_cuda(*ops, g), K.rowwise_backward_cuda(*ops, g)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_autodecoder_step_on_card_matches_cpu(cuda):
    """One autodecoder step (loss_and_grads through apply_rowwise: B6a and
    B6b on the card, their plain versions on the CPU) from the same
    weights, table and batch: the loss, and every gradient by the relative
    bounds of B6b (the table's and b1/b5's are bf16 sums; bounded alike)."""
    from shapegan_tpu_torch.train import sdf_autodecoder as T

    params, _, _ = _setup("cpu", 1, 1, seed=9)
    rng = np.random.default_rng(9)
    points = torch.tensor(rng.uniform(-1, 1, (4 * 5000, 3)).astype(np.float32))
    sdf = torch.tensor(np.clip(rng.normal(0, 0.05, 4 * 5000), -0.1, 0.1).astype(np.float32))
    codes = torch.tensor(rng.normal(size=(4, 128)).astype(np.float32) * 0.01)
    indices = torch.tensor(rng.integers(0, 4 * 5000, 20000))
    results = []
    for device in ("cpu", cuda):
        leaves = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        table = codes.to(device).requires_grad_(True)
        before = K.rowwise_forward_cuda.launch_count, K.rowwise_backward_cuda.launch_count
        loss, grads, code_grad = T.loss_and_grads(leaves, table, points.to(device), sdf.to(device),
                                                  indices.to(device), 5000)
        after = K.rowwise_forward_cuda.launch_count, K.rowwise_backward_cuda.launch_count
        assert [a - b for a, b in zip(after, before)] == ([0, 0] if device == "cpu" else [1, 1])
        results.append((float(loss), {k: v.cpu() for k, v in grads.items()}, code_grad.cpu()))
    (cpu_loss, cpu_grads, cpu_codes), (gpu_loss, gpu_grads, gpu_codes) = results
    assert abs(cpu_loss - gpu_loss) <= 1e-5
    pairs = [(k, gpu_grads[k], cpu_grads[k]) for k in cpu_grads] + [("table", gpu_codes, cpu_codes)]
    for name, a, b in pairs:
        d = a.double() - b.double()
        l2 = float(d.norm() / b.double().norm().clamp_min(1e-30))
        mx = float(d.abs().max() / b.double().abs().max().clamp_min(1e-30))
        print(f"  {name}: l2 {l2:.3e} max {mx:.3e}")
        assert l2 <= BWD_L2 and mx <= BWD_MAX, (name, l2, mx)


# B7 (point-GAN generator) against its plain version: chip_smoke.py's bounds.
# The LayerNorm's float32 sums run in another order in the kernel than in
# PyTorch, so now and then an activation lands on the other side of a bf16
# rounding and the flip spreads through the later layers: measured on an H100
# max <= 4.4e-3, mean <= 1.4e-5. The max bound only catches gross errors;
# four wrong kernels read mean >= 1.6e-3 (PERF.md, section 6).
GEN_MAX_ABS = 1e-2
GEN_MEAN_ABS = 1e-4


@pytest.mark.parametrize("batch, n", [(3, 1000), (32, 4096), (2, 129), (2, 100)])
def test_point_gen_kernel_matches_plain(cuda, batch, n):
    """B7 against its plain version: a tail tile (1000, 129, 100 points),
    tiles that span two items, fewer tiles than consumer warpgroups (2 x 100,
    2 x 129)."""
    from shapegan_tpu_torch.models.point_sdf_net import SDFGenerator
    from shapegan_tpu_torch.ops import point_gen_kernels as PG

    gen = SDFGenerator(generator=torch.Generator().manual_seed(batch), device=cuda)
    rng = np.random.default_rng(n)
    pos = torch.tensor(rng.uniform(-1, 1, (batch, n, 3)).astype(np.float32), device=cuda)
    z = torch.tensor(rng.normal(size=(batch, 128)).astype(np.float32), device=cuda)
    with torch.no_grad():
        ops = PG.generate_operands(dict(gen.named_parameters()), pos, z)
    before = PG.generate_cuda.launch_count
    got = PG.generate_cuda(*ops)
    assert PG.generate_cuda.launch_count == before + 1
    want = PG.generate_plain(*ops)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (batch, n) and torch.isfinite(got).all()
    diff = (got - want).abs()
    print(f"  B={batch} N={n}: max {float(diff.max()):.3e} mean {float(diff.mean()):.3e}")
    assert float(diff.max()) <= GEN_MAX_ABS and float(diff.mean()) <= GEN_MEAN_ABS
    # items differ: each row reads its own item's latent rows
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_point_gen_best_launches_kernel_and_rejects_cpu_operands(cuda, monkeypatch):
    from shapegan_tpu_torch.models.point_sdf_net import SDFGenerator
    from shapegan_tpu_torch.ops import point_gen_kernels as PG

    gen = SDFGenerator(dtype=torch.bfloat16, device=cuda)
    params = dict(gen.named_parameters())
    pos = torch.rand((2, 300, 3), device=cuda) * 2 - 1
    z = torch.randn((2, 128), device=cuda)
    for fused in (True, False):
        monkeypatch.setattr(PG, "_FORCE_FUSED_GENERATE", fused)
        before = PG.generate_cuda.launch_count
        with torch.no_grad():
            out = PG.generate_best(gen, params, pos, z)
        assert out.shape == (2, 300, 1)
        assert PG.generate_cuda.launch_count == before + int(fused)
    with torch.no_grad():
        ops = PG.generate_operands(params, pos, z)
    with pytest.raises(ValueError, match="on cpu"):
        PG.generate_cuda(ops[0], ops[1].cpu(), *ops[2:])
    with pytest.raises(ValueError, match="shape"):
        PG.generate_cuda(ops[0], ops[1][:1], *ops[2:])


# B5a (stash forward) and B5b (stash backward). B5a's output is B1's bit for
# bit (the same arithmetic), and its planes the plain version's: measured on
# an H100 at 16 x 64^3 and B=3, P=3001, share of differing elements 0 (bound
# 1e-4, chip_smoke.py's; a plane written one layer late differs almost
# everywhere). B5b is held to B2's bounds against its plain version on the
# same planes.
STASH_SETS = [(2, 4, 6), (1, 2, 3, 4, 5, 6)]
STASH_PLANE_SHARE = 1e-4


@pytest.mark.parametrize("stash", STASH_SETS)
@pytest.mark.parametrize("n_points, n_latents", [(3001, 3), (16**3, 16)])
def test_stash_kernels_match_b1_and_plain(cuda, n_points, n_latents, stash):
    params, pts, lats = _setup(cuda, n_points, n_latents, seed=8)
    g = torch.tensor(np.random.default_rng(8).normal(size=(n_latents, n_points)).astype(np.float32),
                     device=cuda)
    ops = K.grid_operands(params, pts, lats)
    before = (K.grid_forward_stash_cuda.launch_count, K.grid_backward_stash_cuda.launch_count)
    out, planes = K.grid_forward_stash_cuda(*ops, stash)
    got = K.grid_backward_stash_cuda(*ops, g, planes, stash)
    assert (K.grid_forward_stash_cuda.launch_count, K.grid_backward_stash_cuda.launch_count) == (
        before[0] + 1, before[1] + 1)
    want_out, want_planes = K.grid_forward_stash_plain(*ops, stash)
    torch.cuda.synchronize()
    assert torch.equal(out, K.grid_forward_cuda(*ops))
    _close(out, want_out)
    for j, a, b in zip(stash, planes, want_planes):
        assert a.shape == (n_latents, n_points, 256)
        share = float((a != b).float().mean())
        assert share <= STASH_PLANE_SHARE, (j, share)
    _bwd_close(got, K.grid_backward_stash_plain(*ops, g, planes, stash))


def test_apply_grid_trainable_stash_launches_stash_kernels(cuda):
    """Gradients through B5a and B5b on the card, with the full stash set
    (1..6) whatever the trainers' ``hybrid_gan._GRID_STASH`` is, against the
    same autograd function on CPU copies (the plain versions); neither B1
    nor B2 runs."""
    params, _, lats = _setup(cuda, 1, 3, seed=9)
    pts = voxel_coordinates(16, device=cuda)
    cot = torch.tensor(np.random.default_rng(9).normal(size=(3, 16**3)).astype(np.float32))
    counters = (K.grid_forward_cuda, K.grid_backward_cuda, K.grid_forward_stash_cuda,
                K.grid_backward_stash_cuda)
    grads = []
    for device in (cuda, torch.device("cpu")):
        leaves = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
        grid = pts.detach().to(device).requires_grad_(True)
        latents = lats.detach().to(device).requires_grad_(True)
        counts = [c.launch_count for c in counters]
        K.apply_grid_trainable_stash(leaves, grid, latents, STASH_SETS[-1]).backward(cot.to(device))
        launched = [c.launch_count - n for c, n in zip(counters, counts)]
        assert launched == ([0, 0, 1, 1] if device.type == "cuda" else [0, 0, 0, 0])
        grads.append([leaves[k].grad for k in sdf_mlp.PARAM_KEYS] + [grid.grad, latents.grad])
    for name, a, b in zip(list(sdf_mlp.PARAM_KEYS) + ["grid", "latents"], *grads):
        a = a.cpu().double()
        l2 = float((a - b.double()).norm() / b.double().norm())
        print(f"  {name}: l2 {l2:.3e}")
        assert l2 <= BWD_L2, (name, l2)
