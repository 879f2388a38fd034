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
