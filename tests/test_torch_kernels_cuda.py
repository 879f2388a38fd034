"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked ``gpu``: without CUDA each test skips (a CUDA kernel has no CPU
or interpret mode); on a machine with a GPU run them with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m gpu
"""

import numpy as np
import pytest
import torch

from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K

pytestmark = pytest.mark.gpu

# Same operands, same bf16 rounding points: kernel and plain version agree
# to float32 summation order in the head. Measured on an H100: max <= 3e-8
# with random weights at these shapes. A kernel with a rounding point wrong
# (no bf16 round before the bias add, layer-5 adds in float32, an fp16 or
# float32 trunk) reads max >= 1.4e-4, mean >= 2.3e-5 (PERF.md, section 6).
MAX_ABS = 1e-5
MEAN_ABS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


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
