"""The activation-stash grid path of the port (B5a, B5b): the plain versions
of its kernels, ``sdf_mlp_kernels.grid_forward_stash_plain`` and
``grid_backward_stash_plain`` behind ``apply_grid_trainable_stash``, held
against the JAX package's ``_stash_fwd_call`` and ``jax.vjp`` of its
``apply_grid_trainable_stash`` with the Pallas kernels in interpret mode, on
the CPU.

Inputs are made with numpy from a seed; the weights come from the JAX
package's init through ``params_from_jax``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops import sdf_mlp_pallas
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.ops.coords import voxel_coordinates

# The forward's output against the Pallas kernel's: the bounds of
# tests/test_torch_sdf_mlp.py (the same rounding points; read max 2.2e-8,
# mean 6.2e-9 here).
BF16_MAX_ABS = 1e-5
BF16_MEAN_ABS = 1e-6
# Each stashed plane against the Pallas kernel's: the share of bf16
# elements that differ. Read 0 at every case (both round the same float32
# sums); a plane written one layer late differs almost everywhere.
PLANE_SHARE = 1e-4
# The gradients (19 parameters, the points, the latents) against jax.vjp of
# the stash VJP, ||d||_2 / ||ref||_2 and max|d| / max|ref| per tensor. The
# stashed positions are the forward's own bf16 values on both sides, so the
# relu masks agree and only float32 summation order differs: read worst L2
# 4.0e-4, max 5.8e-4 (P=3001 x 3). B2's plain backward (every position
# rebuilt at B2's rounding points) reads a worst L2 >= 9.3e-2 against the
# same reference at every case, so it must fail these bounds.
STASH_L2 = 2e-3
STASH_MAX = 3e-3
FULL = (1, 2, 3, 4, 5, 6)


@functools.lru_cache(maxsize=1)
def _params():
    np_params = {k: np.asarray(v) for k, v in jax_mlp.init(jax.random.PRNGKey(0)).items()}
    return np_params, sdf_mlp.params_from_jax(np_params)


def _case(name):
    rng = np.random.default_rng(7)
    if name.startswith("P"):
        n, batch = (int(v) for v in name[1:].split("x"))
        pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    else:
        res, batch = (8, 2) if name == "8^3x2" else (16, 3)
        pts = voxel_coordinates(res).numpy()
    lats = rng.normal(size=(batch, 128)).astype(np.float32)
    cot = rng.normal(size=(batch, pts.shape[0])).astype(np.float32)
    return pts, lats, cot


def _rel_errors(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = got - ref
    return (np.linalg.norm(diff) / np.linalg.norm(ref),
            np.abs(diff).max() / np.abs(ref).max())


@pytest.mark.parametrize("stash", [(2, 4, 6), (0, 1, 2, 3, 4, 5, 6)])
@pytest.mark.parametrize("case", ["16^3x3", "P3000x2"])
def test_stash_forward_plain_matches_pallas_interpreted(case, stash):
    """The output by the bf16 bounds, and bit for bit B1's plain output;
    each plane by the share of differing elements."""
    np_params, params = _params()
    pts, lats, _ = _case(case)
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_planes = sdf_mlp_pallas._stash_fwd_call(
            {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts), jnp.asarray(lats),
            sdf_mlp_pallas.DEFAULT_TILE, stash)
    ops = K.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    out, planes = K.grid_forward_stash_plain(*ops, stash)
    diff = np.abs(out.numpy().astype(np.float64) - np.asarray(ref_out, np.float64))
    assert diff.max() <= BF16_MAX_ABS and diff.mean() <= BF16_MEAN_ABS, (diff.max(), diff.mean())
    np.testing.assert_array_equal(out.numpy(), K.grid_forward_plain(*ops).numpy())
    assert len(planes) == len(stash)
    for j, plane, ref in zip(stash, planes, ref_planes):
        assert plane.dtype == torch.bfloat16 and tuple(plane.shape) == (len(lats), len(pts), 256)
        ref = np.asarray(ref, np.float32)[:, :len(pts)]  # the TPU kernel pads P to its tile
        share = float((plane.float().numpy() != ref).mean())
        assert share <= PLANE_SHARE, (j, share)


@pytest.mark.parametrize("stash", [(2, 4, 6), FULL])
@pytest.mark.parametrize("case", ["8^3x2", "16^3x3", "P3001x3"])
def test_stash_backward_plain_matches_pallas_interpreted(case, stash):
    """All 19 parameter gradients, d_grid and d_latents of the port's
    apply_grid_trainable_stash against jax.vjp of the JAX package's; then
    the mutant check: the recompute VJP's plain versions (B2's rounding
    points for the stashed positions) fall outside the bounds."""
    np_params, params = _params()
    pts, lats, cot = _case(case)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(functools.partial(sdf_mlp_pallas.apply_grid_trainable_stash, stash=stash),
                         {k: jnp.asarray(v) for k, v in np_params.items()},
                         jnp.asarray(pts), jnp.asarray(lats))
        ref_params, ref_grid, ref_lats = vjp(jnp.asarray(cot))
    refs = [ref_params[k] for k in sdf_mlp.PARAM_KEYS] + [ref_grid, ref_lats]

    def gradients(apply):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        grid = torch.tensor(pts, requires_grad=True)
        latents = torch.tensor(lats, requires_grad=True)
        apply(leaves, grid, latents).backward(torch.tensor(cot))
        return [leaves[k].grad for k in sdf_mlp.PARAM_KEYS] + [grid.grad, latents.grad]

    names = list(sdf_mlp.PARAM_KEYS) + ["grid", "latents"]
    got = gradients(lambda p, g, z: K.apply_grid_trainable_stash(p, g, z, stash))
    for name, value, ref in zip(names, got, refs):
        assert tuple(value.shape) == np.shape(ref), name
        l2, mx = _rel_errors(value.numpy(), ref)
        assert l2 <= STASH_L2 and mx <= STASH_MAX, (name, l2, mx)

    recompute = gradients(K.apply_grid_trainable)
    worst = max(_rel_errors(value.numpy(), ref)[0] for value, ref in zip(recompute, refs))
    assert worst > STASH_L2, worst


def test_stash_forward_value_is_the_grid_kernels():
    """apply_grid_trainable_stash's value is B1's plain output, for every
    stash set; the set has no default (the trainers' is hybrid_gan's
    _GRID_STASH)."""
    _, params = _params()
    pts, lats, _ = _case("8^3x2")
    grid, latents = torch.tensor(pts), torch.tensor(lats)
    want = K.apply_grid_fused(params, grid, latents)
    with pytest.raises(TypeError):
        K.apply_grid_trainable_stash(params, grid, latents)
    for stash in ((), (0,), (2, 4, 6), FULL):
        got = K.apply_grid_trainable_stash(params, grid, latents, stash)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("bad", [(4, 2), (2, 2), (7,), (-1,), (2.0,), (True,)])
def test_stash_sets_are_checked(bad):
    """Distinct positions in 0..6, ascending; anything else raises, in the
    plain versions, the wrappers and the autograd entry point alike."""
    _, params = _params()
    pts, lats, cot = _case("8^3x2")
    ops = K.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    with pytest.raises(ValueError, match="stash"):
        K.grid_forward_stash_plain(*ops, bad)
    with pytest.raises(ValueError, match="stash"):
        K.grid_backward_stash_plain(*ops, torch.tensor(cot), (), bad)
    with pytest.raises(ValueError, match="stash"):
        K.apply_grid_trainable_stash(params, torch.tensor(pts), torch.tensor(lats), bad)


def test_stash_wrappers_raise_on_cpu_and_meta_tensors():
    """The B5a and B5b wrappers launch or raise; they never fall back, and a
    refused call does not count as a launch."""
    _, params = _params()
    pts, lats, cot = _case("8^3x2")
    ops = K.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    g = torch.tensor(cot)
    _, planes = K.grid_forward_stash_plain(*ops, (2, 4, 6))
    before = (K.grid_forward_stash_cuda.launch_count, K.grid_backward_stash_cuda.launch_count)
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.grid_forward_stash_cuda(*ops, (2, 4, 6))
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.grid_backward_stash_cuda(*ops, g, planes, (2, 4, 6))
    meta = [t.to("meta") for t in ops]
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.grid_forward_stash(*meta, (2, 4, 6))
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.grid_backward_stash(*meta, g.to("meta"), [p.to("meta") for p in planes], (2, 4, 6))
    assert (K.grid_forward_stash_cuda.launch_count,
            K.grid_backward_stash_cuda.launch_count) == before
    with pytest.raises(ValueError, match="stashed planes"):
        K.grid_backward_stash_plain(*ops, g, planes[:2], (2, 4, 6))
