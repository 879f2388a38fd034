"""The grid backward (B2) of the port — ``apply_grid_trainable`` and the
plain version of its kernel, ``sdf_mlp_kernels.grid_backward_plain`` — held
against the JAX package's ``apply_grid_trainable`` with its Pallas
``_bwd_kernel`` in interpret mode, on the CPU.

Inputs are made with numpy from a seed; the weights come from the JAX
package's init through ``params_from_jax``; one cotangent goes to
``jax.vjp`` and to ``backward``.
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
from shapegan_tpu_torch.ops import sdf_mlp, sdf_mlp_kernels
from shapegan_tpu_torch.ops.coords import voxel_coordinates

# Relative errors per gradient tensor, ||d||_2 / ||ref||_2 and
# max|d| / max|ref|. Each dz is rounded to bf16 and feeds the next layer, so
# a float32 sum taken in another order flips a few bf16 roundings and the
# flips spread: the plain version with float64 products (same rounding
# points) already differs from itself in float32 by up to 3.5e-2 max-rel at
# 8^3 x 2. The noise shrinks with more rows. Readings of the sound plain
# version against the Pallas kernel (worst tensor): 8^3 x 2: L2 5.9e-3, max
# 3.5e-2 (d_grid); 16^3 x 3: 1.4e-3, 7.0e-3; P=3001 x 3: 8.9e-4, 7.6e-3.
# Two mutants read: the recompute at B1's rounding points, L2 >= 9.4e-2 and
# max >= 0.12 at every shape; dz left in float32, L2 6.6e-3 (16^3 x 3) and
# 7.1e-3 (P=3001), but 7.2e-3 at 8^3 x 2, inside that shape's noise. The
# bounds sit between sound and mutant where the shape tells them apart.
BOUNDS = {  # case: (L2 bound, max bound)
    "8^3x2": (1e-2, 5e-2),
    "16^3x3": (3e-3, 1.5e-2),
    "P3001x3": (3e-3, 1.5e-2),
}


@functools.lru_cache(maxsize=1)
def _params():
    np_params = {k: np.asarray(v) for k, v in jax_mlp.init(jax.random.PRNGKey(0)).items()}
    return np_params, sdf_mlp.params_from_jax(np_params)


def _case(name):
    rng = np.random.default_rng(7)
    if name == "P3001x3":
        pts, batch = rng.uniform(-1, 1, (3001, 3)).astype(np.float32), 3
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


@pytest.mark.parametrize("case", list(BOUNDS))
def test_grid_backward_plain_matches_pallas_interpreted(case):
    """All 19 parameter gradients, d_grid and d_latents of the port's
    apply_grid_trainable (B1 and B2 plain versions) against jax.vjp of the
    Pallas custom VJP: 8^3 x 2 (one 512-point tile), 16^3 x 3 (eight
    tiles), P=3001 x 3 (a padded tail)."""
    np_params, params = _params()
    pts, lats, cot = _case(case)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(sdf_mlp_pallas.apply_grid_trainable,
                           {k: jnp.asarray(v) for k, v in np_params.items()},
                           jnp.asarray(pts), jnp.asarray(lats))
        ref_params, ref_grid, ref_lats = vjp(jnp.asarray(cot))

    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    grid = torch.tensor(pts, requires_grad=True)
    latents = torch.tensor(lats, requires_grad=True)
    values = sdf_mlp_kernels.apply_grid_trainable(leaves, grid, latents)
    np.testing.assert_array_equal(  # the forward is B1's plain version
        values.detach().numpy(),
        sdf_mlp_kernels.apply_grid_fused(params, torch.tensor(pts), torch.tensor(lats)).numpy())
    values.backward(torch.tensor(cot))

    l2_bound, max_bound = BOUNDS[case]
    pairs = [(k, leaves[k].grad, ref_params[k]) for k in sdf_mlp.PARAM_KEYS]
    pairs += [("grid", grid.grad, ref_grid), ("latents", latents.grad, ref_lats)]
    for name, got, ref in pairs:
        assert tuple(got.shape) == np.shape(ref), name
        l2, mx = _rel_errors(got.numpy(), ref)
        assert l2 <= l2_bound and mx <= max_bound, (name, l2, mx)


def test_grid_backward_plain_shapes_and_layout():
    """Outputs are float32 in the JAX package's layout: d_w [6, in, out],
    d_b rows in BIAS_STACK_ORDER with the unused rows (3, 6, 7) zero."""
    _, params = _params()
    pts, lats, cot = _case("8^3x2")
    ops = sdf_mlp_kernels.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    outs = sdf_mlp_kernels.grid_backward(*ops, torch.tensor(cot))
    shapes = [(512, 256), (512, 256), (2, 256), (2, 256), (6, 256, 256), (8, 256), (256,), (1,)]
    assert [tuple(t.shape) for t in outs] == shapes
    assert all(t.dtype == torch.float32 for t in outs)
    d_b = outs[5]
    assert not d_b[[3, 6, 7]].any() and d_b[[0, 1, 2, 4, 5]].abs().sum(1).gt(0).all()


def test_grid_backward_cuda_raises_on_cpu_tensors():
    """The B2 wrapper launches or raises; it never falls back, and a refused
    call does not count as a launch."""
    _, params = _params()
    pts, lats, cot = _case("8^3x2")
    ops = sdf_mlp_kernels.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    g = torch.tensor(cot)
    before = sdf_mlp_kernels.grid_backward_cuda.launch_count
    with pytest.raises(ValueError, match="CUDA kernel"):
        sdf_mlp_kernels.grid_backward_cuda(*ops, g)
    with pytest.raises(ValueError, match="CUDA kernel"):  # a non-CPU, non-CUDA device
        sdf_mlp_kernels.grid_backward(*(t.to("meta") for t in ops), g.to("meta"))
    assert sdf_mlp_kernels.grid_backward_cuda.launch_count == before


# The rows pass alone (grid_backward_rows_plain: the scratch the kernel's
# rows pass writes). A share of differing bf16 plane elements above
# ROWS_PLANE_SHARE fails a plane comparison, as in chip_smoke.py phase 3.
ROWS_PLANE_SHARE = 1e-2
# The planes of rows computed in two calls against one call: bit for bit on
# this CPU (every reading 0). A matmul whose sum order followed the row
# count would flip a few bf16 roundings; these bounds leave room for that.
SPLIT_SHARE = 1e-3
SPLIT_REL = 1e-5
# The sums of the planes in float64 against grid_backward_plain's float32
# sums over 3 x 3001 rows: relative L2 per output (float32 sums of a few
# thousand terms: ~1e-7 each).
SUMS_L2 = 1e-5


def _rows_case():
    _, params = _params()
    pts, lats, cot = _case("P3001x3")
    ops = sdf_mlp_kernels.grid_operands(params, torch.tensor(pts), torch.tensor(lats))
    return ops, torch.tensor(cot)


def _by_shape(t, batch):
    """[..., B·P, ...] rows as [..., B, P, ...]."""
    lead = 1 if t.dim() == 3 else 0
    return t.reshape(t.shape[:lead] + (batch, -1) + t.shape[lead + 1:])


@pytest.mark.parametrize("split", [1, 1237, 3000])
def test_grid_backward_rows_plain_is_row_local(split):
    """The rows pass is row-local: the planes of P = 3001 points x 3 shapes
    computed in two calls, split at an odd point, equal one call's."""
    ops, g = _rows_case()
    whole = sdf_mlp_kernels.grid_backward_rows_plain(*ops, g)
    parts = [sdf_mlp_kernels.grid_backward_rows_plain(ops[0][sl], ops[1][sl], *ops[2:], g[:, sl])
             for sl in (slice(0, split), slice(split, None))]
    for name, one, a, b in zip(("h", "dz", "dx1", "gz"), whole, *parts):
        joined = torch.cat([_by_shape(a, 3), _by_shape(b, 3)], dim=2 if one.dim() == 3 else 1)
        one = _by_shape(one, 3)
        assert joined.shape == one.shape, name
        if one.dtype == torch.bfloat16:
            assert float((joined != one).float().mean()) <= SPLIT_SHARE, name
        else:
            diff = float((joined - one).abs().max())
            assert diff <= SPLIT_REL * float(one.abs().max()), (name, diff)


def test_grid_backward_rows_plain_sums_match_grid_backward_plain():
    """The sums of the rows pass's planes (passes 2-4, here in float64)
    reproduce grid_backward_plain's eight outputs."""
    ops, g = _rows_case()
    h, dz, dx1, gz = (t.double() for t in sdf_mlp_kernels.grid_backward_rows_plain(*ops, g))
    batch, points = g.shape
    skip = sdf_mlp_kernels.SKIP_LAYER
    d_w = torch.einsum("lri,lro->lio", h[:6], dz)
    d_b = torch.zeros((8, 256), dtype=torch.float64)
    d_b[[0, 1, 2, 4, 5]] = dz[[0, 1, 2, 4, 5]].sum(1)
    want = (dx1.reshape(batch, points, 256).sum(0), dz[skip].reshape(batch, points, 256).sum(0),
            dx1.reshape(batch, points, 256).sum(1), dz[skip].reshape(batch, points, 256).sum(1),
            d_w, d_b, h[6].t() @ gz, gz.sum().reshape(1))
    got = sdf_mlp_kernels.grid_backward_plain(*ops, g)
    for name, a, b in zip(("d_pp1", "d_pp5", "d_zz1", "d_zz5", "d_w", "d_b", "d_w8", "d_b8"), got, want):
        assert a.shape == b.shape, name
        assert float((a.double() - b).norm() / b.norm()) <= SUMS_L2, name


def _rows_rounded_before_bias(pp1, pp5, zz1, zz5, w, b, w8, g):
    """A wrong rows pass: each rebuilt layer rounds its product to bf16
    before the bias is added (B3's rounding points, not the backward's)."""
    bf16 = torch.bfloat16
    wf, bf, w8f = w.float(), b.float(), w8.float()
    planes = []
    for s in range(zz1.shape[0]):
        h = [torch.relu(pp1.float() + zz1[s].float()).to(bf16)]
        for layer in range(6):
            acc = (h[-1].float() @ wf[layer].t()).to(bf16).float()
            acc = acc + pp5.float() + zz5[s].float() if layer == 3 else acc + bf[layer]
            h.append(torch.relu(acc).to(bf16))
        planes.append(torch.stack(h))
    return torch.cat(planes, dim=1)


def test_grid_backward_rows_rounding_mutant_fails_plane_bound():
    """The product rounded before the bias moves more than ROWS_PLANE_SHARE
    of the rebuilt h planes' elements; the sound twin against itself moves
    none."""
    ops, g = _rows_case()
    h = sdf_mlp_kernels.grid_backward_rows_plain(*ops, g)[0]
    wrong = _rows_rounded_before_bias(*ops, g)
    shares = [float((a != b).float().mean()) for a, b in zip(wrong, h)]
    assert shares[0] == 0.0  # h1 has no product
    assert all(share > ROWS_PLANE_SHARE for share in shares[1:]), shares
