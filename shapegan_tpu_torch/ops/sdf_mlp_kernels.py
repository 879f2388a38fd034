"""Forward kernels of the DeepSDF MLP for the H100 (counterpart of the
forward half of :mod:`shapegan_tpu.ops.sdf_mlp_pallas`).

Two hand-written CUDA kernels (sources in ``ops/csrc/``):

* the **grid kernel** (``sdf_grid.cu``, replaces ``_kernel`` /
  ``apply_grid_fused``): B shape latents over one shared point grid
  → [B, P];
* the **points kernel** (``sdf_points.cu``, replaces ``_points_kernel`` /
  ``apply_points_fused``): one latent, raw points, both fan-in projections
  in the kernel → [1, N].

Each kernel has a thin wrapper (``*_cuda``: checks, allocates, launches on
the current stream, counts its launches in ``launch_count``) and a plain
PyTorch version (``*_plain``) of the same math at the same bf16 rounding
points. The dispatchers (``grid_forward``, ``points_forward``) take the
plain version only for tensors on the CPU; a CUDA tensor goes to the kernel,
which raises if it cannot run. There is no fallback.

Operand layout (shared with the kernels, see ``csrc/sdf_trunk.cuh``):
``w`` [6, 256(out), 256(in)] bf16 — w2, w3, w4, w5h, w6, w7 transposed;
``b`` [8, 256] bf16 — rows b2, b3, b4, <unused>, b6, b7, b8 broadcast,
<unused> (the JAX package's ``BIAS_STACK_ORDER``); ``w8`` [256] bf16.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from shapegan_tpu_torch.ops import _build
from shapegan_tpu_torch.ops.sdf_mlp import Params

BF16 = torch.bfloat16
WIDTH = 256
TRUNK_KEYS = ("w2", "w3", "w4", "w5h", "w6", "w7")
SKIP_LAYER = 3  # w5h: adds pp5 + zz5 instead of a bias
HEAD_BIAS_ROW = 6

Operands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------- operands


def trunk_operands(params: Params) -> Operands:
    """Latent-free kernel operands (w, b, w8) in the kernels' layout."""
    zero = torch.zeros_like(params["b2"])
    w = torch.stack([params[k].t() for k in TRUNK_KEYS]).to(BF16).contiguous()
    b = torch.stack([
        params["b2"], params["b3"], params["b4"], zero,
        params["b6"], params["b7"], params["b8"].expand_as(zero), zero,
    ]).to(BF16).contiguous()
    w8 = params["w8"][:, 0].to(BF16).contiguous()
    return w, b, w8


def latent_terms(params: Params, latents: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """zz1/zz5 = z @ w1z/w5z + b1/b5 in bf16, [B, 256] for latents [B, L]
    (L may be 0 after ``fold_latent``: then they are the folded biases)."""
    z = latents.to(BF16)
    zz1 = z @ params["w1z"].to(BF16) + params["b1"].to(BF16)
    zz5 = z @ params["w5z"].to(BF16) + params["b5"].to(BF16)
    return zz1.contiguous(), zz5.contiguous()


# ------------------------------------------------------------ plain versions


def _trunk_plain(x: torch.Tensor, add_skip: Callable[[torch.Tensor], torch.Tensor],
                 w: torch.Tensor, b: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Six trunk layers and the head over layer-1 activations x [R, 256]
    bf16 → [R] float32. A bf16 matmul accumulates in float32 and rounds once
    to bf16; the bias add is a bf16 add: the kernels' rounding points."""
    for layer in range(len(TRUNK_KEYS)):
        h = x @ w[layer].t()
        h = add_skip(h) if layer == SKIP_LAYER else h + b[layer]
        x = torch.relu(h)
    return torch.tanh(x.float() @ w8.float() + b[HEAD_BIAS_ROW, 0].float())


def grid_forward_plain(pp1, pp5, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Plain PyTorch version of the grid kernel → [B, P] float32."""
    batch, points = zz1.shape[0], pp1.shape[0]

    def add_skip(h):
        h = h.reshape(batch, points, WIDTH) + pp5[None] + zz5[:, None]
        return h.reshape(batch * points, WIDTH)

    x = torch.relu(pp1[None] + zz1[:, None]).reshape(batch * points, WIDTH)
    return _trunk_plain(x, add_skip, w, b, w8).reshape(batch, points)


def points_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Plain PyTorch version of the points kernel → [N] float32. The fan-in
    projections are float32 sums of bf16 products, rounded to bf16."""
    p = pts.to(BF16).float()
    pp1 = (p @ w1p.float()).to(BF16)
    pp5 = (p @ w5p.float()).to(BF16)
    x = torch.relu(pp1 + zz1)
    return _trunk_plain(x, lambda h: h + pp5 + zz5, w, b, w8)


# ------------------------------------------------------------ kernel wrappers


def _check(name: str, device: torch.device, tensor: torch.Tensor, shape, dtype) -> None:
    if tensor.device != device:
        raise ValueError(f"{name}: on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(tensor.shape)}, expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_trunk(device, w, b, w8) -> None:
    _check("w", device, w, (len(TRUNK_KEYS), WIDTH, WIDTH), BF16)
    _check("b", device, b, (8, WIDTH), BF16)
    _check("w8", device, w8, (WIDTH,), BF16)


def _cuda_device(tensor: torch.Tensor) -> torch.device:
    if tensor.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {tensor.device}")
    return tensor.device


def grid_forward_cuda(pp1, pp5, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Launch the grid kernel (``csrc/sdf_grid.cu``) → [B, P] float32."""
    device = _cuda_device(pp1)
    points, batch = pp1.shape[0], zz1.shape[0]
    _check("pp1", device, pp1, (points, WIDTH), BF16)
    _check("pp5", device, pp5, (points, WIDTH), BF16)
    _check("zz1", device, zz1, (batch, WIDTH), BF16)
    _check("zz5", device, zz5, (batch, WIDTH), BF16)
    _check_trunk(device, w, b, w8)
    out = torch.empty((batch, points), dtype=torch.float32, device=device)
    if batch == 0 or points == 0:
        return out
    lib = _build.load()
    code = lib.sdf_grid_forward(
        pp1.data_ptr(), pp5.data_ptr(), zz1.data_ptr(), zz5.data_ptr(),
        w.data_ptr(), b.data_ptr(), w8.data_ptr(), out.data_ptr(),
        batch, points, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_forward", code)
    grid_forward_cuda.launch_count += 1
    return out


grid_forward_cuda.launch_count = 0


def points_forward_cuda(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Launch the points kernel (``csrc/sdf_points.cu``) → [N] float32."""
    device = _cuda_device(pts)
    n = pts.shape[0]
    _check("pts", device, pts, (n, 3), torch.float32)
    _check("w1p", device, w1p, (3, WIDTH), BF16)
    _check("w5p", device, w5p, (3, WIDTH), BF16)
    _check("zz1", device, zz1, (WIDTH,), BF16)
    _check("zz5", device, zz5, (WIDTH,), BF16)
    _check_trunk(device, w, b, w8)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = _build.load()
    code = lib.sdf_points_forward(
        pts.data_ptr(), w1p.data_ptr(), w5p.data_ptr(), zz1.data_ptr(), zz5.data_ptr(),
        w.data_ptr(), b.data_ptr(), w8.data_ptr(), out.data_ptr(),
        n, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_points_forward", code)
    points_forward_cuda.launch_count += 1
    return out


points_forward_cuda.launch_count = 0


def grid_forward(pp1, pp5, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Grid kernel on CUDA tensors, its plain version on CPU tensors."""
    if pp1.device.type == "cpu":
        return grid_forward_plain(pp1, pp5, zz1, zz5, w, b, w8)
    return grid_forward_cuda(pp1, pp5, zz1, zz5, w, b, w8)


def points_forward(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Points kernel on CUDA tensors, its plain version on CPU tensors."""
    if pts.device.type == "cpu":
        return points_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8)
    return points_forward_cuda(pts, w1p, w5p, zz1, zz5, w, b, w8)


# ------------------------------------------------------------- entry points


def grid_operands(params: Params, grid_points: torch.Tensor, latents: torch.Tensor):
    """The grid kernel's operands (pp1, pp5, zz1, zz5, w, b, w8). The point
    projections are bf16 matmuls outside the kernel, as in the TPU version."""
    pts = grid_points.to(BF16)
    pp1 = (pts @ params["w1p"].to(BF16)).contiguous()
    pp5 = (pts @ params["w5p"].to(BF16)).contiguous()
    return (pp1, pp5) + latent_terms(params, latents) + trunk_operands(params)


def points_operands(params: Params, points: torch.Tensor, latent: torch.Tensor):
    """The points kernel's operands (pts, w1p, w5p, zz1, zz5, w, b, w8)."""
    zz1, zz5 = latent_terms(params, latent[None, :])
    return ((points.float().contiguous(),
             params["w1p"].to(BF16).contiguous(), params["w5p"].to(BF16).contiguous(),
             zz1[0], zz5[0]) + trunk_operands(params))


def apply_grid_fused(params: Params, grid_points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Shared points [P, 3] x shape latents [B, L] → [B, P] float32."""
    return grid_forward(*grid_operands(params, grid_points, latents))


def apply_points_fused(params: Params, points: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
    """One latent [L] (L may be 0 after ``fold_latent``) over points
    [N, 3] → [1, N] float32."""
    return points_forward(*points_operands(params, points, latent))[None, :]


def apply_grid_best(params: Params, grid_points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Forward-only grid evaluation [P, 3] x [B, L] → [B, P]: the points
    kernel when B == 1, the grid kernel otherwise (the JAX package's
    dispatch on a TPU). On CPU tensors each runs its plain version."""
    if latents.shape[0] == 1:
        return apply_points_fused(params, grid_points, latents[0])
    return apply_grid_fused(params, grid_points, latents)
