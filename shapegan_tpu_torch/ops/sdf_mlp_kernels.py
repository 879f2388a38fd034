"""Kernels of the DeepSDF MLP for the H100 (counterpart of
:mod:`shapegan_tpu.ops.sdf_mlp_pallas`).

Six hand-written CUDA kernels (sources in ``ops/csrc/``):

* the **grid kernel** (``sdf_grid.cu``, replaces ``_kernel`` /
  ``apply_grid_fused``): B shape latents over one shared point grid
  → [B, P];
* the **points kernel** (``sdf_points.cu``, replaces ``_points_kernel`` /
  ``apply_points_fused``): one latent, raw points, both fan-in projections
  in the kernel → [1, N];
* the **grid backward kernel** (``sdf_grid_bwd.cu``, replaces
  ``_bwd_kernel`` / ``_trainable_bwd``): the recompute backward of the grid
  kernel, behind the autograd function :func:`apply_grid_trainable`; its
  rows pass (:func:`grid_backward_rows_cuda`) and its passes 2-4
  (:func:`grid_backward_passes_cuda`, ``sdf_bwd_passes_sm90.cuh``) also run
  alone, for checks and timing;
* the **trace kernel** (``sdf_trace.cu``, replaces ``_make_trace_kernel`` /
  ``trace_steps_fused``): K masked sphere-trace iterations of the points
  kernel's forward per launch, the lane state kept on chip.
* the **rowwise kernel** (``sdf_rowwise.cu``, replaces ``_rowwise_kernel``
  / ``_rowwise_fwd``): raw points [N, 3] with per-row latent terms
  zz1/zz5 [N, 256] (the autodecoder's gathered codes) → [N];
* the **rowwise backward kernel** (``sdf_rowwise_bwd.cu``, replaces
  ``_rowwise_bwd_kernel`` / ``_rowwise_bwd``): its recompute backward,
  per-row dzz1/dzz5 and the trunk's weight gradients, behind the autograd
  function :func:`apply_rowwise_trainable`;
* the **stash forward kernel** (the grid kernel of ``sdf_grid.cu`` given
  stash planes, replaces ``_stash_fwd_kernel`` / ``_stash_fwd_call``): the
  grid kernel's forward that also writes the h-chain positions of a stash
  set to [B, P, 256] bf16 planes;
* the **stash backward kernel** (the grid backward of ``sdf_grid_bwd.cu``
  given those planes, replaces ``_stash_bwd_kernel`` /
  ``_stash_trainable_bwd``): the grid backward with the stashed positions
  read from the planes, behind the autograd function
  :func:`apply_grid_trainable_stash`.

Each kernel has a thin wrapper (``*_cuda``: checks, allocates, launches on
the current stream, counts its launches in ``launch_count``; a traced run
sees each call as the span ``sg.kernel.<name>``) and a plain
PyTorch version (``*_plain``) of the same math at the same bf16 rounding
points. The dispatchers (``grid_forward``, ``points_forward``,
``grid_backward``, ``trace_steps``, ``rowwise_forward``,
``rowwise_backward``, ``grid_forward_stash``, ``grid_backward_stash``) take
the plain version only for tensors
on the CPU; a CUDA tensor goes to the kernel, which raises if it cannot
run. There is no fallback.

Operand layout (shared with the kernels, see ``csrc/sdf_trunk_sm90.cuh``):
``w`` [6, 256(out), 256(in)] bf16 — w2, w3, w4, w5h, w6, w7 transposed;
``b`` [8, 256] bf16 — rows b2, b3, b4, <unused>, b6, b7, b8 broadcast,
<unused> (the JAX package's ``BIAS_STACK_ORDER``); ``w8`` [256] bf16.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch

from shapegan_tpu_torch import tracing
from shapegan_tpu_torch.ops import _build, sdf_mlp
from shapegan_tpu_torch.ops.sdf_mlp import PARAM_KEYS, Params

BF16 = torch.bfloat16
WIDTH = 256
TRUNK_KEYS = ("w2", "w3", "w4", "w5h", "w6", "w7")
SKIP_LAYER = 3  # w5h: adds pp5 + zz5 instead of a bias
HEAD_BIAS_ROW = 6
# Lane status of the sphere trace (the JAX package's TRACE_ACTIVE/HIT/MISS).
TRACE_ACTIVE, TRACE_HIT, TRACE_MISS = 0, 1, 2
# Rows of one grid backward chunk (ROW_CAP in csrc/sdf_grid_bwd.cu): the
# points gradient runs in chunks of at most this many points, so the
# kernel's scratch (~2.1 GB a chunk) does not grow with the frame.
ROW_CAP = 262144
# The h-chain positions a stash set names: 0-indexed into h1..h7, as in the
# JAX package.
HIDDEN = len(TRUNK_KEYS) + 1

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


def check_stash(stash: Sequence[int]) -> Tuple[int, ...]:
    """A stash set as a tuple: distinct h-chain positions in 0..6 in
    ascending order, the sets the JAX package's stash kernels take. Any
    other set raises."""
    stash = tuple(stash)
    if (not all(isinstance(j, int) and not isinstance(j, bool) and 0 <= j < HIDDEN for j in stash)
            or list(stash) != sorted(set(stash))):
        raise ValueError(f"stash {stash}: expected distinct positions in 0..{HIDDEN - 1}, ascending")
    return stash


def _trunk_plain(x: torch.Tensor, add_skip: Callable[[torch.Tensor], torch.Tensor],
                 w: torch.Tensor, b: torch.Tensor, w8: torch.Tensor,
                 keep: Optional[Callable[[int, torch.Tensor], None]] = None) -> torch.Tensor:
    """Six trunk layers and the head over layer-1 activations x [R, 256]
    bf16 → [R] float32. A bf16 matmul accumulates in float32 and rounds once
    to bf16; the bias add is a bf16 add: the kernels' rounding points.
    ``keep(j, x)`` sees each new activation x, h-chain position j = 1..6."""
    for layer in range(len(TRUNK_KEYS)):
        h = x @ w[layer].t()
        h = add_skip(h) if layer == SKIP_LAYER else h + b[layer]
        x = torch.relu(h)
        if keep is not None:
            keep(layer + 1, x)
    return torch.tanh(x.float() @ w8.float() + b[HEAD_BIAS_ROW, 0].float())


def grid_forward_plain(pp1, pp5, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Plain PyTorch version of the grid kernel → [B, P] float32."""
    return grid_forward_stash_plain(pp1, pp5, zz1, zz5, w, b, w8, ())[0]


def grid_forward_stash_plain(pp1, pp5, zz1, zz5, w, b, w8, stash):
    """Plain PyTorch version of the stash forward kernel: the grid kernel's
    output [B, P] float32 (the same computation, so bit for bit the same),
    and a [B, P, 256] bf16 plane for each position of ``stash``: position j
    is the activation after trunk layer j - 1's epilogue, position 0 is
    h1 = relu(pp1 + zz1)."""
    stash = check_stash(stash)
    batch, points = zz1.shape[0], pp1.shape[0]
    planes = {}

    def keep(j, x):
        if j in stash:
            planes[j] = x.reshape(batch, points, WIDTH)

    def add_skip(h):
        h = h.reshape(batch, points, WIDTH) + pp5[None] + zz5[:, None]
        return h.reshape(batch * points, WIDTH)

    x = torch.relu(pp1[None] + zz1[:, None]).reshape(batch * points, WIDTH)
    keep(0, x)
    out = _trunk_plain(x, add_skip, w, b, w8, keep).reshape(batch, points)
    return out, tuple(planes[j] for j in stash)


def points_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Plain PyTorch version of the points kernel → [N] float32. The fan-in
    projections are float32 sums of bf16 products, rounded to bf16."""
    p = pts.to(BF16).float()
    pp1 = (p @ w1p.float()).to(BF16)
    pp5 = (p @ w5p.float()).to(BF16)
    x = torch.relu(pp1 + zz1)
    return _trunk_plain(x, lambda h: h + pp5 + zz5, w, b, w8)


def trace_update(points, dirs, status, sdf, *, shadow: bool, threshold: float, step_clamp: float,
                 sdf_offset: float, radius: float, escape=None):
    """One sphere-trace iteration given the SDF at the pre-advance points:
    returns the advanced points and the new status. The step is clipped to
    ±step_clamp; only ACTIVE lanes move; a lane hits at 0 < sdf < threshold
    and misses outside the bounding sphere (primary: the sum of squares
    against radius², as the kernel does it) or above its escape height
    (shadow: ``escape`` [N], else the scalar ``radius``); a hit beats a
    miss. Each product and sum is its own rounded operation, as in the
    kernel."""
    sdf = (sdf + sdf_offset).clamp(-step_clamp, step_clamp)
    active = status == TRACE_ACTIVE
    points = points + dirs * torch.where(active, sdf, 0.0)[:, None]
    hits = active & (sdf > 0) & (sdf < threshold)
    if shadow:
        outside = points[:, 1] > (radius if escape is None else escape)
    else:
        x, y, z = points.unbind(1)
        outside = x * x + y * y + z * z > radius * radius
    status = torch.where(hits, TRACE_HIT, torch.where(active & outside, TRACE_MISS, status))
    return points, status.to(torch.int32)


def trace_steps_plain(pts, dirs, status, escape, w1p, w5p, zz1, zz5, w, b, w8, *, k: int,
                      shadow: bool, threshold: float, step_clamp: float, sdf_offset: float,
                      radius: float):
    """Plain PyTorch version of the trace kernel: ``k`` iterations of the
    points kernel's plain version and :func:`trace_update`. Returns (points
    [N, 3] float32, status [N] int32). It stops early once no lane is
    ACTIVE, which changes nothing: resolved lanes never move."""
    for _ in range(k):
        if not bool((status == TRACE_ACTIVE).any()):
            break
        sdf = points_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8)
        pts, status = trace_update(pts, dirs, status, sdf, shadow=shadow, threshold=threshold,
                                   step_clamp=step_clamp, sdf_offset=sdf_offset, radius=radius,
                                   escape=escape)
    return pts, status


def grid_backward_plain(pp1, pp5, zz1, zz5, w, b, w8, g):
    """Plain PyTorch version of the grid backward kernel (the math of
    ``_bwd_kernel``), one shape at a time so memory stays bounded. Returns
    float32 (d_pp1 [P, 256], d_pp5 [P, 256], d_zz1 [B, 256], d_zz5 [B, 256],
    d_w [6, 256(in), 256(out)], d_b [8, 256], d_w8 [256], d_b8 [1]).

    Its rounding points are not the forward's: each rebuilt layer adds its
    bias (layer 5: pp5, then zz5) to the float32 product and rounds once;
    each dz is rounded to bf16 before it is used; dh and dx1 stay float32.
    Products take bf16 operands in float32 (``a.float() @ b.float()``), exact
    per product, so a float32 result is never rounded to bf16 on the way.
    The outputs are the sums of :func:`grid_backward_rows_plain`'s planes
    (the kernel's passes 2-4), one shape at a time."""
    return grid_backward_stash_plain(pp1, pp5, zz1, zz5, w, b, w8, g, (), ())


def grid_backward_rows_plain(pp1, pp5, zz1, zz5, w, b, w8, g):
    """Plain PyTorch version of the grid backward kernel's rows pass: the
    scratch it writes for B shapes over P points, row s·P + p for shape s
    and point p (R = B·P rows). Returns (h [7, R, 256] bf16: h1..h7; dz
    [6, R, 256] bf16, plane l the gradient at trunk layer l's output; dx1
    [R, 256] float32; gz [R] float32), at :func:`grid_backward_plain`'s
    rounding points."""
    wf, bf, w8f = w.float(), b.float(), w8.float()
    shapes = [_grid_rows(pp1, pp5, zz1, zz5, wf, bf, w8f, g, {}, s) for s in range(zz1.shape[0])]
    h, dz, dx1, gz = zip(*shapes)
    return (torch.stack([torch.cat(planes) for planes in zip(*h)]),
            torch.stack([torch.cat(planes) for planes in zip(*dz)]), torch.cat(dx1), torch.cat(gz))


def grid_backward_passes_plain(h, dz, dx1, gz, shapes: int, points: int, s0: int = 0):
    """Plain PyTorch version of the grid backward kernel's passes 2-4 over
    one chunk of ``shapes`` shapes from shape ``s0`` on: the eight outputs
    of :func:`grid_backward_plain` made from the rows pass's planes (as
    :func:`grid_backward_rows_plain` returns them, R = shapes·points rows),
    summed in float64 and returned in float32. d_zz1 and d_zz5 have
    s0 + shapes rows, the chunk's from row s0 on; d_pp1 and d_pp5 are summed
    over the chunk's shapes."""
    h, dz, dx1, gz = (t.double() for t in (h, dz, dx1, gz))
    by_shape = (shapes, points, WIDTH)
    d_zz1 = torch.zeros((s0 + shapes, WIDTH), dtype=torch.float64, device=dx1.device)
    d_zz5 = torch.zeros_like(d_zz1)
    d_zz1[s0:] = dx1.reshape(by_shape).sum(1)
    d_zz5[s0:] = dz[SKIP_LAYER].reshape(by_shape).sum(1)
    d_b = torch.zeros((8, WIDTH), dtype=torch.float64, device=dx1.device)
    biased = [layer for layer in range(len(TRUNK_KEYS)) if layer != SKIP_LAYER]
    d_b[biased] = dz[biased].sum(1)
    outs = (dx1.reshape(by_shape).sum(0), dz[SKIP_LAYER].reshape(by_shape).sum(0), d_zz1, d_zz5,
            torch.einsum("lri,lro->lio", h[:len(TRUNK_KEYS)], dz), d_b, h[-1].t() @ gz,
            gz.sum().reshape(1))
    return tuple(t.float() for t in outs)


def _grid_rows(pp1, pp5, zz1, zz5, wf, bf, w8f, g, planes, s):
    """The rows pass of shape s (float32 weights ``wf``, ``bf``, ``w8f``;
    ``planes``: stashed position → [B, P, 256] bf16 plane): (h1..h7 [P, 256]
    bf16, dz [P, 256] bf16 per trunk layer, dx1 [P, 256], gz [P] float32)."""
    h = [torch.relu(pp1.float() + zz1[s].float()).to(BF16)]
    for layer in range(len(TRUNK_KEYS)):
        if layer + 1 in planes:
            h.append(planes[layer + 1][s])
            continue
        acc = h[-1].float() @ wf[layer].t()
        if layer == SKIP_LAYER:
            acc = acc + pp5.float() + zz5[s].float()
        else:
            acc = acc + bf[layer]
        h.append(torch.relu(acc).to(BF16))
    out = torch.tanh(h[-1].float() @ w8f + bf[HEAD_BIAS_ROW, 0])
    gz = g[s].float() * (1.0 - out * out)
    dz = [None] * len(TRUNK_KEYS)
    dh = gz[:, None] * w8f[None, :]
    for layer in reversed(range(len(TRUNK_KEYS))):
        dz[layer] = (dh * (h[layer + 1] > 0)).to(BF16)
        dh = dz[layer].float() @ wf[layer]
    return h, dz, dh * (h[0] > 0), gz


def grid_backward_stash_plain(pp1, pp5, zz1, zz5, w, b, w8, g, stashed, stash):
    """Plain PyTorch version of the stash backward kernel (the math of
    ``_stash_bwd_kernel``): what :func:`grid_backward_plain` returns, with
    the positions of ``stash`` read from ``stashed`` (one [B, P, 256] bf16
    plane each, the stash forward's). Its rounding points: h1 is rebuilt as
    the grid backward does it; a stashed position is the forward's own
    value; a position that is not stashed is rebuilt, in ascending order,
    from its predecessor (which may be stashed) at the grid backward's
    rounding points; the sweep is the grid backward's. A stashed position 0
    is ignored, as the TPU kernel ignores it. The outputs are sums of the
    rows pass's planes, one shape at a time."""
    stash = check_stash(stash)
    if len(stashed) != len(stash):
        raise ValueError(f"{len(stashed)} stashed planes for the stash {stash}")
    planes = dict(zip(stash, stashed))
    f32 = torch.float32
    points, width = pp1.shape
    wf = w.float()
    bf = b.float()
    w8f = w8.float()
    d_pp1 = torch.zeros((points, width), dtype=f32, device=pp1.device)
    d_pp5 = torch.zeros_like(d_pp1)
    d_zz1 = torch.zeros(zz1.shape, dtype=f32, device=pp1.device)
    d_zz5 = torch.zeros_like(d_zz1)
    d_w = torch.zeros(wf.shape, dtype=f32, device=pp1.device)
    d_b = torch.zeros((8, width), dtype=f32, device=pp1.device)
    d_w8 = torch.zeros(width, dtype=f32, device=pp1.device)
    d_b8 = torch.zeros(1, dtype=f32, device=pp1.device)
    for s in range(zz1.shape[0]):
        h, dz, dx1, gz = _grid_rows(pp1, pp5, zz1, zz5, wf, bf, w8f, g, planes, s)
        d_w8 += h[-1].float().t() @ gz
        d_b8 += gz.sum()
        for layer in reversed(range(len(TRUNK_KEYS))):
            dzf = dz[layer].float()
            d_w[layer] += h[layer].float().t() @ dzf
            if layer == SKIP_LAYER:
                d_pp5 += dzf
                d_zz5[s] = dzf.sum(0)
            else:
                d_b[layer] += dzf.sum(0)
        d_pp1 += dx1
        d_zz1[s] = dx1.sum(0)
    return d_pp1, d_pp5, d_zz1, d_zz5, d_w, d_b, d_w8, d_b8


def rowwise_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Plain PyTorch version of the rowwise kernel → [N] float32: the points
    kernel's math with per-row zz1/zz5 [N, 256] (the same rounding points,
    ``_points_trunk``)."""
    return points_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8)


def rowwise_backward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8, g):
    """Plain PyTorch version of the rowwise backward kernel (the math of
    ``_rowwise_bwd_kernel``) for the cotangent g [N]. Returns float32
    (dzz1 [N, 256], dzz5 [N, 256], d_w [6, 256(in), 256(out)], d_b [8, 256],
    d_w8 [256], d_b8 [1]).

    Its rounding points are neither the forward's nor the grid backward's:
    layer 1 adds zz1 to the float32 projection pts @ w1p (not rounded to
    bf16 first) and rounds once; layer 5 sums its product, pts @ w5p and zz5
    in float32 and rounds once; the other layers add their bias to the
    float32 product and round once. Each dz is rounded to bf16 before it is
    used; dzz5 is that bf16 dz as float32, dzz1 the float32 dx1. The d_b
    rows 3, 6 and 7 stay zero."""
    p = pts.to(BF16).float()
    wf = w.float()
    bf = b.float()
    w8f = w8.float()
    h = [torch.relu(p @ w1p.float() + zz1.float()).to(BF16)]
    for layer in range(len(TRUNK_KEYS)):
        acc = h[-1].float() @ wf[layer].t()
        if layer == SKIP_LAYER:
            acc = acc + p @ w5p.float() + zz5.float()
        else:
            acc = acc + bf[layer]
        h.append(torch.relu(acc).to(BF16))
    out = torch.tanh(h[-1].float() @ w8f + bf[HEAD_BIAS_ROW, 0])
    gz = g.float() * (1.0 - out * out)
    d_w8 = h[-1].float().t() @ gz
    d_b8 = gz.sum().reshape(1)
    d_w = torch.zeros(wf.shape, dtype=torch.float32, device=pts.device)
    d_b = torch.zeros((8, WIDTH), dtype=torch.float32, device=pts.device)
    dh = gz[:, None] * w8f[None, :]
    for layer in reversed(range(len(TRUNK_KEYS))):
        dz = (dh * (h[layer + 1] > 0)).to(BF16).float()
        d_w[layer] = h[layer].float().t() @ dz
        if layer == SKIP_LAYER:
            dzz5 = dz
        else:
            d_b[layer] = dz.sum(0)
        dh = dz @ wf[layer]
    dzz1 = dh * (h[0] > 0)
    return dzz1, dzz5, d_w, d_b, d_w8, d_b8


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


def _check_grid(pp1, pp5, zz1, zz5, w, b, w8):
    """The grid kernels' operand checks; returns (device, points, batch)."""
    device = _cuda_device(pp1)
    points, batch = pp1.shape[0], zz1.shape[0]
    _check("pp1", device, pp1, (points, WIDTH), BF16)
    _check("pp5", device, pp5, (points, WIDTH), BF16)
    _check("zz1", device, zz1, (batch, WIDTH), BF16)
    _check("zz5", device, zz5, (batch, WIDTH), BF16)
    _check_trunk(device, w, b, w8)
    return device, points, batch


@tracing.kernel
def grid_forward_cuda(pp1, pp5, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Launch the grid kernel (``csrc/sdf_grid.cu``) → [B, P] float32."""
    device, points, batch = _check_grid(pp1, pp5, zz1, zz5, w, b, w8)
    out = torch.empty((batch, points), dtype=torch.float32, device=device)
    if batch == 0 or points == 0:
        return out
    lib = _build.load()
    code = lib.sdf_grid_forward(
        pp1.data_ptr(), pp5.data_ptr(), zz1.data_ptr(), zz5.data_ptr(),
        w.data_ptr(), b.data_ptr(), w8.data_ptr(), out.data_ptr(),
        batch, points, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_forward", code)
    _build.count_launch(grid_forward_cuda)
    return out


grid_forward_cuda.launch_count = 0


@tracing.kernel
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
    _build.count_launch(points_forward_cuda)
    return out


points_forward_cuda.launch_count = 0


@tracing.kernel
def grid_backward_cuda(pp1, pp5, zz1, zz5, w, b, w8, g):
    """Launch the grid backward kernel (``csrc/sdf_grid_bwd.cu``); returns
    what :func:`grid_backward_plain` returns. The scratch it needs (about
    2 GB for a chunk of 262,144 rows) is allocated here, per call."""
    device, points, batch = _check_grid(pp1, pp5, zz1, zz5, w, b, w8)
    outs = _grid_grad_buffers(device, points, batch, g)
    lib = _build.load()
    chunk = lib.sdf_grid_backward_chunk_shapes(points, batch)
    scratch = torch.empty(lib.sdf_grid_backward_scratch_bytes(points, chunk, 0),
                          dtype=torch.uint8, device=device)
    wt = w.transpose(1, 2).contiguous()  # [6, in, out]: the backward products' operand
    code = lib.sdf_grid_backward(
        pp1.data_ptr(), pp5.data_ptr(), zz1.data_ptr(), zz5.data_ptr(), w.data_ptr(),
        wt.data_ptr(), b.data_ptr(), w8.data_ptr(), g.data_ptr(),
        *(t.data_ptr() for t in outs), scratch.data_ptr(),
        batch, points, chunk, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_backward", code)
    _build.count_launch(grid_backward_cuda)
    return outs


grid_backward_cuda.launch_count = 0


@tracing.kernel
def grid_backward_rows_cuda(pp1, pp5, zz1, zz5, w, b, w8, g):
    """Launch the grid backward kernel's rows pass alone
    (``csrc/sdf_grid_bwd_sm90.cuh``, the C entry point
    ``sdf_grid_backward_rows``) over the B shapes as one chunk; returns what
    :func:`grid_backward_rows_plain` returns, as views of the scratch the
    passes after it would read. B·P must fit one chunk (``ROW_CAP`` rows, or
    one shape)."""
    device, points, batch = _check_grid(pp1, pp5, zz1, zz5, w, b, w8)
    _check("g", device, g, (batch, points), torch.float32)
    lib = _build.load()
    if batch == 0 or points == 0 or lib.sdf_grid_backward_chunk_shapes(points, batch) < batch:
        raise ValueError(f"the rows pass takes one chunk of B > 0 shapes, got B={batch} P={points}")
    offsets = (ctypes.c_longlong * 5)()
    lib.sdf_grid_backward_offsets(points, batch, 0, offsets)
    scratch = torch.empty(offsets[4], dtype=torch.uint8, device=device)
    wt = w.transpose(1, 2).contiguous()
    code = lib.sdf_grid_backward_rows(
        pp1.data_ptr(), pp5.data_ptr(), zz1.data_ptr(), zz5.data_ptr(), w.data_ptr(), wt.data_ptr(),
        b.data_ptr(), w8.data_ptr(), g.data_ptr(), scratch.data_ptr(), batch, points, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_backward_rows", code)
    _build.count_launch(grid_backward_rows_cuda)
    rows = batch * points

    def view(i, dtype, *shape):
        n = torch.Size(shape).numel() * dtype.itemsize
        return scratch[offsets[i]:offsets[i] + n].view(dtype).view(shape)

    return (view(0, BF16, HIDDEN, rows, WIDTH), view(1, BF16, len(TRUNK_KEYS), rows, WIDTH),
            view(2, torch.float32, rows, WIDTH), view(3, torch.float32, rows))


grid_backward_rows_cuda.launch_count = 0


@tracing.kernel
def grid_backward_passes_cuda(h, dz, dx1, gz, shapes: int, points: int, s0: int = 0):
    """Launch the grid backward kernel's passes 2-4 alone
    (``csrc/sdf_bwd_passes_sm90.cuh``, the C entry point
    ``sdf_grid_backward_passes``) over one chunk's planes; returns what
    :func:`grid_backward_passes_plain` returns."""
    device = _cuda_device(h)
    rows = shapes * points
    if shapes <= 0 or points <= 0 or s0 < 0:
        raise ValueError(f"the passes take shapes > 0, points > 0, s0 >= 0, got {shapes}, {points}, {s0}")
    _check("h", device, h, (HIDDEN, rows, WIDTH), BF16)
    _check("dz", device, dz, (len(TRUNK_KEYS), rows, WIDTH), BF16)
    _check("dx1", device, dx1, (rows, WIDTH), torch.float32)
    _check("gz", device, gz, (rows,), torch.float32)
    outs = _grid_grad_buffers(device, points, s0 + shapes)
    lib = _build.load()
    scratch = torch.empty(lib.sdf_grid_backward_passes_scratch_bytes(points, shapes), dtype=torch.uint8,
                          device=device)
    code = lib.sdf_grid_backward_passes(
        h.data_ptr(), dz.data_ptr(), dx1.data_ptr(), gz.data_ptr(), *(t.data_ptr() for t in outs),
        scratch.data_ptr(), shapes, points, s0, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_backward_passes", code)
    _build.count_launch(grid_backward_passes_cuda)
    return outs


grid_backward_passes_cuda.launch_count = 0


def _grid_grad_buffers(device, points: int, batch: int, g: Optional[torch.Tensor] = None):
    """The grid backwards' eight float32 outputs (zeroed by the kernels),
    after checking the cotangent g [B, P] if given."""
    if g is not None:
        _check("g", device, g, (batch, points), torch.float32)
    if batch == 0 or points == 0:
        raise ValueError(f"grid backward needs B > 0 and P > 0, got B={batch} P={points}")

    def buffer(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    return (buffer(points, WIDTH), buffer(points, WIDTH), buffer(batch, WIDTH),
            buffer(batch, WIDTH), buffer(len(TRUNK_KEYS), WIDTH, WIDTH), buffer(8, WIDTH),
            buffer(WIDTH), buffer(1))


def _stash_pointers(stash: Tuple[int, ...], planes) -> ctypes.Array:
    """The kernels' HIDDEN plane pointers: a plane's address at its
    position, NULL elsewhere."""
    pointers = [None] * HIDDEN
    for j, plane in zip(stash, planes):
        pointers[j] = plane.data_ptr()
    return (ctypes.c_void_p * HIDDEN)(*pointers)


@tracing.kernel
def grid_forward_stash_cuda(pp1, pp5, zz1, zz5, w, b, w8, stash):
    """Launch the stash forward kernel (``csrc/sdf_grid.cu``); returns
    what :func:`grid_forward_stash_plain` returns. The planes (B·P·512 bytes
    each) are allocated here."""
    stash = check_stash(stash)
    device, points, batch = _check_grid(pp1, pp5, zz1, zz5, w, b, w8)
    out = torch.empty((batch, points), dtype=torch.float32, device=device)
    planes = tuple(torch.empty((batch, points, WIDTH), dtype=BF16, device=device) for _ in stash)
    if batch == 0 or points == 0:
        return out, planes
    lib = _build.load()
    code = lib.sdf_grid_stash_forward(
        pp1.data_ptr(), pp5.data_ptr(), zz1.data_ptr(), zz5.data_ptr(), w.data_ptr(),
        b.data_ptr(), w8.data_ptr(), out.data_ptr(), _stash_pointers(stash, planes),
        batch, points, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_stash_forward", code)
    _build.count_launch(grid_forward_stash_cuda)
    return out, planes


grid_forward_stash_cuda.launch_count = 0


@tracing.kernel
def grid_backward_stash_cuda(pp1, pp5, zz1, zz5, w, b, w8, g, stashed, stash):
    """Launch the stash backward kernel (``csrc/sdf_grid_bwd.cu``);
    returns what :func:`grid_backward_stash_plain` returns. Its scratch is
    the grid backward's less one plane for each stashed position among
    h2..h7."""
    stash = check_stash(stash)
    device, points, batch = _check_grid(pp1, pp5, zz1, zz5, w, b, w8)
    if len(stashed) != len(stash):
        raise ValueError(f"{len(stashed)} stashed planes for the stash {stash}")
    for j, plane in zip(stash, stashed):
        _check(f"stash plane {j}", device, plane, (batch, points, WIDTH), BF16)
    outs = _grid_grad_buffers(device, points, batch, g)
    lib = _build.load()
    chunk = lib.sdf_grid_backward_chunk_shapes(points, batch)
    mask = sum(1 << j for j in stash)
    scratch = torch.empty(lib.sdf_grid_backward_scratch_bytes(points, chunk, mask),
                          dtype=torch.uint8, device=device)
    wt = w.transpose(1, 2).contiguous()  # [6, in, out]: the backward products' operand
    code = lib.sdf_grid_stash_backward(
        pp1.data_ptr(), pp5.data_ptr(), zz1.data_ptr(), zz5.data_ptr(), w.data_ptr(),
        wt.data_ptr(), b.data_ptr(), w8.data_ptr(), g.data_ptr(), _stash_pointers(stash, stashed),
        *(t.data_ptr() for t in outs), scratch.data_ptr(),
        batch, points, chunk, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_grid_stash_backward", code)
    _build.count_launch(grid_backward_stash_cuda)
    return outs


grid_backward_stash_cuda.launch_count = 0


@tracing.kernel
def trace_steps_cuda(pts, dirs, status, escape, w1p, w5p, zz1, zz5, w, b, w8, *, k: int,
                     shadow: bool, threshold: float, step_clamp: float, sdf_offset: float,
                     radius: float):
    """Launch the trace kernel (``csrc/sdf_trace.cu``); returns what
    :func:`trace_steps_plain` returns. ``escape`` (shadow rays only) is None
    or [N] float32."""
    device = _cuda_device(pts)
    n = pts.shape[0]
    _check("pts", device, pts, (n, 3), torch.float32)
    _check("dirs", device, dirs, (n, 3), torch.float32)
    _check("status", device, status, (n,), torch.int32)
    if escape is not None:
        if not shadow:
            raise ValueError("escape heights apply to shadow rays only")
        _check("escape", device, escape, (n,), torch.float32)
    _check("w1p", device, w1p, (3, WIDTH), BF16)
    _check("w5p", device, w5p, (3, WIDTH), BF16)
    _check("zz1", device, zz1, (WIDTH,), BF16)
    _check("zz5", device, zz5, (WIDTH,), BF16)
    _check_trunk(device, w, b, w8)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if n == 0 or k == 0:
        return pts.clone(), status.clone()
    pts_out = torch.empty_like(pts)
    status_out = torch.empty_like(status)
    counter = torch.zeros(1, dtype=torch.int32, device=device)  # the lanes handed out so far
    lib = _build.load()
    code = lib.sdf_trace_steps(
        pts.data_ptr(), dirs.data_ptr(), status.data_ptr(),
        None if escape is None else escape.data_ptr(), w1p.data_ptr(), w5p.data_ptr(),
        zz1.data_ptr(), zz5.data_ptr(), w.data_ptr(), b.data_ptr(), w8.data_ptr(),
        pts_out.data_ptr(), status_out.data_ptr(), counter.data_ptr(), n, k, int(shadow),
        threshold, step_clamp,
        sdf_offset, radius, radius * radius, device.index,
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_trace_steps", code)
    _build.count_launch(trace_steps_cuda)
    return pts_out, status_out


trace_steps_cuda.launch_count = 0


def _check_rowwise(pts, w1p, w5p, zz1, zz5, w, b, w8):
    device = _cuda_device(pts)
    n = pts.shape[0]
    _check("pts", device, pts, (n, 3), torch.float32)
    _check("w1p", device, w1p, (3, WIDTH), BF16)
    _check("w5p", device, w5p, (3, WIDTH), BF16)
    _check("zz1", device, zz1, (n, WIDTH), BF16)
    _check("zz5", device, zz5, (n, WIDTH), BF16)
    _check_trunk(device, w, b, w8)
    return device, n


@tracing.kernel
def rowwise_forward_cuda(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Launch the rowwise kernel (``csrc/sdf_rowwise.cu``) → [N] float32."""
    device, n = _check_rowwise(pts, w1p, w5p, zz1, zz5, w, b, w8)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lib = _build.load()
    code = lib.sdf_rowwise_forward(
        pts.data_ptr(), w1p.data_ptr(), w5p.data_ptr(), zz1.data_ptr(), zz5.data_ptr(),
        w.data_ptr(), b.data_ptr(), w8.data_ptr(), out.data_ptr(),
        n, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_rowwise_forward", code)
    _build.count_launch(rowwise_forward_cuda)
    return out


rowwise_forward_cuda.launch_count = 0


@tracing.kernel
def rowwise_backward_cuda(pts, w1p, w5p, zz1, zz5, w, b, w8, g):
    """Launch the rowwise backward kernel (``csrc/sdf_rowwise_bwd.cu``: the
    grid backward's Hopper rows pass and weight kernel, then the d_w8 / d_b8
    sums); returns what :func:`rowwise_backward_plain` returns. Its scratch
    (about 6.7 KB a row and 17 MB of partials) comes from PyTorch's caching
    allocator, so a training loop of equal batches reuses one block."""
    device, n = _check_rowwise(pts, w1p, w5p, zz1, zz5, w, b, w8)
    _check("g", device, g, (n,), torch.float32)
    if n == 0:
        raise ValueError("rowwise backward needs N > 0")

    # Written whole by the kernel: the per-row pair in one allocation, the
    # trunk's gradients in another (fewer allocator calls on the host).
    layers = len(TRUNK_KEYS)
    dzz1, dzz5 = torch.empty((2, n, WIDTH), dtype=torch.float32, device=device)
    summed = torch.empty(layers * WIDTH * WIDTH + 9 * WIDTH + 1, dtype=torch.float32, device=device)
    d_w, d_b, d_w8, d_b8 = summed.split([layers * WIDTH * WIDTH, 8 * WIDTH, WIDTH, 1])
    outs = (dzz1, dzz5, d_w.view(layers, WIDTH, WIDTH), d_b.view(8, WIDTH), d_w8, d_b8)
    lib = _build.load()
    scratch = torch.empty(lib.sdf_rowwise_backward_scratch_bytes(n), dtype=torch.uint8,
                          device=device)
    wt = w.transpose(1, 2).contiguous()  # [6, in, out]: the backward products' operand
    code = lib.sdf_rowwise_backward(
        pts.data_ptr(), w1p.data_ptr(), w5p.data_ptr(), zz1.data_ptr(), zz5.data_ptr(),
        w.data_ptr(), wt.data_ptr(), b.data_ptr(), w8.data_ptr(), g.data_ptr(),
        *(t.data_ptr() for t in outs), scratch.data_ptr(),
        n, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "sdf_rowwise_backward", code)
    _build.count_launch(rowwise_backward_cuda)
    return outs


rowwise_backward_cuda.launch_count = 0


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


def grid_backward(pp1, pp5, zz1, zz5, w, b, w8, g):
    """Grid backward kernel on CUDA tensors, its plain version on CPU tensors."""
    if pp1.device.type == "cpu":
        return grid_backward_plain(pp1, pp5, zz1, zz5, w, b, w8, g)
    return grid_backward_cuda(pp1, pp5, zz1, zz5, w, b, w8, g)


def grid_forward_stash(pp1, pp5, zz1, zz5, w, b, w8, stash):
    """Stash forward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if pp1.device.type == "cpu":
        return grid_forward_stash_plain(pp1, pp5, zz1, zz5, w, b, w8, stash)
    return grid_forward_stash_cuda(pp1, pp5, zz1, zz5, w, b, w8, stash)


def grid_backward_stash(pp1, pp5, zz1, zz5, w, b, w8, g, stashed, stash):
    """Stash backward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if pp1.device.type == "cpu":
        return grid_backward_stash_plain(pp1, pp5, zz1, zz5, w, b, w8, g, stashed, stash)
    return grid_backward_stash_cuda(pp1, pp5, zz1, zz5, w, b, w8, g, stashed, stash)


def trace_steps(pts, dirs, status, escape, w1p, w5p, zz1, zz5, w, b, w8, **kw):
    """Trace kernel on CUDA tensors, its plain version on CPU tensors."""
    if pts.device.type == "cpu":
        return trace_steps_plain(pts, dirs, status, escape, w1p, w5p, zz1, zz5, w, b, w8, **kw)
    return trace_steps_cuda(pts, dirs, status, escape, w1p, w5p, zz1, zz5, w, b, w8, **kw)


def rowwise_forward(pts, w1p, w5p, zz1, zz5, w, b, w8) -> torch.Tensor:
    """Rowwise kernel on CUDA tensors, its plain version on CPU tensors."""
    if pts.device.type == "cpu":
        return rowwise_forward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8)
    return rowwise_forward_cuda(pts, w1p, w5p, zz1, zz5, w, b, w8)


def rowwise_backward(pts, w1p, w5p, zz1, zz5, w, b, w8, g):
    """Rowwise backward kernel on CUDA tensors, its plain version on CPU
    tensors."""
    if pts.device.type == "cpu":
        return rowwise_backward_plain(pts, w1p, w5p, zz1, zz5, w, b, w8, g)
    return rowwise_backward_cuda(pts, w1p, w5p, zz1, zz5, w, b, w8, g)


# ------------------------------------------------------------- entry points


def grid_operands(params: Params, grid_points: torch.Tensor, latents: torch.Tensor):
    """The grid kernel's operands (pp1, pp5, zz1, zz5, w, b, w8). The point
    projections are bf16 matmuls outside the kernel, as in the TPU version."""
    pts = grid_points.to(BF16)
    pp1 = (pts @ params["w1p"].to(BF16)).contiguous()
    pp5 = (pts @ params["w5p"].to(BF16)).contiguous()
    return (pp1, pp5) + latent_terms(params, latents) + trunk_operands(params)


def point_weights(params: Params, latent: torch.Tensor):
    """The points and trace kernels' weight operands (w1p, w5p, zz1, zz5,
    w, b, w8) for one latent [L]."""
    zz1, zz5 = latent_terms(params, latent[None, :])
    return ((params["w1p"].to(BF16).contiguous(), params["w5p"].to(BF16).contiguous(),
             zz1[0], zz5[0]) + trunk_operands(params))


def points_operands(params: Params, points: torch.Tensor, latent: torch.Tensor):
    """The points kernel's operands (pts, w1p, w5p, zz1, zz5, w, b, w8)."""
    return (points.float().contiguous(),) + point_weights(params, latent)


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
    dispatch on a TPU). On CPU tensors each runs its plain version. The
    operands are made anew each call, in the span ``sg.generate.operands``."""
    if latents.shape[0] == 1:
        with tracing.span("sg.generate.operands"):
            operands = points_operands(params, grid_points, latents[0])
        return points_forward(*operands)[None, :]
    with tracing.span("sg.generate.operands"):
        operands = grid_operands(params, grid_points, latents)
    return grid_forward(*operands)


def trace_steps_fused(params: Params, latent: torch.Tensor, points: torch.Tensor,
                      directions: torch.Tensor, status: torch.Tensor, *, k: int, shadow: bool,
                      threshold: float, step_clamp: float, sdf_offset: float, radius: float,
                      escape=None):
    """Run ``k`` masked sphere-trace iterations (the JAX package's
    ``trace_steps_fused``): points/directions [N, 3], status [N] (0 active,
    1 hit, 2 miss) → (points, status). A non-empty latent is folded into the
    biases first; ``escape`` [N] gives shadow rays per-lane escape heights
    (default: the scalar ``radius``) and is ignored for primary rays."""
    if latent.shape[0]:
        params = sdf_mlp.fold_latent(params, latent)
        latent = latent[:0]
    escape = escape.float().contiguous() if shadow and escape is not None else None
    return trace_steps(points.float().contiguous(), directions.float().contiguous(),
                       status.to(torch.int32).contiguous(), escape,
                       *point_weights(params, latent), k=k, shadow=shadow, threshold=threshold,
                       step_clamp=step_clamp, sdf_offset=sdf_offset, radius=radius)


class _GridTrainable(torch.autograd.Function):
    """The grid kernel forward with the grid backward kernel as its
    gradient (the custom VJP of the JAX package's ``apply_grid_trainable``).
    Inputs: grid points [P, 3], latents [B, L], then the 19 parameters in
    ``PARAM_KEYS`` order."""

    @staticmethod
    def forward(ctx, grid_points, latents, *values):
        ctx.save_for_backward(grid_points, latents, *values)
        params = dict(zip(PARAM_KEYS, values))
        return grid_forward(*grid_operands(params, grid_points, latents))

    @staticmethod
    def backward(ctx, g):
        grid_points, latents, *values = ctx.saved_tensors
        params = dict(zip(PARAM_KEYS, values))
        grads = grid_backward(*grid_operands(params, grid_points, latents), g.float().contiguous())
        return _close_grid_chain(params, grid_points, latents, grads)


def _close_grid_chain(params: Params, grid_points: torch.Tensor, latents: torch.Tensor, grads):
    """The closing products of ``_trainable_bwd`` (and
    ``_stash_trainable_bwd``), in float32: from a grid backward's outputs to
    the gradients of the points, the latents and the 19 parameters in
    ``PARAM_KEYS`` order."""
    d_pp1, d_pp5, d_zz1, d_zz5, d_w, d_b, d_w8, d_b8 = grads
    pts = grid_points.float()
    lat = latents.float()
    d = {
        "w1p": pts.t() @ d_pp1, "w1z": lat.t() @ d_zz1, "b1": d_zz1.sum(0),
        "w5p": pts.t() @ d_pp5, "w5z": lat.t() @ d_zz5, "b5": d_zz5.sum(0),
        "w8": d_w8[:, None], "b8": d_b8,
    }
    for layer, key in enumerate(TRUNK_KEYS):
        d[key] = d_w[layer]
        if layer != SKIP_LAYER:
            d["b" + key[1:]] = d_b[layer]
    d_grid = d_pp1 @ params["w1p"].float().t() + d_pp5 @ params["w5p"].float().t()
    d_latents = d_zz1 @ params["w1z"].float().t() + d_zz5 @ params["w5z"].float().t()
    return (d_grid.to(grid_points.dtype), d_latents.to(latents.dtype),
            *(d[k].to(params[k].dtype) for k in PARAM_KEYS))


def apply_grid_trainable(params: Params, grid_points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Differentiable grid evaluation [P, 3] x [B, L] → [B, P] float32: the
    grid kernel forward, the grid backward kernel for the gradients of the
    parameters, the points and the latents."""
    return _GridTrainable.apply(grid_points, latents, *(params[k] for k in PARAM_KEYS))


class _GridTrainableStash(torch.autograd.Function):
    """The stash forward kernel with the stash backward kernel as its
    gradient (the custom VJP of the JAX package's
    ``apply_grid_trainable_stash``). Inputs: the stash set, grid points
    [P, 3], latents [B, L], then the 19 parameters in ``PARAM_KEYS`` order.
    The stashed planes are kept for the backward."""

    @staticmethod
    def forward(ctx, stash, grid_points, latents, *values):
        params = dict(zip(PARAM_KEYS, values))
        out, stashed = grid_forward_stash(*grid_operands(params, grid_points, latents), stash)
        ctx.stash = stash
        ctx.save_for_backward(grid_points, latents, *values, *stashed)
        return out

    @staticmethod
    def backward(ctx, g):
        grid_points, latents, *saved = ctx.saved_tensors
        values, stashed = saved[:len(PARAM_KEYS)], saved[len(PARAM_KEYS):]
        params = dict(zip(PARAM_KEYS, values))
        grads = grid_backward_stash(*grid_operands(params, grid_points, latents),
                                    g.float().contiguous(), stashed, ctx.stash)
        return (None,) + _close_grid_chain(params, grid_points, latents, grads)


def apply_grid_trainable_stash(params: Params, grid_points: torch.Tensor, latents: torch.Tensor,
                               stash: Sequence[int]) -> torch.Tensor:
    """Differentiable grid evaluation [P, 3] x [B, L] → [B, P] float32 with
    an activation stash: the stash forward kernel writes the h-chain
    positions of ``stash`` (0-indexed into h1..h7; the trainers' set is
    :data:`shapegan_tpu_torch.train.hybrid_gan._GRID_STASH`), and
    the stash backward kernel reads them instead of rebuilding them. The
    value is the grid kernel's; the gradients differ from
    :func:`apply_grid_trainable`'s by the rounding of the positions read."""
    return _GridTrainableStash.apply(check_stash(stash), grid_points, latents,
                                     *(params[k] for k in PARAM_KEYS))


# Calls of apply_grid_sharded: tests and the multichip dryrun read it to
# see that a multi-rank step took the sharded route.
sharded_call_count = 0


def _trainable_dispatch(params: Params, grid_points: torch.Tensor,
                        latents: torch.Tensor) -> torch.Tensor:
    """A rank's differentiable grid evaluation (the JAX package's
    ``_trainable_dispatch``): the grid kernel and the grid backward kernel
    on CUDA; on the CPU the float32 reference math, chunked under
    ``torch.utils.checkpoint`` (:func:`sdf_mlp.apply_grid_remat`) when
    ``P * B > 2**18``."""
    if grid_points.device.type != "cpu":
        return apply_grid_trainable(params, grid_points, latents)
    n_points = grid_points.shape[0]
    if n_points * latents.shape[0] > 2**18:
        return sdf_mlp.apply_grid_remat(params, grid_points, latents,
                                        chunk_size=min(n_points, 16384))
    return sdf_mlp.apply_grid(params, grid_points, latents)


def _forward_dispatch(params: Params, grid_points: torch.Tensor,
                      latents: torch.Tensor) -> torch.Tensor:
    """A rank's forward-only evaluation: :func:`apply_grid_best` on CUDA (the
    grid kernel, or the points kernel for one latent), the float32 reference
    math on the CPU (the JAX package's ``apply_grid_best`` off a TPU)."""
    if grid_points.device.type != "cpu":
        return apply_grid_best(params, grid_points, latents)
    return sdf_mlp.apply_grid(params, grid_points, latents)


def apply_grid_sharded(params: Params, grid_points: torch.Tensor, latents: torch.Tensor, mesh,
                       trainable: bool = False) -> torch.Tensor:
    """The grid evaluation over a mesh of ranks (the JAX package's
    ``apply_grid_sharded``, shard_map's ``P(data, points)`` layout): this
    rank evaluates its rows of the global ``latents`` [B, L] (over
    ``data``) at its slice of ``grid_points`` [P, 3] (over ``points``) with
    the single-process dispatch, and gathers the slices over its points
    group: it returns its data rows ``[B / data, P]``.

    ``trainable`` differentiates it: the gradient of the gathered rows
    keeps this rank's point slice, the rank's backward runs locally (the
    grid backward kernel on CUDA), and the gradients of the parameters, the
    points and the latents are summed over the points group, as shard_map's
    transpose psums them. The mean over ``data`` is the trainer's
    (``Mesh.mean_over_data``), so no gradient is reduced twice."""
    global sharded_call_count
    sharded_call_count += 1
    if not mesh.member:
        raise ValueError(f"rank {mesh.rank} is outside {mesh}")
    rows = mesh.data_slice(latents.shape[0])
    cols = mesh.points_slice(grid_points.shape[0])
    if not trainable:
        with torch.no_grad():
            local = _forward_dispatch(params, grid_points[cols].contiguous(), latents[rows])
        return mesh.gather_points(local)
    grid_points, latents, *values = mesh.sum_grads_over_points(
        grid_points, latents, *(params[k] for k in PARAM_KEYS))
    local = _trainable_dispatch(dict(zip(PARAM_KEYS, values)), grid_points[cols].contiguous(),
                                latents[rows])
    return mesh.gather_points(local)


def points_value_and_gradient(params: Params, points: torch.Tensor, latent: torch.Tensor,
                              chunk_size: int = ROW_CAP):
    """SDF [N] and its gradient with respect to the points [N, 3] for one
    latent [L] (L may be 0 after ``fold_latent``), through
    :func:`apply_grid_trainable` (B1 forward, B2 backward on CUDA tensors)
    in chunks of at most ``chunk_size`` points. Each point's gradient
    depends on that point alone, so the chunks' results equal one call's.
    The parameters and the latent are held fixed."""
    if chunk_size > ROW_CAP:
        raise ValueError(f"chunk_size {chunk_size} exceeds the grid backward's chunk {ROW_CAP}")
    fixed = {k: v.detach() for k, v in params.items()}
    latents = latent.detach().reshape(1, -1)
    values, grads = [], []
    for chunk in points.detach().float().split(chunk_size):
        q = chunk.clone().requires_grad_(True)
        with torch.enable_grad():
            out = apply_grid_trainable(fixed, q, latents)[0]
            (grad,) = torch.autograd.grad(out.sum(), q)
        values.append(out.detach())
        grads.append(grad)
    if not values:
        return points.new_zeros((0,)), points.new_zeros((0, 3))
    return torch.cat(values), torch.cat(grads)


def rowwise_operands(params: Params, points: torch.Tensor, zz1: torch.Tensor, zz5: torch.Tensor):
    """The rowwise kernels' operands (pts, w1p, w5p, zz1, zz5, w, b, w8) for
    points [N, 3] and per-row latent terms zz1/zz5 [N, 256]."""
    return ((points.float().contiguous(), params["w1p"].to(BF16).contiguous(),
             params["w5p"].to(BF16).contiguous(), zz1.to(BF16).contiguous(),
             zz5.to(BF16).contiguous()) + trunk_operands(params))


# The parameters the rowwise kernels read; w1z, b1, w5z and b5 enter through
# zz1/zz5 and receive their gradients through them.
_ROWWISE_KEYS = tuple(k for k in PARAM_KEYS if k not in ("w1z", "b1", "w5z", "b5"))


class _RowwiseTrainable(torch.autograd.Function):
    """The rowwise kernel forward with the rowwise backward kernel as its
    gradient (the custom VJP of the JAX package's
    ``apply_rowwise_trainable``). Inputs: points [N, 3], zz1, zz5 [N, 256],
    then the parameters in ``_ROWWISE_KEYS`` order."""

    @staticmethod
    def forward(ctx, points, zz1, zz5, *values):
        ctx.save_for_backward(points, zz1, zz5, *values)
        params = dict(zip(_ROWWISE_KEYS, values))
        return rowwise_forward(*rowwise_operands(params, points, zz1, zz5))

    @staticmethod
    def backward(ctx, g):
        points, zz1, zz5, *values = ctx.saved_tensors
        params = dict(zip(_ROWWISE_KEYS, values))
        dzz1, dzz5, d_w, d_b, d_w8, d_b8 = rowwise_backward(
            *rowwise_operands(params, points, zz1, zz5), g.float().contiguous())
        # The closing products of _rowwise_bwd, in float32, on the float32 points.
        pts = points.float()
        d = {"w1p": pts.t() @ dzz1, "w5p": pts.t() @ dzz5, "w8": d_w8[:, None], "b8": d_b8}
        for layer, key in enumerate(TRUNK_KEYS):
            d[key] = d_w[layer]
            if layer != SKIP_LAYER:
                d["b" + key[1:]] = d_b[layer]
        d_points = None
        if ctx.needs_input_grad[0]:
            d_points = (dzz1 @ params["w1p"].float().t()
                        + dzz5 @ params["w5p"].float().t()).to(points.dtype)
        # The zz cotangents go back in the zz dtype (bf16), as in the JAX VJP.
        return (d_points, dzz1.to(zz1.dtype), dzz5.to(zz5.dtype),
                *(d[k].to(params[k].dtype) for k in _ROWWISE_KEYS))


def apply_rowwise_trainable(params: Params, points: torch.Tensor, zz1: torch.Tensor,
                            zz5: torch.Tensor) -> torch.Tensor:
    """Differentiable per-row evaluation: points [N, 3] with per-row latent
    terms zz1/zz5 [N, 256] → [N] float32: the rowwise kernel forward, the
    rowwise backward kernel for the gradients of the points, zz1/zz5 and the
    parameters they do not carry (w1z, b1, w5z and b5 get theirs through
    zz1/zz5)."""
    return _RowwiseTrainable.apply(points, zz1, zz5, *(params[k] for k in _ROWWISE_KEYS))


def apply_rowwise(params: Params, points: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """Points [N, 3] with per-point latents [N, L] → [N] float32 (the JAX
    package's ``apply_rowwise``): zz1/zz5 = z @ w1z/w5z + b1/b5 in bf16,
    then :func:`apply_rowwise_trainable`. Differentiable with respect to the
    parameters, the points and the latents (the autodecoder's gathered
    rows)."""
    return apply_rowwise_trainable(params, points, *latent_terms(params, latents))
