"""Sphere-traced raymarching against the implicit SDF network (counterpart of
:mod:`shapegan_tpu.render.raymarching`).

The same frame as the JAX package renders: a fixed camera (distance 2.2,
yaw 147°, pitch 20°) and light (distance 6, 164°, 50°), analytic ray entry
into the bounding sphere, sphere tracing with the step clamped to ±0.02,
surface normals from the gradient of the network, 200-step shadow rays,
diffuse / specular (power 20) / rim (power 4) shading, ground-plane shadows
and a Lanczos-3 SSAA downsample. The whole frame stays on the device; only
the final [res, res, 3] uint8 pixels are copied to the host (with ``crop``,
the SSAA-size frame, which the host crops and resizes with Pillow's
Lanczos written out).

The trace runs in stages (``_trace_staged``): masked iterations advance all
lanes (resolved lanes ride at zero step), and between stages the ACTIVE
lanes are compacted into a smaller bucket of a fixed size
(``_default_schedule``); the last stage runs until no lane is active,
capped at ``TAIL_ITERS`` for primary rays. Each iteration evaluates the
network through a hand-written kernel: with ``_FORCE_FUSED_TRACE`` on, the
trace kernel runs K iterations per launch
(:func:`~shapegan_tpu_torch.ops.sdf_mlp_kernels.trace_steps`); off, every
iteration is one points-kernel launch and a few element-wise operations.
The frame's latent code is folded into the biases first, so every
evaluation runs the latent-free network. On CPU tensors the kernels' plain
versions run instead.

A traced run sees the frame's four phases, each host test between trace
stages and the frame's copy to the host as spans (``sg.render.*``,
:mod:`shapegan_tpu_torch.tracing`); the counter ``render.lane_steps`` adds
the lanes times the iterations of every trace launch, ``render.host_waits``
each host test and each copy.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from shapegan_tpu_torch import tracing
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.render.camera import camera_position_from_transform, get_camera_transform
from shapegan_tpu_torch.render.png import read_png, write_png
from shapegan_tpu_torch.util import crop_image, resize_lanczos

# Compaction schedule constants (the JAX package's, measured there on the
# chair's live-lane decay: a plateau of surface oscillators after ~100
# iterations, whose positions have converged; the tail is capped).
STAGE_ITERS = 100  # traces with no more iterations than this run unstaged
TAIL_ITERS = 120
# The trace kernel (B4) instead of one points-kernel launch per iteration,
# for traces of at least FUSED_MIN_LANES lanes. Default from the H100
# measurement (PERF.md).
_FORCE_FUSED_TRACE = True
FUSED_MIN_LANES = 2048
# Iterations per trace-kernel launch in the early-exit tail (the JAX
# package's chunk), and iterations between the per-iteration path's
# any-active tests (each a host sync; extra iterations with no active lane
# change nothing).
FUSED_CHUNK = 20
ACTIVE_CHECK_EVERY = 10

_ACTIVE, _HIT, _MISS = K.TRACE_ACTIVE, K.TRACE_HIT, K.TRACE_MISS


def camera_rays(camera_position, size: int, radius: float = 1.0, basis=None):
    """Per-pixel camera rays and their analytic entry into the sphere of
    ``radius``: (points [n, 3] — the entry point, or the camera position
    where the ray misses — unit directions [n, 3], entered mask [n]).

    Numpy in, numpy out (the host-side capacity bound), or torch tensors in
    and out on the camera's device (the frame). ``basis`` optionally gives
    (right, up, forward); otherwise it is derived from the camera position."""
    if not isinstance(camera_position, torch.Tensor):
        return _camera_rays_np(np.asarray(camera_position), size, radius, basis)
    cam = camera_position
    if basis is None:
        fwd = -cam / torch.linalg.norm(cam)
        right = torch.linalg.cross(fwd, cam.new_tensor([0.0, 1.0, 0.0]))
        right = right / torch.linalg.norm(right)
        up = torch.linalg.cross(fwd, right)
        up = up / torch.linalg.norm(up)
    else:
        right, up, fwd = (torch.as_tensor(b, dtype=cam.dtype, device=cam.device) for b in basis)
    lin = torch.linspace(-1.0, 1.0, size, dtype=cam.dtype, device=cam.device)
    u, v = torch.meshgrid(lin, lin, indexing="xy")
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=1)
    focal = 1.0 / torch.tan(torch.arcsin(radius / torch.linalg.norm(cam)))
    directions = uv[:, 0:1] * right[None, :] + uv[:, 1:2] * up[None, :] + focal * fwd[None, :]
    directions = directions / torch.linalg.norm(directions, dim=1, keepdim=True)
    b = 2.0 * (directions * cam).sum(1)
    disc = b * b - 4.0 * ((cam * cam).sum() - radius * radius)
    entered = disc >= 0
    dist = torch.where(entered, (-b - torch.sqrt(disc.clamp_min(0.0))) / 2.0, 0.0)
    return cam[None, :] + directions * dist[:, None], directions, entered


def _camera_rays_np(cam, size, radius, basis):
    if basis is None:
        fwd = -cam / np.linalg.norm(cam)
        right = np.cross(fwd, np.asarray([0.0, 1.0, 0.0], dtype=cam.dtype))
        right = right / np.linalg.norm(right)
        up = np.cross(fwd, right)
        up = up / np.linalg.norm(up)
    else:
        right, up, fwd = (np.asarray(b) for b in basis)
    lin = np.linspace(-1.0, 1.0, size, dtype=cam.dtype)
    u, v = np.meshgrid(lin, lin)
    uv = np.stack([u.reshape(-1), v.reshape(-1)], axis=1)
    focal = 1.0 / np.tan(np.arcsin(radius / np.linalg.norm(cam)))
    directions = uv[:, 0:1] * right[None, :] + uv[:, 1:2] * up[None, :] + focal * fwd[None, :]
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    b = 2.0 * (directions @ cam)
    disc = b * b - 4.0 * (cam @ cam - radius * radius)
    entered = disc >= 0
    dist = np.where(entered, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0, 0.0)
    return cam[None, :] + directions * dist[:, None], directions, entered


def get_default_coordinates():
    camera_position = camera_position_from_transform(get_camera_transform(2.2, 147, 20))
    light_position = camera_position_from_transform(get_camera_transform(6, 164, 50))
    return camera_position, light_position


CAMERA_POSITION, LIGHT_POSITION = get_default_coordinates()


def _any_active(status: torch.Tensor) -> bool:
    """Whether a lane is still active: a host test that waits for the
    device (``sg.render.host_wait``, counted in ``render.host_waits``)."""
    tracing.count("render.host_waits")
    with tracing.span("sg.render.host_wait"):
        return bool((status == _ACTIVE).any())


@torch.no_grad()
def _trace_staged(kind, params, latent, points, directions, status, budget, threshold,
                  step_clamp, sdf_offset, radius, schedule, tail_cap=None, escape=None):
    """Trace rays to completion (no autograd: the trace is not differentiable). ``schedule`` is a tuple of (iterations,
    bucket_size): after each stage's masked iterations the surviving ACTIVE
    lanes are compacted into a ``bucket_size`` bucket; the final stage runs
    until no lane is active or the budget (capped at ``tail_cap`` when
    given) is spent. Returns (points, status).

    kind: 'primary' rays miss outside the bounding sphere; 'shadow' rays
    miss above y = radius, or above the per-lane height ``escape`` [n]."""
    if latent.shape[0]:
        params = sdf_mlp.fold_latent(params, latent)
        latent = latent[:0]
    weights = K.point_weights(params, latent)
    trace_kw = dict(shadow=kind == "shadow", threshold=threshold, step_clamp=step_clamp,
                    sdf_offset=sdf_offset, radius=radius)
    return _run_stages(weights, trace_kw, points, directions, status, budget, schedule,
                       tail_cap, escape if kind == "shadow" else None)


def _run_stages(weights, trace_kw, points, dirs, status, budget, schedule, tail_cap, escape):
    fused = _FORCE_FUSED_TRACE and points.shape[0] >= FUSED_MIN_LANES

    def step(points, status):  # one iteration through the points kernel
        tracing.count("render.lane_steps", points.shape[0])
        sdf = K.points_forward(points, *weights)
        return K.trace_update(points, dirs, status, sdf, escape=escape, **trace_kw)

    def fused_steps(k, points, status):
        tracing.count("render.lane_steps", points.shape[0] * k)
        return K.trace_steps(points, dirs, status, escape, *weights, k=k, **trace_kw)

    def run_fori(k, points, status):
        if fused and k:
            return fused_steps(k, points, status)
        for i in range(k):
            if i % ACTIVE_CHECK_EVERY == 0 and not _any_active(status):
                break
            points, status = step(points, status)
        return points, status

    def run_while(b, points, status):
        if not fused:
            return run_fori(b, points, status)
        # Early exit at chunk granularity, then the remainder.
        for _ in range(b // FUSED_CHUNK):
            if not _any_active(status):
                break
            points, status = fused_steps(FUSED_CHUNK, points, status)
        if b % FUSED_CHUNK:
            points, status = fused_steps(b % FUSED_CHUNK, points, status)
        return points, status

    if budget <= 0:
        return points, status
    if not schedule:
        if tail_cap is not None:
            budget = min(budget, tail_cap)
        return run_while(budget, points, status)

    (k, size), rest = schedule[0], schedule[1:]
    k = min(k, budget)
    points, status = run_fori(k, points, status)
    budget -= k
    if budget <= 0:
        return points, status

    n = points.shape[0]
    size = max(512, min(size, n))
    if size >= n:
        return _run_stages(weights, trace_kw, points, dirs, status, budget, rest, tail_cap, escape)

    # Compact the first `size` ACTIVE lanes, in ascending order, into the
    # bucket. Overflow lanes keep riding as ACTIVE in the source and come
    # out as hits, like budget exhaustion. Fill lanes start as MISS at the
    # origin with a zero direction, so they never move.
    tracing.count("render.host_waits")
    with tracing.span("sg.render.host_wait"):  # nonzero's count waits for the device
        idx = torch.nonzero(status == _ACTIVE).flatten()[:size]
    count = idx.shape[0]

    def take(x):
        out = x.new_zeros((size,) + tuple(x.shape[1:]))
        out[:count] = x[idx]
        return out

    status_c = torch.full((size,), _MISS, dtype=torch.int32, device=status.device)
    status_c[:count] = _ACTIVE
    pts_c, status_c = _run_stages(weights, trace_kw, take(points), take(dirs), status_c, budget,
                                  rest, tail_cap, None if escape is None else take(escape))
    # The scatter back drops the fill lanes.
    return (points.index_copy(0, idx, pts_c[:count]),
            status.index_copy(0, idx, status_c[:count]))


def _default_schedule(kind, n, iterations):
    """The JAX package's compaction schedules: buckets with headroom over
    the chair's measured active fractions (overflow degrades conservatively
    to a hit at the current point); the primary's first bucket is exact for
    the camera geometry (lanes that never enter the sphere)."""
    if n <= 2048 or iterations <= STAGE_ITERS:
        return ()
    if kind == "shadow":
        return ((40, -(-n // 4)),)
    return (
        (0, -(-n * 4 // 5)),
        (60, -(-n // 2)),
        (40, -(-n // 5)),
    )


def _trace_rays(kind, params, latent, points, directions, iterations, threshold, step_clamp,
                sdf_offset, radius):
    """Staged trace over explicit rays (all start ACTIVE)."""
    status = torch.zeros(points.shape[0], dtype=torch.int32, device=points.device)
    schedule = _default_schedule(kind, points.shape[0], iterations)
    # The tail cap is measured (and justified) for the primary trace only;
    # shadow traces keep their full budget.
    return _trace_staged(
        kind, params, latent, points, directions, status, iterations, threshold, step_clamp,
        sdf_offset, radius, schedule,
        tail_cap=TAIL_ITERS if schedule and kind == "primary" else None)


def _bucketed_trace(kind, params, latent, points, directions, iterations, threshold, step_clamp,
                    sdf_offset, radius):
    """Trace numpy rays on the parameters' device, padded to a power-of-two
    bucket as the JAX package pads them (so the same schedules engage).
    Returns numpy (points, hit); rays still active after the budget count
    as hits."""
    device = params["w2"].device
    n = points.shape[0]
    bucket = 1 << max(7, (n - 1).bit_length())
    pad = bucket - n
    pts = np.concatenate([np.asarray(points, np.float32),
                          np.full((pad, 3), 2.0 * radius + 1.0, np.float32)])
    dirs = np.concatenate([np.asarray(directions, np.float32), np.zeros((pad, 3), np.float32)])
    traced, status = _trace_rays(
        kind, params, torch.as_tensor(np.asarray(latent, np.float32), device=device),
        torch.tensor(pts, device=device), torch.tensor(dirs, device=device), iterations,
        threshold, step_clamp, sdf_offset, radius)
    traced = traced[:n].cpu().numpy()
    status = status[:n].cpu().numpy()
    return traced, (status == _HIT) | (status == _ACTIVE)


def _points_gradient(params, points, latent):
    """∇_p SDF(p, z) for every point: B1 forward and B2 backward on CUDA
    tensors, in chunks (ops.sdf_mlp_kernels.points_value_and_gradient)."""
    return K.points_value_and_gradient(params, points, latent)[1]


def get_normals(net, latent_code, points, batch_size: int = K.ROW_CAP) -> np.ndarray:
    """Unit surface normals [n, 3] (numpy) of ``points`` for one latent code,
    the gradient taken in chunks of at most ``batch_size`` points."""
    return net.get_normals(latent_code, points, chunk_size=batch_size).cpu().numpy()


def get_shadows(net, latent_code, points, light_position, threshold: float = 0.001,
                sdf_offset: float = 0.0, radius: float = 1.0) -> np.ndarray:
    """1.0 where a 200-step ray from ``points`` toward the light re-hits the
    shape (numpy in and out)."""
    if points.shape[0] == 0:
        return np.zeros(0, dtype=np.float32)
    code = torch.as_tensor(np.asarray(latent_code, np.float32), device=net.device)
    params = sdf_mlp.fold_latent(net.param_dict(), code)
    directions = light_position[None, :] - points
    directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
    start = points + directions * 0.1
    _, hit = _bucketed_trace("shadow", params, np.zeros(0, np.float32), start, directions,
                             iterations=200, threshold=threshold, step_clamp=0.1,
                             sdf_offset=sdf_offset, radius=radius)
    return hit.astype(np.float32)


def _shadow_mask_capacity(camera_position, size, radius=1.0):
    """Upper bound on the shadow mask (model hits ∪ ground lanes) of a
    frame: lanes that enter the bounding sphere plus lanes that point below
    the horizontal. It depends on (camera, size, radius) alone, so the
    shadow pass's first bucket never overflows, for any shape."""
    cam = np.asarray(camera_position, np.float64)
    return _shadow_mask_capacity_cached(tuple(cam.tolist()), int(size), float(radius))


@functools.lru_cache(maxsize=64)
def _shadow_mask_capacity_cached(camera_position, size, radius):
    cam = np.asarray(camera_position, np.float64)
    _, dirs, entered = camera_rays(cam, size, radius=radius)
    count = int(np.count_nonzero(entered | (dirs[:, 1] < 0)))
    # The frame computes the mask in float32; rays on the silhouette or the
    # horizon may classify differently there than in this float64 count, so
    # 512 lanes of slack before rounding up.
    return min(-(-(count + 512) // 512) * 512, size * size)


def _shadow_factor(params, latent, points, mask, light_position, threshold, sdf_offset, radius,
                   first_bucket=None, escape=None):
    """Shadow test of the masked lanes: 1.0 where the 200-step ray toward
    the light re-hits the shape or is still active. ``escape`` [n] gives
    each lane its own escape height (model lanes the caller's radius, ground
    lanes 1.0); the masked lanes are compacted into a bucket of the
    geometric capacity ``first_bucket`` before any tracing."""
    n = points.shape[0]
    directions = light_position[None, :] - points
    directions = directions / torch.linalg.norm(directions, dim=1, keepdim=True)
    start = points + directions * 0.1
    status = torch.where(mask, _ACTIVE, _MISS).to(torch.int32)
    cap = n if first_bucket is None else min(first_bucket, n)
    schedule = () if n <= 2048 else (
        (0, cap),
        (20, -(-cap * 7 // 10)),
        (10, -(-n // 16)),
        (10, -(-n // 64)),
    )
    _, status = _trace_staged("shadow", params, latent, start, directions, status, 200,
                              threshold, 0.1, sdf_offset, radius, schedule, tail_cap=None,
                              escape=escape)
    return ((status == _HIT) | (status == _ACTIVE)).float()


def _lanczos3_downsample(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Separable Lanczos-3 resample [H, W, 3] → [H/factor, W/factor, 3] for
    an integer ``factor``: every output pixel sees the same stencil, so it
    is two strided depthwise ``conv1d`` passes, borders edge-replicated. On
    the card the convolutions run with TF32 off (float32, as on the CPU)."""
    s = factor
    c0 = 0.5 * s - 0.5  # source-space center of output pixel 0
    lo = int(math.ceil(c0 - 3 * s))
    hi = int(math.floor(c0 + 3 * s))
    x = (np.arange(lo, hi + 1) - c0) / s
    w = np.sinc(x) * np.sinc(x / 3.0)
    kern = torch.tensor((w / w.sum()).astype(np.float32), device=image.device)
    pad = (-lo, hi - (s - 1))

    def along_rows(img):  # [H, W, 3] -> [H/s, W, 3]
        height, width, channels = img.shape
        t = img.permute(1, 2, 0).reshape(1, width * channels, height)
        t = F.pad(t, pad, mode="replicate")
        weight = kern.expand(width * channels, 1, kern.shape[0]).contiguous()
        out = F.conv1d(t, weight, stride=s, groups=width * channels)
        return out.reshape(width, channels, -1).permute(2, 0, 1)

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        image = along_rows(image)
        return along_rows(image.transpose(0, 1)).transpose(0, 1)


def _render_pixels(params, latent, camera_position, camera_right, camera_up, camera_forward,
                   light_position, *, size, iterations, threshold, sdf_offset, radius,
                   vertical_cutoff, color, ssaa=1, shadow_bucket=None,
                   on_phase: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """One frame on the parameters' device: [size/ssaa, size/ssaa, 3] uint8.
    ``on_phase(name)``, when given, is called as each phase ends (primary
    trace, normals, shadow trace, shading) — the profiler's hook. Each
    phase is also the span ``sg.render.<phase>``."""
    on_phase = on_phase or (lambda name: None)
    with tracing.span("sg.render.primary_trace"):
        # One fixed code for the whole frame: fold it into the biases so
        # every evaluation runs the latent-free network.
        params = sdf_mlp.fold_latent(params, latent)
        latent = latent[:0]
        n = size * size

        points, ray_directions, entered = camera_rays(
            camera_position, size, radius=radius,
            basis=(camera_right, camera_up, camera_forward))

        # Primary trace: lanes that never enter the sphere start as misses.
        status = torch.where(entered, _ACTIVE, _MISS).to(torch.int32)
        primary_schedule = _default_schedule("primary", n, iterations)
        points, status = _trace_staged(
            "primary", params, latent, points, ray_directions, status, iterations, threshold,
            0.02, sdf_offset, radius, primary_schedule,
            tail_cap=TAIL_ITERS if primary_schedule else None)
        model_mask = (status == _HIT) | (status == _ACTIVE)
        if vertical_cutoff is not None:
            model_mask &= points[:, 1].abs() <= vertical_cutoff
        any_hit = model_mask.any()
    on_phase("primary trace")

    with tracing.span("sg.render.normals"):
        # Surface normals for every lane, masked at their uses.
        normal = _points_gradient(params, points, latent)
        normal = normal / torch.linalg.norm(normal, dim=1, keepdim=True).clamp_min(1e-12)
    on_phase("normals")

    with tracing.span("sg.render.shadow_trace"):
        # Ground-plane points under the model; model-surface and ground
        # shadow rays run as one trace (the lane sets are disjoint), with
        # per-lane escape heights when the caller's radius is not 1.0.
        ground_plane = torch.where(model_mask, points[:, 1], math.inf).min()
        down = ray_directions[:, 1] < 0
        ground = down & ~model_mask & any_hit
        t = (points[:, 1] - ground_plane) / torch.where(down, ray_directions[:, 1], -1.0)
        g_pts = points - ray_directions * t[:, None]
        ground &= torch.sqrt(g_pts[:, 0] ** 2 + g_pts[:, 2] ** 2) < 3

        shadow_mask = model_mask | ground
        shadow_points = torch.where(model_mask[:, None], points,
                                    torch.where(ground[:, None], g_pts, 2.0 + radius))
        shadow_escape = None if radius == 1.0 else torch.where(model_mask, float(radius), 1.0)
        shadow = _shadow_factor(params, latent, shadow_points, shadow_mask, light_position,
                                0.001, sdf_offset, radius, first_bucket=shadow_bucket,
                                escape=shadow_escape)
    on_phase("shadow trace")

    with tracing.span("sg.render.shading"):
        seen_by_light = 1.0 - shadow

        light_direction = light_position[None, :] - points
        light_direction = light_direction / torch.linalg.norm(light_direction, dim=1,
                                                              keepdim=True)
        l_dot_n = (light_direction * normal).sum(1)
        diffuse = l_dot_n.clamp(0, 1) * seen_by_light
        reflect = light_direction - 2.0 * l_dot_n[:, None] * normal
        reflect = reflect / torch.linalg.norm(reflect, dim=1, keepdim=True).clamp_min(1e-12)
        specular = (reflect * ray_directions).sum(1).clamp(0, 1)
        specular = specular.pow(20) * seen_by_light
        rim = 1.0 - (-(normal * ray_directions).sum(1)).clamp(0, 1)
        rim = rim.pow(4) * 0.3

        shaded = torch.tensor(color, dtype=torch.float32, device=points.device)[None, :] \
            * (diffuse * 0.5 + 0.5)[:, None]
        shaded = shaded + (specular * 0.3 + rim)[:, None]
        pixels = torch.where(model_mask[:, None], shaded.clamp(0, 1), 1.0)
        pixels = pixels - torch.where(ground, (1.0 - 0.65) * shadow, 0.0)[:, None]

        pixels = pixels.clamp(0.0, 1.0).reshape(size, size, 3)
        if ssaa != 1:
            pixels = _lanczos3_downsample(pixels, ssaa).clamp(0.0, 1.0)
        pixels = torch.round(pixels * 255.0).to(torch.uint8)
    on_phase("shading and downsample")
    return pixels


def crop_frame(pixels: np.ndarray, resolution: int, ssaa: int) -> np.ndarray:
    """``render_image``'s crop of a uint8 frame rendered at ``resolution *
    ssaa`` without the SSAA downsample: the square around the content
    (:func:`shapegan_tpu_torch.util.crop_image` on the frame in [0, 1],
    background 1; only a box wider than 200 pixels crops), back to uint8,
    then with ``ssaa != 1`` resized to ``resolution``^2 by Pillow's Lanczos
    (:func:`shapegan_tpu_torch.util.resize_lanczos`); with ``ssaa == 1``
    the cropped size is kept."""
    pixels = np.uint8(np.round(crop_image(pixels / 255.0, background=1) * 255.0))
    if ssaa != 1:
        pixels = resize_lanczos(pixels, resolution)
    return pixels


def render_image(net, latent_code, resolution: int = 800, threshold: float = 0.0005,
                 sdf_offset: float = 0.0, iterations: int = 1000, ssaa: int = 2,
                 radius: float = 1.0, crop: bool = False, color=(0.8, 0.1, 0.1),
                 vertical_cutoff=None, on_phase=None) -> np.ndarray:
    """Render one latent code of ``net`` (an ``SDFNet``) on its device:
    returns the [resolution, resolution, 3] uint8 frame as a numpy array.
    With ``crop`` the frame is rendered at ``resolution * ssaa`` without
    the device's downsample and goes through :func:`crop_frame` on the
    host (with ``ssaa == 1`` it keeps the crop box's size).
    ``on_phase`` is :func:`_render_pixels`' profiling hook."""
    device = net.device
    camera_position = CAMERA_POSITION
    camera_forward = -camera_position / np.linalg.norm(camera_position)
    camera_right = np.cross(camera_forward, np.array([0.0, 1.0, 0.0]))
    camera_right /= np.linalg.norm(camera_right)
    camera_up = np.cross(camera_forward, camera_right)
    camera_up /= np.linalg.norm(camera_up)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    size = resolution * ssaa
    # The crop is taken on the SSAA-size frame and only then resized, so
    # with crop the device's downsample is skipped.
    device_ssaa = 1 if crop else ssaa
    with torch.no_grad():
        pixels = _render_pixels(
            net.param_dict(), f32(latent_code), f32(camera_position), f32(camera_right),
            f32(camera_up), f32(camera_forward), f32(LIGHT_POSITION), size=size,
            iterations=iterations, threshold=threshold, sdf_offset=sdf_offset, radius=radius,
            vertical_cutoff=vertical_cutoff, color=tuple(color), ssaa=device_ssaa,
            shadow_bucket=_shadow_mask_capacity(camera_position, size, radius),
            on_phase=on_phase)
    tracing.count("render.host_waits")
    with tracing.span("sg.render.to_host"):
        pixels = pixels.cpu().numpy()
    return crop_frame(pixels, resolution, ssaa) if crop else pixels


def _render_devices(net, devices) -> list:
    """The devices of :func:`render_image_sequence`: the given ones (``cpu``
    for the CPU), by default every local CUDA device when the network lies
    on one, else the network's device."""
    if devices is None:
        if net.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [net.device]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def render_image_sequence(net, latent_codes: Sequence, devices=None,
                          on_frame: Optional[Callable] = None,
                          keep_results: Optional[bool] = None, **render_kw):
    """Render many latent codes, one worker thread a device (the JAX
    package's ``render_image_sequence``): each worker holds its own copy of
    the network on its device and renders the codes ``d::n`` of the ``n``
    devices in turn (a device may be named twice: two workers then share
    it). With one device, or one code, the frames are rendered in turn on
    that device, the network's own when it lies there.
    ``on_frame(index, image)``, when given, fires as each frame completes,
    from the workers, possibly out of order; frames are then not kept
    unless ``keep_results=True``. Returns the frames in code order, or None
    in that streaming mode. ``devices``: a list of devices, ``cpu``, or by
    default every local CUDA device when the network lies on one."""
    import concurrent.futures
    import contextlib

    from shapegan_tpu_torch.models.sdf_net import SDFNet

    if keep_results is None:
        keep_results = on_frame is None
    codes = list(latent_codes)
    devices = _render_devices(net, devices)
    results = [None] * len(codes) if keep_results else None

    def on_device(device: torch.device):
        if device == net.device:
            return net
        return SDFNet({k: v.detach().to(device) for k, v in net.param_dict().items()})

    def drive(worker: int, worker_net) -> None:
        device = devices[worker]
        ctx = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        with ctx:
            for i in range(worker, len(codes), len(devices)):
                image = render_image(worker_net, codes[i], **render_kw)
                if keep_results:
                    results[i] = image
                if on_frame is not None:
                    on_frame(i, image)

    if len(devices) <= 1 or len(codes) <= 1:
        devices = devices[:1]
        drive(0, on_device(devices[0]))
        return results
    nets = [SDFNet({k: v.detach().to(d, copy=True) for k, v in net.param_dict().items()})
            for d in devices]
    with concurrent.futures.ThreadPoolExecutor(len(devices)) as pool:
        # list() raises the first worker's exception.
        list(pool.map(drive, range(len(devices)), nets))
    return results


def render_image_for_index(net, latent_codes, index: int, crop: bool = False,
                           resolution: int = 800) -> np.ndarray:
    """Render one code of a table, cached on disk as
    ``screenshots/raymarching-examples/image-<index>-<resolution>.png``."""
    directory = os.path.join("screenshots", "raymarching-examples")
    os.makedirs(directory, exist_ok=True)
    filename = os.path.join(directory, f"image-{index}-{resolution}.png")
    if os.path.isfile(filename):
        return read_png(filename)
    image = render_image(net, latent_codes[index], resolution=resolution, crop=crop)
    write_png(filename, image)
    return image
