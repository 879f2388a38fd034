"""The raymarched frame in plain PyTorch, float32: what
``render.raymarching.render_image(net, code, resolution, ssaa=2)`` draws,
computed the plain way (marian42/shapegan ``rendering/raymarching.py``
as the JAX package renders it).

Camera at distance 2.2, yaw 147, pitch 20, light at 6, 164, 50; rays enter
the unit sphere analytically; sphere tracing steps by the SDF clamped to
+-0.02, a lane hits at 0 < sdf < 5e-4 and misses outside the sphere, and a
lane still active after the trace's iterations counts as a hit; normals
are the normalized gradient of the SDF; shadow rays start 0.1 towards the
light and trace 200 steps clamped to +-0.1 (hit below 1e-3, escape above
y = 1); diffuse, specular (power 20) and rim (power 4) shading, shadows on
the ground plane under the model; a Lanczos-3 downsample by ``ssaa``;
rounding to 8 bits.

Every iteration evaluates only the lanes still active, so the count of
evaluations is what the trace needs."""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import sdf_net
from benchmark.reference.precision import Precision

ACTIVE, HIT, MISS = 0, 1, 2


def _rotation(angle_degrees: float, axis: str) -> np.ndarray:
    t = math.radians(angle_degrees)
    c, s = math.cos(t), math.sin(t)
    m = np.identity(4)
    if axis == "x":
        m[1:3, 1:3] = [[c, -s], [s, c]]
    else:
        m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def camera_position(distance: float, yaw: float, pitch: float) -> np.ndarray:
    """World position of a camera at ``distance`` turned by ``yaw`` about y
    and ``pitch`` about x (float64)."""
    transform = np.identity(4)
    transform[2, 3] = -distance
    transform = transform @ _rotation(pitch, "x") @ _rotation(yaw, "y")
    return (np.linalg.inv(transform) @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]


def camera_rays(cam: np.ndarray, size: int, radius: float, device):
    """(entry points, unit directions, entered) of the size^2 pixel rays."""
    fwd = -cam / np.linalg.norm(cam)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    up /= np.linalg.norm(up)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    cam_t, right, up, fwd = f32(cam), f32(right), f32(up), f32(fwd)
    lin = torch.linspace(-1.0, 1.0, size, dtype=torch.float32, device=device)
    u, v = torch.meshgrid(lin, lin, indexing="xy")
    u, v = u.reshape(-1, 1), v.reshape(-1, 1)
    focal = 1.0 / torch.tan(torch.arcsin(radius / torch.linalg.norm(cam_t)))
    dirs = u * right[None] + v * up[None] + focal * fwd[None]
    dirs = dirs / torch.linalg.norm(dirs, dim=1, keepdim=True)
    b = 2.0 * (dirs * cam_t).sum(1)
    disc = b * b - 4.0 * ((cam_t * cam_t).sum() - radius * radius)
    entered = disc >= 0
    dist = torch.where(entered, (-b - torch.sqrt(disc.clamp_min(0.0))) / 2.0, 0.0)
    return cam_t[None] + dirs * dist[:, None], dirs, entered


def trace(evaluate: Callable[[torch.Tensor], torch.Tensor], points, dirs, status, *,
          iterations: int, threshold: float, step_clamp: float, shadow: bool,
          radius: float) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sphere-trace the ACTIVE lanes: (points, status, evaluations)."""
    points, status = points.clone(), status.clone()
    idx = torch.nonzero(status == ACTIVE).flatten()
    evaluations = 0
    for _ in range(iterations):
        if idx.numel() == 0:
            break
        p, d = points[idx], dirs[idx]
        sdf = evaluate(p).clamp(-step_clamp, step_clamp)
        evaluations += idx.numel()
        p = p + d * sdf[:, None]
        hit = (sdf > 0) & (sdf < threshold)
        outside = p[:, 1] > radius if shadow else (p * p).sum(1) > radius * radius
        new = torch.where(hit, HIT, torch.where(outside, MISS, ACTIVE)).to(status.dtype)
        points[idx], status[idx] = p, new
        idx = idx[new == ACTIVE]
    return points, status, evaluations


def lanczos3_downsample(image: torch.Tensor, factor: int) -> torch.Tensor:
    """Separable Lanczos-3 resample [H, W, 3] -> [H/f, W/f, 3], edges
    replicated, float32 with TF32 off."""
    s = factor
    c0 = 0.5 * s - 0.5
    lo, hi = int(math.ceil(c0 - 3 * s)), int(math.floor(c0 + 3 * s))
    x = (np.arange(lo, hi + 1) - c0) / s
    w = np.sinc(x) * np.sinc(x / 3.0)
    kern = torch.tensor((w / w.sum()).astype(np.float32), device=image.device)

    def along_rows(img):
        height, width, channels = img.shape
        t = F.pad(img.permute(1, 2, 0).reshape(1, width * channels, height),
                  (-lo, hi - (s - 1)), mode="replicate")
        weight = kern.expand(width * channels, 1, kern.shape[0]).contiguous()
        out = F.conv1d(t, weight, stride=s, groups=width * channels)
        return out.reshape(width, channels, -1).permute(2, 0, 1)

    return along_rows(along_rows(image).transpose(0, 1)).transpose(0, 1)


@torch.no_grad()
def render(params, code: torch.Tensor, frame: dict, precision: Precision = Precision.F32,
           block: int = 1 << 19) -> Tuple[np.ndarray, Dict[str, int]]:
    """The [res, res, 3] uint8 frame and what the check needs of it:
    the evaluations it needed (``trace``: primary and shadow steps;
    ``normals``: lanes whose gradient was taken) and ``interior`` [res, res],
    the pixels whose every sample hit the model, ``interior_margin`` pixels
    or more from its silhouette."""
    device = code.device
    zz1, zz5 = sdf_net.fold(params, code, precision)
    offset = frame["sdf_offset"]

    def evaluate(p):
        return torch.cat([sdf_net.rows(params, c, zz1, zz5, precision)
                          for c in p.split(block)]) + offset

    size = frame["resolution"] * frame["ssaa"]
    radius = frame["radius"]
    cam = camera_position(*frame["camera"])
    light = torch.as_tensor(camera_position(*frame["light"]), dtype=torch.float32, device=device)
    points, dirs, entered = camera_rays(cam, size, radius, device)
    status = torch.where(entered, ACTIVE, MISS).to(torch.int32)
    points, status, primary = trace(
        evaluate, points, dirs, status, iterations=frame["primary_iterations"],
        threshold=frame["threshold"], step_clamp=frame["primary_step_clamp"], shadow=False,
        radius=radius)
    model = (status == HIT) | (status == ACTIVE)

    normal = torch.zeros_like(points)
    idx = torch.nonzero(model).flatten()
    for chunk in idx.split(block):
        with torch.enable_grad():
            p = points[chunk].clone().requires_grad_(True)
            (g,) = torch.autograd.grad(evaluate(p).sum(), p)
        normal[chunk] = g / torch.linalg.norm(g, dim=1, keepdim=True).clamp_min(1e-12)

    ground_plane = torch.where(model, points[:, 1], math.inf).min()
    down = dirs[:, 1] < 0
    ground = down & ~model & model.any()
    t = (points[:, 1] - ground_plane) / torch.where(down, dirs[:, 1], -1.0)
    g_pts = points - dirs * t[:, None]
    ground &= torch.sqrt(g_pts[:, 0] ** 2 + g_pts[:, 2] ** 2) < 3
    mask = model | ground
    start = torch.where(model[:, None], points, torch.where(ground[:, None], g_pts, 2.0 + radius))
    to_light = light[None] - start
    to_light = to_light / torch.linalg.norm(to_light, dim=1, keepdim=True)
    _, shadow_status, shadow_steps = trace(
        evaluate, start + to_light * 0.1, to_light,
        torch.where(mask, ACTIVE, MISS).to(torch.int32),
        iterations=frame["shadow_iterations"], threshold=frame["shadow_threshold"],
        step_clamp=frame["shadow_step_clamp"], shadow=True, radius=radius)
    shadow = ((shadow_status == HIT) | (shadow_status == ACTIVE)).float()
    lit = 1.0 - shadow

    light_dir = light[None] - points
    light_dir = light_dir / torch.linalg.norm(light_dir, dim=1, keepdim=True)
    l_dot_n = (light_dir * normal).sum(1)
    diffuse = l_dot_n.clamp(0, 1) * lit
    reflect = light_dir - 2.0 * l_dot_n[:, None] * normal
    reflect = reflect / torch.linalg.norm(reflect, dim=1, keepdim=True).clamp_min(1e-12)
    specular = (reflect * dirs).sum(1).clamp(0, 1).pow(20) * lit
    rim = (1.0 - (-(normal * dirs).sum(1)).clamp(0, 1)).pow(4) * 0.3
    color = torch.tensor(frame["color"], dtype=torch.float32, device=device)
    shaded = color[None] * (diffuse * 0.5 + 0.5)[:, None] + (specular * 0.3 + rim)[:, None]
    pixels = torch.where(model[:, None], shaded.clamp(0, 1), 1.0)
    pixels = pixels - torch.where(ground, (1.0 - 0.65) * shadow, 0.0)[:, None]
    pixels = pixels.clamp(0.0, 1.0).reshape(size, size, 3)
    if frame["ssaa"] != 1:
        pixels = lanczos3_downsample(pixels, frame["ssaa"]).clamp(0.0, 1.0)
    out = torch.round(pixels * 255.0).to(torch.uint8).cpu().numpy()
    # The frame's pixels whose every sample is a model lane, less a margin:
    # the model's interior, away from its silhouette.
    s = frame["ssaa"]
    inside = model.reshape(size // s, s, size // s, s).all(dim=3).all(dim=1).float()
    margin = frame["interior_margin"]
    inside = -F.max_pool2d(-inside[None, None], 2 * margin + 1, stride=1, padding=margin)[0, 0]
    return out, {"trace": primary + shadow_steps, "normals": int(idx.numel()),
                 "interior": inside.bool().cpu().numpy()}
