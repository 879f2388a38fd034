"""The chair that the raymarched cell renders: a frozen copy of
``shapegan_tpu_torch.examples.example_chair_sdf`` / ``chair_samples`` /
``fit_chair`` in torch on the device, drawn from the seed.

The analytic chair (seat, backrest, four legs) scaled by 0.9 into the
unit sphere; samples half uniform in the unit ball, half within 0.05 of
the surface; a full-width DeepSDF network with a fixed latent code fitted
to the clipped SDF by Adam in float32 with TF32 off. The fitted weights
stand in for trained DeepSDF weights, which the repository does not hold,
and are handed alike to the program and to the reference."""

from __future__ import annotations

import torch

from benchmark.inputs import weights
from benchmark.reference import sdf_net

CHAIR_SCALE = 0.9
BOXES = (  # (half extents, center) in the chair's own frame
    ((0.45, 0.05, 0.45), (0.0, -0.1, 0.0)),     # seat
    ((0.45, 0.45, 0.06), (0.0, 0.3, -0.39)),    # back
    ((0.05, 0.35, 0.05), (-0.38, -0.5, -0.38)),
    ((0.05, 0.35, 0.05), (-0.38, -0.5, 0.38)),
    ((0.05, 0.35, 0.05), (0.38, -0.5, -0.38)),
    ((0.05, 0.35, 0.05), (0.38, -0.5, 0.38)),
)


def chair_sdf(points: torch.Tensor) -> torch.Tensor:
    """SDF of the scaled chair at points [N, 3]."""
    p = points / CHAIR_SCALE
    out = None
    for half, center in BOXES:
        d = (p - p.new_tensor(center)).abs() - p.new_tensor(half)
        box = torch.sqrt((d.clamp_min(0.0) ** 2).sum(-1)) + d.max(-1).values.clamp_max(0.0)
        out = box if out is None else torch.minimum(out, box)
    return out * CHAIR_SCALE


def _ball(n: int, generator: torch.Generator, device) -> torch.Tensor:
    direction = torch.randn((n, 3), generator=generator, device=device)
    direction = direction / torch.linalg.norm(direction, dim=1, keepdim=True).clamp_min(1e-12)
    return direction * torch.rand((n, 1), generator=generator, device=device) ** (1.0 / 3.0)


def samples(count: int, clip: float, generator: torch.Generator, device):
    """(points [count, 3], clipped SDF [count]): half uniform in the unit
    ball, half within 0.05 of the surface, by rejection from the ball."""
    uniform = _ball(count // 2, generator, device)
    near, found = [], 0
    while found < count - count // 2:
        candidates = _ball(1 << 20, generator, device)
        keep = candidates[chair_sdf(candidates).abs() < 0.05]
        near.append(keep)
        found += keep.shape[0]
    points = torch.cat([uniform] + near)[:count].contiguous()
    return points, chair_sdf(points).clamp(-clip, clip)


def fit(config: dict, generator: torch.Generator, device):
    """(params, code): the network fitted as ``config['fit']`` says, float32
    on ``device``."""
    fit_cfg = config["fit"]
    width, latent = config["width"], config["latent_size"]
    params = weights.draw(weights.sdf_net_spec(width, latent), generator, device)
    code = torch.randn((latent,), generator=generator, device=device) * fit_cfg["code_std"]
    points, target = samples(fit_cfg["samples"], config["sdf_clipping"], generator, device)
    leaves = [p.requires_grad_(True) for p in params.values()]
    optimizer = torch.optim.Adam(leaves, lr=fit_cfg["learning_rate"])
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for _ in range(fit_cfg["steps"]):
            idx = torch.randint(points.shape[0], (fit_cfg["batch_size"],), generator=generator,
                                device=device)
            zz1, zz5 = sdf_net.latent_terms(params, code[None])
            out = sdf_net.rows(params, points[idx], zz1, zz5)
            loss = (out - target[idx]).abs().mean()
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    return {k: v.detach() for k, v in params.items()}, code
