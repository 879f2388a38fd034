"""The references agree with the program's CPU path at small sizes: the
float32 MLP and critic with the program's float32 modules, the frame with
``render_image``'s plain versions; and a whole run of each cell on the CPU
compares within the program's bf16 rounding."""

import numpy as np
import pytest
import torch

from benchmark import seeds
from benchmark.inputs import shapes, weights
from benchmark.reference import critic as C
from benchmark.reference import raymarch, sdf_net
from benchmark.tests import tiny

CRITIC = {"feature_counts": [128, 64, 32, 1], "final_features": 256, "head_features": 128, "kernel": 4}


def _weights(seed):
    gen = torch.Generator().manual_seed(seed)
    return (weights.draw(weights.sdf_net_spec(256, 128), gen, "cpu"),
            weights.draw(weights.critic_spec(**CRITIC), gen, "cpu"))


def test_sdf_net_matches_the_programs_float32_math():
    from shapegan_tpu_torch.ops import sdf_mlp

    g, _ = _weights(1)
    points = shapes.voxel_grid(8, "cpu")
    latents = torch.randn((3, 128), generator=torch.Generator().manual_seed(2))
    ref = sdf_net.grid(g, points, latents, block=100)
    got = sdf_mlp.apply_grid(g, points, latents)
    assert torch.allclose(ref, got, atol=2e-6, rtol=0)


@pytest.mark.parametrize("iteration", [0, 3])
def test_critic_and_penalty_match_the_programs(iteration):
    from shapegan_tpu_torch.models.progressive_gan import ProgressiveDiscriminator
    from shapegan_tpu_torch.ops.losses import gradient_penalty

    _, d = _weights(3)
    program = ProgressiveDiscriminator()
    program.load_state_dict(d)
    res = 8 * 2 ** iteration
    gen = torch.Generator().manual_seed(4)
    real = torch.rand((2, res, res, res), generator=gen) * 0.2 - 0.1
    fake = torch.rand((2, res, res, res), generator=gen) * 0.2 - 0.1
    alpha = torch.rand((2, 1, 1, 1), generator=gen)
    assert torch.allclose(C.critic(d, real, iteration), program(real, iteration, 1.0), atol=1e-6)
    ref = C.gradient_penalty(lambda x: C.critic(d, x, iteration), alpha, real, fake, 10.0)
    got = gradient_penalty(lambda x: program(x, iteration, 1.0), alpha, real, fake, weight=10.0)
    assert torch.allclose(ref, got, rtol=1e-5)


def test_frame_matches_render_image_on_the_cpu():
    from shapegan_tpu_torch.examples import octahedron_params
    from shapegan_tpu_torch.models.sdf_net import SDFNet
    from shapegan_tpu_torch.render.raymarching import render_image

    params = {k: torch.tensor(v) for k, v in octahedron_params().items()}
    code = torch.zeros(128)
    cell = tiny.cell("deepsdf_chair.raymarch")
    frame = dict(cell.traffic["frame"], camera=cell.config["camera"], light=cell.config["light"])
    ref, needed = raymarch.render(params, code, frame)
    got = render_image(SDFNet(params), code, resolution=frame["resolution"], ssaa=frame["ssaa"],
                       iterations=frame["iterations"])
    assert ref.shape == got.shape == (16, 16, 3)
    assert (ref != 255).any(), "the octahedron is in the frame"
    gap = np.abs(ref.astype(int) - got.astype(int))
    assert gap.mean() < 1.0 and needed["trace"] > 0 and needed["normals"] > 0


def test_seeds_are_distinct_and_whole():
    assert seeds.derive(2**31 + 11, "a") != seeds.derive(2**31 + 11, "b")
    assert 0 <= seeds.derive(-5, "a") < 2**62 and 0 <= seeds.derive(2**70, "a") < 2**62
