"""The port's figure factory against the repo's root ``create_plot.py``:
the raymarched grids of the implicit models (the autodecoder's
interpolation, samples and snapshots, the hybrid GAN's samples and
interpolation), on the same files. Each cell's frame is held to the JAX
recipe's by ``test_torch_plot_env.assert_frames_close`` (the port's bf16
network against the JAX package's float32 one)."""

import os

import numpy as np
import pytest

import test_torch_plot_env as env
from test_torch_plot_env import in_plot_dir, jax_plot, plot_dir  # noqa: F401  (fixtures)


@pytest.mark.parametrize("recipe, args", [
    ("sdf_net_interpolation", []), ("sdf_net_sample", []), ("hybrid_gan", []),
    ("hybrid_gan_interpolation", ["0", "1"]), ("sdf_checkpoints", []),
])
def test_raymarched_grids_match_jax(recipe, args, jax_plot, monkeypatch):
    """Every cell's frame (crop at ssaa 1 keeps the crop box's size; the
    hybrid GAN's enlarged sphere, SDF offset and cut-off) against the JAX
    recipe's."""
    record = env.record_jax(monkeypatch, jax_plot)
    getattr(jax_plot, recipe)(list(args), env.jax_config(**env.FRAMES))
    grid = env.port_main(recipe, args, **env.FRAMES)
    want = record["grids"][0]
    assert sorted(grid.cells) == sorted(want.cells) and len(grid.cells) == 2
    for key, cell in grid.cells.items():
        env.assert_frames_close(cell["image"], want.cells[key]["image"])


def test_hybrid_gan_options_are_written(monkeypatch):
    """Without start and end indices the option frames are written first
    (at most 200 pixels), then the interpolation between options 0 and 1."""
    grid = env.port_main("hybrid_gan_interpolation", [], **env.FRAMES)
    for i in range(2):
        assert os.path.isfile(f"plots/option-{i}.png")
    np.testing.assert_allclose(grid.codes[0], np.random.default_rng(0).normal(size=(2, 128))[0],
                               rtol=1e-6)
