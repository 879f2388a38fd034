"""The port's figure factory against the repo's root ``create_plot.py``:
the recipes that draw through ``ImageGrid`` (the (V)AE and class-colour
grids, the voxel GAN's figures) on the same files. Each cell's volume is
held at its network's tolerance and its rendered image against the JAX
viewer's software route; the GAN recipes get the JAX recipes' latents
(``jax.random.normal(PRNGKey(k))``) through the port's ``_gan_latents``."""

import jax
import numpy as np
import pytest

import test_torch_plot_env as env
from test_torch_plot_env import in_plot_dir, jax_plot, plot_dir  # noqa: F401  (fixtures)
from shapegan_tpu_torch import create_plot

# Autoencoder volumes against the largest entry, float32 both sides
# (tests/test_torch_demos.py's AE_REL).
AE_REL = 1e-4
# Generator volumes (tanh), float32 both sides (tests/test_torch_demos.py's
# GEN_ATOL).
GEN_ATOL = 1e-4


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture
def jax_latents(monkeypatch):
    """The port's GAN latents replaced by the JAX recipes' draws."""
    monkeypatch.setattr(create_plot, "_gan_latents", lambda count, seed: np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), (count, 128))))


def test_autoencoder_interpolation_cells_match_jax(jax_plot, monkeypatch):
    """Both rows' decoded volumes (AE and VAE) at the AE tolerance and each
    rendered cell against the JAX viewer's; the written PNG holds each
    cell's image fitted into its cell."""
    from shapegan_tpu_torch.render.figure import fit_image
    from shapegan_tpu_torch.render.png import read_png

    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.autoencoder_interpolation([], env.jax_config())
    grid = env.port_main("autoencoder_interpolation", [])
    want = record["grids"][0]
    assert sorted(grid.cells) == sorted(want.cells) and len(grid.cells) == 4
    for key, cell in grid.cells.items():
        assert _rel(cell["volume"], want.cells[key]["volume"]) <= AE_REL
        env.assert_renders_close(cell["image"], want.cells[key]["image"])
    written = read_png("plots/ae-vae-interpolation.png")
    ox, oy = grid.figure.offset
    for (x, y), cell in grid.cells.items():
        c0, r0, c1, r1 = (int(round(v)) for v in grid.axes[y, x].frame)
        placed = written[r0 - oy:r1 - oy, c0 - ox:c1 - ox]
        np.testing.assert_array_equal(placed, fit_image(cell["image"], c1 - c0, r1 - r0))




@pytest.mark.parametrize("recipe", ["autoencoder_examples_2", "autoencoder_interpolation_2",
                                    "vae_checkpoints", "autoencoder_classes", "color_test"])
def test_voxel_grid_recipes_match_jax(recipe, jax_plot, monkeypatch):
    """Every cell of the (V)AE grids and the class-colour grid: the volume
    each shows at the AE tolerance (the synthetic classes exactly), its
    rendered image against the JAX viewer's."""
    record = env.record_jax(monkeypatch, jax_plot)
    getattr(jax_plot, recipe)([], env.jax_config())
    grid = env.port_main(recipe)
    want = record["grids"][0]
    assert (grid.width, grid.height) == (want.width, want.height)
    assert sorted(grid.cells) == sorted(want.cells)
    for key, cell in grid.cells.items():
        assert _rel(cell["volume"], want.cells[key]["volume"]) <= AE_REL
        env.assert_renders_close(cell["image"], want.cells[key]["image"])


@pytest.mark.parametrize("recipe, args", [("gan_examples", []), ("gan_interpolation", ["wgan"])])
def test_gan_grid_recipes_match_jax(recipe, args, jax_plot, monkeypatch, jax_latents):
    """The GAN and WGAN generators' volumes in each cell at the generator
    tolerance, each rendered cell against the JAX viewer's."""
    record = env.record_jax(monkeypatch, jax_plot)
    getattr(jax_plot, recipe)(list(args), env.jax_config())
    grid = env.port_main(recipe, args)
    want = record["grids"][0]
    assert sorted(grid.cells) == sorted(want.cells) and len(grid.cells) == 2
    for key, cell in grid.cells.items():
        assert np.abs(cell["volume"] - want.cells[key]["volume"]).max() <= GEN_ATOL
        env.assert_renders_close(cell["image"], want.cells[key]["image"])


def test_gan_results_matches_jax(jax_plot, monkeypatch, jax_latents):
    """The generator's volumes at the generator tolerance, then each
    panel's top-down preview (gray, origin lower) against the JAX figure's."""
    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.gan_results(["3"], env.jax_config())
    fig = env.port_main("gan_results", ["3"])
    want = record["figures"][0]
    assert fig.figsize == tuple(want.get_size_inches()) and len(fig.axes) == 3
    for ax, want_ax, volume in zip(fig.axes, want.axes, fig.volumes):
        env.assert_axes_match(ax, want_ax)
        np.testing.assert_array_equal(ax.images[0]["array"], create_plot._voxel_image(volume))


def test_gan_latents_are_a_seeded_normal():
    """``_gan_latents``: [count, 128] float32 from a CPU generator of the
    seed, the same for the same seed, a prefix of a longer draw."""
    a, b = create_plot._gan_latents(5, 1), create_plot._gan_latents(5, 1)
    assert a.shape == (5, 128) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(create_plot._gan_latents(3, 1), a[:3])
    assert not np.array_equal(a, create_plot._gan_latents(5, 0))
    assert abs(float(create_plot._gan_latents(200, 0).std()) - 1.0) < 0.05
