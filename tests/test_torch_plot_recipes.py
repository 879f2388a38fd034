"""The port's figure factory (``python -m shapegan_tpu_torch.create_plot``)
against the repo's root ``create_plot.py``: the curve and histogram
recipes, the (V)AE charts and the SDF slices, on the same files (networks built once with
the port's init, saved in the npz layout both packages load). Each chart's
spec is held against the matplotlib figure the JAX recipe saves (captured,
not written); each grid cell against what the JAX ``ImageGrid`` shows."""

import jax  # noqa: F401  (the JAX package's CPU backend, set up by conftest)
import numpy as np
import pytest
from sklearn.metrics import pairwise_distances

import test_torch_plot_env as env
from test_torch_plot_env import in_plot_dir, jax_plot, plot_dir  # noqa: F401  (fixtures)
from shapegan_tpu_torch import create_plot

# Autoencoder codes and volumes against the largest entry, float32 both
# sides (tests/test_torch_demos.py's AE_REL).
AE_REL = 1e-4
# The port's bf16 SDF network against the JAX package's float32 one, over
# the largest |SDF| of the slice: eight bf16 layers, each rounding to 2^-8
# of its values (the test network reaches |SDF| ~0.6, where
# tests/test_torch_slice.py's bundled one stays near 0.02; read here <= 6.5e-3).
BF16_VS_F32_REL = 1e-2


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _figures(result):
    return result if isinstance(result, list) else [result]


def _match(ours, theirs, **kw):
    assert len(ours) == len(theirs)
    for fig, want in zip(ours, theirs):
        assert fig.figsize == tuple(want.get_size_inches())
        assert len(fig.axes) == len(want.axes)
        for ax, want_ax in zip(fig.axes, want.axes):
            env.assert_axes_match(ax, want_ax, **kw)


@pytest.mark.parametrize("recipe, args", [
    ("wgan_training", []), ("sdf_training", []), ("autoencoder_training", []),
    ("autoencoder_training", ["latex"]),
    ("training_curves", ["plots/wgan_training.csv", "plots/sdf_net_training.csv"]),
])
def test_curve_recipes_match_jax(recipe, args, jax_plot, monkeypatch):
    """Lines (data, colour, width, marker), labels, titles, legends and
    ``set_yticks([])``, figure by figure."""
    record = env.record_jax(monkeypatch, jax_plot)
    getattr(jax_plot, recipe)(list(args), env.jax_config())
    ours = env.port_main(recipe, args)
    _match(_figures(ours), record["figures"])
    for fig in _figures(ours):
        assert fig.axes[0].lines


@pytest.mark.parametrize("recipe, args", [
    ("latent_distribution", []), ("autodecoder_hist", []), ("voxel_occupancy", []),
    ("autoencoder_hist", ["classic"]), ("autoencoder_hist", []),
])
def test_histogram_recipes_match_jax(recipe, args, jax_plot, monkeypatch):
    """Bar heights and edges (``density`` with ``range``), the per-dimension
    step outlines of ``codes[:, ::4]``, the overlaid curves, the math-text
    labels; the (V)AE's codes come from the port's encoder."""
    record = env.record_jax(monkeypatch, jax_plot)
    getattr(jax_plot, recipe)(list(args), env.jax_config(count=6))
    ours = env.port_main(recipe, args, count=6)
    _match(_figures(ours), record["figures"])
    assert any(ax.bars or ax.steps for fig in _figures(ours) for ax in fig.axes)


def test_autoencoder_results_matches_jax(jax_plot, monkeypatch):
    """The input and reconstruction previews: the decoded volumes at the
    AE tolerance, then each ``imshow`` array, origin and colour map."""
    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.autoencoder_results(["2"], env.jax_config())
    fig = env.port_main("autoencoder_results", ["2"])
    want = record["figures"][0]
    voxels, recon = fig.volumes
    theirs = np.stack([ax.images[0].get_array() for ax in want.axes[2:]])
    ours = np.stack([create_plot._voxel_image(v) for v in recon])
    np.testing.assert_allclose(ours, theirs, atol=1e-5)
    _match([fig], [want])


def test_autoencoder_examples_bars_match_jax(jax_plot, monkeypatch):
    """The bar column (every code as 128 bars, y limits -3..3) and the two
    rendered columns against the JAX viewer's software frames."""
    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.autoencoder_examples([], env.jax_config(count=2))
    fig = env.port_main("autoencoder_examples", [], count=2)
    want = record["figures"][0]
    assert fig.figsize == tuple(want.get_size_inches()) and len(fig.axes) == len(want.axes) == 6
    for row in range(2):
        bars, want_bars = fig.axes[3 * row + 1], want.axes[3 * row + 1]
        assert len(bars.bars[0]["height"]) == len(want_bars.patches) == 128
        heights = np.array([p.get_height() for p in want_bars.patches])
        assert _rel(bars.bars[0]["height"], heights) <= AE_REL
        np.testing.assert_allclose(bars.bars[0]["x"], [p.get_x() for p in want_bars.patches], atol=1e-12)
        np.testing.assert_allclose(bars.ylim, want_bars.get_ylim())
        for col in (0, 2):
            env.assert_renders_close(fig.axes[3 * row + col].images[0]["array"],
                                     np.asarray(want.axes[3 * row + col].images[0].get_array()))


def test_autoencoder_generate_nearest_match_sklearn():
    """The cosine-nearest dataset codes of the drawn samples equal
    ``argmin(pairwise_distances(codes, drawn, metric="cosine"))``, in the
    recipe and on random codes."""
    rng = np.random.default_rng(8)
    codes, drawn = rng.normal(size=(40, 16)), rng.normal(size=(7, 16))
    np.testing.assert_array_equal(create_plot.cosine_nearest(codes, drawn),
                                  np.argmin(pairwise_distances(codes, drawn, metric="cosine"), axis=0))
    config = env.port_config(count=2)
    grid = env.port_main("autoencoder_generate", count=2)
    voxels = create_plot._dataset_voxels(config, 6)
    rng = np.random.default_rng(0)
    for row, variational in enumerate((False, True)):
        codes = create_plot._ae_encode(create_plot._load_autoencoder(config, variational), voxels)
        flat = codes.reshape(-1)
        drawn = rng.normal(flat.mean(), flat.std(), (2, 128)).astype(np.float32)
        want = np.argmin(pairwise_distances(codes, drawn, metric="cosine"), axis=0)
        np.testing.assert_array_equal(grid.nearest[row], want)
    assert len(grid.cells) == 8


def _bf16_atol(figure):
    return BF16_VS_F32_REL * max(float(np.abs(ax.images[0].get_array()).max()) for ax in figure.axes)


def test_sdf_slices_match_jax(jax_plot, monkeypatch):
    """Each panel's ``volume[:, :, 32].T`` (RdBu, -0.1..0.1, origin lower):
    the port's bf16 volumes against the JAX package's float32 ones at the
    bf16 bound, and each panel's array equal to its volume's slice."""
    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.sdf_slices(["1"], env.jax_config())
    fig = env.port_main("sdf_slices", ["1"])
    _match([fig], record["figures"], image_atol=_bf16_atol(record["figures"][0]))
    for ax, volume in zip(fig.axes, fig.volumes):
        np.testing.assert_allclose(ax.images[0]["array"], volume[:, :, 32].T, atol=1e-5)
        assert (volume < 0).any() and (volume > 0).any()


def test_checkpoint_evolution_matches_jax(jax_plot, monkeypatch):
    """One panel per ``sdf_net`` snapshot (``epoch N`` titles), the 48^3
    volume's middle slice, as in ``sdf_slices``."""
    record = env.record_jax(monkeypatch, jax_plot)
    jax_plot.checkpoint_evolution([], env.jax_config())
    fig = env.port_main("checkpoint_evolution", [])
    assert [ax.title for ax in fig.axes] == ["epoch 0", "epoch 1"]
    _match([fig], record["figures"], image_atol=_bf16_atol(record["figures"][0]))
    for ax, volume in zip(fig.axes, fig.volumes):
        np.testing.assert_allclose(ax.images[0]["array"], volume[:, :, 24].T, atol=1e-5)
