"""``python -m shapegan_tpu_torch.create_plot`` end to end for the recipes
the other ``test_torch_plot_*`` files do not hold against the JAX recipes
(the t-SNE figures, the mesh screenshots and reconstructions, the
raymarched examples) and for every alias, each writing the JAX script's
files; the t-SNE figure's thumbnails and embedding; its recipe table
against the JAX script's; the CUDA rule."""

import os

import jax  # noqa: F401  (the JAX package's CPU backend, set up by conftest)
import numpy as np
import pytest
import torch
from sklearn.manifold import TSNE, trustworthiness

import test_torch_plot_env as env
from test_torch_plot_env import in_plot_dir, jax_plot, plot_dir  # noqa: F401  (fixtures)
from shapegan_tpu_torch import create_plot
from shapegan_tpu_torch.examples import example_chair_path

# The port's exact t-SNE against scikit-learn's exact one from the same PCA
# start: the final KL and the trustworthiness (k = 2 on these few codes),
# tests/test_torch_embedding.py's bounds.
KL_RATIO, KL_SLACK = 1.1, 0.02
TRUST_SLACK = 0.05
# A thumbnail (128-pixel frame, cropped, area-resized to 96) against the JAX
# viewer's software route: tests/test_torch_gan_gate.py's TILE_MAX_LEVELS.
TILE_MAX_LEVELS = 1
# (recipe or alias, args, extras, the files it writes)
RUNS = [
    ("tsne", [], {"count": 3}, ["plots/latent_space_tsne.png"]),
    ("autoencoder_tsne", ["classic"], {"count": 3}, ["plots/autoencoder-tsne.png"]),
    ("autodecoder_tsne", [], {"count": 3}, ["plots/deepsdf-tsne.png"]),
    ("gan_tsne", ["wgan"], {"count": 3}, ["plots/wgan-images.png"]),
    ("raymarch_examples", ["1"], {"res": 8}, ["screenshots/raymarching-examples/image-0-8.png"]),
    ("color-test", [], {}, ["plots/color-test.png"]),
    ("autoencoder-classes", [], {}, ["plots/vae-reconstruction-classes.png"]),
    ("autodecoder-classes", [], {}, ["plots/vae-reconstruction-classes.png"]),
    ("autoencoder", [], {"count": 3}, ["plots/variational-autoencoder-tsne.png"]),
    ("wgan-results", [], {}, ["plots/wgan-results.png"]),
    ("shapenet-errors", [], {}, ["plots/errors.png"]),
    ("deepsdf-interpolation-stl", [], {"voxel_res": 16}, ["plots/mesh-0.stl", "plots/mesh-1.stl"]),
]


@pytest.mark.parametrize("name, args, extras, files", RUNS, ids=[r[0] for r in RUNS])
def test_recipe_runs_end_to_end(name, args, extras, files):
    from shapegan_tpu_torch.render.png import read_png

    for path in files:
        if os.path.exists(path):
            os.remove(path)
    env.port_main(name, args, **extras)
    for path in files:
        assert os.path.isfile(path), path
        if path.endswith(".png"):
            assert (read_png(path) != 255).any(), path


def test_mesh_screenshots_and_reconstruction(tmp_path):
    """``model_images`` renders a mesh file into ``screenshots/sdf_meshes``
    as the JAX viewer's software route renders it; ``sdf_net_reconstruction``
    then pairs each screenshot (cropped) with a raymarched frame."""
    from shapegan_tpu.data.mesh_io import load_mesh as jax_load_mesh
    from shapegan_tpu.render.viewer import MeshRenderer as JaxMeshRenderer
    from shapegan_tpu_torch.render.png import read_png
    from shapegan_tpu_torch.util import crop_image

    for i in range(6):
        path = f"screenshots/sdf_meshes/{i}.png"
        if os.path.exists(path):
            os.remove(path)
    written = env.port_main("model_images", [example_chair_path(device="cpu")], res=64)
    assert written == ["screenshots/sdf_meshes/0.png"]
    theirs = JaxMeshRenderer(size=64, start_thread=False)
    theirs._gl_failed = True
    theirs.set_mesh(jax_load_mesh(example_chair_path(device="cpu")), center_and_scale=True)
    np.testing.assert_array_equal(read_png(written[0]), theirs.get_image())
    # the table's indices drawn by the recipe must all have a screenshot
    for i in range(1, 6):
        os.link(written[0], f"screenshots/sdf_meshes/{i}.png")
    grid = env.port_main("sdf_net_reconstruction", [], res=8)
    assert grid.height == 2 and len(grid.cells) == 4
    np.testing.assert_array_equal(grid.cells[(0, 0)]["image"], crop_image(read_png(written[0])))
    assert os.path.isfile("plots/deepsdf-reconstruction.png")


def test_tsne_recipe_embedding_and_thumbnails(jax_plot, monkeypatch):
    """``gan_tsne``: the thumbnails equal to the JAX recipe's (up to the
    area resize's rounding) on the same generated volumes; the embedding
    held to scikit-learn's exact t-SNE by KL and trustworthiness."""
    record = {}
    monkeypatch.setattr(jax_plot, "create_tsne_plot", lambda codes, images, labels, filename:
                        record.update(codes=np.asarray(codes), images=images))
    env.skip_jax_init(monkeypatch)
    monkeypatch.setattr(create_plot, "_gan_latents", lambda count, seed: np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), (count, 128))))
    jax_plot.gan_tsne([], env.jax_config(count=6))
    fig = env.port_main("gan_tsne", [], count=6)
    ax = fig.axes[0]
    assert len(ax.thumbnails) == len(record["images"]) == 6 and not ax.axis_on
    for thumb, want in zip(ax.thumbnails, record["images"]):
        assert thumb["image"].shape == want.shape and thumb["zoom"] == 0.5
        assert np.abs(thumb["image"].astype(int) - want).max() <= TILE_MAX_LEVELS
    offsets = ax.scatters[0]["offsets"]
    assert offsets.min() == 0.0 and offsets.max() == 1.0
    codes = record["codes"].astype(np.float32)
    perplexity = min(30.0, max(2.0, (len(codes) - 1) / 3))
    reference = TSNE(n_components=2, perplexity=perplexity, method="exact", init="pca",
                     random_state=0).fit(codes)
    assert fig.kl <= KL_RATIO * reference.kl_divergence_ + KL_SLACK, (fig.kl, reference.kl_divergence_)
    ours = trustworthiness(codes, fig.embedded, n_neighbors=2)
    assert ours >= trustworthiness(codes, reference.embedding_, n_neighbors=2) - TRUST_SLACK


def test_recipe_table_matches_jax(jax_plot, capsys):
    """The 40 recipes and 7 aliases of the JAX script, each alias to the same
    recipe; an unknown name prints the list and runs nothing."""
    assert list(create_plot.RECIPES) == list(jax_plot.RECIPES) and len(create_plot.RECIPES) == 40
    assert create_plot.ALIASES == jax_plot.ALIASES and len(create_plot.ALIASES) == 7
    assert create_plot.main(["no_such_recipe", "cpu"]) is None
    assert "available recipes: training_curves" in capsys.readouterr().out


def test_create_plot_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    """On CUDA by default: without a card it raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_plot.main(["wgan_training"])
    assert not os.listdir(tmp_path)
