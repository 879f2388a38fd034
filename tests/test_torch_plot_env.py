"""The figure-factory tests' shared pieces (this file holds no test): a
working directory with every artifact the recipes read, built with the
port's own init and saved in the npz layout both packages load (the
networks once per test file: the JAX package's init of every network is
what makes its own recipe tests slow), the configurations, the recorder of
what the JAX recipes draw, and the comparisons.

* ``models/``: the classic AE and the VAE (and two VAE snapshots), the GAN
  and WGAN generators, ``sdf_net`` and ``hybrid_gan_generator`` (the
  octahedron network with random latent weights, so every code has a
  surface and codes differ) with a latent table of 6 codes, and two
  ``sdf_net`` snapshots of their own;
* ``plots/``: the trainers' CSV logs;
* ``screenshots/wgan`` and ``screenshots/errors``: two PNG files each,
  written by ``write_png``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.flax_layers import variables_to_jax
from shapegan_tpu_torch.render.png import write_png
from shapegan_tpu_torch.train.autoencoder import create_state
from shapegan_tpu_torch.train.gan import create_states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX package's recipe tests' extras (tests/test_plot_recipes.py).
TINY = {"res": "16", "iterations": "4", "ssaa": "1", "count": "2", "steps": "2",
        "voxel_res": "24", "pool": "6", "options": "2"}


def sdf_params(seed: int) -> dict:
    """The octahedron network with random latent weights (0.01 scale: each
    code moves the surface a little)."""
    params = octahedron_params()
    rng = np.random.default_rng(seed)
    params["w1z"] = (0.01 * rng.standard_normal(params["w1z"].shape)).astype(np.float32)
    return params


def build(root) -> None:
    """Write the artifacts into the directory ``root``."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        for d in ("plots", "screenshots/wgan", "screenshots/errors"):
            os.makedirs(d, exist_ok=True)
        for variational in (False, True):
            model = create_state(variational, seed=0)[0]
            payload = variables_to_jax(model)
            checkpoints.save(payload, model.checkpoint_name, base="models")
            if variational:
                for epoch in (0, 1):
                    model = create_state(variational, seed=10 + epoch)[0]
                    checkpoints.save(variables_to_jax(model), model.checkpoint_name, epoch=epoch,
                                     base="models")
        generator = create_states(1)[0]
        checkpoints.save(variables_to_jax(generator), "generator", base="models")
        checkpoints.save(variables_to_jax(create_states(2)[0]), "wgan-generator", base="models")

        codes = np.random.default_rng(0).normal(0, 0.3, (6, 128)).astype(np.float32)
        checkpoints.save(sdf_params(0), "sdf_net", base="models")
        checkpoints.save(sdf_params(1), "hybrid_gan_generator", base="models")
        checkpoints.save_array(codes, LATENT_CODES_FILENAME, base="models")
        for epoch in (0, 1):
            checkpoints.save(sdf_params(2 + epoch), "sdf_net", epoch=epoch, base="models")
            checkpoints.save_array(codes[::-1].copy(), LATENT_CODES_FILENAME, epoch=epoch,
                                   base="models")

        with open("plots/wgan_training.csv", "w") as f:
            for epoch in range(5):
                f.write(f"{epoch} 1.0 {-epoch:.3f} {epoch:.3f}\n")
        with open("plots/sdf_net_training.csv", "w") as f:
            for epoch in range(5):
                f.write(f"{epoch} 1.0 {1.0 / (epoch + 1):.4f} 0.02\n")
        for name in ("autoencoder_training.csv", "variational_autoencoder_training.csv"):
            with open(f"plots/{name}", "w") as f:
                for epoch in range(5):
                    f.write(f"{epoch} 1.0 {2.0 / (epoch + 1):.4f} 0.1 {0.5 / (epoch + 1):.4f}\n")

        rng = np.random.default_rng(3)
        for i in range(2):
            img = np.full((32, 32, 3), 255, np.uint8)
            img[8:24, 8:24] = rng.integers(0, 200, (16, 16, 3), dtype=np.uint8)
            write_png(f"screenshots/wgan/{i}.png", img)
            write_png(f"screenshots/errors/error-{i + 1}.png", img)
    finally:
        os.chdir(cwd)


def port_main(recipe, args=(), **extras):
    """``python -m shapegan_tpu_torch.create_plot <recipe> [args] ... cpu``
    with ``synthetic=6`` and the tiny extras, updated by ``extras``;
    returns what the recipe drew."""
    from shapegan_tpu_torch import create_plot

    merged = dict(TINY)
    merged.update({k: str(v) for k, v in extras.items()})
    return create_plot.main([recipe, *args, *(f"{k}={v}" for k, v in merged.items()),
                             "synthetic=6", "cpu"])


def port_config(**extras):
    """The port's config of the recipes on the CPU: ``synthetic=6`` and the
    tiny extras, updated by ``extras``."""
    from shapegan_tpu_torch.core.config import TrainConfig

    merged = dict(TINY)
    merged.update({k: str(v) for k, v in extras.items()})
    return TrainConfig(synthetic=6, model_dir="models", plot_dir="plots", cpu=True,
                       extras={k: int(v) if v.isdigit() else v for k, v in merged.items()})


def _npz_tree(path) -> dict:
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def skip_jax_init(monkeypatch) -> None:
    """The JAX recipes build their networks' variable templates by the JAX
    init (seconds of compiling each; their values are then replaced by the
    checkpoint's): give them the saved file's own tree instead."""
    import types

    import shapegan_tpu.train.autoencoder as jax_autoencoder
    import shapegan_tpu.train.gan as jax_gan
    from shapegan_tpu.models.gan import Generator

    def state(name):
        tree = _npz_tree(os.path.join("models", f"{name}.npz"))
        return types.SimpleNamespace(params=tree["params"], batch_stats=tree.get("batch_stats", {}))

    monkeypatch.setattr(jax_autoencoder, "create_state", lambda model, key: state(model.checkpoint_name))
    monkeypatch.setattr(jax_gan, "create_states",
                        lambda key: (Generator(), None, state("generator"), None))


def record_jax(monkeypatch, jax_create_plot) -> dict:
    """Record what the JAX recipes draw: every matplotlib figure they save
    (``savefig`` captured, nothing written) and every ``ImageGrid`` with
    each cell's image (as passed to ``imshow``) and volume. The JAX viewers
    take their software route (the port's), not host GL, and the networks
    skip the JAX init (:func:`skip_jax_init`)."""
    import matplotlib.figure

    record = {"figures": [], "grids": []}
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, *a, **k: record["figures"].append(self))
    grid = jax_create_plot.ImageGrid
    init, set_image, set_voxels = grid.__init__, grid.set_image, grid.set_voxels

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.cells = {}
        record["grids"].append(self)

    def recording_set_image(self, image, x=0, y=0):
        self.cells.setdefault((x, y), {})["image"] = np.asarray(image)
        set_image(self, image, x, y)

    def recording_set_voxels(self, voxels, x=0, y=0, color=None):
        set_voxels(self, voxels, x, y, color)
        self.cells[(x, y)]["volume"] = np.asarray(voxels)

    from shapegan_tpu.render.viewer import MeshRenderer

    viewer_init = MeshRenderer.__init__

    def software_init(self, *args, **kwargs):
        viewer_init(self, *args, **kwargs)
        self._gl_failed = True  # its software route, as the port's

    monkeypatch.setattr(MeshRenderer, "__init__", software_init)
    skip_jax_init(monkeypatch)
    monkeypatch.setattr(grid, "__init__", recording_init)
    monkeypatch.setattr(grid, "set_image", recording_set_image)
    monkeypatch.setattr(grid, "set_voxels", recording_set_voxels)
    return record


def jax_config(**extras):
    """The JAX package's config of the same recipes."""
    from shapegan_tpu.core.config import TrainConfig

    merged = dict(TINY)
    merged.update({k: str(v) for k, v in extras.items()})
    return TrainConfig(synthetic=6, model_dir="models", plot_dir="plots", extras=merged)


def assert_axes_match(ours, theirs, atol=1e-6, image_atol=1e-5):
    """A rasterizer panel's spec against a matplotlib Axes: lines' data and
    colours, bar heights and edges, step outlines, images (array, origin,
    colour map, limits), title, labels, legend texts, set y ticks."""
    import matplotlib.colors
    from matplotlib.patches import Polygon, Rectangle

    assert len(ours.lines) == len(theirs.lines)
    for line, want in zip(ours.lines, theirs.lines):
        np.testing.assert_allclose(line["x"], want.get_xdata(), atol=atol)
        np.testing.assert_allclose(line["y"], want.get_ydata(), atol=atol)
        np.testing.assert_allclose(line["color"], matplotlib.colors.to_rgb(want.get_color()), atol=1e-12)
        assert line["linewidth"] == want.get_linewidth()
        assert (line["marker"] or "None") == want.get_marker()
    rects = [p for p in theirs.patches if isinstance(p, Rectangle)]
    heights = np.concatenate([b["height"] for b in ours.bars]) if ours.bars else np.zeros(0)
    np.testing.assert_allclose(heights, [p.get_height() for p in rects], atol=atol)
    if rects:
        np.testing.assert_allclose(np.concatenate([b["x"] for b in ours.bars]),
                                   [p.get_x() for p in rects], atol=atol)
        np.testing.assert_allclose(np.concatenate([b["width"] for b in ours.bars]),
                                   [p.get_width() for p in rects], atol=atol)
    polygons = [p for p in theirs.patches if isinstance(p, Polygon)][::-1]  # added last first
    assert len(ours.steps) == len(polygons)
    for step, want in zip(ours.steps, polygons):
        np.testing.assert_allclose(np.stack([step["x"], step["y"]], 1),
                                   want.get_xy()[:len(step["x"])], atol=atol)
    assert len(ours.images) == len(theirs.images)
    for image, want in zip(ours.images, theirs.images):
        np.testing.assert_allclose(np.asarray(image["array"], np.float64),
                                   np.asarray(want.get_array(), np.float64), atol=image_atol)
        assert image["origin"] == want.origin
        if image["array"].ndim == 2:
            assert image["cmap"] == want.get_cmap().name
            assert (image["vmin"], image["vmax"]) == pytest_approx((want.norm.vmin, want.norm.vmax))
    assert ours.title == theirs.get_title()
    assert ours.axis_on == theirs.axison
    if ours.axis_on:
        assert ours.xlabel == theirs.get_xlabel() and ours.ylabel == theirs.get_ylabel()
    legend = theirs.get_legend()
    if legend is None:
        assert ours.legend_loc is None
    else:
        assert [e["label"] for e in ours.legend_entries] == [t.get_text() for t in legend.get_texts()]
    if ours.yticks is not None:
        np.testing.assert_allclose(ours.yticks, theirs.get_yticks())
    if ours.ylim is not None:
        np.testing.assert_allclose(ours.ylim, theirs.get_ylim())


# A frame of the port (bf16) against the JAX package's (float32): at most 2
# pixels shaded in one and background in the other
# (tests/test_torch_raymarch.py), and 99 % of the pixel values within 2
# levels. A point's shadow flag may flip where its shadow ray grazes the
# surface (tests/test_torch_raymarch.py holds the flags at 99 %), which
# moves its pixel by the shadow's weight: read here one pixel of a frame by
# up to 65 levels, 0.3 % of the frame's values.
FRAME_MASK_DIFFER_PIXELS = 2
FRAME_CLOSE_SHARE = 0.99
FRAME_CLOSE_LEVELS = 2
# Raymarched frames at 16^2, ssaa 1, and the recipes' 1000 steps (rays
# that stop unresolved could end either way).
FRAMES = {"res": 16, "iterations": 1000}


def assert_frames_close(got, want):
    """A raymarched frame of the port against the JAX package's."""
    assert got.shape == want.shape and got.dtype == np.uint8
    mask, want_mask = (got != 255).any(axis=2), (want != 255).any(axis=2)
    diff = np.abs(got.astype(np.int64) - want)
    assert (mask != want_mask).sum() <= FRAME_MASK_DIFFER_PIXELS
    assert (diff <= FRAME_CLOSE_LEVELS).mean() >= FRAME_CLOSE_SHARE, (diff > FRAME_CLOSE_LEVELS).mean()
    assert mask.any()


def pytest_approx(values):
    import pytest

    return pytest.approx(values, rel=1e-6, abs=1e-6)


def assert_renders_close(got, want, share=0.99, levels=2):
    """A rendered cell against the JAX viewer's: the same shape, and at
    least ``share`` of the pixel values within ``levels`` of 255."""
    assert got.shape == want.shape, (got.shape, want.shape)
    close = np.abs(got.astype(np.int64) - want.astype(np.int64)) <= levels
    assert close.mean() >= share, close.mean()


@pytest.fixture(scope="module")
def plot_dir(tmp_path_factory):
    """The module's working directory of artifacts (:func:`build`)."""
    root = tmp_path_factory.mktemp("plot_env")
    build(str(root))
    return root


@pytest.fixture(scope="module")
def jax_plot(plot_dir):
    """The root create_plot module, imported in the test directory (its
    import creates ``plots/`` in the working directory)."""
    cwd = os.getcwd()
    os.chdir(plot_dir)
    try:
        sys.path.insert(0, REPO)
        import create_plot as module
    finally:
        os.chdir(cwd)
    return module


@pytest.fixture(autouse=True)
def in_plot_dir(plot_dir, monkeypatch):
    """Each test in the artifacts' directory, on one intra-op thread (the
    workers of pytest-xdist share the cores)."""
    monkeypatch.chdir(plot_dir)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
