#!/usr/bin/env python3
"""Figure factory: the thesis and paper figures behind argv switches
(counterpart of the repo's ``create_plot.py``, with its 40 recipes, its
hyphenated aliases and its output file names under ``plots/``).

    python -m shapegan_tpu_torch.create_plot <recipe> [args] [name=value] [cpu]

Extras (name=value): ``res=N`` raymarch / grid render resolution,
``voxel_res=N`` implicit-eval grid resolution, ``count=N`` sample count,
``steps=N`` interpolation steps, ``iterations=N`` and ``ssaa=N`` raymarch
quality. Without the ``cpu`` token it runs on CUDA and fails if there is
none; ``plots/`` is created in the working directory.

The networks run on the device: the implicit models' volumes and meshes
through the points kernel (``SDFNet.get_voxels`` / ``get_mesh``), their
frames through the raymarcher (the trace kernel, the grid kernel and its
backward for the normals). Shapes are shown through the headless
:class:`~shapegan_tpu_torch.render.viewer.MeshRenderer`. The figures are
drawn by the port's own rasterizer (:mod:`shapegan_tpu_torch.render.figure`,
the card's machine has no matplotlib), screenshots read by
:func:`~shapegan_tpu_torch.render.png.read_png` (no Pillow), the t-SNE and
k-means are :mod:`shapegan_tpu_torch.embedding`'s (no scikit-learn), and
the GAN recipes' latents come from a CPU ``torch.Generator``
(:func:`_gan_latents`) where the JAX recipes draw ``jax.random.normal``.
Every recipe returns what it drew (its :class:`Figure`, :class:`ImageGrid`
or file names).

Recipes:
  training_curves, autoencoder_training, wgan_training, sdf_training
  latent_distribution, autoencoder_hist, autodecoder_hist
  tsne, autoencoder_tsne, autodecoder_tsne, gan_tsne, color_test
  autoencoder_results, autoencoder_classes, autoencoder_examples,
  autoencoder_examples_2, autoencoder_generate,
  autoencoder_interpolation, autoencoder_interpolation_2
  gan_results, gan_examples, gan_interpolation, wgan_results
  sdf_slices, sdf_slice, voxel_occupancy, model_images
  sdf_net_reconstruction, sdf_net_interpolation, sdf_net_sample
  hybrid_gan, hybrid_gan_interpolation, hybrid_gan_upscaling
  checkpoint_evolution, vae_checkpoints, sdf_checkpoints
  shapenet_errors, raymarch_examples, export_stl, deepsdf_interpolation_stl
"""

from __future__ import annotations

import glob as globlib
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, checkpoints
from shapegan_tpu_torch.core.config import parse_cli, resolve_device
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.render import colormaps
from shapegan_tpu_torch.render.figure import Figure
from shapegan_tpu_torch.render.png import read_png, write_png
from shapegan_tpu_torch.util import crop_image, ensure_directory


def _extra_int(config, key, default):
    return int(config.extras.get(key, default))


def _figure(figsize, dpi, rows=1, cols=1):
    """A figure and its panels [rows, cols] (``plt.subplots``)."""
    fig = Figure(figsize, dpi)
    return fig, fig.subplots(rows, cols)


def _save(fig, filename):
    fig.savefig(filename)
    print(filename)
    return fig


# ---------------------------------------------------------------- loaders


def _load_sdf_net(config, epoch=None, filename=None):
    """(net, latent table) of ``sdf_net`` (or ``filename``, then no table)
    on the config's device; a missing table raises here, not later in a
    recipe that indexes it."""
    from shapegan_tpu_torch.models.sdf_net import SDFNet

    device = resolve_device(config)
    net = SDFNet(checkpoints.load(filename or "sdf_net", epoch=epoch, base=config.model_dir,
                                  device=device))
    codes = None
    if filename is None:
        codes = checkpoints.load_array(LATENT_CODES_FILENAME, epoch=epoch, base=config.model_dir)
    return net, codes


def _load_autoencoder(config, is_variational, epoch=None):
    """The (V)AE of the trainer's checkpoint (or its ``epoch`` snapshot)."""
    from shapegan_tpu_torch.train.autoencoder import create_state
    from shapegan_tpu_torch.train.common import load_module

    model = create_state(is_variational, 0, resolve_device(config))[0]
    load_module(model, model.checkpoint_name, config.model_dir, epoch=epoch)
    return model


@torch.no_grad()
def _ae_encode(model, voxels) -> np.ndarray:
    """Volumes [N, 32, 32, 32] → codes [N, 128] in eval mode (flax's
    running statistics; the VAE's mean)."""
    x = torch.as_tensor(np.asarray(voxels), dtype=torch.float32,
                        device=next(model.parameters()).device)
    return model.encode(x, train=False).cpu().numpy()


@torch.no_grad()
def _ae_decode(model, codes) -> np.ndarray:
    z = torch.as_tensor(np.asarray(codes), dtype=torch.float32,
                        device=next(model.parameters()).device)
    return model.decode(z, train=False).cpu().numpy()


def _load_generator_fn(config, wgan: bool, epoch=None):
    """The voxel-GAN generator as z [n, 128] → volumes [n, 32, 32, 32]
    (numpy, eval mode)."""
    from shapegan_tpu_torch.train.common import load_module
    from shapegan_tpu_torch.train.gan import create_states

    device = resolve_device(config)
    generator = create_states(0, device)[0]
    load_module(generator, "wgan-generator" if wgan else "generator", config.model_dir, epoch=epoch)

    @torch.no_grad()
    def generate(z):
        z = torch.as_tensor(np.asarray(z), dtype=torch.float32, device=device)
        return generator(z, train=False).cpu().numpy()

    return generate


def _gan_latents(count: int, seed: int) -> np.ndarray:
    """The GAN recipes' latents [count, 128]: a standard normal from a CPU
    ``torch.Generator`` seeded ``seed`` (the JAX recipes draw
    ``jax.random.normal(PRNGKey(seed))``)."""
    generator = torch.Generator().manual_seed(seed)
    return torch.randn((count, LATENT_CODE_SIZE), generator=generator).numpy()


def _dataset_voxels(config, count, seed=0, resolution=32):
    from shapegan_tpu_torch.train.common import resolve_voxel_dataset

    dataset = resolve_voxel_dataset(config, resolution=resolution)
    rng = np.random.default_rng(seed)
    indices = rng.choice(len(dataset), min(count, len(dataset)), replace=False)
    return np.stack([np.asarray(dataset[int(i)]) for i in indices])


def _labeled_voxels(config, per_class=1, seed=0, resolution=32):
    """(voxels, labels, class names): one or more categories from the data
    directory, or synthetic shape classes when no dataset exists."""
    categories = []
    if os.path.isdir(config.data_dir):
        for entry in sorted(os.listdir(config.data_dir)):
            if os.path.isdir(os.path.join(config.data_dir, entry, f"voxels_{resolution}")):
                categories.append(entry)
    if not categories:
        from shapegan_tpu_torch.train.classifier import make_synthetic_class_dataset

        volumes, labels, label_count = make_synthetic_class_dataset(
            max(per_class, 2), resolution=resolution, seed=seed)
        return np.asarray(volumes), np.asarray(labels), [f"class {i}" for i in range(label_count)]

    rng = np.random.default_rng(seed)
    voxels, labels = [], []
    for label, category in enumerate(categories):
        files = sorted(globlib.glob(os.path.join(config.data_dir, category, f"voxels_{resolution}",
                                                 "*.npy")))
        chosen = rng.choice(len(files), min(per_class, len(files)), replace=False)
        for i in chosen:
            voxels.append(np.clip(np.load(files[int(i)]), -0.1, 0.1) / 0.1)
            labels.append(label)
    return np.stack(voxels), np.asarray(labels), categories


def _class_color(label):
    return tuple(colormaps.TAB10[int(label) % 10])


def _interpolate(code_start, code_end, steps):
    """Linear latent interpolation [steps, L]."""
    t = np.linspace(0.0, 1.0, steps)[:, None]
    return code_start[None, :] * (1.0 - t) + code_end[None, :] * t


def _epochs(config, name):
    """The epochs of ``models/checkpoints/<name>-epoch-*.npz``, sorted."""
    paths = sorted(globlib.glob(os.path.join(config.model_dir, "checkpoints", f"{name}-epoch-*.npz")))
    epochs = [int(p.split("-epoch-")[1].split(".")[0]) for p in paths]
    if not epochs:
        raise SystemExit(f"no {name} epoch snapshots found")
    return epochs


# ------------------------------------------------------------- image grid


class ImageGrid:
    """A grid of rendered shapes: ``width x height`` cells of ``cell_width
    x cell_height`` inches at 200 dpi with ``margin`` between them, each
    image fitted into its cell with its aspect kept; voxels and meshes are
    rendered by the headless viewer. ``cells[(x, y)]`` keeps each cell's
    image (and ``volume`` for ``set_voxels``)."""

    DPI = 200

    def __init__(self, width, height=1, cell_width=3, cell_height=None, margin=0.2,
                 create_viewer=True, crop=True, render_size=400, device="cpu"):
        cell_height = cell_height if cell_height is not None else cell_width
        self.width, self.height = width, height
        self.figure = Figure((width * cell_width, height * cell_height), self.DPI)
        self.axes = self.figure.subplots(height, width, left=0, right=1, top=1, bottom=0,
                                         wspace=margin, hspace=margin)
        self.crop = crop
        self.device = torch.device(device)
        self.cells = {}
        self.viewer = None
        if create_viewer:
            from shapegan_tpu_torch.render.viewer import MeshRenderer

            self.viewer = MeshRenderer(size=render_size, start_thread=False)

    def set_image(self, image, x=0, y=0):
        image = np.asarray(image)
        cell = self.axes[y, x]
        cell.imshow(image, cmap="gray" if image.ndim == 2 else None)
        cell.axis("off")
        self.cells.setdefault((x, y), {})["image"] = image

    def set_voxels(self, voxels, x=0, y=0, color=None):
        if color is not None:
            self.viewer.model_color = tuple(color)
        voxels = np.asarray(voxels, np.float32)
        self.viewer.set_voxels(torch.as_tensor(voxels, device=self.device))
        self.set_image(self.viewer.get_image(crop=self.crop), x, y)
        self.cells[(x, y)]["volume"] = voxels

    def set_mesh(self, mesh, x=0, y=0, color=None):
        if color is not None:
            self.viewer.model_color = tuple(color)
        self.viewer.set_mesh(mesh)
        self.set_image(self.viewer.get_image(crop=self.crop), x, y)

    def save(self, filename):
        _save(self.figure, filename)
        return self


def _voxel_image(volume: np.ndarray):
    """Shaded top-down projection of occupied voxels (a GL-free preview)."""
    occupancy = (volume < 0).astype(np.float32)
    depth = occupancy.argmax(axis=1) + (1 - occupancy.any(axis=1)) * volume.shape[1]
    return 1.0 - depth.T / volume.shape[1]


def _thumbnails(voxels, colors=None, device="cpu"):
    """Cropped 96-pixel renders of volumes (128-pixel frames)."""
    from shapegan_tpu_torch.render.viewer import MeshRenderer

    viewer = MeshRenderer(size=128, start_thread=False)
    images = []
    for i, volume in enumerate(voxels):
        if colors is not None:
            viewer.model_color = colors[i]
        viewer.set_voxels(torch.as_tensor(np.asarray(volume, np.float32), device=device))
        images.append(viewer.get_image(crop=True, output_size=96))
    return images


def create_tsne_plot(codes, images=None, labels=None, filename="plots/tsne.png", device="cpu"):
    """t-SNE scatter with optional per-point shape thumbnails, the
    embedding scaled to [0, 1] on each axis."""
    from shapegan_tpu_torch.embedding import tsne

    codes = np.asarray(codes, np.float32)
    perplexity = min(30.0, max(2.0, (len(codes) - 1) / 3))
    embedded, kl = tsne(codes, perplexity, device=device)
    x = np.interp(embedded[:, 0], (embedded[:, 0].min(), embedded[:, 0].max()), (0, 1))
    y = np.interp(embedded[:, 1], (embedded[:, 1].min(), embedded[:, 1].max()), (0, 1))
    fig, axes = _figure((12, 12), 150)
    ax = axes[0, 0]
    ax.axis("off")
    ax.scatter(x, y, c=labels if labels is not None else "tab:blue", s=40, cmap="Set1")
    for i, image in enumerate(images or []):
        ax.add_thumbnail(image, (x[i], y[i]), zoom=0.5)
    fig.embedded, fig.kl = embedded, kl
    return _save(fig, filename)


# =============================================================== curves


def training_curves(args, config):
    csvs = args or [os.path.join(config.plot_dir, name) for name in os.listdir(config.plot_dir)
                    if name.endswith(".csv")]
    fig, axes = _figure((8, 5), 120)
    ax = axes[0, 0]
    for path in csvs:
        data = np.loadtxt(path, ndmin=2)
        if data.size == 0:
            continue
        ax.plot(data[:, 0], data[:, 2], label=os.path.splitext(os.path.basename(path))[0])
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss / score")
    ax.legend()
    return _save(fig, "plots/training_curves.png")


def wgan_training(args, config):
    """Critic output curves from the WGAN log."""
    data = np.loadtxt(os.path.join(config.plot_dir, "wgan_training.csv"), ndmin=2)
    fig, axes = _figure((6.4, 4.8), 120)
    ax = axes[0, 0]
    ax.plot(data[:, 3], label="Assessment of real objects")
    ax.plot(data[:, 2], label="Assessment of fake objects")
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Critic output")
    ax.legend()
    return _save(fig, "plots/wgan-training-critic.png")


def sdf_training(args, config):
    """Autodecoder loss curve."""
    data = np.loadtxt(os.path.join(config.plot_dir, "sdf_net_training.csv"), ndmin=2)
    fig, axes = _figure((6.4, 4.8), 120)
    ax = axes[0, 0]
    epochs = np.arange(1, data.shape[0] + 1)
    ax.plot(epochs, data[:, 2], linestyle="-", linewidth=0.5, color="grey")
    ax.plot(epochs, data[:, 2], "x")
    ax.set_ylabel("Loss")
    ax.set_xlabel("Epoch")
    return _save(fig, "plots/deepsdf-training-loss.png")


def autoencoder_training(args, config):
    """(V)AE training curves: normalized recon + voxel error per variant, or
    the ``latex`` two-figure variant; returns the figures drawn."""
    if "latex" in args:
        data = np.loadtxt(os.path.join(config.plot_dir, "variational_autoencoder_training.csv"),
                          ndmin=2)
        fig, axes = _figure((6.4, 4.8), 120)
        ax = axes[0, 0]
        ax.plot(data[:, 2], label="Reconstruction loss")
        ax.plot(data[:, 3], label="KLD loss")
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Loss")
        ax.legend()
        first = _save(fig, "plots/vae-training-loss.png")
        fig, axes = _figure((6.4, 4.8), 120)
        ax = axes[0, 0]
        ax.plot(data[:, 4])
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Voxel error")
        return [first, _save(fig, "plots/vae-training-error.png")]
    figures = []
    for csv_name, title, out in (
        ("autoencoder_training.csv", "Autoencoder Training", "plots/autoencoder-training.png"),
        ("variational_autoencoder_training.csv", "Variational Autoencoder Training",
         "plots/variational-autoencoder-training.png"),
    ):
        path = os.path.join(config.plot_dir, csv_name)
        if not os.path.isfile(path):
            continue
        data = np.loadtxt(path, ndmin=2)
        fig, axes = _figure((6.4, 4.8), 120)
        ax = axes[0, 0]
        max_recon = np.max(data[:, 2]) or 1.0
        ax.plot(data[:, 2] / max_recon, label=f"Reconstruction loss ({data[-1, 2]:.3f})")
        ax.plot(data[:, 4] / (np.max(data[:, 4]) or 1.0), label=f"Voxel error ({data[-1, 4]:.3f})")
        ax.set_xlabel("Epoch")
        ax.set_yticks([])
        ax.set_title(title)
        ax.legend(loc="center right")
        figures.append(_save(fig, out))
    return figures


# ============================================================ histograms


def latent_distribution(args, config):
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=config.model_dir).reshape(-1)
    fig, axes = _figure((6, 4), 120)
    ax = axes[0, 0]
    ax.hist(codes, bins=100, density=True, alpha=0.7, label="latent codes")
    x = np.linspace(codes.min(), codes.max(), 200)
    std = codes.std() or 1.0
    ax.plot(x, np.exp(-0.5 * (x / std) ** 2) / (std * np.sqrt(2 * np.pi)), label=f"N(0, {std:.3f})")
    ax.legend()
    return _save(fig, "plots/latent_distribution.png")


def _hist_pair(codes, x_range, prefix, overlay_normal):
    """Per-dimension step histograms (every fourth dimension) and the
    combined histogram; returns both figures."""
    fig, axes = _figure((6.4, 4.8), 120)
    ax = axes[0, 0]
    ax.hist(codes[:, ::4], bins=100, range=(-x_range, x_range), histtype="step", density=True,
            color=["#1f77b4"] * len(range(0, codes.shape[1], 4)))
    ax.set_xlabel(r"$\mathbf{z}^{(i)}$")
    ax.set_ylabel("relative abundance")
    first = _save(fig, f"plots/{prefix}-histogram.png")

    fig, axes = _figure((6.4, 4.8), 120)
    ax = axes[0, 0]
    if overlay_normal:
        x = np.linspace(-x_range, x_range, 500)
        ax.plot(x, np.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi), color="green")
    ax.hist(codes.reshape(-1), bins=100, range=(-x_range, x_range), density=True)
    ax.set_xlabel(r"$\mathbf{z}$")
    ax.set_ylabel("relative abundance")
    return [first, _save(fig, f"plots/{prefix}-histogram-combined.png")]


def autoencoder_hist(args, config):
    is_variational = "classic" not in args
    model = _load_autoencoder(config, is_variational)
    codes = _ae_encode(model, _dataset_voxels(config, _extra_int(config, "count", 512)))
    prefix = "variational-autoencoder" if is_variational else "autoencoder"
    return _hist_pair(codes, x_range=4.0 if is_variational else 1.0, prefix=prefix,
                      overlay_normal=is_variational)


def autodecoder_hist(args, config):
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=config.model_dir)
    return _hist_pair(codes, x_range=0.42, prefix="autodecoder", overlay_normal=False)


def voxel_occupancy(args, config):
    """Histogram of occupied-voxel counts over the dataset."""
    voxels = _dataset_voxels(config, _extra_int(config, "count", 1000))
    occupied = (voxels < 0).reshape(len(voxels), -1).sum(axis=1)
    fig, axes = _figure((6.4, 4.8), 120)
    axes[0, 0].hist(occupied, bins=100)
    return _save(fig, "plots/voxel-occupancy-histogram.png")


# ================================================================= t-SNE


def tsne(args, config):
    from shapegan_tpu_torch.embedding import kmeans
    from shapegan_tpu_torch.embedding import tsne as embed

    device = resolve_device(config)
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=config.model_dir)
    perplexity = min(30.0, max(2.0, (len(codes) - 1) / 3))
    embedded, _ = embed(codes, perplexity, device=device)
    labels = kmeans(codes, min(10, len(codes)), seed=0, device=device)[1]
    fig, axes = _figure((6, 6), 120)
    ax = axes[0, 0]
    ax.scatter(embedded[:, 0], embedded[:, 1], c=labels, cmap="tab10", s=6)
    ax.set_title("autodecoder latent space (t-SNE)")
    return _save(fig, "plots/latent_space_tsne.png")


def autoencoder_tsne(args, config):
    """Class-colored t-SNE of (V)AE codes with shape thumbnails."""
    is_variational = "classic" not in args
    device = resolve_device(config)
    model = _load_autoencoder(config, is_variational)
    voxels, labels, _ = _labeled_voxels(config, per_class=_extra_int(config, "count", 24))
    codes = _ae_encode(model, voxels)
    images = _thumbnails(voxels, [_class_color(label) for label in labels], device)
    prefix = "" if "classic" in args else "variational-"
    return create_tsne_plot(codes, images, labels, f"plots/{prefix}autoencoder-tsne.png", device)


def autodecoder_tsne(args, config):
    """t-SNE of the autodecoder latent table (a sample of ``count``)."""
    codes = checkpoints.load_array(LATENT_CODES_FILENAME, base=config.model_dir)
    count = min(_extra_int(config, "count", 1000), len(codes))
    indices = np.random.default_rng(0).choice(len(codes), count, replace=False)
    return create_tsne_plot(codes[indices], None, None, "plots/deepsdf-tsne.png",
                            resolve_device(config))


def gan_tsne(args, config):
    """t-SNE of GAN latent samples with generated-shape thumbnails."""
    wgan = "wgan" in args
    device = resolve_device(config)
    generate = _load_generator_fn(config, wgan)
    z = _gan_latents(_extra_int(config, "count", 100), 0)
    images = _thumbnails(generate(z), device=device)
    filename = "plots/wgan-images.png" if wgan else "plots/gan-images.png"
    return create_tsne_plot(z, images, None, filename, device)


def color_test(args, config):
    """One rendered shape per class in its class colour."""
    voxels, labels, names = _labeled_voxels(config, per_class=1)
    plot = ImageGrid(len(names), device=resolve_device(config))
    for label in range(len(names)):
        index = int(np.nonzero(labels == label)[0][0])
        plot.set_voxels(voxels[index], label, 0, color=_class_color(label))
    return plot.save("plots/color-test.png")


# ======================================================== AE/VAE figures


def autoencoder_results(args, config):
    model = _load_autoencoder(config, is_variational="classic" not in args)
    n = int(args[0]) if args and args[0].isdigit() else 6
    voxels = _dataset_voxels(config, n)
    recon = _ae_decode(model, _ae_encode(model, voxels))
    fig, axes = _figure((2.2 * len(voxels), 4.8), 120, 2, len(voxels))
    for col in range(len(voxels)):
        axes[0, col].imshow(_voxel_image(voxels[col]), cmap="gray", origin="lower")
        axes[1, col].imshow(_voxel_image(recon[col]), cmap="gray", origin="lower")
        axes[0, col].axis("off")
        axes[1, col].axis("off")
    axes[0, 0].set_title("input")
    axes[1, 0].set_title("reconstruction")
    fig.volumes = (voxels, recon)
    return _save(fig, "plots/autoencoder_results.png")


def autoencoder_classes(args, config):
    """One VAE reconstruction per class, class-coloured inputs."""
    model = _load_autoencoder(config, is_variational=True)
    voxels, labels, names = _labeled_voxels(config, per_class=1)
    picks = [int(np.nonzero(labels == label)[0][0]) for label in range(len(names))]
    inputs = voxels[picks]
    recon = _ae_decode(model, _ae_encode(model, inputs))
    plot = ImageGrid(len(picks), 2, device=resolve_device(config))
    for i in range(len(picks)):
        plot.set_voxels(inputs[i], i, 0, color=_class_color(i))
        plot.set_voxels(recon[i], i, 1)
    return plot.save("plots/vae-reconstruction-classes.png")


def autoencoder_examples(args, config):
    """Rows of input render | latent bar chart | reconstruction render."""
    from shapegan_tpu_torch.render.viewer import MeshRenderer

    device = resolve_device(config)
    model = _load_autoencoder(config, is_variational="classic" not in args)
    voxels = _dataset_voxels(config, _extra_int(config, "count", 8))
    codes = _ae_encode(model, voxels)
    recon = _ae_decode(model, codes)
    viewer = MeshRenderer(size=256, start_thread=False)
    fig, axs = _figure((10, 3.2 * len(voxels)), 120, len(voxels), 3)
    for i in range(len(voxels)):
        viewer.set_voxels(torch.as_tensor(voxels[i], device=device))
        axs[i, 0].imshow(viewer.get_image(crop=True))
        axs[i, 0].axis("off")
        axs[i, 1].bar(range(codes.shape[1]), codes[i])
        axs[i, 1].set_ylim((-3, 3))
        viewer.set_voxels(torch.as_tensor(recon[i], device=device))
        axs[i, 2].imshow(viewer.get_image(crop=True))
        axs[i, 2].axis("off")
    fig.volumes = (voxels, recon)
    return _save(fig, "plots/autoencoder-examples.png")


def autoencoder_examples_2(args, config):
    """Input | AE reconstruction | VAE reconstruction grid."""
    ae = _load_autoencoder(config, is_variational=False)
    vae = _load_autoencoder(config, is_variational=True)
    voxels = _dataset_voxels(config, _extra_int(config, "count", 5))
    recon_ae = _ae_decode(ae, _ae_encode(ae, voxels))
    recon_vae = _ae_decode(vae, _ae_encode(vae, voxels))
    plot = ImageGrid(len(voxels), 3, device=resolve_device(config))
    for i in range(len(voxels)):
        plot.set_voxels(voxels[i], i, 0)
        plot.set_voxels(recon_ae[i], i, 1)
        plot.set_voxels(recon_vae[i], i, 2)
    return plot.save("plots/ae-vae-examples.png")


def cosine_nearest(codes, drawn) -> np.ndarray:
    """For each drawn code, the index of the code nearest by cosine
    distance (1 - cos, clipped at 0 as scikit-learn's
    ``pairwise_distances(metric="cosine")``), computed in torch."""
    a = torch.as_tensor(np.asarray(codes), dtype=torch.float64)
    b = torch.as_tensor(np.asarray(drawn), dtype=torch.float64)
    a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-300)
    b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-300)
    distances = (1.0 - a @ b.T).clamp_min(0.0)
    return torch.argmin(distances, dim=0).numpy()


def autoencoder_generate(args, config):
    """AE / VAE random samples next to their cosine-nearest dataset codes."""
    samples = _extra_int(config, "count", 5)
    models = (_load_autoencoder(config, is_variational=False),
              _load_autoencoder(config, is_variational=True))
    voxels = _dataset_voxels(config, _extra_int(config, "pool", 128))
    rng = np.random.default_rng(0)
    plot = ImageGrid(samples, 4, device=resolve_device(config))
    plot.nearest = []
    for row, model in enumerate(models):
        codes = _ae_encode(model, voxels)
        flat = codes.reshape(-1)
        drawn = rng.normal(flat.mean(), flat.std(), (samples, LATENT_CODE_SIZE)).astype(np.float32)
        generated = _ae_decode(model, drawn)
        nearest = cosine_nearest(codes, drawn)
        plot.nearest.append(nearest)
        references = _ae_decode(model, codes[nearest])
        for i in range(samples):
            plot.set_voxels(generated[i], i, row * 2)
            plot.set_voxels(references[i], i, row * 2 + 1)
    return plot.save("plots/ae-vae-samples.png")


def autoencoder_interpolation(args, config):
    """AE + VAE latent interpolation between two dataset shapes."""
    steps = _extra_int(config, "steps", 6)
    models = (_load_autoencoder(config, is_variational=False),
              _load_autoencoder(config, is_variational=True))
    voxels = _dataset_voxels(config, 2)
    plot = ImageGrid(steps, 2, device=resolve_device(config))
    for row, model in enumerate(models):
        codes = _ae_encode(model, voxels)
        recon = _ae_decode(model, _interpolate(codes[0], codes[1], steps))
        for i in range(steps):
            plot.set_voxels(recon[i], i, row)
    return plot.save("plots/ae-vae-interpolation.png")


def autoencoder_interpolation_2(args, config):
    """VAE-only interpolation row."""
    steps = _extra_int(config, "steps", 6)
    model = _load_autoencoder(config, is_variational=True)
    codes = _ae_encode(model, _dataset_voxels(config, 2))
    recon = _ae_decode(model, _interpolate(codes[0], codes[1], steps))
    plot = ImageGrid(steps, device=resolve_device(config))
    for i in range(steps):
        plot.set_voxels(recon[i], i)
    return plot.save("plots/vae-interpolation.png")


# ============================================================ GAN figures


def gan_results(args, config):
    n = int(args[0]) if args and args[0].isdigit() else 8
    generate = _load_generator_fn(config, wgan="wgan" in args)
    voxels = generate(_gan_latents(n, 1))
    fig, axes = _figure((2.2 * n, 2.5), 120, 1, n)
    for i, ax in enumerate(axes[0]):
        ax.imshow(_voxel_image(voxels[i]), cmap="gray", origin="lower")
        ax.axis("off")
    fig.volumes = voxels
    return _save(fig, "plots/gan_results.png")


def gan_examples(args, config):
    """Rendered sample grid."""
    wgan = "wgan" in args
    count = _extra_int(config, "count", 5)
    voxels = _load_generator_fn(config, wgan)(_gan_latents(count, 0))
    plot = ImageGrid(count, device=resolve_device(config))
    for i in range(count):
        plot.set_voxels(voxels[i], i)
    return plot.save("plots/wgan-examples.png" if wgan else "plots/gan-examples.png")


def gan_interpolation(args, config):
    """Latent interpolation through the voxel GAN."""
    wgan = "wgan" in args
    steps = _extra_int(config, "steps", 6)
    generate = _load_generator_fn(config, wgan)
    ends = _gan_latents(2, 0)
    voxels = generate(_interpolate(ends[0], ends[1], steps).astype(np.float32))
    plot = ImageGrid(steps, device=resolve_device(config))
    for i in range(steps):
        plot.set_voxels(voxels[i], i)
    return plot.save("plots/wgan-interpolation.png" if wgan else "plots/gan-interpolation.png")


def _screenshot_grid(paths, filename):
    """A row of screenshots read from disk, each cropped to its content."""
    plot = ImageGrid(len(paths), create_viewer=False)
    for i, path in enumerate(paths):
        plot.set_image(crop_image(read_png(path), background=255), i)
    return plot.save(filename)


def wgan_results(args, config):
    """Grid of saved WGAN screenshots."""
    count = _extra_int(config, "count", 5)
    return _screenshot_grid([f"screenshots/wgan/{i}.png" for i in range(count)],
                            "plots/wgan-results.png")


# ===================================================== implicit-SDF figures


def _slice_figure(volumes, titles, index, filename):
    """A row of SDF slices ``volume[:, :, index].T`` in RdBu, ±0.1."""
    fig, axes = _figure((3 * len(volumes), 3), 120, 1, len(volumes))
    for ax, volume, title in zip(axes[0], volumes, titles):
        ax.imshow(volume[:, :, index].T, cmap="RdBu", vmin=-0.1, vmax=0.1, origin="lower")
        if title:
            ax.set_title(title)
        ax.axis("off")
    fig.volumes = volumes
    return _save(fig, filename)


def sdf_slices(args, config):
    n = int(args[0]) if args and args[0].isdigit() else 6
    net, codes = _load_sdf_net(config)
    rng = np.random.default_rng(0)
    volumes = [net.get_voxels(codes[rng.integers(len(codes))], voxel_resolution=64).cpu().numpy()
               for _ in range(n)]
    return _slice_figure(volumes, [None] * n, 32, "plots/sdf_slices.png")


def sdf_slice_image(mesh, resolution: int, clip: float = 0.1) -> np.ndarray:
    """The red / blue-green signed-distance cross-section x = 0 of a mesh
    scaled to the unit sphere, [resolution, resolution, 3] uint8, from the
    mesh→SDF engine."""
    from shapegan_tpu_torch.data.mesh_to_sdf import MeshSDF

    mesh = mesh.scaled_to_unit_sphere()
    ys = np.linspace(1, -1, resolution)
    zs = np.linspace(-1, 1, resolution)
    grid_y, grid_z = np.meshgrid(ys, zs, indexing="ij")
    points = np.stack([np.zeros_like(grid_y).reshape(-1), grid_y.reshape(-1), grid_z.reshape(-1)],
                      axis=1).astype(np.float32)
    sdf = MeshSDF(mesh).query(points).reshape(resolution, resolution)
    sdf = np.clip(sdf, -clip, clip) / clip
    image = np.ones((resolution, resolution, 3))
    positive, negative = sdf > 0, sdf < 0
    image[:, :, :2][positive] = (1.0 - sdf[positive])[:, np.newaxis]
    image[:, :, 1:][negative] = (1.0 + sdf[negative])[:, np.newaxis]
    image[np.abs(sdf) < 0.03] = 0
    return np.uint8(image * 255)


def sdf_slice(args, config):
    """Signed-distance cross-section of a mesh (the example chair when no
    file is given), written as ``plots/sdf_example.png``."""
    from shapegan_tpu_torch.data.mesh_io import load_mesh
    from shapegan_tpu_torch.examples import example_chair_path

    mesh = load_mesh(args[0] if args else example_chair_path(device=resolve_device(config)))
    image = sdf_slice_image(mesh, _extra_int(config, "res", 640))
    write_png("plots/sdf_example.png", image)
    print("plots/sdf_example.png")
    return image


def model_images(args, config):
    """Render dataset meshes into ``screenshots/sdf_meshes/<i>.png`` (files
    already there are kept). Args: mesh files or directories to scan for
    .obj / .stl; defaults to <data_dir>/meshes, else the example chair."""
    from shapegan_tpu_torch.data.mesh_io import load_mesh
    from shapegan_tpu_torch.examples import example_chair_path
    from shapegan_tpu_torch.render.viewer import MeshRenderer

    device = resolve_device(config)
    files = []
    for source in args or [os.path.join(config.data_dir, "meshes")]:
        if os.path.isdir(source):
            for ext in ("obj", "stl"):
                files.extend(sorted(globlib.glob(os.path.join(source, f"**/*.{ext}"), recursive=True)))
        elif os.path.isfile(source):
            files.append(source)
    if not files:
        files = [example_chair_path(device=device)]
    ensure_directory("screenshots/sdf_meshes")
    viewer = MeshRenderer(size=_extra_int(config, "res", 400), start_thread=False)
    written = []
    for index, filename in enumerate(files):
        out = f"screenshots/sdf_meshes/{index}.png"
        if os.path.isfile(out):
            continue
        viewer.set_mesh(load_mesh(filename), center_and_scale=True)
        write_png(out, viewer.get_image())
        print(out)
        written.append(out)
    return written


def sdf_net_reconstruction(args, config):
    """Dataset mesh render | autodecoder raymarch reconstruction pairs (the
    mesh images come from ``model_images`` when present)."""
    from shapegan_tpu_torch.render.raymarching import render_image_for_index

    net, codes = _load_sdf_net(config)
    count = min(_extra_int(config, "count", 5), len(codes))
    res = _extra_int(config, "res", 400)
    indices = np.random.default_rng(0).choice(len(codes), count, replace=False)
    have_mesh_images = all(os.path.isfile(f"screenshots/sdf_meshes/{i}.png") for i in indices)
    plot = ImageGrid(count, 2 if have_mesh_images else 1, create_viewer=False)
    for column, index in enumerate(indices):
        row = 0
        if have_mesh_images:
            plot.set_image(crop_image(read_png(f"screenshots/sdf_meshes/{index}.png"),
                                      background=255), column, 0)
            row = 1
        plot.set_image(render_image_for_index(net, codes, int(index), crop=True, resolution=res),
                       column, row)
    return plot.save("plots/deepsdf-reconstruction.png")


def _render_opts(config):
    """Raymarch quality knobs from extras (1000 iterations, ssaa 2)."""
    return dict(iterations=_extra_int(config, "iterations", 1000), ssaa=_extra_int(config, "ssaa", 2))


def _render_codes(net, codes, **render_kw):
    """Raymarch a list of codes into uint8 frames on the net's device."""
    from shapegan_tpu_torch.render.raymarching import render_image_sequence

    return render_image_sequence(net, [np.asarray(c, np.float32) for c in codes], **render_kw)


def _frame_grid(frames, filename):
    plot = ImageGrid(len(frames), create_viewer=False)
    for i, image in enumerate(frames):
        plot.set_image(image, i)
    return plot.save(filename)


def sdf_net_interpolation(args, config):
    """Raymarched interpolation between two latent-table codes."""
    net, codes = _load_sdf_net(config)
    steps = _extra_int(config, "steps", 6)
    indices = np.random.default_rng(0).choice(len(codes), 2, replace=False)
    interpolated = _interpolate(codes[indices[0]], codes[indices[1]], steps)
    plot = _frame_grid(_render_codes(net, interpolated, resolution=_extra_int(config, "res", 400),
                                     crop=True, **_render_opts(config)),
                       "plots/deepsdf-interpolation.png")
    plot.codes = interpolated
    return plot


def sdf_net_sample(args, config):
    """Raymarched samples drawn from the latent table's fitted Normal."""
    net, codes = _load_sdf_net(config)
    count = _extra_int(config, "count", 5)
    flat = codes.reshape(-1)
    mean, std = float(flat.mean()), float(flat.var() ** 0.5)
    print("mean:", mean, "std:", std)
    drawn = np.random.default_rng(0).normal(mean, std, (count, LATENT_CODE_SIZE)).astype(np.float32)
    plot = _frame_grid(_render_codes(net, drawn, resolution=_extra_int(config, "res", 400),
                                     crop=True, **_render_opts(config)),
                       "plots/deepsdf-samples.png")
    plot.codes = drawn
    return plot


# ========================================================= hybrid figures

# The hybrid GAN's outputs are rendered with an enlarged trace sphere and a
# small SDF offset (its generator is trained on raw, un-rescaled SDF volumes).
_HYBRID_RENDER = dict(radius=1.6, sdf_offset=-0.045, vertical_cutoff=1, crop=True)


def hybrid_gan(args, config):
    """Raymarched samples from the hybrid GAN's implicit generator."""
    net, _ = _load_sdf_net(config, filename="hybrid_gan_generator")
    count = _extra_int(config, "count", 5)
    codes = np.random.default_rng(0).normal(size=(count, LATENT_CODE_SIZE)).astype(np.float32)
    plot = _frame_grid(_render_codes(net, codes, resolution=_extra_int(config, "res", 400),
                                     **_HYBRID_RENDER, **_render_opts(config)),
                       "plots/hybrid-gan-samples.png")
    plot.codes = codes
    return plot


def hybrid_gan_interpolation(args, config):
    """Render candidate shapes (``plots/option-<i>.png``), then interpolate
    between two chosen ones (indices from args, else 0 and 1)."""
    net, _ = _load_sdf_net(config, filename="hybrid_gan_generator")
    options = _extra_int(config, "options", 10)
    steps = _extra_int(config, "steps", 6)
    res = _extra_int(config, "res", 400)
    codes = np.random.default_rng(0).normal(size=(options, LATENT_CODE_SIZE)).astype(np.float32)
    numeric = [a for a in args if a.isdigit()]
    if len(numeric) >= 2:
        start, end = int(numeric[0]), int(numeric[1])
    else:
        for i, image in enumerate(_render_codes(net, codes, resolution=min(res, 200),
                                                **_HYBRID_RENDER, **_render_opts(config))):
            write_png(f"plots/option-{i}.png", image)
            print(f"plots/option-{i}.png")
        start, end = 0, 1
        print(f"no start/end indices given — using {start} and {end} "
              f"(pass e.g. `hybrid_gan_interpolation 3 7`)")
    interpolated = _interpolate(codes[start], codes[end], steps)
    plot = _frame_grid(_render_codes(net, interpolated, resolution=res, **_HYBRID_RENDER,
                                     **_render_opts(config)),
                       "plots/hybrid-gan-interpolation.png")
    plot.codes = interpolated
    return plot


def hybrid_gan_upscaling(args, config):
    """One latent as a 32^3 grid, that grid zoomed x4 (``scipy.ndimage.zoom``),
    a real ``voxel_res`` (128) evaluation, and the raymarched frame."""
    import scipy.ndimage

    from shapegan_tpu_torch.render.raymarching import render_image

    net, _ = _load_sdf_net(config, filename="hybrid_gan_generator")
    high_res = _extra_int(config, "voxel_res", 128)
    code = np.random.default_rng(0).normal(size=(LATENT_CODE_SIZE,)).astype(np.float32)
    plot = ImageGrid(4, device=net.device)
    voxels_32 = net.get_voxels(code, voxel_resolution=32, sphere_only=False).cpu().numpy()
    plot.set_voxels(voxels_32, 0)
    upscaled = scipy.ndimage.zoom(voxels_32[1:-2, 1:-2, 1:-2], 4)
    plot.set_voxels(np.pad(upscaled, 1, mode="constant", constant_values=1), 1)
    plot.set_voxels(net.get_voxels(code, voxel_resolution=high_res, sphere_only=False).cpu().numpy(), 2)
    plot.set_image(render_image(net, code, resolution=_extra_int(config, "res", 400), **_HYBRID_RENDER,
                                **_render_opts(config)), 3)
    plot.code = code
    return plot.save("plots/hybrid-gan-upscaling.png")


# ===================================================== checkpoint evolution


def checkpoint_evolution(args, config):
    epochs = _epochs(config, "sdf_net")
    volumes = []
    for epoch in epochs:
        net, codes = _load_sdf_net(config, epoch=epoch)
        volumes.append(net.get_voxels(codes[0], voxel_resolution=48).cpu().numpy())
    return _slice_figure(volumes, [f"epoch {epoch}" for epoch in epochs], 24,
                         "plots/checkpoint_evolution.png")


def _spread_epochs(epochs, count):
    if len(epochs) <= count:
        return epochs
    if count == 1:
        return [epochs[-1]]
    return [epochs[i * (len(epochs) - 1) // (count - 1)] for i in range(count)]


def vae_checkpoints(args, config):
    """One dataset shape reconstructed by successive VAE epoch snapshots."""
    name = f"variational-autoencoder-{LATENT_CODE_SIZE}"  # Autoencoder.checkpoint_name
    epochs = _spread_epochs(_epochs(config, name), _extra_int(config, "count", 5))
    voxels = _dataset_voxels(config, 1)
    plot = ImageGrid(len(epochs), device=resolve_device(config))
    for i, epoch in enumerate(epochs):
        model = _load_autoencoder(config, is_variational=True, epoch=epoch)
        plot.set_voxels(_ae_decode(model, _ae_encode(model, voxels))[0], i)
    return plot.save("plots/vae-checkpoints.png")


def sdf_checkpoints(args, config):
    """One latent code raymarched through successive autodecoder snapshots."""
    from shapegan_tpu_torch.render.raymarching import render_image

    epochs = _spread_epochs(_epochs(config, "sdf_net"), _extra_int(config, "count", 5))
    res = _extra_int(config, "res", 400)
    index = _extra_int(config, "index", 0)
    plot = ImageGrid(len(epochs), create_viewer=False)
    for i, epoch in enumerate(epochs):
        net, codes = _load_sdf_net(config, epoch=epoch)
        plot.set_image(render_image(net, codes[index], resolution=res, crop=True,
                                    **_render_opts(config)), i)
    return plot.save("plots/deepsdf-checkpoints.png")


# ================================================== screenshots & exports


def shapenet_errors(args, config):
    """Grid of data-preparation failure screenshots."""
    count = _extra_int(config, "count", 6)
    return _screenshot_grid([f"screenshots/errors/error-{i + 1}.png" for i in range(count)],
                            "plots/errors.png")


def raymarch_examples(args, config):
    from shapegan_tpu_torch.render.raymarching import render_image_for_index

    n = int(args[0]) if args and args[0].isdigit() else 4
    net, codes = _load_sdf_net(config)
    frames = []
    for i in range(min(n, len(codes))):
        frames.append(render_image_for_index(net, codes, i, resolution=_extra_int(config, "res", 400)))
        print(f"rendered example {i}")
    return frames


def export_stl(args, config):
    n = int(args[0]) if args and args[0].isdigit() else 4
    net, codes = _load_sdf_net(config)
    ensure_directory("plots/stl")
    rng = np.random.default_rng(0)
    written = []
    for i in range(n):
        mesh = net.get_mesh(codes[rng.integers(len(codes))], voxel_resolution=64)
        if mesh is not None:
            path = f"plots/stl/shape_{i}.stl"
            mesh.weld().save(path)
            print(path)
            written.append(path)
    return written


def deepsdf_interpolation_stl(args, config):
    """High-resolution meshes along a latent interpolation, as STL."""
    net, codes = _load_sdf_net(config)
    steps = _extra_int(config, "steps", 5)
    voxel_res = _extra_int(config, "voxel_res", 256)
    indices = np.random.default_rng(0).choice(len(codes), 2, replace=False)
    interpolated = _interpolate(codes[indices[0]], codes[indices[1]], steps)
    written = []
    for i in range(steps):
        mesh = net.get_mesh(interpolated[i], voxel_resolution=voxel_res, sphere_only=False)
        if mesh is not None:
            path = f"plots/mesh-{i}.stl"
            mesh.weld().save(path)
            print(path)
            written.append(path)
    return written


RECIPES = {
    "training_curves": training_curves,
    "autoencoder_training": autoencoder_training,
    "wgan_training": wgan_training,
    "sdf_training": sdf_training,
    "latent_distribution": latent_distribution,
    "autoencoder_hist": autoencoder_hist,
    "autodecoder_hist": autodecoder_hist,
    "tsne": tsne,
    "autoencoder_tsne": autoencoder_tsne,
    "autodecoder_tsne": autodecoder_tsne,
    "gan_tsne": gan_tsne,
    "color_test": color_test,
    "autoencoder_results": autoencoder_results,
    "autoencoder_classes": autoencoder_classes,
    "autoencoder_examples": autoencoder_examples,
    "autoencoder_examples_2": autoencoder_examples_2,
    "autoencoder_generate": autoencoder_generate,
    "autoencoder_interpolation": autoencoder_interpolation,
    "autoencoder_interpolation_2": autoencoder_interpolation_2,
    "gan_results": gan_results,
    "gan_examples": gan_examples,
    "gan_interpolation": gan_interpolation,
    "wgan_results": wgan_results,
    "sdf_slices": sdf_slices,
    "sdf_slice": sdf_slice,
    "voxel_occupancy": voxel_occupancy,
    "model_images": model_images,
    "sdf_net_reconstruction": sdf_net_reconstruction,
    "sdf_net_interpolation": sdf_net_interpolation,
    "sdf_net_sample": sdf_net_sample,
    "hybrid_gan": hybrid_gan,
    "hybrid_gan_interpolation": hybrid_gan_interpolation,
    "hybrid_gan_upscaling": hybrid_gan_upscaling,
    "checkpoint_evolution": checkpoint_evolution,
    "vae_checkpoints": vae_checkpoints,
    "sdf_checkpoints": sdf_checkpoints,
    "shapenet_errors": shapenet_errors,
    "raymarch_examples": raymarch_examples,
    "export_stl": export_stl,
    "deepsdf_interpolation_stl": deepsdf_interpolation_stl,
}

# The original repository's hyphenated argv names.
ALIASES = {
    "color-test": "color_test",
    "autoencoder-classes": "autoencoder_classes",
    "autodecoder-classes": "autoencoder_classes",
    "autoencoder": "autoencoder_tsne",
    "wgan-results": "wgan_results",
    "shapenet-errors": "shapenet_errors",
    "deepsdf-interpolation-stl": "deepsdf_interpolation_stl",
}


def main(argv: Optional[List[str]] = None):
    """Run one recipe; returns what it drew (None for an unknown name,
    after printing the list)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    recipe = ALIASES.get(argv[0], argv[0]) if argv else None
    if recipe not in RECIPES:
        print(__doc__)
        print("available recipes:", ", ".join(RECIPES))
        return None
    config = parse_cli(argv[1:])
    resolve_device(config)  # no card and no 'cpu': fail before any work
    ensure_directory("plots")
    args = [a for a in argv[1:] if "=" not in a and a != "cpu"]
    return RECIPES[recipe](args, config)


if __name__ == "__main__":
    main()
