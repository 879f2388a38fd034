"""The port's t-SNE and k-means (shapegan_tpu_torch.embedding), the scatter
panel, and the latent-space demo's tour and cursor, held against what the
JAX package's ``demo_latent_space.py`` calls: scikit-learn's ``TSNE`` and
``KMeans``, matplotlib's ``tab10`` mapping, and the demo's own statements
(demo_latent_space.py:55-69), on the same numpy inputs; and the demo's
entry point end to end on the CPU."""

import os

import matplotlib
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans
from sklearn.manifold import TSNE, trustworthiness

from shapegan_tpu_torch import checkpoints, demo_latent_space, embedding
from shapegan_tpu_torch.demo_latent_space import cursor, greedy_tour
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.models import LATENT_CODES_FILENAME
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.render.panel import ScatterPanel, tab10_colours
from shapegan_tpu_torch.render.png import read_png
from shapegan_tpu_torch.render.raymarching import render_image

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "shapegan_tpu", "examples")
# Each row's perplexity after the binary search (entropy tolerance 1e-5:
# read <= 2e-4 at perplexity 19.7).
PERPLEXITY_ATOL = 1e-3
# Final KL against scikit-learn's exact t-SNE from the same PCA start (read
# 1.05x on the 8 codes, 0.995x on the blobs: float64 here, float32 there).
KL_RATIO, KL_SLACK = 1.1, 0.02
# Trustworthiness (k = 5) on the blobs (read 0.9643 against 0.965).
TRUST_SLACK = 0.05
# k-means inertia against scikit-learn's best of 10 (read equal).
INERTIA_RATIO = 1.001


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _codes():
    """The bundled autodecoder's latent table: 8 codes of 128."""
    with np.load(os.path.join(EXAMPLES, "sdf_net_latent_codes.npz")) as data:
        return data["array"].astype(np.float32)


def _blobs():
    """60 points in 3 separated blobs of 20, in 10-D."""
    rng = np.random.default_rng(0)
    return np.concatenate([rng.normal(c, 1.0, (20, 10)) for c in (0, 6, 12)]).astype(np.float32)


def _perplexity(n):
    """demo_latent_space.py:45."""
    return min(30.0, max(2.0, (n - 1) / 3))


@pytest.mark.parametrize("which", ["codes", "blobs"])
def test_binary_search_reaches_the_perplexity(which):
    x = _codes() if which == "codes" else _blobs()
    target = _perplexity(len(x))
    distances = embedding.squared_distances(torch.tensor(x, dtype=torch.float64))
    p, perplexity = embedding.conditional_probabilities(distances, target)
    assert torch.allclose(p.sum(1), torch.ones(len(x), dtype=torch.float64))
    assert float(p.diagonal().abs().max()) == 0.0
    assert float((perplexity - target).abs().max()) <= PERPLEXITY_ATOL
    # The perplexity from the rows themselves: exp of their entropy.
    entropy = -(p * torch.log(p.clamp_min(1e-300))).sum(1)
    assert float((torch.exp(entropy) - target).abs().max()) <= PERPLEXITY_ATOL


@pytest.mark.parametrize("which", ["codes", "blobs"])
def test_tsne_against_sklearn_exact(which):
    x = _codes() if which == "codes" else _blobs()
    perplexity = _perplexity(len(x))
    embedded, kl = embedding.tsne(x, perplexity)
    reference = TSNE(n_components=2, perplexity=perplexity, method="exact", init="pca",
                     random_state=0).fit(x)
    assert embedded.shape == (len(x), 2) and embedded.dtype == np.float32
    assert np.isfinite(embedded).all()
    assert kl <= KL_RATIO * reference.kl_divergence_ + KL_SLACK, (kl, reference.kl_divergence_)
    if which == "blobs":
        ours = trustworthiness(x, embedded, n_neighbors=5)
        theirs = trustworthiness(x, reference.embedding_, n_neighbors=5)
        assert ours >= theirs - TRUST_SLACK, (ours, theirs)
    again, kl_again = embedding.tsne(x, perplexity)
    np.testing.assert_array_equal(embedded, again)
    with pytest.raises(ValueError, match="perplexity"):
        embedding.tsne(x[:2], 2.0)


@pytest.mark.parametrize("which, k", [("codes", 3), ("codes", 8), ("blobs", 3)])
def test_kmeans_against_sklearn(which, k):
    x = _codes() if which == "codes" else _blobs()
    centres, labels, inertia = embedding.kmeans(x, k, seed=0)
    reference = KMeans(n_clusters=k, random_state=0, n_init=10).fit(x)
    assert centres.shape == (k, x.shape[1]) and labels.shape == (len(x),)
    assert inertia <= INERTIA_RATIO * reference.inertia_ + 1e-12, (inertia, reference.inertia_)
    # The inertia is that of the returned centres and labels.
    recomputed = float(((x.astype(np.float64) - centres[labels]) ** 2).sum())
    assert abs(recomputed - inertia) <= 1e-5 * max(inertia, 1e-12) + 1e-9
    if which == "blobs" or k == len(x):  # the same partition
        pairs = set(zip(labels.tolist(), reference.labels_.tolist()))
        assert len(pairs) == k == len(set(labels.tolist()))


def test_kmeans_reseeds_an_empty_cluster():
    """Two centres on one point leave a cluster empty after the first
    assignment; it is re-seeded at the point farthest from its centre."""
    x = torch.tensor([[0.0], [0.1], [10.0], [10.1]], dtype=torch.float64)
    centres, labels, inertia = embedding._lloyd(x, torch.tensor([[0.0], [0.0]], dtype=torch.float64),
                                                tol=0.0)
    assert sorted(centres[:, 0].tolist()) == pytest.approx([0.05, 10.05])
    assert len(set(labels.tolist())) == 2 and inertia == pytest.approx(0.01)


def _jax_demo_tour(centers):
    """demo_latent_space.py:55-62, as it stands."""
    order = [0]
    remaining = set(range(1, len(centers)))
    while remaining:
        last = centers[order[-1]]
        nxt = min(remaining, key=lambda i: np.linalg.norm(centers[i] - last))
        order.append(nxt)
        remaining.discard(nxt)
    return order


def test_greedy_tour_and_cursor_match_the_demo():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 10):
        centres = rng.normal(size=(n, 16))
        assert greedy_tour(centres) == _jax_demo_tour(centres)
    ties = np.array([[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0]])
    assert greedy_tour(ties) == _jax_demo_tour(ties)
    codes = rng.normal(size=(12, 8))
    embedded = rng.normal(size=(12, 2))
    for code in rng.normal(size=(5, 8)):
        # demo_latent_space.py:66-69
        want = embedded[np.argmin(np.linalg.norm(codes - code, axis=1))]
        np.testing.assert_array_equal(cursor(codes, embedded, code), want)


@pytest.mark.parametrize("k", [1, 3, 8, 10])
def test_panel_colours_match_matplotlib_tab10(k):
    labels = np.arange(k).repeat(2)
    cmap = matplotlib.colormaps["tab10"]
    want = cmap(matplotlib.colors.Normalize()(labels))[:, :3]
    np.testing.assert_allclose(tab10_colours(labels), want, atol=1e-12)


def test_scatter_panel_draws_points_and_cursor():
    points = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [1.0, 2.0]])
    panel = ScatterPanel(points, np.arange(4), 100)
    assert panel.image.shape == (100, 100, 3) and panel.image.dtype == np.uint8
    corners = panel.pixels(points).round().astype(int)
    for (row, col), colour in zip(corners, tab10_colours(np.arange(4))):
        want = np.round((1 - 0.6) * 255 + 0.6 * colour * 255)
        np.testing.assert_allclose(panel.image[row, col], want, atol=1)
    assert corners[0, 0] > corners[2, 0] and corners[1, 1] > corners[0, 1]  # y up, x right
    assert (panel.image == 255).all(axis=2).mean() > 0.95  # white elsewhere
    marked = panel.with_cursor(np.array([0.5, 1.0]))
    row, col = panel.pixels(np.array([0.5, 1.0]))[0].round().astype(int)
    assert (marked[row, col] == 0).all() and (marked[row - 2, col - 2] == 0).all()
    assert (marked[row, col + 2] == 255).all()
    assert (panel.image[row, col] == 255).all()  # the panel itself is unchanged


def test_demo_latent_space_writes_the_tour(tmp_path, monkeypatch):
    """The octahedron and a 4-row code table at 24^2, one frame a
    transition: 4 frames [24, 48, 3], the left half the frame of its path
    code; a second run skips them."""
    monkeypatch.chdir(tmp_path)
    params = octahedron_params()
    checkpoints.save(params, "sdf_net", base="models")
    codes = np.random.default_rng(6).normal(0, 0.1, (4, 128)).astype(np.float32)
    checkpoints.save_array(codes, LATENT_CODES_FILENAME, base="models")
    out = demo_latent_space.main(["cpu", "resolution=24", "frames_per_transition=1"])
    frames = sorted(os.listdir(demo_latent_space.OUT_DIR))
    assert frames == [f"frame-{i:05d}.png" for i in range(4)] and len(out["path"]) == 4
    assert out["embedded"].shape == (4, 2) and sorted(out["labels"].tolist()) == [0, 1, 2, 3]
    image = read_png(os.path.join(demo_latent_space.OUT_DIR, frames[1]))
    assert image.shape == (24, 48, 3)
    want = render_image(SDFNet(sdf_mlp.params_from_jax(params)), out["path"][1].astype(np.float32),
                         resolution=24, ssaa=1, iterations=400)
    np.testing.assert_array_equal(image[:, :24], want)
    assert (image[:, 24:] == 0).all(axis=2).any()  # the cursor
    assert all(0.05 < c < 0.6 for c in out["coverage"])
    again = demo_latent_space.main(["cpu", "resolution=24", "frames_per_transition=1"])
    assert again["coverage"] == []
