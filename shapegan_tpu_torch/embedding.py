"""t-SNE and k-means of a latent table, in torch on the given device (what
``demo_latent_space.py`` asks of scikit-learn, which the card's machine
does not have).

:func:`tsne` is exact t-SNE with the defaults of ``sklearn.manifold.TSNE``:
squared Euclidean input distances, a per-row precision found by binary
search to the perplexity (100 steps, entropy tolerance 1e-5), the
symmetrised and normalised joint P, a PCA start scaled to a standard
deviation of 1e-4 on its first axis, a Student-t kernel with one degree of
freedom, 250 iterations at early exaggeration 12 and momentum 0.5, then
momentum 0.8 up to 1000 iterations, learning rate ``max(N / 12 / 4, 50)``,
per-coordinate gains (+0.2 / x0.8, floor 0.01), and scikit-learn's
stopping checks every 50 iterations. It is exact, O(N^2) in memory and
time (scikit-learn's default Barnes-Hut approximates the same gradient),
and runs in float64. The PCA start is an exact SVD, so the embedding needs
no seed.

:func:`kmeans` is k-means++ seeding (scikit-learn's greedy variant, 2 +
log k candidates a centre), then Lloyd's iterations to convergence, the
best of ``n_init`` runs by inertia; a cluster left empty is re-seeded at
the point farthest from its centre.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

MACHINE_EPSILON = float(np.finfo(np.float64).eps)
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERATIONS = 250
CHECK_EVERY = 50
MIN_GRAD_NORM = 1e-7
MAX_ITERATIONS = 1000
LLOYD_ITERATIONS = 300
PERPLEXITY_STEPS = 100
ENTROPY_TOLERANCE = 1e-5


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances [N, N] between the rows of ``x``, zero
    on the diagonal."""
    sq = (x * x).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * x @ x.T).clamp_min(0.0)
    return d.fill_diagonal_(0.0)


def conditional_probabilities(distances: torch.Tensor, perplexity: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P [N, N], perplexity [N]): each row's Gaussian conditional
    probabilities over the other rows, its precision found by scikit-learn's
    binary search (start 1, doubled or halved until bracketed, then
    bisected; a row stops once its entropy is within 1e-5 of
    ``log(perplexity)``), and the perplexity each row reached. The distances
    are shifted by each row's nearest neighbour first, which leaves P and
    the entropy unchanged and keeps the exponentials from underflowing."""
    n = distances.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=distances.device)
    d = distances - torch.where(off, distances, math.inf).min(1, keepdim=True).values
    d = torch.where(off, d, 0.0)
    beta = torch.ones(n, dtype=d.dtype, device=d.device)
    low = torch.full_like(beta, -math.inf)
    high = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=d.device)
    probabilities = torch.zeros_like(d)
    entropy = torch.zeros_like(beta)
    target = math.log(perplexity)
    for _ in range(PERPLEXITY_STEPS):
        p = torch.exp(-d * beta[:, None]) * off
        total = p.sum(1)
        total = torch.where(total == 0.0, 1e-8, total)
        p = p / total[:, None]
        h = torch.log(total) + beta * (d * p).sum(1)
        probabilities = torch.where(active[:, None], p, probabilities)
        entropy = torch.where(active, h, entropy)
        excess = h - target
        active = active & (excess.abs() > ENTROPY_TOLERANCE)
        if not bool(active.any()):
            break
        up = active & (excess > 0)    # too flat: raise the precision
        down = active & (excess <= 0)
        low = torch.where(up, beta, low)
        high = torch.where(down, beta, high)
        beta = torch.where(up, torch.where(torch.isinf(high), beta * 2.0, (beta + high) / 2.0),
                           beta)
        beta = torch.where(down, torch.where(torch.isinf(low), beta / 2.0, (beta + low) / 2.0),
                           beta)
    return probabilities, torch.exp(entropy)


def joint_probabilities(distances: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetric joint P [N, N] of t-SNE: the conditionals plus their
    transpose, over their sum, floored at machine epsilon off the
    diagonal (zero on it)."""
    conditional, _ = conditional_probabilities(distances, perplexity)
    p = conditional + conditional.T
    p = (p / max(float(p.sum()), MACHINE_EPSILON)).clamp_min(MACHINE_EPSILON)
    return p.fill_diagonal_(0.0)


def kl_and_gradient(y: torch.Tensor, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """KL(P || Q) and its gradient [N, 2] for the embedding ``y``, Q the
    normalised Student-t kernel with one degree of freedom."""
    w = 1.0 / (1.0 + squared_distances(y))
    w = w.fill_diagonal_(0.0)
    q = (w / w.sum()).clamp_min(MACHINE_EPSILON).fill_diagonal_(0.0)
    off = p > 0
    kl = torch.where(off, p * torch.log(p.clamp_min(MACHINE_EPSILON) / q.clamp_min(MACHINE_EPSILON)),
                     0.0).sum()
    pqd = (p - q) * w
    grad = 4.0 * (y * pqd.sum(1, keepdim=True) - pqd @ y)
    return kl, grad


def pca_start(x: torch.Tensor) -> torch.Tensor:
    """The first two principal components of ``x`` (scikit-learn's signs:
    each axis's largest loading positive), scaled so the first has a
    standard deviation of 1e-4."""
    centred = x - x.mean(0)
    vt = torch.linalg.svd(centred, full_matrices=False).Vh
    vt = vt[:2]
    signs = torch.sign(vt.gather(1, vt.abs().argmax(1, keepdim=True)))
    y = (centred @ vt.T) * signs.T
    return y / y[:, 0].std(unbiased=False) * 1e-4


def _descend(y, p, iterations, start, momentum, learning_rate, patience):
    """scikit-learn's ``_gradient_descent``: gains and momentum from zero;
    every 50th iteration (and the last) the KL is read, and the run stops
    early when it has not improved for ``patience`` iterations or the
    gradient's norm falls to 1e-7. Returns (y, KL, last iteration)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error, best_error, best_iter = math.inf, math.inf, start
    i = start
    for i in range(start, iterations):
        check = (i + 1) % CHECK_EVERY == 0
        kl, grad = kl_and_gradient(y, p)
        increase = update * grad < 0.0
        gains = torch.where(increase, gains + 0.2, gains * 0.8).clamp_min(0.01)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check or i == iterations - 1:
            error = float(kl)
        if check:
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > patience:
                break
            if float(torch.linalg.norm(grad)) <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(codes, perplexity: float = 30.0, device="cpu") -> Tuple[np.ndarray, float]:
    """Exact t-SNE of ``codes`` [N, D] into 2-D: (embedding [N, 2] float32
    numpy, the final KL divergence)."""
    x = torch.as_tensor(np.asarray(codes), dtype=torch.float64, device=device)
    n = x.shape[0]
    if not 0 < perplexity < n:
        raise ValueError(f"perplexity {perplexity} must lie in (0, {n})")
    p = joint_probabilities(squared_distances(x), perplexity)
    learning_rate = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    y = pca_start(x)
    y, _, it = _descend(y, p * EARLY_EXAGGERATION, EXPLORATION_ITERATIONS, 0, 0.5,
                        learning_rate, EXPLORATION_ITERATIONS)
    y, kl, _ = _descend(y, p, MAX_ITERATIONS, it + 1, 0.8, learning_rate, 300)
    return y.float().cpu().numpy(), kl


def _plus_plus(x: torch.Tensor, k: int, rng: np.random.Generator) -> torch.Tensor:
    """Greedy k-means++ seeding: each new centre is the best of 2 + log k
    candidates drawn in proportion to the squared distance to the nearest
    centre so far."""
    n = x.shape[0]
    trials = 2 + int(math.log(k))
    centres = [x[int(rng.integers(n))]]
    closest = ((x - centres[0]) ** 2).sum(1)
    for _ in range(1, k):
        potential = float(closest.sum())
        cumulative = torch.cumsum(closest, 0).cpu().numpy()
        picks = np.searchsorted(cumulative, rng.uniform(size=trials) * potential)
        picks = torch.as_tensor(np.minimum(picks, n - 1), device=x.device)
        candidate = torch.minimum(closest[None, :], _squared_to(x, x[picks]).T)
        best = int(candidate.sum(1).argmin())
        centres.append(x[picks[best]])
        closest = candidate[best]
    return torch.stack(centres)


def _squared_to(x: torch.Tensor, centres: torch.Tensor) -> torch.Tensor:
    """Squared distances [N, K] from the rows of ``x`` to ``centres``."""
    return ((x * x).sum(1, keepdim=True) - 2.0 * x @ centres.T
            + (centres * centres).sum(1)[None, :]).clamp_min(0.0)


def _lloyd(x: torch.Tensor, centres: torch.Tensor, tol: float):
    """Lloyd's iterations from ``centres`` until the labels stop changing or
    the centres move by at most ``tol`` (squared, summed); an empty
    cluster takes the point farthest from its centre. Returns (centres,
    labels, inertia) with the labels of the final centres."""
    k = centres.shape[0]
    labels = None
    for _ in range(LLOYD_ITERATIONS):
        new_labels = _squared_to(x, centres).argmin(1)
        if labels is not None and torch.equal(new_labels, labels):
            break
        labels = new_labels
        counts = torch.bincount(labels, minlength=k)
        sums = torch.zeros_like(centres).index_add_(0, labels, x)
        moved = sums / counts.clamp_min(1)[:, None].to(x.dtype)
        for empty in torch.nonzero(counts == 0).flatten().tolist():
            far = int(((x - moved[labels]) ** 2).sum(1).argmax())
            moved[empty] = x[far]
            labels = labels.clone()
            labels[far] = empty
        shift = float(((moved - centres) ** 2).sum())
        centres = moved
        if shift <= tol:
            break
    distances = _squared_to(x, centres)
    labels = distances.argmin(1)
    inertia = float(distances.gather(1, labels[:, None]).sum())
    return centres, labels, inertia


def kmeans(codes, k: int, seed: int = 0, n_init: int = 10, device="cpu"
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """k-means of ``codes`` [N, D] into ``k`` clusters: (centres [k, D]
    float32, labels [N] int64, inertia), the best of ``n_init`` k-means++
    starts drawn from ``default_rng(seed)``."""
    x = torch.as_tensor(np.asarray(codes), dtype=torch.float64, device=device)
    if not 0 < k <= x.shape[0]:
        raise ValueError(f"k={k} must lie in [1, {x.shape[0]}]")
    rng = np.random.default_rng(seed)
    tol = 1e-4 * float(x.var(0, unbiased=False).mean())
    best = None
    for _ in range(n_init):
        run = _lloyd(x, _plus_plus(x, k, rng), tol)
        if best is None or run[2] < best[2]:
            best = run
    centres, labels, inertia = best
    return centres.float().cpu().numpy(), labels.cpu().numpy(), inertia
