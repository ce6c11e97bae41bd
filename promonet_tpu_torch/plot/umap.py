"""A small UMAP (McInnes et al., 2018) for speaker-cluster plots
(counterpart of `promonet_tpu/plot/umap.py`)

A copy of the JAX package's numpy implementation, kept float64 on the
host: the layout is a plot-sized, host-only algorithm, and on the same
input and `random_state` this copy gives exactly the JAX package's
output, which a port to tensors would not. The steps:

1. kNN graph with per-point connectivity calibration: rho_i is the
   distance to the nearest neighbor, sigma_i solves
   sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k) by bisection.
2. Fuzzy-union symmetrization  w = w + w' - w w'.
3. Spectral initialization from the normalized graph Laplacian.
4. SGD layout: attractive updates along edges sampled by weight,
   repulsive updates against uniform negatives, with the standard
   rational curve  phi(d) = 1 / (1 + a d^(2b))  fit to min_dist.

Deterministic for a fixed seed (`np.random.default_rng(random_state)`).
Dense O(N^2) neighbor search: fine for hundreds of embeddings, not a
general-purpose UMAP.
"""
import numpy as np


def _fit_curve(min_dist, spread=1.0):
    """Least-squares fit of a, b so 1/(1+a d^(2b)) matches the target

    Target: 1 for d <= min_dist, exp(-(d - min_dist)/spread) beyond —
    the same curve umap-learn fits with scipy.optimize.curve_fit.
    """
    d = np.linspace(0, 3 * spread, 300)[1:]
    target = np.where(
        d <= min_dist, 1., np.exp(-(d - min_dist) / spread))
    best, best_err = (1.577, 0.8951), np.inf
    for a in np.linspace(0.5, 3.0, 60):
        for b in np.linspace(0.5, 1.5, 60):
            err = np.square(1. / (1. + a * d ** (2 * b)) - target).sum()
            if err < best_err:
                best, best_err = (float(a), float(b)), err
    return best


def _membership_strengths(distances, indices, k):
    """Per-point calibrated edge weights (rho/sigma smoothing)"""
    n = distances.shape[0]
    target = np.log2(k)
    rho = distances[:, 0]
    sigma = np.ones(n)
    for i in range(n):
        lo, hi = 1e-8, 1e4
        d = np.maximum(distances[i] - rho[i], 0.)
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            if np.exp(-d / mid).sum() > target:
                hi = mid
            else:
                lo = mid
        sigma[i] = 0.5 * (lo + hi)
    weights = np.exp(
        -np.maximum(distances - rho[:, None], 0.) / sigma[:, None])
    return weights


def _spectral_init(graph, n_components, rng):
    """Eigenvectors 1..n of the symmetric normalized Laplacian"""
    degree = np.asarray(graph.sum(axis=1)).reshape(-1)
    inv_sqrt = 1. / np.sqrt(np.maximum(degree, 1e-12))
    laplacian = np.eye(len(degree)) - (
        inv_sqrt[:, None] * graph * inv_sqrt[None, :])
    values, vectors = np.linalg.eigh(laplacian)
    embedding = vectors[:, 1:n_components + 1]
    scale = 10. / max(np.abs(embedding).max(), 1e-12)
    return embedding * scale + rng.normal(
        0, 1e-4, embedding.shape)


class UMAP:
    """Drop-in for umap.UMAP().fit_transform at plot scales"""

    def __init__(
        self,
        n_neighbors=15,
        min_dist=0.1,
        n_components=2,
        n_epochs=300,
        negative_sample_rate=5,
        learning_rate=1.0,
        random_state=0,
    ):
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.n_components = n_components
        self.n_epochs = n_epochs
        self.negative_sample_rate = negative_sample_rate
        self.learning_rate = learning_rate
        self.random_state = random_state

    def fit_transform(self, data):
        data = np.asarray(data, np.float64)
        n = len(data)
        if n <= self.n_components + 1:
            # Degenerate input: centered PCA fallback
            centered = data - data.mean(axis=0)
            _, _, components = np.linalg.svd(centered, full_matrices=False)
            return (centered @ components[:self.n_components].T).astype(
                np.float32)
        k = min(self.n_neighbors, n - 1)
        rng = np.random.default_rng(self.random_state)

        # kNN (dense; plot-sized inputs)
        deltas = data[:, None, :] - data[None, :, :]
        full = np.sqrt(np.square(deltas).sum(-1))
        np.fill_diagonal(full, np.inf)
        indices = np.argsort(full, axis=1)[:, :k]
        distances = np.take_along_axis(full, indices, axis=1)

        # Fuzzy simplicial set
        weights = _membership_strengths(distances, indices, k)
        graph = np.zeros((n, n))
        rows = np.repeat(np.arange(n), k)
        graph[rows, indices.reshape(-1)] = weights.reshape(-1)
        graph = graph + graph.T - graph * graph.T

        embedding = _spectral_init(graph, self.n_components, rng)
        a, b = _fit_curve(self.min_dist)

        # Edge sampling schedule (epochs_per_sample ∝ 1/weight)
        edge_i, edge_j = np.nonzero(graph > 0)
        edge_w = graph[edge_i, edge_j]
        epochs_per_sample = edge_w.max() / edge_w
        next_epoch = epochs_per_sample.copy()

        for epoch in range(1, self.n_epochs + 1):
            alpha = self.learning_rate * (1. - epoch / self.n_epochs)
            active = next_epoch <= epoch
            for e in np.nonzero(active)[0]:
                i, j = edge_i[e], edge_j[e]
                diff = embedding[i] - embedding[j]
                d2 = np.square(diff).sum()
                if d2 > 0:
                    grad = (-2. * a * b * d2 ** (b - 1.)) / (
                        1. + a * d2 ** b)
                    step = np.clip(grad * diff, -4., 4.)
                    embedding[i] += alpha * step
                    embedding[j] -= alpha * step
                for _ in range(self.negative_sample_rate):
                    t = rng.integers(n)
                    if t == i:
                        continue
                    diff = embedding[i] - embedding[t]
                    d2 = np.square(diff).sum()
                    grad = (2. * b) / (
                        (0.001 + d2) * (1. + a * d2 ** b))
                    step = np.clip(grad * diff, -4., 4.)
                    embedding[i] += alpha * step
                next_epoch[e] += epochs_per_sample[e]
        return embedding.astype(np.float32)
