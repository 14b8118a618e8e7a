"""k-means (Lloyd's algorithm) for representative selection,
counterpart of `bayesvlm_tpu.select.kmeans`.

Replaces the reference's sklearn KMeans / MiniBatchKMeans
(ref:scripts/activelearning_kmeans.py:94-164) on the device: an
iteration is one [N, K] distance product, an argmin and the centroid
sums as a one-hot product (a fixed summation order, where an atomic
scatter would vary run to run). The initial centroids are a permutation
prefix from `select/draws.py` (the JAX package's `choice` without
replacement). One device; the JAX package's mesh path is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bayesvlm_tpu_torch.select import draws
from bayesvlm_tpu_torch.types import EncoderResult, _highest_fp32_matmul


def kmeans_fit(x: torch.Tensor, k: int, seed: int = 0,
               num_iters: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means. Returns (centroids [k, D], assignments [N])."""
    N = x.shape[0]
    init = torch.as_tensor(draws.permutation(seed, N)[:k], device=x.device)
    centroids = x[init]
    x_sq = (x**2).sum(-1)

    def assign(c):
        with _highest_fp32_matmul():
            d = x_sq[:, None] - 2.0 * (x @ c.T) + (c**2).sum(-1)[None, :]
        return torch.argmin(d, dim=-1)

    for _ in range(num_iters):
        one_hot = torch.nn.functional.one_hot(assign(centroids), k).to(x.dtype)
        counts = one_hot.sum(0)
        with _highest_fp32_matmul():
            sums = one_hot.T @ x
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts, min=1.0)[:, None], centroids)
    return centroids, assign(centroids)


def cluster_and_select_representatives(
        train_outputs: EncoderResult, k_clusters: int, seed: int = 0,
        num_iters: int = 100) -> Tuple[torch.Tensor, EncoderResult]:
    """k-means over the train embeddings, the sample closest to each
    centroid, deduplicated and sorted
    (ref:scripts/activelearning_kmeans.py:94-164). Returns
    (representative indices [<= k_clusters] on the CPU, their features)."""
    embeds = train_outputs.embeds.float()
    centroids, _ = kmeans_fit(embeds, k_clusters, seed=seed, num_iters=num_iters)
    with _highest_fp32_matmul():
        d = ((centroids**2).sum(-1)[:, None] - 2.0 * (centroids @ embeds.T)
             + (embeds**2).sum(-1)[None, :])
    rep_idx = torch.as_tensor(np.unique(torch.argmin(d, dim=-1).cpu().numpy()))
    return rep_idx, train_outputs[rep_idx.to(embeds.device)]
