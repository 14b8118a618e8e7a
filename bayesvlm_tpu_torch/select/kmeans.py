"""k-means (Lloyd's algorithm) for representative selection,
counterpart of `bayesvlm_tpu.select.kmeans`.

Replaces the reference's sklearn KMeans / MiniBatchKMeans
(ref:scripts/activelearning_kmeans.py:94-164) on the device: an
iteration is one [N, K] distance product, an argmin and the centroid
sums as a one-hot product (a fixed summation order, where an atomic
scatter would vary run to run). The initial centroids are a permutation
prefix from `select/draws.py` (the JAX package's `choice` without
replacement).

With a mesh of several ranks the rows are sharded over the ranks: each
Lloyd iteration's distances and argmin are row-local and the
per-centroid sums and counts are `all_reduce`d, so the result can differ
from one device's only by the float reassociation of those sums (JAX's
GSPMD partition says the same of its own).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from bayesvlm_tpu_torch.dist.mesh import (
    all_gather_rows,
    all_reduce_sum,
    local_rows,
    resolve_auto_mesh,
)
from bayesvlm_tpu_torch.select import draws
from bayesvlm_tpu_torch.types import EncoderResult, _highest_fp32_matmul


def kmeans_fit(x: torch.Tensor, k: int, seed: int = 0, num_iters: int = 100,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means. Returns (centroids [k, D], assignments [N]). `mesh`:
    the rows sharded over its ranks (every rank takes the full x and
    returns the full result)."""
    N = x.shape[0]
    init = torch.as_tensor(draws.permutation(seed, N)[:k], device=x.device)
    centroids = x[init]
    rows, mask = local_rows(x, mesh, fill=0.0)
    x_sq = (rows**2).sum(-1)

    def assign(c):
        with _highest_fp32_matmul():
            d = x_sq[:, None] - 2.0 * (rows @ c.T) + (c**2).sum(-1)[None, :]
        return torch.argmin(d, dim=-1)

    for _ in range(num_iters):
        # the pad rows (mask 0) count for no centroid
        one_hot = torch.nn.functional.one_hot(assign(centroids), k).to(x.dtype)
        one_hot = one_hot * mask[:, None].to(x.dtype)
        counts = all_reduce_sum(one_hot.sum(0), mesh)
        with _highest_fp32_matmul():
            sums = all_reduce_sum(one_hot.T @ rows, mesh)
        centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts, min=1.0)[:, None], centroids)
    return centroids, all_gather_rows(assign(centroids), mesh)[:N]


def cluster_and_select_representatives(
        train_outputs: EncoderResult, k_clusters: int, seed: int = 0,
        num_iters: int = 100, mesh="auto") -> Tuple[torch.Tensor, EncoderResult]:
    """k-means over the train embeddings, the sample closest to each
    centroid, deduplicated and sorted
    (ref:scripts/activelearning_kmeans.py:94-164). Returns
    (representative indices [<= k_clusters] on the CPU, their features).
    `mesh`: the Lloyd iterations' rows sharded over a mesh's ranks ("auto":
    the world mesh when a group of more than one rank is initialised;
    None: one device); the closest samples are found on every rank's
    full copy."""
    embeds = train_outputs.embeds.float()
    centroids, _ = kmeans_fit(embeds, k_clusters, seed=seed, num_iters=num_iters,
                              mesh=resolve_auto_mesh(mesh))
    with _highest_fp32_matmul():
        d = ((centroids**2).sum(-1)[:, None] - 2.0 * (centroids @ embeds.T)
             + (embeds**2).sum(-1)[None, :])
    rep_idx = torch.as_tensor(np.unique(torch.argmin(d, dim=-1).cpu().numpy()))
    return rep_idx, train_outputs[rep_idx.to(embeds.device)]
