"""Probabilistic kNN retrieval (ref:bayesvlm/knn.py), counterpart of
`bayesvlm_tpu.select.knn`.

Two similarity notions between probabilistic embeddings:
  - expected cosine: normalize by the *expected* squared norm
    E||z||^2 = ||mu||^2 + sum(sigma) (the Smith forward's chain)
  - negative squared 2-Wasserstein between diagonal Gaussians

The [N_test, N_train] similarities and their top-k stay on the device
(`ops.topk_exact`, the JAX package's tie order); the grow-k'-until-
enough-unique-train-indices dedup loop runs on the host
(data-dependent, ref:bayesvlm/knn.py:93-111). With a mesh of several
ranks the train columns are sharded over the ranks (`_sims_topk_sharded`):
every rank holds the same result, and it is one device's up to the
rounding of the similarity GEMM, whose bits depend on the width of a
rank's column block. Exact ties keep one device's order, but two
similarities that one device rounds apart may round otherwise on a
rank, so a near-tie can pick other ids than a one-device run.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from bayesvlm_tpu_torch.ops import to_numpy as _host
from bayesvlm_tpu_torch.ops import topk_exact

from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.dist.mesh import (
    all_gather_rows,
    local_rows,
    mesh_size,
    resolve_auto_mesh,
    row_block,
)
from bayesvlm_tpu_torch.probforward.smith import (
    _highest_fp32_matmul,
    activation_diag_covariance,
)
from bayesvlm_tpu_torch.types import EncoderResult


def diagonal_wasserstein_distance(mu1: torch.Tensor, mu2: torch.Tensor,
                                  cov1: torch.Tensor, cov2: torch.Tensor) -> torch.Tensor:
    """Squared 2-Wasserstein between diagonal Gaussians
    (ref:bayesvlm/knn.py:6-16):
      ||mu1-mu2||^2 + sum(cov1) + sum(cov2) - 2 sum(sqrt(cov1 cov2))
    Shapes: mu1 [A, D], mu2 [B, D], cov1 [A, D], cov2 [B, D] -> [A, B]."""
    with _highest_fp32_matmul():
        sq = ((mu1**2).sum(-1)[:, None] + (mu2**2).sum(-1)[None, :]
              - 2 * mu1 @ mu2.T)
        var_prod = 2.0 * torch.sqrt(cov1) @ torch.sqrt(cov2).T
    return sq + cov1.sum(-1)[:, None] + cov2.sum(-1)[None, :] - var_prod


def wdist2(mu1, mu2, cov1, cov2) -> torch.Tensor:
    """ref:bayesvlm/knn.py:18-20."""
    return diagonal_wasserstein_distance(mu1, mu2, cov1, cov2)


def expected_cosine_similarity(test: EncoderResult, train: EncoderResult,
                               A_inv: torch.Tensor, B_diag: torch.Tensor,
                               has_bias: bool = False) -> torch.Tensor:
    """[N_test, N_train] expected cosine similarity under the posterior
    (ref:bayesvlm/knn.py:59-82)."""
    cov = KroneckerFactorizedCovariance(A_inv=A_inv, B_inv=torch.diag(B_diag))
    train_diag = activation_diag_covariance(train.activations, cov, has_bias)
    test_diag = activation_diag_covariance(test.activations, cov, has_bias)
    E_train = (train.embeds**2 + train_diag).sum(-1, keepdim=True)
    E_test = (test.embeds**2 + test_diag).sum(-1, keepdim=True)
    with _highest_fp32_matmul():
        return (test.embeds / torch.sqrt(E_test)) @ (train.embeds / torch.sqrt(E_train)).T


def _sims_topk_sharded(sims_fn, train: EncoderResult, k_cap: int, mesh):
    """The [N_test, N_train] similarities' top-k_cap with the TRAIN rows
    sharded over the mesh's ranks (JAX's `_sims_topk_sharded`): each rank
    takes `ops.topk_exact` of its local columns (pad columns, zero rows
    past n_train, masked to -inf by global id), the k_cap candidates of
    every rank are gathered in rank order, which is global column order,
    and a second stable top-k picks the result, so ties resolve as in the
    dense top-k (for the values the ranks computed: these may differ from
    one device's by the GEMM's rounding, see the module docstring). A pad
    column can never surface: rank 0 alone brings k_cap real columns
    ahead of every pad (pads lie at the tail of the last rank's block),
    and both stages keep ties in index order. NaN similarities are
    unspecified, as in the dense top-k. The dense top-k with no mesh
    (None), one rank, or a rank's width under k_cap. Returns (values,
    global ids), replicated. `sims_fn(train_rows)` computes row-wise
    similarity columns."""
    n_dev, n_train = mesh_size(mesh), len(train)
    gid0, width = row_block(n_train, mesh)
    if n_dev < 2 or width < k_cap:
        return topk_exact(sims_fn(train), k_cap)
    local = EncoderResult(*(local_rows(x, mesh, fill=0.0)[0] for x in (
        train.embeds, train.activations, train.residuals)))
    sims = sims_fn(local)                                        # [N_t, width]
    gid = gid0 + torch.arange(width, device=sims.device)
    sims = torch.where(gid[None, :] < n_train, sims, -torch.inf)
    v, i = topk_exact(sims, k_cap)
    n_t = v.shape[0]
    # [n_dev * N_t, k] in rank order -> [N_t, n_dev * k] in global column order
    vg = all_gather_rows(v, mesh).reshape(n_dev, n_t, k_cap).transpose(0, 1)
    gg = all_gather_rows(i + gid0, mesh).reshape(n_dev, n_t, k_cap).transpose(0, 1)
    v2, i2 = topk_exact(vg.reshape(n_t, n_dev * k_cap), k_cap)
    return v2, torch.take_along_dim(gg.reshape(n_t, n_dev * k_cap), i2, dim=1)


def _dedup_loop(topk_idx: np.ndarray, topk_val: np.ndarray, k_nearest: int,
                n_test: int):
    """Host-side dedup (ref:bayesvlm/knn.py:93-135): grow k' until the
    column-major flattened top-k' indices hold >= k_nearest * n_test
    unique entries, then trim from the end.

    DIVERGENCE, kept from the JAX package: the reference's loop has no
    termination guard. When the fetched top-(k_nearest + buffersize)
    columns cannot supply enough unique train indices its slice clamps,
    the unique count stops growing and the loop spins forever
    (ref:bayesvlm/knn.py:95-110). Here it stops at the fetched width and
    returns what exists (the k-means variant re-fetches instead,
    select/knn_kmeans.py:_dedup_refetch)."""
    goal = k_nearest * n_test
    k_ = k_nearest
    max_k = topk_idx.shape[1]
    while True:
        flat = topk_idx[:, :k_].T.flatten()
        if np.unique(flat).size >= goal or k_ >= max_k:
            break
        k_ += 1
    # trim from the end until exactly `goal` unique remain
    # (ref:bayesvlm/knn.py:22-25)
    trimmed = flat
    while np.unique(trimmed).size > goal:
        trimmed = trimmed[:-1]
    return k_, set(np.unique(trimmed).tolist())


def _collect(topk_idx, topk_val, k_, keep, indices_test, values_test) -> OrderedDict:
    out = OrderedDict()
    for i in range(topk_idx.shape[0]):
        ids = topk_idx[i, :k_]
        vals = topk_val[i, :k_]
        keep_ids = [int(x) for x in ids if int(x) in keep]
        keep_vals = [float(v) for x, v in zip(ids, vals) if int(x) in keep]
        out[int(indices_test[i])] = dict(
            score=float(values_test[i]), indices=keep_ids, similarities=keep_vals)
    return out


def _find(sims_fn, train: EncoderResult, indices_test, values_test, k_nearest: int,
          buffersize: int, mesh) -> OrderedDict:
    k_cap = min(k_nearest + buffersize, len(train))
    vals, ids = _sims_topk_sharded(sims_fn, train, k_cap, resolve_auto_mesh(mesh))
    ids_np, vals_np = _host(ids), _host(vals)
    indices_test = _host(indices_test)
    k_, keep = _dedup_loop(ids_np, vals_np, k_nearest, len(indices_test))
    return _collect(ids_np, vals_np, k_, keep, indices_test, _host(values_test))


def find_similar_samples_cosine(train: EncoderResult, test: EncoderResult,
                                indices_test, values_test, k_nearest: int,
                                source_covariance: KroneckerFactorizedCovariance,
                                buffersize: int = 150, has_bias: bool = False,
                                mesh="auto") -> OrderedDict:
    """ref:bayesvlm/knn.py:39-137: {test index: {score, indices,
    similarities}} in the order of `indices_test`. `mesh`: shard the
    train pool's similarity columns over a mesh's ranks ("auto": the world
    mesh when a group of more than one rank is initialised; replicated on
    every rank, one device's up to the GEMM's rounding, see
    `_sims_topk_sharded`)."""
    test_sub = test[torch.as_tensor(_host(indices_test), device=test.embeds.device)]
    A_inv, B_diag = source_covariance.A_inv, torch.diagonal(source_covariance.B_inv)
    return _find(lambda tr: expected_cosine_similarity(test_sub, tr, A_inv, B_diag,
                                                       has_bias=has_bias),
                 train, indices_test, values_test, k_nearest, buffersize, mesh)


def find_similar_samples_wasserstein(train: EncoderResult, test: EncoderResult,
                                     indices_test, values_test, k_nearest: int,
                                     source_covariance: KroneckerFactorizedCovariance,
                                     buffersize: int = 150, has_bias: bool = False,
                                     mesh="auto") -> OrderedDict:
    """ref:bayesvlm/knn.py:139-220, the similarity -wdist2. `mesh`: as
    in find_similar_samples_cosine."""
    test_sub = test[torch.as_tensor(_host(indices_test), device=test.embeds.device)]
    cov = source_covariance
    test_diag = activation_diag_covariance(test_sub.activations, cov, has_bias)

    def sims_fn(tr):
        tr_diag = activation_diag_covariance(tr.activations, cov, has_bias)
        return -wdist2(test_sub.embeds, tr.embeds, test_diag, tr_diag)

    return _find(sims_fn, train, indices_test, values_test, k_nearest, buffersize, mesh)


def extract_test_train_indices(text_idx_to_train_data) -> dict:
    """The test indices and the unique train indices of a kNN result
    (ref:bayesvlm/knn.py:27-37). `train` is `list(set(...))`, as in both
    other packages: its order decides the fine-tune's data order."""
    test_indices, train_indices = [], []
    for test_idx, data in text_idx_to_train_data.items():
        test_indices.append(int(test_idx))
        train_indices.extend(int(x) for x in data["indices"])
    return dict(test=test_indices, train=list(set(train_indices)))
