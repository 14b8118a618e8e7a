"""kNN over k-means representatives, mapping hits back to full-train
indices (ref:bayesvlm/knn_kmeans.py), counterpart of
`bayesvlm_tpu.select.knn_kmeans`.

Same math as `select.knn` with four behavioral additions from the
reference variant:
  - expected-norm clamping (>= 1e-12) before the rsqrt
    (ref:bayesvlm/knn_kmeans.py:138-140),
  - per-test-sample cap of `k_nearest` kept neighbors
    (ref:bayesvlm/knn_kmeans.py:205-211),
  - dynamic buffer re-fetch: when the grow-k' loop exhausts the
    initially fetched top-k width, a WIDER top-k is fetched
    (k' + buffersize) and the loop continues; termination is
    unique >= goal or k' >= n_representatives
    (ref:bayesvlm/knn_kmeans.py:174,182-186),
  - local->original index remapping through `original_train_indices`.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.ops import to_numpy as _host
from bayesvlm_tpu_torch.ops import topk_exact
from bayesvlm_tpu_torch.probforward.smith import activation_diag_covariance
from bayesvlm_tpu_torch.select.knn import wdist2
from bayesvlm_tpu_torch.types import EncoderResult, _highest_fp32_matmul


def _dedup_refetch(sims: torch.Tensor, k_nearest: int, buffersize: int):
    """Grow-k' dedup with the k-means variant's re-fetch
    (ref:bayesvlm/knn_kmeans.py:150-186): fetch top-(k_nearest +
    buffersize), grow k' by 1 until the column-major flattened top-k' ids
    hold >= k_nearest * n_test unique entries or k' >= n_representatives;
    when k' outgrows the fetched width, fetch top-(k' + buffersize). Then
    trim the flat id list from the end to exactly the goal's unique count
    (ref :54-64), the kept set. Returns (ids, vals, k', keep), ids and
    vals at the last fetched width (the reference collects from the
    re-fetched top-k, ref :194)."""
    n_test, n_reps = sims.shape
    goal = k_nearest * n_test
    k_fetch = min(k_nearest + buffersize, n_reps)
    vals, ids = topk_exact(sims, k_fetch)
    ids_np, vals_np = _host(ids), _host(vals)
    k_ = k_nearest
    while True:
        flat = ids_np[:, :k_].T.flatten()  # a clamped slice, as in torch
        if np.unique(flat).size >= goal or k_ >= n_reps:
            trimmed = flat
            while np.unique(trimmed).size > goal:
                trimmed = trimmed[:-1]
            keep = set(np.unique(trimmed).tolist())
            return ids_np, vals_np, min(k_, ids_np.shape[1]), keep
        k_ += 1
        if k_ > k_fetch and k_fetch < n_reps:
            k_fetch = min(k_ + buffersize, n_reps)
            vals, ids = topk_exact(sims, k_fetch)
            ids_np, vals_np = _host(ids), _host(vals)


def _expected_cosine_clamped(test_sub: EncoderResult, train: EncoderResult,
                             cov: KroneckerFactorizedCovariance,
                             has_bias: bool) -> torch.Tensor:
    train_diag = activation_diag_covariance(train.activations, cov, has_bias)
    test_diag = activation_diag_covariance(test_sub.activations, cov, has_bias)
    E_train = torch.clamp((train.embeds**2 + train_diag).sum(-1, keepdim=True), min=1e-12)
    E_test = torch.clamp((test_sub.embeds**2 + test_diag).sum(-1, keepdim=True), min=1e-12)
    with _highest_fp32_matmul():
        return (test_sub.embeds / torch.sqrt(E_test)) @ (
            train.embeds / torch.sqrt(E_train)).T


def _collect_remapped(topk_idx, topk_val, k_, keep, indices_test, values_test,
                      original_train_indices, k_nearest) -> OrderedDict:
    orig = _host(original_train_indices)
    out = OrderedDict()
    for i in range(topk_idx.shape[0]):
        keep_ids, keep_vals = [], []
        for idx_local, val in zip(topk_idx[i, :k_], topk_val[i, :k_]):
            if int(idx_local) in keep:
                keep_ids.append(int(orig[int(idx_local)]))
                keep_vals.append(float(val))
                if len(keep_ids) >= k_nearest:
                    break
        out[int(indices_test[i])] = dict(
            score=float(values_test[i]), indices=keep_ids, similarities=keep_vals)
    return out


def _find(sims, indices_test, values_test, original_train_indices, k_nearest,
          buffersize) -> OrderedDict:
    ids_np, vals_np, k_, keep = _dedup_refetch(sims, k_nearest, buffersize)
    return _collect_remapped(ids_np, vals_np, k_, keep, _host(indices_test),
                             _host(values_test), original_train_indices, k_nearest)


def find_similar_samples_cosine(train: EncoderResult, test: EncoderResult,
                                indices_test, values_test, original_train_indices,
                                k_nearest: int,
                                source_covariance: KroneckerFactorizedCovariance,
                                buffersize: int = 150,
                                has_bias: bool = False) -> OrderedDict:
    """ref:bayesvlm/knn_kmeans.py:80-224."""
    test_sub = test[torch.as_tensor(_host(indices_test), device=test.embeds.device)]
    sims = _expected_cosine_clamped(test_sub, train, source_covariance, has_bias)
    return _find(sims, indices_test, values_test, original_train_indices, k_nearest,
                 buffersize)


def find_similar_samples_wasserstein(train: EncoderResult, test: EncoderResult,
                                     indices_test, values_test, original_train_indices,
                                     k_nearest: int,
                                     source_covariance: KroneckerFactorizedCovariance,
                                     buffersize: int = 150,
                                     has_bias: bool = False) -> OrderedDict:
    """ref:bayesvlm/knn_kmeans.py:226-352 (similarity = -wdist2, clamped at 0)."""
    test_sub = test[torch.as_tensor(_host(indices_test), device=test.embeds.device)]
    cov = source_covariance
    train_diag = activation_diag_covariance(train.activations, cov, has_bias)
    test_diag = activation_diag_covariance(test_sub.activations, cov, has_bias)
    sims = -torch.clamp(wdist2(test_sub.embeds, train.embeds, test_diag, train_diag),
                        min=0.0)
    return _find(sims, indices_test, values_test, original_train_indices, k_nearest,
                 buffersize)
