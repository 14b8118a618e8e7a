"""Similarities between probabilistic embeddings (ref:bayesvlm/knn.py).

Counterpart of the parts of `bayesvlm_tpu.select.knn` that the online
EPIG loop uses for its kNN pool subsampling:

  - expected cosine: normalize by the *expected* squared norm
    E||z||^2 = ||mu||^2 + sum(sigma) (the Smith forward's chain)
  - negative squared 2-Wasserstein between diagonal Gaussians

The top-k over these is `torch.topk` in the caller. Not ported yet:
`find_similar_samples_*` and the host dedup loop.
"""

from __future__ import annotations

import torch

from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
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
