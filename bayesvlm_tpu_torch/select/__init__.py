"""Stage-3 selection: online EPIG and the kNN similarities it uses."""

from bayesvlm_tpu_torch.select.epig import (
    entropy_from_probs,
    epig_from_logits_using_matmul,
    epig_from_probs_using_matmul,
    marginal_entropy_from_probs,
    select_epig_online,
    update_embeddings,
)
from bayesvlm_tpu_torch.select.knn import (
    diagonal_wasserstein_distance,
    expected_cosine_similarity,
    wdist2,
)

__all__ = [
    "diagonal_wasserstein_distance",
    "entropy_from_probs",
    "epig_from_logits_using_matmul",
    "epig_from_probs_using_matmul",
    "expected_cosine_similarity",
    "marginal_entropy_from_probs",
    "select_epig_online",
    "update_embeddings",
    "wdist2",
]
