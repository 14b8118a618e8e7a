"""Stage-3 selection: uncertainty scores, kNN support search, k-means
representatives, online EPIG, closed-form EGL and LLM-scored selection."""

from bayesvlm_tpu_torch.select.egl import expected_gradient_length, select_egl
from bayesvlm_tpu_torch.select.epig import (
    entropy_from_probs,
    epig_from_logits_using_matmul,
    epig_from_probs_using_matmul,
    marginal_entropy_from_probs,
    select_epig_online,
    update_embeddings,
)
from bayesvlm_tpu_torch.select.kmeans import (
    cluster_and_select_representatives,
    kmeans_fit,
)
from bayesvlm_tpu_torch.select.knn import (
    diagonal_wasserstein_distance,
    expected_cosine_similarity,
    extract_test_train_indices,
    find_similar_samples_cosine,
    find_similar_samples_wasserstein,
    wdist2,
)
from bayesvlm_tpu_torch.select.llm import (
    make_gemini_client,
    parse_llm_score,
    select_llm_score,
)
from bayesvlm_tpu_torch.select.scores import (
    complexity_score,
    create_subset_json,
    entropy_score,
    select_random,
    select_random_classbalanced,
    select_topk,
    select_topk_classbalanced,
    select_topk_randomized,
)

__all__ = [
    "cluster_and_select_representatives",
    "complexity_score",
    "create_subset_json",
    "diagonal_wasserstein_distance",
    "entropy_from_probs",
    "entropy_score",
    "epig_from_logits_using_matmul",
    "epig_from_probs_using_matmul",
    "expected_cosine_similarity",
    "expected_gradient_length",
    "extract_test_train_indices",
    "find_similar_samples_cosine",
    "find_similar_samples_wasserstein",
    "kmeans_fit",
    "make_gemini_client",
    "marginal_entropy_from_probs",
    "parse_llm_score",
    "select_egl",
    "select_epig_online",
    "select_llm_score",
    "select_random",
    "select_random_classbalanced",
    "select_topk",
    "select_topk_classbalanced",
    "select_topk_randomized",
    "update_embeddings",
    "wdist2",
]
