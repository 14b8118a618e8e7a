"""The port's k-means active-learning CLI
(`bayesvlm_tpu_torch.activelearning_kmeans`) against the JAX package's
(`scripts/activelearning_kmeans.py`) on the CPU, with the setup, draws
and tolerances of tests/test_torch_activelearning.py: 16 clusters (the
k-means init a permutation prefix, JAX's handed to the port), the
re-fetching kNN over the representatives, EPIG on the whole pool, and
early stopping with patience 1; then the port's CLI resuming on the JAX
CLI's directory.
"""

import pytest
from test_torch_activelearning import KW, check_cli_matches_jax, check_resume, run_both

import activelearning_kmeans as jax_al_kmeans
from bayesvlm_tpu_torch import activelearning_kmeans

KMEANS_KW = dict(KW, k_clusters=16, early_stopping_patience=1)
KMEANS_STRATEGIES = (["entropy_map_kmeans_knn", "entropy_map_trainset_direct",
                      "bald_test_kmeans_knn", "epig_direct"]
                     + [f"random_on_test_kmeans_knn_{i}" for i in range(5)]
                     + [f"random_on_train_direct_{i}" for i in range(5)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, jax_al_kmeans, activelearning_kmeans, KMEANS_KW)


def test_activelearning_kmeans_matches_jax(runs):
    check_cli_matches_jax(runs, "kmeans_subset_", KMEANS_STRATEGIES)
    port = runs["port"]
    assert 1 <= port["n_representatives"] <= 16
    assert "[2b] clustering" in port["seconds"]
    # patience 1 stops where an epoch does not improve strictly
    assert all(t["epochs"] in (1, 2) for t in port["finetune"].values())


def test_resume_on_a_directory_the_jax_cli_wrote(runs, tmp_path):
    check_resume(runs, activelearning_kmeans, KMEANS_KW, tmp_path)
