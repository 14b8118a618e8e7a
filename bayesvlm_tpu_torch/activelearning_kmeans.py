"""Stage-3 variant with a k-means representative pre-filter before the
kNN support search, the port of the JAX package's
`scripts/activelearning_kmeans.py` (ref:scripts/activelearning_kmeans.py):
same flags and defaults, same resumable JSON and checkpoints.

    python -m bayesvlm_tpu_torch.activelearning_kmeans --model clip-large \\
        --dataset synthetic --hessian_dir <dir>

The train pool is clustered (Lloyd k-means on the device,
select/kmeans.py, in place of sklearn), the kNN search runs over the
representatives only and its hits are mapped back to train indices
(select/knn_kmeans.py). EPIG runs on the whole pool. The fine-tune stops
early after `--early_stopping_patience` epochs without a strict val-loss
improvement (ref:activelearning_kmeans.py:367). `--use_minibatch_kmeans`
and `--kmeans_batch_size` are accepted and unused, as in the JAX CLI
(there is no minibatch variant). Device, dtype, weights and tokenizer as
in `bayesvlm_tpu_torch.activelearning`. One process: like the JAX CLI,
it never calls `initialize_distributed`, so a multi-process launch runs
it whole in every process.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from bayesvlm_tpu_torch.activelearning import SubsetStore
from bayesvlm_tpu_torch.ops import to_numpy as _host


def run_knn_kmeans(reps, embeds_test, indices_test, values_test, original_train_indices,
                   k_nearest, source_covariance, method, proj_has_bias=False,
                   buffersize=150):
    from bayesvlm_tpu_torch.select.knn_kmeans import (
        find_similar_samples_cosine,
        find_similar_samples_wasserstein,
    )

    fn = (find_similar_samples_cosine if method == "cosine"
          else find_similar_samples_wasserstein)
    return fn(reps, embeds_test, indices_test, values_test, original_train_indices,
              k_nearest, source_covariance, buffersize=buffersize,
              has_bias=proj_has_bias)


def run(
    model_str: str,
    dataset: str,
    hessian_dir: str,
    experiment_dir: str,
    project_name: str,
    hessian_scale: float,
    subset_size: int,
    k_clusters: int = 1000,
    predictions_batch_size: int = 256,
    precompute_batch_size: int = 256,
    precompute_num_workers: int = 4,
    finetune_lr: float = 1e-5,
    finetune_wd: float = 5e-2,
    finetune_epochs: int = 100,
    finetune_batch_size: int = 32,
    k_nearest: int = 1,
    knn_method: str = "wasserstein",
    knn_buffersize: int = 150,
    early_stopping_patience: int = 15,
    use_minibatch_kmeans: bool = False,
    kmeans_batch_size: int = 1024,
    epig_lr: float = 1e-4,
    epig_hessian_update_scale: float = 10.0,
    epig_num_samples: int = 100,
    only_deterministic_strategies: bool = False,
    only_random_strategies: bool = False,
    only_epig: bool = False,
    without_epig: bool = False,
    weights_dir=None,
    tokenizer_dir=None,
    mlp_int8: bool = False,
    device: str = "cuda",
    dtype: str = "bf16",
    dataset_overrides: Optional[dict] = None,
) -> dict:
    """Steps [1]-[4] with [2b] the clustering; returns what
    `activelearning.run` returns, `seconds` with "[2b] clustering" and
    `n_representatives`."""
    if only_epig and without_epig:
        raise ValueError("Cannot set both only_epig and without_epig")
    # accepted for the JAX CLI's flags (the reference switches sklearn
    # KMeans / MiniBatchKMeans, ref:activelearning_kmeans.py:94-164)
    del use_minibatch_kmeans, kmeans_batch_size
    from bayesvlm_tpu_torch.train.al_common import refuse_unported

    device = refuse_unported(device)
    from bayesvlm_tpu_torch.inference.predictions import make_predictions
    from bayesvlm_tpu_torch.select.kmeans import cluster_and_select_representatives
    from bayesvlm_tpu_torch.select.scores import select_random, select_topk
    from bayesvlm_tpu_torch.train.al_common import (
        epig_subset,
        finetune_all_subsets,
        setup_context,
        synchronize,
    )

    ctx = setup_context(
        model_str, dataset, hessian_dir, experiment_dir, hessian_scale,
        precompute_batch_size, precompute_num_workers, weights_dir, tokenizer_dir,
        mlp_int8=mlp_int8, device=device, dtype=dtype,
        dataset_overrides=dataset_overrides)
    if knn_method not in ("cosine", "wasserstein"):
        raise ValueError(f"Unknown knn_method: {knn_method!r} (expected 'cosine' or "
                         "'wasserstein')")
    seconds = {"[1] features": ctx.seconds["features"],
               "[1] lambda + covariances": ctx.seconds["lambda + covariances"]}
    head = ctx.head
    train, test = ctx.image_outputs_train, ctx.image_outputs_test

    t0 = time.perf_counter()
    print("[2] Making predictions ...")

    def predict(feats, map_est):
        return make_predictions(head, feats, ctx.label_outputs,
                                batch_size=predictions_batch_size, map_estimate=map_est)

    prob_logits_test = predict(test, False)
    prob_logits_test_map = predict(test, True)
    prob_logits_train = predict(train, False)
    prob_logits_train_map = predict(train, True)
    synchronize(device)
    seconds["[2] predictions"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[2b] Clustering train pool ...")
    rep_idx, reps = cluster_and_select_representatives(
        train, k_clusters=min(k_clusters, len(train)))
    synchronize(device)
    seconds["[2b] clustering"] = time.perf_counter() - t0

    subset_dir = ctx.run_dir / (f"kmeans_subset_{subset_size}_k_{k_nearest}_c_{k_clusters}"
                                f"_n_{hessian_scale}_knn_{knn_method}")
    subset_dir.mkdir(parents=True, exist_ok=True)
    store = SubsetStore(subset_dir / "subset_indices_train.json")

    t0 = time.perf_counter()
    print("[3] Creating training subsets (kmeans-representative kNN) ...")

    def knn(idx, vals):
        return run_knn_kmeans(reps, test, _host(idx), vals, rep_idx, k_nearest,
                              head.source_covariance, knn_method,
                              head.source_projection_has_bias, buffersize=knn_buffersize)

    def topk(logits, **kw):
        return select_topk(logits, k=subset_size, return_values=True, **kw)

    def topk_direct(logits, **kw):
        idx, vals = topk(logits, **kw)
        return {0: dict(score=0.0, indices=_host(idx).tolist(),
                        similarities=_host(vals).tolist())}

    # the strategies and their keys: ref:activelearning_kmeans.py:603-714
    if not only_random_strategies and not only_epig:
        store.make("entropy_map_kmeans_knn", lambda: knn(*map(_host, topk(
            prob_logits_test_map, variant="entropy", entropy_variant="map_alea"))))
        store.make("entropy_map_trainset_direct", lambda: topk_direct(
            prob_logits_train_map, variant="entropy", entropy_variant="map_alea"))
        store.make("bald_test_kmeans_knn", lambda: knn(*map(_host, topk(
            prob_logits_test, variant="exp_mutual_info", seed=0))))

    if not only_random_strategies and not without_epig:
        # the whole pool, no k-means pre-filter, and the reference's caps on
        # the EPIG subsamples (ref:activelearning_kmeans.py:647-671)
        store.make("epig_direct", lambda: epig_subset(
            ctx, subset_size, epig_lr, epig_hessian_update_scale, epig_num_samples,
            40_000, 20_000, knn_method))

    if not only_deterministic_strategies and not only_epig:
        def random_test(i):
            idx = select_random(prob_logits_test, k=subset_size, seed=i)
            return knn(idx, np.ones(len(idx)))

        def random_train(i):
            idx = _host(select_random(prob_logits_train, k=k_nearest * subset_size,
                                      seed=i))
            uniq = np.unique(idx)[:subset_size]
            return {0: dict(score=0.0, indices=uniq.tolist(),
                            similarities=[1.0] * len(uniq))}

        for i in range(5):
            store.make(f"random_on_test_kmeans_knn_{i}", lambda i=i: random_test(i))
        for i in range(5):
            store.make(f"random_on_train_direct_{i}", lambda i=i: random_train(i))
    store.save()
    synchronize(device)
    seconds["[3] strategies"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[4] Fine-tuning based on training subsets ...")
    timings = {}
    results = finetune_all_subsets(
        ctx, store.subsets, subset_dir, project_name, dataset,
        finetune_lr, finetune_wd, finetune_epochs, finetune_batch_size,
        config=dict(k_clusters=k_clusters, knn_method=knn_method,
                    subset_size=subset_size, hessian_scale=hessian_scale),
        early_stopping_patience=early_stopping_patience, timings=timings)
    synchronize(device)
    seconds["[4] fine-tuning"] = time.perf_counter() - t0
    return dict(results=results, seconds=seconds, strategy_seconds=store.seconds,
                finetune=timings, subset_dir=subset_dir, subsets=store.subsets,
                n_representatives=len(rep_idx))


def main(*args, **kwargs) -> dict:
    """The CLI's entry point: takes `run`'s arguments and returns each
    trained strategy's best test metrics, as the JAX `main` does."""
    return run(*args, **kwargs)["results"]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", type=str, default="clip-base")
    parser.add_argument("--dataset", type=str, default="homeoffice-da-clipart")
    parser.add_argument("--hessian_dir", type=str, required=True,
                        help="Directory containing precomputed Hessian factors")
    parser.add_argument("--experiment_dir", type=str,
                        default="experiments/active-finetuning-kmeans")
    parser.add_argument("--project_name", type=str, default="active-finetuning-kmeans")
    parser.add_argument("--subset_size", type=int, default=50)
    parser.add_argument("--hessian_scale", type=float, default=10)
    parser.add_argument("--k_clusters", type=int, default=1000)
    parser.add_argument("--predictions_batch_size", type=int, default=256)
    parser.add_argument("--precompute_batch_size", type=int, default=256)
    parser.add_argument("--precompute_num_workers", type=int, default=4)
    parser.add_argument("--finetune_lr", type=float, default=1e-5)
    parser.add_argument("--finetune_wd", type=float, default=5e-2)
    parser.add_argument("--finetune_epochs", type=int, default=100)
    parser.add_argument("--finetune_batch_size", type=int, default=32)
    parser.add_argument("--k_nearest", type=int, default=1)
    parser.add_argument("--knn_method", type=str, default="wasserstein")
    parser.add_argument("--knn_buffersize", type=int, default=150)
    parser.add_argument("--early_stopping_patience", type=int, default=15)
    parser.add_argument("--kmeans_clusters", type=int, default=None,
                        help="reference flag name; alias of --k_clusters")
    parser.add_argument("--use_minibatch_kmeans", action="store_true",
                        help="accepted and unused (Lloyd k-means on the device has "
                        "no minibatch variant)")
    parser.add_argument("--kmeans_batch_size", type=int, default=1024,
                        help="accepted and unused (see --use_minibatch_kmeans)")
    parser.add_argument("--epig_lr", type=float, default=1e-4)
    parser.add_argument("--epig_hessian_update_scale", type=float, default=10.0)
    parser.add_argument("--epig_num_samples", type=int, default=100,
                        help="EPIG Monte-Carlo samples (reference default 100)")
    parser.add_argument("--only_deterministic_strategies", action="store_true")
    parser.add_argument("--only_random_strategies", action="store_true")
    parser.add_argument("--only_epig", action="store_true")
    parser.add_argument("--without_epig", action="store_true")
    parser.add_argument("--weights_dir", type=str, default=None)
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--mlp_int8", action="store_true",
                        help="W8A8 int8 vision-tower MLPs for the feature pass "
                        "(csrc/mlp_int8.cu); off by default")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(
        model_str=args.model, dataset=args.dataset, hessian_dir=args.hessian_dir,
        experiment_dir=args.experiment_dir, project_name=args.project_name,
        hessian_scale=args.hessian_scale, subset_size=args.subset_size,
        k_clusters=args.kmeans_clusters or args.k_clusters,
        predictions_batch_size=args.predictions_batch_size,
        precompute_batch_size=args.precompute_batch_size,
        precompute_num_workers=args.precompute_num_workers,
        finetune_lr=args.finetune_lr, finetune_wd=args.finetune_wd,
        finetune_epochs=args.finetune_epochs,
        finetune_batch_size=args.finetune_batch_size,
        k_nearest=args.k_nearest, knn_method=args.knn_method,
        knn_buffersize=args.knn_buffersize,
        early_stopping_patience=args.early_stopping_patience,
        use_minibatch_kmeans=args.use_minibatch_kmeans,
        kmeans_batch_size=args.kmeans_batch_size,
        epig_lr=args.epig_lr,
        epig_hessian_update_scale=args.epig_hessian_update_scale,
        epig_num_samples=args.epig_num_samples,
        only_deterministic_strategies=args.only_deterministic_strategies,
        only_random_strategies=args.only_random_strategies,
        only_epig=args.only_epig, without_epig=args.without_epig,
        weights_dir=args.weights_dir, tokenizer_dir=args.tokenizer_dir,
        mlp_int8=args.mlp_int8, device=args.device, dtype=args.dtype,
    )
