"""Stage 3: uncertainty-based active fine-tuning, the port of the JAX
package's `scripts/activelearning.py` (ref:scripts/activelearning.py):
same flags and defaults, same printed steps, same resumable
`subset_indices_train.json` and per-subset `img_projection.pt`.

    python -m bayesvlm_tpu_torch.activelearning --model clip-large \\
        --dataset synthetic --hessian_dir <dir>

[1] features of the train, val and test splits and of the class prompts
(cached under `<experiment_dir>/<dataset>/base`), lambda re-optimised
per tower, the covariances; [2] probabilistic and MAP predictions of the
train and test sets; [3] the strategies: entropy_map (+kNN support
search in the train pool), entropy_map_train, bald_test (+kNN), epig_knn
(online EPIG), random_on_test_{0..4} (+kNN), random_on_train_{0..4},
each saved to the JSON as it is made and skipped when the JSON holds it;
[4] the image projection fine-tuned on each strategy's train subset,
skipped where its checkpoint exists.

Runs on the card unless `--device` names another, and refuses to start
without one. `--dtype` (bf16, the JAX CLI's GEMM weights, or fp32) is
the towers' compute dtype. `--weights_dir` is an HF snapshot directory
or the port's converted `vision.pt` / `text.pt`, or none for seeded
random towers; `--tokenizer_dir` a local HF tokenizer, else the
deterministic `HashTokenizer`.

Several processes, one a card: launch each with `COORDINATOR_ADDRESS`
(host:port of rank 0), `NUM_PROCESSES` and `PROCESS_ID` (dist/init.py).
Each rank encodes its stripe of the batches, the features are gathered,
and the strategies and the fine-tune run replicated (the sharded EPIG,
kNN and k-means over the ranks); rank 0 alone writes the caches, the
JSON and the checkpoints, the others' fine-tune logs go to
`_replica_host{rank}` (train/al_common.py). The ranks share the
experiment directory.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from bayesvlm_tpu_torch.ops import to_numpy as _host


def run_knn(embeds_train, embeds_test, indices_test, values_test, k_nearest,
            source_covariance, method, proj_has_bias=False):
    """ref:scripts/activelearning.py:228-250."""
    from bayesvlm_tpu_torch.select.knn import (
        find_similar_samples_cosine,
        find_similar_samples_wasserstein,
    )

    if method == "cosine":
        fn = find_similar_samples_cosine
    elif method == "wasserstein":
        fn = find_similar_samples_wasserstein
    else:
        raise ValueError(f"Unknown method {method}")
    return fn(embeds_train, embeds_test, indices_test, values_test, k_nearest,
              source_covariance, has_bias=proj_has_bias)


class SubsetStore:
    """The resumable strategy checkpoint `subset_indices_train.json`:
    strategy name -> {test index: {score, indices, similarities}}, in the
    order the strategies were made. Keys are written as JSON strings (an
    int test index too) and read back as strings, as in the JAX CLIs. It
    also times each strategy made in this run. Only the `primary` process
    writes it."""

    def __init__(self, path, primary: bool = True):
        self.path, self.primary = path, primary
        if path.exists():
            with open(path) as f:
                self.subsets = json.load(f, object_pairs_hook=OrderedDict)
        else:
            self.subsets = OrderedDict()
        self.seconds = {}

    def make(self, name: str, fn) -> None:
        """Add strategy `name` as `fn()` and save, unless it is held."""
        if name in self.subsets:
            return
        t0 = time.perf_counter()
        self.subsets[name] = fn()
        self.seconds[name] = time.perf_counter() - t0
        self.save()

    def save(self) -> None:
        if not self.primary:
            return  # the replicas make the same subsets; rank 0 keeps them
        with open(self.path, "w") as f:
            json.dump(self.subsets, f)


class Strategies:
    """The strategies the main, EGL and LLM CLIs share, each made into a
    `SubsetStore` under the JAX CLIs' keys, test-pool selections mapped to
    train support by the kNN search (ref:scripts/activelearning.py:252-445,
    ref:scripts/activelearning_elg.py:670-806). `logits` holds the four
    predictions of step [2]: "train", "train_map", "test", "test_map"."""

    def __init__(self, ctx, store: SubsetStore, logits: dict, subset_size: int,
                 k_nearest: int, knn_method: str):
        self.ctx, self.store, self.logits = ctx, store, logits
        self.subset_size, self.k_nearest, self.knn_method = subset_size, k_nearest, knn_method

    def knn(self, idx, vals) -> dict:
        ctx = self.ctx
        return run_knn(ctx.image_outputs_train, ctx.image_outputs_test, _host(idx), vals,
                       self.k_nearest, ctx.head.source_covariance, self.knn_method,
                       ctx.head.source_projection_has_bias)

    def _topk(self, logits, **kw):
        from bayesvlm_tpu_torch.select.scores import select_topk

        idx, vals = select_topk(logits, k=self.subset_size, return_values=True, **kw)
        return _host(idx), _host(vals)

    def deterministic(self) -> None:
        """entropy_map (+kNN), entropy_map_train, bald_test (+kNN)."""
        lg = self.logits
        print("    - Aleatoric entropy ...", flush=True)
        self.store.make("entropy_map", lambda: self.knn(*self._topk(
            lg["test_map"], variant="entropy", entropy_variant="map_alea")))

        def on_train():
            idx, vals = self._topk(lg["train_map"], variant="entropy",
                                   entropy_variant="map_alea")
            return {0: dict(score=0.0, indices=idx.tolist(), similarities=vals.tolist())}

        print("    - Aleatoric entropy on train ...", flush=True)
        self.store.make("entropy_map_train", on_train)
        print("    - BALD (on test) ...", flush=True)
        self.store.make("bald_test", lambda: self.knn(*self._topk(
            lg["test"], variant="exp_mutual_info", seed=0)))

    def epig(self, lr: float, hessian_update_scale: float, num_samples: int,
             pool_max_size: int, target_max_size: int) -> None:
        """epig_knn: online EPIG over the train pool (al_common.epig_subset)."""
        from bayesvlm_tpu_torch.train.al_common import epig_subset

        print("    - EPIG KNN...", flush=True)
        self.store.make("epig_knn", lambda: epig_subset(
            self.ctx, self.subset_size, lr, hessian_update_scale, num_samples,
            pool_max_size, target_max_size, self.knn_method))

    def random(self) -> None:
        """random_on_test_{0..4} (+kNN), random_on_train_{0..4}."""
        from bayesvlm_tpu_torch.select.scores import select_random

        def on_test(i):
            idx = select_random(self.logits["test"], k=self.subset_size, seed=i)
            return self.knn(idx, np.ones(len(idx)))

        def on_train(i):
            idx = _host(select_random(self.logits["train"],
                                      k=self.k_nearest * self.subset_size, seed=i))
            return {0: dict(score=0.0, indices=idx.tolist(),
                            similarities=[1.0] * len(idx))}

        for i in range(5):
            self.store.make(f"random_on_test_{i}", lambda i=i: on_test(i))
        for i in range(5):
            self.store.make(f"random_on_train_{i}", lambda i=i: on_train(i))


def run_steps(ctx, subset_name: str, header: str, make_strategies, *,
              predictions_batch_size: int, subset_size: int, k_nearest: int,
              knn_method: str, project_name: str, dataset: str, finetune_lr: float,
              finetune_wd: float, finetune_epochs: int, finetune_batch_size: int,
              config: dict) -> dict:
    """Steps [2]-[4] of the main, EGL and LLM CLIs after step [1] (`ctx`):
    the predictions, `make_strategies(Strategies)` into
    `<run_dir>/<subset_name>/subset_indices_train.json` (saved after each
    strategy and once more at the end, as in JAX), and the fine-tune of
    each subset with `config` logged. Returns `run`'s dict."""
    from bayesvlm_tpu_torch.inference.predictions import make_predictions
    from bayesvlm_tpu_torch.train.al_common import (
        barrier,
        finetune_all_subsets,
        synchronize,
    )

    seconds = {"[1] features": ctx.seconds["features"],
               "[1] lambda + covariances": ctx.seconds["lambda + covariances"]}
    t0 = time.perf_counter()
    print("[2] Making predictions ...")
    logits = {}
    for split, feats in (("train", ctx.image_outputs_train),
                         ("test", ctx.image_outputs_test)):
        for suffix, map_est in (("", False), ("_map", True)):
            logits[split + suffix] = make_predictions(
                ctx.head, feats, ctx.label_outputs, batch_size=predictions_batch_size,
                map_estimate=map_est)
    synchronize(ctx.device)
    seconds["[2] predictions"] = time.perf_counter() - t0

    subset_dir = ctx.run_dir / subset_name
    subset_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    print(header)
    store = SubsetStore(subset_dir / "subset_indices_train.json", ctx.is_primary)
    barrier()
    make_strategies(Strategies(ctx, store, logits, subset_size, k_nearest, knn_method))
    store.save()
    synchronize(ctx.device)
    seconds["[3] strategies"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[4] Fine-tuning based on training subsets ...")
    timings = {}
    results = finetune_all_subsets(
        ctx, store.subsets, subset_dir, project_name, dataset,
        finetune_lr, finetune_wd, finetune_epochs, finetune_batch_size,
        config=config, timings=timings)
    synchronize(ctx.device)
    seconds["[4] fine-tuning"] = time.perf_counter() - t0
    return dict(results=results, seconds=seconds, strategy_seconds=store.seconds,
                finetune=timings, subset_dir=subset_dir, subsets=store.subsets)


def run(
    model_str: str,
    dataset: str,
    hessian_dir: str,
    experiment_dir: str,
    project_name: str,
    hessian_scale: float,
    subset_size: int,
    predictions_batch_size: int = 256,
    precompute_batch_size: int = 256,
    precompute_num_workers: int = 8,
    finetune_lr: float = 1e-5,
    finetune_wd: float = 5e-2,
    finetune_epochs: int = 100,
    finetune_batch_size: int = 30,
    only_deterministic_strategies: bool = False,
    only_random_strategies: bool = False,
    only_epig: bool = False,
    without_epig: bool = False,
    epig_lr: float = 1e-4,
    epig_hessian_update_scale: float = 10.0,
    epig_num_samples: int = 100,
    k_nearest: int = 1,
    knn_method: str = "wasserstein",
    weights_dir=None,
    tokenizer_dir=None,
    mlp_int8: bool = False,
    epig_pool_max_size: int = 40_000,
    epig_target_max_size: int = 20_000,
    device: str = "cuda",
    dtype: str = "bf16",
    dataset_overrides: Optional[dict] = None,
) -> dict:
    """Steps [1]-[4]; returns a dict: `results` (each trained strategy's
    best test metrics, what `main` returns), `seconds` (each step's, host
    clock, the card synchronised at each step's end; "[1] features" is
    the feature pass alone), `strategy_seconds` (each strategy made in
    this run), `finetune` (each trained strategy's {"seconds", "epochs",
    "steps"}), `subset_dir` and `subsets` (the JSON's content).
    `dataset_overrides` go to the datamodule's constructor (e.g. the
    synthetic module's `image_size`, `num_train`, `num_val`, `num_test`,
    `num_classes`)."""
    if only_epig and without_epig:
        # would select no strategy, after the whole feature pass
        raise ValueError("Cannot set both only_epig and without_epig")
    from bayesvlm_tpu_torch.dist.init import initialize_distributed
    from bayesvlm_tpu_torch.train.al_common import refuse_unported, setup_context

    device = refuse_unported(device)
    # a launch of several processes (COORDINATOR_ADDRESS / NUM_PROCESSES /
    # PROCESS_ID): the feature pass striped over the ranks, the selection
    # and fine-tune replicated, rank 0 alone writing; a no-op for one
    dist_ctx = initialize_distributed(device=device)
    if dist_ctx.num_hosts <= 1:
        dist_ctx = None
    else:
        device = dist_ctx.device
    ctx = setup_context(
        model_str, dataset, hessian_dir, experiment_dir, hessian_scale,
        precompute_batch_size, precompute_num_workers, weights_dir, tokenizer_dir,
        mlp_int8=mlp_int8, device=device, dtype=dtype,
        dataset_overrides=dataset_overrides, dist_ctx=dist_ctx)

    def make_strategies(st: Strategies) -> None:
        if not only_random_strategies and not only_epig:
            st.deterministic()
        if not only_random_strategies and not without_epig:
            st.epig(epig_lr, epig_hessian_update_scale, epig_num_samples,
                    epig_pool_max_size, epig_target_max_size)
        if not only_deterministic_strategies and not only_epig:
            st.random()

    return run_steps(
        ctx, f"subset_{subset_size}_k_{k_nearest}_n_{hessian_scale}_epig_lr_{epig_lr}"
             f"_epig_update_{epig_hessian_update_scale}_knn_{knn_method}",
        "[3] Creating training subsets ...", make_strategies,
        predictions_batch_size=predictions_batch_size, subset_size=subset_size,
        k_nearest=k_nearest, knn_method=knn_method, project_name=project_name,
        dataset=dataset, finetune_lr=finetune_lr, finetune_wd=finetune_wd,
        finetune_epochs=finetune_epochs, finetune_batch_size=finetune_batch_size,
        config=dict(subset_size=subset_size, k_nearest=k_nearest,
                    hessian_scale=hessian_scale, epig_lr=epig_lr,
                    epig_hessian_update_scale=epig_hessian_update_scale,
                    epig_mc_samples=epig_num_samples, knn_method=knn_method))


def main(*args, **kwargs) -> dict:
    """The CLI's entry point: takes `run`'s arguments and returns each
    trained strategy's best test metrics, as the JAX `main` does."""
    return run(*args, **kwargs)["results"]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", type=str, default="clip-base")
    parser.add_argument("--dataset", type=str, default="homeoffice-da-clipart")
    parser.add_argument("--hessian_dir", type=str,
                        default="hessians/hessian_CLIP-ViT-B-32-laion2B-s34B-b79K")
    parser.add_argument("--experiment_dir", type=str,
                        default="experiments/active-finetuning")
    parser.add_argument("--project_name", type=str, default="active-finetuning")
    parser.add_argument("--subset_size", type=int, default=50)
    parser.add_argument("--hessian_scale", type=float, default=10)
    parser.add_argument("--predictions_batch_size", type=int, default=256)
    parser.add_argument("--precompute_batch_size", type=int, default=256)
    parser.add_argument("--precompute_num_workers", type=int, default=8)
    parser.add_argument("--finetune_lr", type=float, default=1e-5)
    parser.add_argument("--finetune_wd", type=float, default=5e-2)
    parser.add_argument("--finetune_epochs", type=int, default=100)
    parser.add_argument("--finetune_batch_size", type=int, default=30)
    parser.add_argument("--only_deterministic_strategies", action="store_true")
    parser.add_argument("--only_random_strategies", action="store_true")
    parser.add_argument("--without_epig", action="store_true")
    parser.add_argument("--only_epig", action="store_true")
    parser.add_argument("--epig_lr", type=float, default=1e-4)
    parser.add_argument("--epig_hessian_update_scale", type=float, default=10.0)
    parser.add_argument("--k_nearest", type=int, default=1)
    parser.add_argument("--knn_method", type=str, default="wasserstein")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--weights_dir", type=str, default=None)
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--mlp_int8", action="store_true",
                        help="W8A8 int8 vision-tower MLPs for the feature pass "
                        "(csrc/mlp_int8.cu); off by default")
    parser.add_argument("--epig_num_samples", type=int, default=100,
                        help="EPIG Monte-Carlo samples (reference default 100)")
    parser.add_argument("--epig_pool_max_size", type=int, default=40_000)
    parser.add_argument("--epig_target_max_size", type=int, default=20_000)
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(
        model_str=args.model,
        dataset=args.dataset,
        hessian_dir=args.hessian_dir,
        experiment_dir=args.experiment_dir,
        project_name=args.project_name,
        hessian_scale=args.hessian_scale,
        subset_size=args.subset_size,
        predictions_batch_size=args.predictions_batch_size,
        precompute_batch_size=args.precompute_batch_size,
        precompute_num_workers=args.precompute_num_workers,
        finetune_lr=args.finetune_lr,
        finetune_wd=args.finetune_wd,
        finetune_epochs=args.finetune_epochs,
        finetune_batch_size=args.finetune_batch_size,
        only_deterministic_strategies=args.only_deterministic_strategies,
        only_random_strategies=args.only_random_strategies,
        only_epig=args.only_epig,
        without_epig=args.without_epig,
        epig_lr=args.epig_lr,
        epig_hessian_update_scale=args.epig_hessian_update_scale,
        epig_num_samples=args.epig_num_samples,
        epig_pool_max_size=args.epig_pool_max_size,
        epig_target_max_size=args.epig_target_max_size,
        k_nearest=args.k_nearest,
        knn_method=args.knn_method,
        weights_dir=args.weights_dir,
        tokenizer_dir=args.tokenizer_dir,
        mlp_int8=args.mlp_int8,
        device=args.device,
        dtype=args.dtype,
    )
