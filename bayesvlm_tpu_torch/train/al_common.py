"""Setup shared by the active-learning CLIs, counterpart of
`bayesvlm_tpu.train.al_common` (the common prefix of
ref:scripts/activelearning{,_kmeans}.py): the features of the train,
val and test splits and of the class prompts, the K-FAC factors, lambda
re-optimised per tower, the covariances and the head; then the
fine-tune of each strategy's subset.

Several processes, one a card (a `DistContext` from
`dist.init.initialize_distributed`): each rank encodes its stripe of the
loader's batches, the feature rows are gathered and put back in dataset
order, and everything after (selection, fine-tune) runs replicated on
every rank, the same there because the gathered inputs and the seeds
are. Only rank 0 writes: the feature caches (the gathered features, in
the files one process writes, so either kind of run resumes from
them), the subsets and the checkpoints; the other ranks' fine-tune logs
go to `_replica_host{rank}` beside rank 0's. The ranks share the
experiment directory.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ALContext:
    dm: Any
    image_encoder: Any
    text_encoder: Any
    head: Any
    image_outputs_train: Any
    class_ids_train: Any
    image_ids_train: Any
    image_outputs_val: Any
    class_ids_val: Any
    image_outputs_test: Any
    class_ids_test: Any
    image_ids_test: Any
    label_outputs: Any
    A_img: Any
    B_img: Any
    A_txt: Any
    B_txt: Any
    covar_info: dict
    run_dir: Path
    device: torch.device
    # the seconds of "features" (train, val, test and the prompts, each a
    # cache hit where its files exist) and of "lambda + covariances", the
    # card synchronised at each one's end
    seconds: dict = dataclasses.field(default_factory=dict)
    dist_ctx: Any = None  # a DistContext when launched as several processes

    @property
    def is_primary(self) -> bool:
        return self.dist_ctx is None or self.dist_ctx.is_primary


def barrier() -> None:
    """Several processes (a process group of more than one rank): wait
    until every rank is here; one process: no-op.
    Resume decisions read the directory before a barrier and rank 0 writes
    only after it, so every rank decides alike."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def synchronize(device: torch.device) -> None:
    """Wait for the card, so that a host clock read after it times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def refuse_unported(device) -> torch.device:
    """The check the CLIs make before anything is loaded: a CUDA device
    must exist unless the caller names another (nothing falls back to the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the active-learning CLIs run on the card; "
                           "pass --device cpu to run on the CPU")
    return device


def _stripe_batches(loader, host_id: int, num_hosts: int, sizes: list):
    """This host's stripe of a deterministic loader: batch i goes whole to
    host i % num_hosts, and its size is appended to `sizes`. Whole batches
    (the JAX package stripes single samples) keep each batch as one
    process encodes it, so the gathered features are those bits."""
    for i, batch in enumerate(loader):
        if i % num_hosts == host_id:
            sizes.append(len(batch["image"]))
            yield batch


def _striped_order(sizes: list, dist_ctx) -> torch.Tensor:
    """The permutation taking the rank-order concatenation of every
    host's stripe back to the loader's order, from each host's batch
    sizes."""
    from bayesvlm_tpu_torch.dist.init import allgather_rows

    all_sizes, counts = allgather_rows(np.asarray(sizes, np.int64), dist_ctx.num_hosts,
                                       return_counts=True)
    H = dist_ctx.num_hosts
    per_host = np.split(all_sizes, np.cumsum(counts)[:-1])
    starts = np.concatenate([[0], np.cumsum([s.sum() for s in per_host])[:-1]])
    order = []
    for i in range(len(all_sizes)):
        h = i % H
        n = int(per_host[h][i // H])
        order.extend(range(int(starts[h]), int(starts[h]) + n))
        starts[h] += n
    return torch.as_tensor(order, dtype=torch.long)


def _gather_striped(x: torch.Tensor, order: torch.Tensor, dist_ctx) -> torch.Tensor:
    """Every host's stripe rows gathered and put back in dataset order."""
    from bayesvlm_tpu_torch.dist.init import allgather_rows

    return allgather_rows(x, dist_ctx.num_hosts)[order.to(x.device)]


def encode_striped(image_encoder, loader, dist_ctx):
    """Several processes: each rank encodes its stripe of the loader's
    batches; returns every rank's rows in dataset order, (EncoderResult,
    class_ids, image_ids) on the encoder's device. A rank whose stripe is
    empty (fewer batches than ranks) takes its peers' row shapes."""
    import itertools

    import torch.distributed as dist

    from bayesvlm_tpu_torch.inference.precompute import precompute_image_features
    from bayesvlm_tpu_torch.types import EncoderResult

    sizes: list = []
    stripe = _stripe_batches(loader, dist_ctx.host_id, dist_ctx.num_hosts, sizes)
    first = next(stripe, None)
    local = None
    if first is not None:
        er, class_ids, image_ids = precompute_image_features(
            image_encoder, itertools.chain([first], stripe))
        local = [er.embeds, er.activations, er.residuals, class_ids, image_ids]
    shapes = [None] * dist_ctx.num_hosts
    dist.all_gather_object(shapes, None if local is None else [
        (tuple(t.shape[1:]), str(t.dtype).split(".")[-1]) for t in local])
    if local is None:
        template = next(s for s in shapes if s is not None)
        local = [torch.empty((0,) + shape, dtype=getattr(torch, dtype),
                             device=image_encoder.device) for shape, dtype in template]
    order = _striped_order(sizes, dist_ctx)
    embeds, activations, residuals, class_ids, image_ids = (
        _gather_striped(t, order, dist_ctx) for t in local)
    return EncoderResult(embeds, activations, residuals), class_ids, image_ids


def _precompute_striped(image_encoder, loader, cache: Path, dist_ctx):
    """Several processes: the split's features from rank 0's cache where it
    holds them all, else `encode_striped`, and rank 0 caches them."""
    from bayesvlm_tpu_torch.inference.precompute import (
        image_cache_paths,
        precompute_image_features,
        save_image_features,
    )

    if all(p.exists() for p in image_cache_paths(cache).values()):
        return precompute_image_features(image_encoder, [], cache_dir=cache)
    er, class_ids, image_ids = encode_striped(image_encoder, loader, dist_ctx)
    if dist_ctx.is_primary:
        save_image_features(cache, er, class_ids, image_ids)
    return er, class_ids, image_ids


def setup_context(
    model_str: str,
    dataset: str,
    hessian_dir: str,
    experiment_dir: str,
    hessian_scale: float,
    precompute_batch_size: int,
    precompute_num_workers: int,
    weights_dir=None,
    tokenizer_dir=None,
    mlp_int8: bool = False,
    device: str = "cuda",
    dtype: str = "bf16",
    dataset_overrides: Optional[dict] = None,
    dist_ctx=None,
) -> ALContext:
    """Step [1] of the CLIs on `device`. `dtype` is the towers' GEMM
    weights (bf16, as the JAX package's `cast_gemm_params`, or fp32);
    `dataset_overrides` go to the datamodule's constructor (e.g. the
    synthetic module's `image_size` and split sizes). The features are
    cached under `run_dir/base/<split>` (the prompts' under `run_dir/base`)
    in the files both packages read. `dist_ctx` (several processes) stripes
    the feature pass over the ranks (module docstring)."""
    from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
    from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
    from bayesvlm_tpu_torch.data.factory import DataModuleFactory
    from bayesvlm_tpu_torch.data.tokenizer import make_tokenizer
    from bayesvlm_tpu_torch.data.transforms import get_transform
    from bayesvlm_tpu_torch.inference.precompute import (
        precompute_image_features,
        precompute_text_features,
    )
    from bayesvlm_tpu_torch.io.artifacts import load_hessians
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.utils import get_image_size

    device = torch.device(device)
    run_dir = Path(experiment_dir) / dataset
    run_dir.mkdir(parents=True, exist_ok=True)

    config = CONFIGS_BY_NAME[model_str]
    transform = get_transform(config.family, get_image_size(model_str))
    dm = DataModuleFactory(
        batch_size=precompute_batch_size,
        num_workers=precompute_num_workers,
        shuffle_train=False,
        train_transform=transform,
        test_transform=transform,
    ).create(dataset, **(dataset_overrides or {}))
    dm.setup()

    tdtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    # load_model casts the GEMM weights to the compute dtype
    image_encoder, text_encoder, head = load_model(
        model_str, weights_dir=weights_dir, dtype=tdtype, device=device,
        mlp_int8=mlp_int8)
    image_encoder.prequantize_int8()  # no-op unless mlp_int8
    text_encoder.tokenizer = make_tokenizer(config.text, tokenizer_dir)

    seconds = {}
    t0 = time.perf_counter()
    print("[1] Precomputing features ...")
    base = run_dir / "base"
    multi_host = dist_ctx is not None and dist_ctx.num_hosts > 1
    if multi_host:
        print(f"[dist] host {dist_ctx.host_id}/{dist_ctx.num_hosts} encodes its "
              f"stripe of the batches on {device}")

        def features(loader, split):
            return _precompute_striped(image_encoder, loader, base / split, dist_ctx)
    else:
        def features(loader, split):
            return precompute_image_features(image_encoder, loader,
                                             cache_dir=base / split,
                                             save_predictions=True)
    image_outputs_train, class_ids_train, image_ids_train = features(
        dm.train_dataloader(), "train")
    image_outputs_val, class_ids_val, _ = features(dm.val_dataloader(), "val")
    image_outputs_test, class_ids_test, image_ids_test = features(
        dm.test_dataloader(), "test")
    # the class prompts are few: rank 0 reads or writes their cache, the
    # other ranks encode them (so no rank reads a file while it is written)
    primary = not multi_host or dist_ctx.is_primary
    label_outputs = precompute_text_features(
        text_encoder, dm.class_prompts, batch_size=precompute_batch_size,
        cache_dir=base if primary else None, save_predictions=primary)
    synchronize(device)
    seconds["features"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    A_img, B_img = (F.to(device) for F in load_hessians(hessian_dir, "img"))
    A_txt, B_txt, info = load_hessians(hessian_dir, "txt", return_info=True)
    A_txt, B_txt = A_txt.to(device), B_txt.to(device)
    lambdas = {}
    for tag, encoder, A, B in (("img", image_encoder, A_img, B_img),
                               ("txt", text_encoder, A_txt, B_txt)):
        lambdas[tag] = float(optimize_prior_precision(
            encoder.projection_l2(), encoder.projection_num_params(), A=A, B=B,
            lmbda_init=info[f"lambda_{tag}"], n=hessian_scale, lr=1e-2, num_steps=500))
    covar_info = dict(lambda_img=lambdas["img"], lambda_txt=lambdas["txt"],
                      n_img=hessian_scale, n_txt=hessian_scale)
    cov_img, cov_txt = compute_covariances(A_img, B_img, A_txt, B_txt, covar_info)
    head = head.set_covariances(cov_img, cov_txt)
    synchronize(device)
    seconds["lambda + covariances"] = time.perf_counter() - t0

    return ALContext(
        dm=dm, image_encoder=image_encoder, text_encoder=text_encoder, head=head,
        image_outputs_train=image_outputs_train, class_ids_train=class_ids_train,
        image_ids_train=image_ids_train,
        image_outputs_val=image_outputs_val, class_ids_val=class_ids_val,
        image_outputs_test=image_outputs_test, class_ids_test=class_ids_test,
        image_ids_test=image_ids_test, label_outputs=label_outputs,
        A_img=A_img, B_img=B_img, A_txt=A_txt, B_txt=B_txt,
        covar_info=covar_info, run_dir=run_dir, device=device, seconds=seconds,
        dist_ctx=dist_ctx)


def epig_subset(ctx: ALContext, budget: int, lr: float, hessian_update_scale: float,
                num_samples: int, pool_max_size: int, target_max_size: int,
                knn_method: str) -> dict:
    """The online-EPIG strategy's JSON entry {0: {score, indices,
    similarities}}: `select_epig_online` over the whole train pool with
    the test set as targets, seed 0, the pool cut to the test samples'
    nearest neighbours by `knn_method`'s similarity
    (ref:scripts/activelearning.py:185-213)."""
    from bayesvlm_tpu_torch.select.epig import select_epig_online

    proj = ctx.image_encoder.projection_tree()
    indices, scores = select_epig_online(
        label_features=ctx.label_outputs, pool_features=ctx.image_outputs_train,
        target_features=ctx.image_outputs_test, pool_class_ids=ctx.class_ids_train,
        projection_kernel=proj["kernel"], projection_bias=proj.get("bias"),
        head=ctx.head, A_img=ctx.A_img, A_txt=ctx.A_txt, B_img=ctx.B_img,
        B_txt=ctx.B_txt, cov_info=ctx.covar_info, budget=budget, lr=lr,
        hessian_update_scale=hessian_update_scale, num_samples=num_samples, seed=0,
        projection_l2=ctx.image_encoder.projection_l2(),
        projection_num_params=ctx.image_encoder.projection_num_params(),
        pool_max_size=pool_max_size, target_max_size=target_max_size,
        pool_subsampling="knn_cosine" if knn_method == "cosine" else "knn_wasserstein",
        proj_has_bias=ctx.head.source_projection_has_bias, device=ctx.device)
    return {0: dict(score=0.0, indices=indices, similarities=scores)}


def finetune_all_subsets(
    ctx: ALContext,
    subset_indices_train: dict,
    subset_dir: Path,
    project_name: str,
    dataset: str,
    finetune_lr: float,
    finetune_wd: float,
    finetune_epochs: int,
    finetune_batch_size: int,
    config: Optional[dict] = None,
    early_stopping_patience: Optional[int] = None,
    timings: Optional[dict] = None,
) -> dict:
    """Fine-tune the image projection on each strategy's subset and write
    `<subset_dir>/<strategy>/img_projection.pt`, the full state dict
    ({"weight": [out, in]} plus SigLIP's "bias": the reference's
    `torch.save(img_projection.state_dict())`,
    ref:scripts/activelearning.py:657-660). A strategy whose checkpoint
    exists is skipped (ref:activelearning_kmeans.py:424). Returns each
    trained strategy's best test metrics; `timings`, when given, receives
    each trained strategy's {"seconds", "epochs", "steps"}. Several
    processes: every rank trains the same subsets (the replicas train
    identically); rank 0 logs and writes the checkpoints, another rank
    logs to `<strategy>/_replica_host{rank}` and writes no checkpoint."""
    from bayesvlm_tpu_torch.select.knn import extract_test_train_indices
    from bayesvlm_tpu_torch.train.finetune import finetune_projection
    from bayesvlm_tpu_torch.train.logging import ExperimentLogger

    results = {}
    done = {subset for subset in subset_indices_train
            if (subset_dir / subset / "img_projection.pt").exists()}
    barrier()
    for subset, indices_dict in subset_indices_train.items():
        print(f"    - Fine-tuning on subset {subset} ...")
        finetune_dir = subset_dir / subset
        finetune_dir.mkdir(parents=True, exist_ok=True)
        checkpoint_path = finetune_dir / "img_projection.pt"
        if subset in done:
            print(f"      checkpoint exists, skipping: {checkpoint_path}")
            continue

        t0 = time.perf_counter()
        indices = torch.as_tensor(extract_test_train_indices(indices_dict)["train"],
                                  dtype=torch.long)
        masked_features = ctx.image_outputs_train[indices.to(ctx.device)]
        masked_class_ids = ctx.class_ids_train[indices.to(ctx.class_ids_train.device)]

        logger_dir = finetune_dir if ctx.is_primary else (
            finetune_dir / f"_replica_host{ctx.dist_ctx.host_id}")
        logger = ExperimentLogger(
            project_name, logger_dir,
            name=f"{finetune_dir.parent.name}/{finetune_dir.name}",
            config=dict(lr=finetune_lr, wd=finetune_wd, epochs=finetune_epochs,
                        batch_size=finetune_batch_size, selection=subset,
                        dataset=dataset, **(config or {})))
        stats = {}
        try:
            best_proj, best_test_m = finetune_projection(
                ctx.image_encoder.projection_tree(), ctx.text_encoder.projection_tree(),
                ctx.head, masked_features, masked_class_ids,
                ctx.image_outputs_val, ctx.class_ids_val,
                ctx.image_outputs_test, ctx.class_ids_test,
                ctx.label_outputs,
                lr=finetune_lr, wd=finetune_wd, epochs=finetune_epochs,
                batch_size=finetune_batch_size,
                num_classes=len(ctx.dm.class_prompts),
                logger=logger,
                early_stopping_patience=early_stopping_patience,
                stats=stats,
            )
        finally:
            logger.finish()
        state = {"weight": best_proj["kernel"].T.contiguous().cpu()}
        if best_proj.get("bias") is not None:
            state["bias"] = best_proj["bias"].cpu()
        if ctx.is_primary:
            torch.save(state, checkpoint_path)
        synchronize(ctx.device)
        if timings is not None:
            timings[subset] = dict(seconds=time.perf_counter() - t0, **stats)
        results[subset] = best_test_m
        print(f"      best test metrics: {best_test_m}")
    return results
