"""Stage 1: fit the K-FAC Laplace posterior over a (LAION-scale) dataset,
the port of the JAX package's `scripts/hessian_estimation.py`
(ref:scripts/hessian_estimation.py): same flags and defaults, same
printed lines, same artifact directory.

    python -m bayesvlm_tpu_torch.hessian_estimation --model clip-large \\
        --hessian_dir <dir>

Writes into `--hessian_dir`: the feature caches `activations_{img,txt}.pt`
and `embeddings_{img,txt}.pt`, the factors `A_{img,txt}_analytic.pt` and
`B_{img,txt}_analytic.pt` (already divided by sqrt(n)) and
`prior_precision_analytic.json`, which both packages' `load_hessians`
read. Each step is skipped when its files exist (file-gated resume); the
feature pass also resumes from its part files and the GGN from its step
checkpoints (`_ggn_steps_{img,txt}`).

Runs on the card unless `--device` names another. `--dtype` (bf16, the
JAX CLI's GEMM weights, or fp32) is the towers' compute dtype; the GGN
always runs in fp32 (`--ggn_precision high`: 3xTF32). `--weights_dir` is
an HF snapshot directory or the port's converted `vision.pt` / `text.pt`;
`--tokenizer_dir` a local HF tokenizer (needs `transformers`), else the
deterministic `HashTokenizer`. `--u8_pipeline` ships uint8 crops that
the image encoder normalises on the device (`get_transform_uint8`).

Several processes, one a card (`COORDINATOR_ADDRESS`, `NUM_PROCESSES`,
`PROCESS_ID`; dist/init.py): each takes its share of the tars
(`shard_for_host`), caches its features as `*_{img,txt}_host{rank}.pt`
and accumulates a local GGN, and `allreduce_factors` combines the
factors; with `--dist_global_batch` the features are gathered instead
and the class batches span the whole dataset, sharded over the ranks.
The GGN step checkpoints run on one process only; only rank 0 writes the
factors, `prior_precision_analytic.json` and the final JSON line.
`--no_mesh` runs one process whatever the environment says.
`--native_decode` decodes whole batches of the LAION JPEGs natively
(data/native_io.py, bilinear): on the card with nvJPEG and the
resize_crop kernel, each rank onto its own card, or with `--device cpu`
through libjpeg; `--num_workers` is its CPU decode threads and
`--u8_pipeline` makes it ship uint8 crops. `--save_orbax` keeps the JAX
flag's spelling: it also writes the factors as the port's DCP
checkpoint, `<hessian_dir>/factors_dcp/` (io/dcp_ckpt.py), from rank 0.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch


def main(
    dataset: str,
    model_str: str,
    precompute_batch_size: int,
    la_num_classes: int,
    la_batch_size: int,
    num_workers: int,
    hessian_dir: str,
    num_files=None,
    max_datapoints=None,
    siglip_chunk_size_j: int = 8000,
    lambda_init_txt: float = 400,
    lambda_init_img: float = 800,
    n_init_txt: float = 1.0,
    n_init_img: float = 1.0,
    lr: float = 1e-2,
    num_steps: int = 300,
    weights_dir=None,
    tokenizer_dir=None,
    use_mesh: bool = True,
    native_decode: bool = False,
    ggn_precision: str = "highest",
    dist_global_batch: bool = False,
    u8_pipeline: bool = False,
    mlp_int8: bool = False,
    save_orbax: bool = False,
    feature_checkpoint_every: int = 256,
    ggn_checkpoint_every: int = 1,
    device: str = "cuda",
    dtype: str = "bf16",
    dataset_overrides: Optional[dict] = None,
) -> dict:
    """The JAX `main`'s steps; returns {"lambda_img", "lambda_txt",
    "seconds"}: the seconds of each step (host clock, the card
    synchronised at each step's end). `dataset_overrides` go to the
    datamodule's constructor (e.g. the synthetic module's `image_size`,
    `num_test`, `num_classes`). `weights_dir` is an HF snapshot or the
    port's converted `vision.pt` / `text.pt`, or None for seeded random
    towers; `tokenizer_dir` a local HF tokenizer, else `HashTokenizer`.
    With `use_mesh`, a launch named by the environment (or a process group
    the caller initialised) runs as one rank of several (module
    docstring); rank r works on `cuda:{r % device_count()}` when `device`
    is "cuda"."""
    from bayesvlm_tpu_torch.bayes.estimation import kfac_ggn
    from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
    from bayesvlm_tpu_torch.data.factory import DataModuleFactory
    from bayesvlm_tpu_torch.data.tokenizer import make_tokenizer
    from bayesvlm_tpu_torch.data.transforms import get_transform, get_transform_uint8
    from bayesvlm_tpu_torch.dist.init import (
        allgather_rows,
        allreduce_factors,
        initialize_distributed,
    )
    from bayesvlm_tpu_torch.inference.precompute import compute_features
    from bayesvlm_tpu_torch.io.artifacts import (
        load_hessians,
        save_hessians,
        save_prior_precision,
    )
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.utils import get_image_size, get_likelihood_for_model

    # one process unless a launch is named (no-op then); the rank's card
    ctx = initialize_distributed(device=device) if use_mesh else None
    multi_host = ctx is not None and ctx.num_hosts > 1
    primary = ctx is None or ctx.is_primary
    device = ctx.device if multi_host else torch.device(device)
    seconds = {}
    clock = [time.perf_counter()]

    def step_done(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

    os.makedirs(hessian_dir, exist_ok=True)
    config = CONFIGS_BY_NAME[model_str]
    likelihood = get_likelihood_for_model(model_str)
    # --u8_pipeline: uint8 crops, normalised by the image encoder on the
    # device (a quarter of the host-to-device bytes)
    transform = (get_transform_uint8 if u8_pipeline else get_transform)(
        config.family, get_image_size(model_str))

    tdtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    image_encoder, text_encoder, head = load_model(
        model_str, weights_dir=weights_dir, dtype=tdtype, device=device,
        mlp_int8=mlp_int8)
    image_encoder.prequantize_int8()  # no-op unless mlp_int8
    text_encoder.tokenizer = make_tokenizer(config.text, tokenizer_dir)

    dm = DataModuleFactory(
        batch_size=precompute_batch_size,
        num_workers=num_workers,
        shuffle_train=False,
        train_transform=transform,
        test_transform=transform,
    ).create(dataset, **(dataset_overrides or {}))
    if num_files is not None and dataset == "laion400m":
        print(f"Reducing number of files from {len(dm.data_path)} to {num_files}")
        dm.data_path = dm.data_path[:num_files]
    dm.setup()
    if native_decode:
        if not hasattr(dm, "enable_native_decode"):
            raise ValueError(f"--native_decode not supported for {dataset}")
        dm.enable_native_decode(get_image_size(model_str), family=config.family,
                                num_threads=num_workers, out_uint8=u8_pipeline,
                                device=device)
        print("[native] batched C++ JPEG decode lane enabled "
              "(bilinear; see BASELINE.md for the measured delta)")
    if multi_host:
        if not hasattr(dm, "shard_for_host"):
            # without a per-host split every host would take the whole
            # dataset, and allreduce_factors would combine duplicated sums
            # as if disjoint: factors inflated by sqrt(num_hosts)
            raise ValueError(
                f"multi-host runs need per-host data sharding, but dataset "
                f"'{dataset}' does not support shard_for_host (currently "
                f"only the webdataset-tar modules do); run single-host or "
                f"use a shardable dataset")
        dm.shard_for_host(ctx.host_id, ctx.num_hosts)
        print(f"[dist] host {ctx.host_id}/{ctx.num_hosts} takes "
              f"{len(dm.dataset.tar_paths)} tar shards")
    loader = dm.test_dataloader()
    step_done("load")

    # several processes: each caches the features of its own shard
    host_tag = f"_host{ctx.host_id}" if multi_host else ""
    fce = feature_checkpoint_every if feature_checkpoint_every > 0 else None
    path_act_img, path_emb_img = compute_features(
        image_encoder, loader, tag="img" + host_tag, cache_dir=hessian_dir,
        modality="image", checkpoint_every=fce)
    step_done("img features")
    path_act_txt, path_emb_txt = compute_features(
        text_encoder, loader, tag="txt" + host_tag, cache_dir=hessian_dir,
        modality="text", checkpoint_every=fce)
    step_done("txt features")

    print("Loading embeddings and activations...")
    activations_img, embeddings_img, activations_txt, embeddings_txt = (
        torch.load(p, map_location=device, weights_only=True)[:max_datapoints]
        for p in (path_act_img, path_emb_img, path_act_txt, path_emb_txt))

    # --dist_global_batch: every host's features gathered in rank order, so
    # that the class batches span the whole dataset, sharded over the
    # ranks; otherwise each host forms its class batches from its own
    # shard and the factors are combined afterwards
    global_batch = multi_host and dist_global_batch
    if global_batch:
        activations_img, embeddings_img, activations_txt, embeddings_txt = (
            allgather_rows(x, ctx.num_hosts) for x in (
                activations_img, embeddings_img, activations_txt, embeddings_txt))
        print(f"[dist] global class batches over {len(embeddings_img)} "
              f"gathered pairs, mesh {tuple(ctx.mesh.shape)}")
    mesh = ctx.mesh if global_batch else None  # else one device a rank

    def global_factors(A, B, n_local):
        if not multi_host or global_batch:
            return A, B  # one host, or class batches already over all hosts
        A, B = allreduce_factors(A, B, n_local, num_hosts=ctx.num_hosts)
        return torch.from_numpy(A).to(device), torch.from_numpy(B).to(device)

    # GGN step checkpoints: one process only (several keep the
    # whole-artifact gating, which the per-host feature parts shorten)
    def ggn_ckpt_dir(direction):
        if multi_host or ggn_checkpoint_every <= 0:
            return None
        return Path(hessian_dir) / f"_ggn_steps_{direction}"

    factors = {}
    for tag, title, src, act, tgt in (
            ("img", "image", embeddings_img, activations_img, embeddings_txt),
            ("txt", "text", embeddings_txt, activations_txt, embeddings_img)):
        if all((Path(hessian_dir) / f"{n}_{tag}_analytic.pt").exists() for n in "AB"):
            factors[tag] = [F.to(device) for F in load_hessians(hessian_dir, tag)]
        else:
            print(f"Computing Hessian for {title} encoder...")
            A, B = kfac_ggn(
                head.logit_scale, head.logit_bias, la_num_classes, src, act, tgt,
                likelihood, block_size=la_batch_size,
                chunk_size_j=siglip_chunk_size_j, precision=ggn_precision,
                mesh=mesh, progress=True, checkpoint_dir=ggn_ckpt_dir(tag),
                checkpoint_every=ggn_checkpoint_every, device=device)
            n_local = (len(src) // la_num_classes) * la_num_classes
            factors[tag] = global_factors(A, B, n_local)
            if primary:
                save_hessians(hessian_dir, *factors[tag], tag)
        step_done(f"GGN {tag}")

    lambdas = {}
    for tag, title, encoder, lmbda_init, n in (
            ("img", "image", image_encoder, lambda_init_img, n_init_img),
            ("txt", "text", text_encoder, lambda_init_txt, n_init_txt)):
        print(f"Optimizing prior precision for {title} encoder...")
        A, B = factors[tag]
        lambdas[tag] = float(optimize_prior_precision(
            encoder.projection_l2(), encoder.projection_num_params(),
            A=A, B=B, lmbda_init=lmbda_init, n=n, lr=lr, num_steps=num_steps))
        step_done(f"lambda {tag}")
    if primary:
        save_prior_precision(hessian_dir, lambdas["img"], n_init_img, lambdas["txt"],
                             n_init_txt)
        if save_orbax:
            # the production lane beside the .pt contract files (JAX
            # scripts/hessian_estimation.py:281-287); load_hessians falls
            # back to it when the .pt files are absent
            from bayesvlm_tpu_torch.io.dcp_ckpt import save_hessians_dcp

            save_hessians_dcp(hessian_dir, *factors["img"], *factors["txt"])
        print(json.dumps({"lambda_img": lambdas["img"], "lambda_txt": lambdas["txt"]}))
    return {"lambda_img": lambdas["img"], "lambda_txt": lambdas["txt"],
            "seconds": seconds}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dataset", type=str, default="laion400m")
    parser.add_argument("--model", type=str, default="clip-base")
    parser.add_argument("--precompute_batch_size", type=int, default=10)
    parser.add_argument("--la_num_classes", type=int, default=32768)
    parser.add_argument(
        "--la_batch_size", type=int, default=2048,
        help="GGN source-axis block size; results are block-size invariant")
    parser.add_argument(
        "--num_workers", type=int, default=8,
        help="decode threads: >= 2 with >= 2 tars assigns the tars "
        "round-robin to threads (another deterministic order than < 2; "
        "drop_last per thread)")
    parser.add_argument("--hessian_dir", type=str,
                        default="hessians/custom-hessian-clip-base")
    parser.add_argument("--num_files", type=int, default=60)
    parser.add_argument("--max_datapoints", type=int, default=327680)
    parser.add_argument(
        "--siglip_chunk_size", type=int, default=8000,
        help="SigLIP GGN target-axis chunk; results are invariant")
    parser.add_argument("--lambda_init_txt", type=float, default=400)
    parser.add_argument("--lambda_init_img", type=float, default=800)
    parser.add_argument("--n_init_txt", type=float, default=1.0)
    parser.add_argument("--n_init_img", type=float, default=1.0)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--num_steps", type=int, default=300)
    parser.add_argument("--weights_dir", type=str, default=None,
                        help="an HF snapshot or the port's vision.pt / text.pt")
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--no_mesh", action="store_true",
                        help="one process, whatever the launch environment says")
    parser.add_argument(
        "--dist_global_batch", action="store_true",
        help="several processes: gather every host's features and shard the "
        "class batches over the ranks (the whole dataset's batch composition) "
        "instead of per-host batches and a factor reduction")
    parser.add_argument("--ggn_precision", type=str, default="highest",
                        choices=["highest", "high"],
                        help="GGN products: 'highest' fp32, 'high' 3xTF32")
    parser.add_argument("--mlp_int8", action="store_true",
                        help="W8A8 int8 vision-tower MLPs for the feature pass")
    parser.add_argument(
        "--native_decode", action="store_true",
        help="decode the LAION JPEGs in whole batches natively (nvJPEG on the "
        "card, libjpeg with --device cpu; bilinear, not PIL's bicubic)")
    parser.add_argument(
        "--save_orbax", action="store_true",
        help="also write the K-FAC factors as a torch.distributed.checkpoint "
             "under <hessian_dir>/factors_dcp (the JAX flag's name; its orbax "
             "lane's counterpart); the .pt files stay the reference contract")
    parser.add_argument("--feature_checkpoint_every", type=int, default=256,
                        help="feature part files every N batches (0 disables)")
    parser.add_argument("--ggn_checkpoint_every", type=int, default=1,
                        help="GGN step checkpoints every N class batches "
                        "(0 disables)")
    parser.add_argument("--u8_pipeline", action="store_true",
                        help="ship uint8 crops; the encoder normalises on the device")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(
        dataset=args.dataset,
        model_str=args.model,
        precompute_batch_size=args.precompute_batch_size,
        la_num_classes=args.la_num_classes,
        la_batch_size=args.la_batch_size,
        num_workers=args.num_workers,
        hessian_dir=args.hessian_dir,
        num_files=args.num_files,
        max_datapoints=args.max_datapoints,
        siglip_chunk_size_j=args.siglip_chunk_size,
        lambda_init_txt=args.lambda_init_txt,
        lambda_init_img=args.lambda_init_img,
        n_init_txt=args.n_init_txt,
        n_init_img=args.n_init_img,
        lr=args.lr,
        num_steps=args.num_steps,
        weights_dir=args.weights_dir,
        tokenizer_dir=args.tokenizer_dir,
        use_mesh=not args.no_mesh,
        native_decode=args.native_decode,
        ggn_precision=args.ggn_precision,
        dist_global_batch=args.dist_global_batch,
        u8_pipeline=args.u8_pipeline,
        mlp_int8=args.mlp_int8,
        save_orbax=args.save_orbax,
        feature_checkpoint_every=args.feature_checkpoint_every,
        ggn_checkpoint_every=args.ggn_checkpoint_every,
        device=args.device,
        dtype=args.dtype,
    )
