"""Stage 2: probabilistic zero-shot evaluation, the port of the JAX
package's `scripts/zeroshot.py` (ref:scripts/zeroshot.py): same flags,
same steps, same printed lines.

    python -m bayesvlm_tpu_torch.zeroshot --dataset synthetic \\
        --hessian_dir <dir> --model siglip-large

[1] load the K-FAC factors and re-optimise lambda with pseudo_data_count,
then the covariances; [2] precompute the test images' and the class
prompts' features; [3] probabilistic predictions, then the probit
softmax; [4] ACC / NLPD / ECE (20-bin L1).

Runs on the card unless `--device` names another. Several processes, one
a card (`COORDINATOR_ADDRESS`, `NUM_PROCESSES`, `PROCESS_ID`, or a
process group the caller initialised; dist/init.py): each rank encodes
its stripe of the test batches, the features are gathered, the
predictions run with the image rows sharded over the ranks
(`make_predictions_sharded`), and rank 0 prints the metrics; every rank
returns them. `--no_mesh` runs one process. `--weights_dir` is an HF
snapshot directory or the port's converted `vision.pt` / `text.pt`
(`convert_weights`, models/bridge.py), or none for seeded random towers;
`--tokenizer_dir` a local HF tokenizer (needs `transformers`), else the
deterministic `HashTokenizer`. The datasets are read from
`DATA_BASE_DIR` (data/factory.py). A name outside `SUPPORTED_DATASETS`,
the JAX CLI's list, is refused before anything is loaded, as the JAX CLI
refuses it.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

# the datasets the CLI takes: the JAX CLI's list (scripts/zeroshot.py)
SUPPORTED_DATASETS = [
    "flowers102", "food101", "stanfordcars", "eurosat", "cifar100", "dtd",
    "synthetic",
    "imagenet-val-wds", "imagenet-100", "imagenet-50",
    "imagenet-r", "imagenet-sketch",
]


def run(
    dataset: str,
    hessian_dir: str,
    model_str: str = "clip-base",
    pseudo_data_count: int = 10,
    batch_size: int = 32,
    num_workers: int = 4,
    weights_dir=None,
    tokenizer_dir=None,
    dtype: str = "bf16",
    use_mesh: bool = True,
    mlp_int8: bool = False,
    attn_int8: bool = False,
    device: str = "cuda",
    dataset_overrides: Optional[dict] = None,
):
    """Steps [1]-[4]; returns a dict: `metrics` (ACC, NLPD, ECE), `info`
    (the lambdas and pseudo-counts), the run's `head`, its
    `image_outputs` and `label_outputs`, the probabilities `probs` and the
    `seconds` of each step (host clock, the card synchronised at each
    step's end). `dataset_overrides` go to the datamodule's constructor
    (`DataModuleFactory.create(dataset, **overrides)`, e.g. the synthetic
    module's `image_size`, `num_test`, `num_classes`). Raises
    ValueError for a dataset outside SUPPORTED_DATASETS before it loads
    anything."""
    if dataset not in SUPPORTED_DATASETS:
        raise ValueError(f"Invalid dataset: {dataset}, must be one of {SUPPORTED_DATASETS}")
    from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
    from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
    from bayesvlm_tpu_torch.data.factory import DataModuleFactory
    from bayesvlm_tpu_torch.data.tokenizer import make_tokenizer
    from bayesvlm_tpu_torch.data.transforms import get_transform
    from bayesvlm_tpu_torch.inference.metrics import evaluate_prediction
    from bayesvlm_tpu_torch.inference.precompute import (
        precompute_image_features,
        precompute_text_features,
    )
    from bayesvlm_tpu_torch.dist.init import initialize_distributed
    from bayesvlm_tpu_torch.inference.predictions import make_predictions_sharded
    from bayesvlm_tpu_torch.io.artifacts import load_hessians
    from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
    from bayesvlm_tpu_torch.models.encoders import load_model
    from bayesvlm_tpu_torch.utils import get_image_size

    # several ranks: the test images striped over them, the predictions
    # sharded (JAX: batch-sharded inference over the data mesh)
    ctx = initialize_distributed(device=device) if use_mesh else None
    mesh = ctx.mesh if ctx is not None and ctx.num_hosts > 1 else None
    primary = ctx is None or ctx.is_primary
    device = ctx.device if mesh is not None else torch.device(device)
    if mesh is not None:
        print(f"[mesh] batch-sharded inference over {tuple(mesh.shape)}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    seconds = {}
    config = CONFIGS_BY_NAME[model_str]
    transform = get_transform(config.family, get_image_size(model_str))

    dm = DataModuleFactory(
        batch_size=batch_size,
        num_workers=num_workers,
        train_transform=transform,
        test_transform=transform,
        shuffle_train=True,
    ).create(dataset, **(dataset_overrides or {}))
    dm.setup()

    tdtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    # load_model casts the GEMM weights to the compute dtype
    image_encoder, text_encoder, head = load_model(
        model_str, weights_dir=weights_dir, dtype=tdtype, device=device,
        mlp_int8=mlp_int8, attn_int8=attn_int8)
    image_encoder.prequantize_int8()  # no-op unless mlp_int8
    text_encoder.tokenizer = make_tokenizer(config.text, tokenizer_dir)

    A_img, B_img = (F.to(device) for F in load_hessians(hessian_dir, "img"))
    A_txt, B_txt = (F.to(device) for F in load_hessians(hessian_dir, "txt"))

    info = {"n_img": pseudo_data_count, "n_txt": pseudo_data_count}

    t0 = time.perf_counter()
    print("[1] Optimizing prior precision...")
    info["lambda_img"] = float(
        optimize_prior_precision(
            image_encoder.projection_l2(), image_encoder.projection_num_params(),
            A=A_img, B=B_img, lmbda_init=300, n=info["n_img"], lr=1e-2, num_steps=1000,
        )
    )
    info["lambda_txt"] = float(
        optimize_prior_precision(
            text_encoder.projection_l2(), text_encoder.projection_num_params(),
            A=A_txt, B=B_txt, lmbda_init=300, n=info["n_txt"], lr=1e-2, num_steps=1000,
        )
    )
    for k in ("n_img", "n_txt", "lambda_img", "lambda_txt"):
        print(f"\t{k}:", info[k])

    cov_img, cov_txt = compute_covariances(A_img, B_img, A_txt, B_txt, info)
    head = head.set_covariances(cov_img, cov_txt)
    sync()
    seconds["[1] lambda + covariances"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[2] Precomputing features...")
    if mesh is None:
        image_outputs, class_ids, _ = precompute_image_features(
            image_encoder, dm.test_dataloader()
        )
    else:
        from bayesvlm_tpu_torch.train.al_common import encode_striped

        image_outputs, class_ids, _ = encode_striped(image_encoder,
                                                     dm.test_dataloader(), ctx)
    sync()
    seconds["[2] image features"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    label_outputs = precompute_text_features(
        text_encoder, dm.class_prompts, batch_size=batch_size
    )
    sync()
    seconds["[2] text features"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[3] Making predictions...")
    prob_logits = make_predictions_sharded(
        head, image_outputs, label_outputs, mesh, batch_size=batch_size)

    # probit approximation (ref:zeroshot.py:119-120)
    kappa = 1.0 / torch.sqrt(1.0 + math.pi / 8 * prob_logits.var)
    pred = torch.softmax(kappa * prob_logits.mean, dim=-1)
    sync()
    seconds["[3] predictions + probit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    print("[4] Evaluate model ...")
    acc, nlpd, ece = evaluate_prediction(pred, class_ids, num_classes=len(dm.class_prompts))
    acc, nlpd = acc.cpu().numpy(), nlpd.cpu().numpy()
    if primary:
        print(f"Zero shot CLIP on {dataset}")
        print(f"ACC: {float(np.mean(acc))}, {float(np.std(acc))}")
        print(f"NLPD: {float(np.mean(nlpd))}, {float(np.std(nlpd))}")
        print(f"ECE: {ece}")
    seconds["[4] metrics"] = time.perf_counter() - t0
    return dict(metrics=(float(np.mean(acc)), float(np.mean(nlpd)), ece),
                info=info, head=head, image_outputs=image_outputs,
                label_outputs=label_outputs, probs=pred, seconds=seconds)


def main(*args, **kwargs) -> Tuple[float, float, float]:
    """The CLI's entry point: takes `run`'s arguments and returns (ACC,
    NLPD, ECE); `main.last_info` then holds the lambdas and pseudo-counts,
    as the JAX `main` exposes them."""
    result = run(*args, **kwargs)
    main.last_info = dict(result["info"])
    return result["metrics"]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dataset", type=str, default="food101")
    parser.add_argument(
        "--hessian_dir", type=str,
        default="hessians/hessian_CLIP-ViT-B-32-laion2B-s34B-b79K",
    )
    parser.add_argument("--model", type=str, default="clip-base")
    parser.add_argument("--pseudo_data_count", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_workers", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--weights_dir", type=str, default=None)
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--no_mesh", action="store_true",
                        help="one process, whatever the launch environment says")
    parser.add_argument("--mlp_int8", action="store_true")
    parser.add_argument("--attn_int8", action="store_true")
    return parser


if __name__ == "__main__":
    args = _parser().parse_args()
    main(
        dataset=args.dataset,
        hessian_dir=args.hessian_dir,
        model_str=args.model,
        pseudo_data_count=args.pseudo_data_count,
        batch_size=args.batch_size,
        num_workers=args.num_workers,
        weights_dir=args.weights_dir,
        tokenizer_dir=args.tokenizer_dir,
        dtype=args.dtype,
        use_mesh=not args.no_mesh,
        mlp_int8=args.mlp_int8,
        attn_int8=args.attn_int8,
        device=args.device,
    )
