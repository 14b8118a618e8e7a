"""Stage-3 variant with Expected Gradient Length selection, the port of
the JAX package's `scripts/activelearning_elg.py`
(ref:scripts/activelearning_elg.py): same flags and defaults, same
strategy gating, keys and resumable `subset_indices_train.json`, same
per-subset `img_projection.pt`.

    python -m bayesvlm_tpu_torch.activelearning_elg --model clip-large \\
        --dataset synthetic --hessian_dir <dir>

Step [3] makes the main CLI's strategies with `egl_test` after
`bald_test`: the closed-form EGL (select/egl.py, a few fp32 products in
place of the reference's one backward pass per candidate and class) on
the test pool, its top `subset_size` mapped to train support by the kNN
search. `--only_egl` makes EGL alone. The subsets go to
`elg_subset_{n}_k_{k}_n_{scale}_knn_{method}`. Device, dtype, weights,
tokenizer and `dataset_overrides` as in
`bayesvlm_tpu_torch.activelearning`. One process: like the JAX CLI, it
never calls `initialize_distributed`, so a multi-process launch runs it
whole in every process.
"""

from __future__ import annotations

import argparse
from typing import Optional

from bayesvlm_tpu_torch.activelearning import Strategies, run_steps
from bayesvlm_tpu_torch.ops import to_numpy


def strategy_gates(only_deterministic_strategies: bool, only_random_strategies: bool,
                   only_epig: bool, without_epig: bool, only_egl: bool) -> dict:
    """Which strategy groups run (ref:activelearning_elg.py:647-668):
    "deterministic", "egl", "epig", "random"."""
    run = dict(
        deterministic=not only_random_strategies and not only_epig and not only_egl,
        epig=not only_random_strategies and not without_epig and not only_egl,
        egl=not only_random_strategies and not only_epig,
        random=not only_deterministic_strategies and not only_epig and not only_egl)
    if only_deterministic_strategies:
        run.update(random=False, epig=False)
    if only_random_strategies:
        run.update(deterministic=False, epig=False, egl=False)
    if only_epig:
        # the reference forces EPIG on (ref:659-663)
        run.update(deterministic=False, random=False, egl=False, epig=True)
    if only_egl:
        # and EGL (ref:664-668)
        run.update(deterministic=False, random=False, epig=False, egl=True)
    return run


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
    k_nearest: int = 1,
    knn_method: str = "wasserstein",
    epig_lr: float = 1e-4,
    epig_hessian_update_scale: float = 10.0,
    epig_num_samples: int = 100,
    epig_pool_max_size: int = 40_000,
    epig_target_max_size: int = 20_000,
    only_deterministic_strategies: bool = False,
    only_random_strategies: bool = False,
    only_epig: bool = False,
    without_epig: bool = False,
    only_egl: bool = False,
    weights_dir=None,
    tokenizer_dir=None,
    mlp_int8: bool = False,
    device: str = "cuda",
    dtype: str = "bf16",
    dataset_overrides: Optional[dict] = None,
) -> dict:
    """Steps [1]-[4]; returns what `activelearning.run` returns."""
    if knn_method not in ("cosine", "wasserstein"):
        raise ValueError(f"Unknown knn_method: {knn_method!r} (expected 'cosine' or "
                         "'wasserstein')")
    gates = strategy_gates(only_deterministic_strategies, only_random_strategies,
                           only_epig, without_epig, only_egl)
    from bayesvlm_tpu_torch.train.al_common import refuse_unported, setup_context

    device = refuse_unported(device)
    ctx = setup_context(
        model_str, dataset, hessian_dir, experiment_dir, hessian_scale,
        precompute_batch_size, precompute_num_workers, weights_dir, tokenizer_dir,
        mlp_int8=mlp_int8, device=device, dtype=dtype,
        dataset_overrides=dataset_overrides)

    def egl(st: Strategies) -> dict:
        from bayesvlm_tpu_torch.select.egl import select_egl

        head = st.ctx.head
        idx, vals = select_egl(
            st.ctx.image_outputs_test, st.ctx.label_outputs, st.logits["test"],
            k=subset_size, logit_scale=head.logit_scale, logit_bias=head.logit_bias,
            proj_has_bias=head.source_projection_has_bias)
        return st.knn(idx, to_numpy(vals))

    def make_strategies(st: Strategies) -> None:
        if gates["deterministic"]:
            st.deterministic()
        if gates["egl"]:
            print("    - EGL (on test) ...", flush=True)
            st.store.make("egl_test", lambda: egl(st))
        if gates["epig"]:
            st.epig(epig_lr, epig_hessian_update_scale, epig_num_samples,
                    epig_pool_max_size, epig_target_max_size)
        if gates["random"]:
            st.random()

    return run_steps(
        ctx, f"elg_subset_{subset_size}_k_{k_nearest}_n_{hessian_scale}_knn_{knn_method}",
        "[3] Creating training subsets (EGL variant, full strategy set) ...",
        make_strategies, predictions_batch_size=predictions_batch_size,
        subset_size=subset_size, k_nearest=k_nearest, knn_method=knn_method,
        project_name=project_name, dataset=dataset, finetune_lr=finetune_lr,
        finetune_wd=finetune_wd, finetune_epochs=finetune_epochs,
        finetune_batch_size=finetune_batch_size,
        config=dict(knn_method=knn_method, subset_size=subset_size,
                    hessian_scale=hessian_scale, strategy="egl"))


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
    parser.add_argument("--k_nearest", type=int, default=1)
    parser.add_argument("--knn_method", type=str, default="wasserstein")
    parser.add_argument("--epig_lr", type=float, default=1e-4)
    parser.add_argument("--epig_hessian_update_scale", type=float, default=10.0)
    parser.add_argument("--epig_num_samples", type=int, default=100,
                        help="EPIG Monte-Carlo samples (reference default 100)")
    parser.add_argument("--epig_pool_max_size", type=int, default=40_000)
    parser.add_argument("--epig_target_max_size", type=int, default=20_000)
    parser.add_argument("--only_deterministic_strategies", action="store_true")
    parser.add_argument("--only_random_strategies", action="store_true")
    parser.add_argument("--only_epig", action="store_true")
    parser.add_argument("--without_epig", action="store_true")
    parser.add_argument("--only_egl", action="store_true")
    parser.add_argument("--weights_dir", type=str, default=None)
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--mlp_int8", action="store_true",
                        help="W8A8 int8 vision-tower MLPs for the feature pass "
                        "(csrc/mlp_int8.cu); off by default")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", type=str, default="bf16", choices=["bf16", "fp32"])
    return parser


if __name__ == "__main__":
    args = vars(_parser().parse_args())
    args["model_str"] = args.pop("model")
    main(**args)
