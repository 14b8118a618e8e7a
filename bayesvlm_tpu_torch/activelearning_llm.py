"""Stage-3 variant with LLM-scored selection, the port of the JAX
package's `scripts/activelearning_llm.py`
(ref:scripts/activelearning_llm.py): same flags and defaults, same
strategy gating, keys and resumable `subset_indices_train.json`, same
per-subset `img_projection.pt`.

    python -m bayesvlm_tpu_torch.activelearning_llm --model clip-large \\
        --dataset synthetic --hessian_dir <dir> --run_llm_difficulty

Step [3] makes the main CLI's strategies, then `llm_difficulty_test`
and / or `llm_value_test`: every test image scored 1-5 by an LLM on a
difficulty or value prompt (select/llm.py), the top `subset_size`
mapped to train support by the kNN search. The client is `run`'s
`llm_client` (any `prompt -> Optional[str]` callable), else a Gemini
client (`google.generativeai`, GEMINI_API_KEY), built only when an LLM
strategy is still to be made. With no `--run_llm_*` flag, a passed
client makes `llm_score_type`'s strategy alone; the command line passes
none, so it needs a flag. `--llm_batch_size` is accepted and unused, as
in JAX (the scorer paces each call by `--llm_rate_limit_delay`). The
subsets go to `llm_{type}_subset_{n}_k_{k}_n_{scale}_knn_{method}`.
Device, dtype, weights, tokenizer and `dataset_overrides` as in
`bayesvlm_tpu_torch.activelearning`. One process: like the JAX CLI, it
never calls `initialize_distributed`, so a multi-process launch runs it
whole in every process.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

from bayesvlm_tpu_torch.activelearning import Strategies, run_steps
from bayesvlm_tpu_torch.ops import to_numpy


def run(
    model_str: str,
    dataset: str,
    hessian_dir: str,
    experiment_dir: str,
    project_name: str,
    hessian_scale: float,
    subset_size: int,
    llm_model_name: str = "gemini-1.5-flash-latest",
    llm_score_type: str = "difficulty",
    run_llm_difficulty: bool = False,
    run_llm_value: bool = False,
    llm_batch_size: int = 5,
    llm_rate_limit_delay: float = 1.1,
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
    weights_dir=None,
    tokenizer_dir=None,
    mlp_int8: bool = False,
    llm_client: Optional[Callable[[str], Optional[str]]] = None,
    device: str = "cuda",
    dtype: str = "bf16",
    dataset_overrides: Optional[dict] = None,
) -> dict:
    """Steps [1]-[4]; returns what `activelearning.run` returns."""
    del llm_batch_size  # accepted for the JAX CLI's flags
    if knn_method not in ("cosine", "wasserstein"):
        raise ValueError(f"Unknown knn_method: {knn_method!r} (expected 'cosine' or "
                         "'wasserstein')")
    # ref:activelearning_llm.py:640-660; only_epig forces EPIG on, over
    # without_epig
    run_deterministic = not only_random_strategies and not only_epig
    run_epig = only_epig or (not only_random_strategies and not without_epig
                             and not only_deterministic_strategies)
    run_random = not only_deterministic_strategies and not only_epig
    # the LLM strategies: the flags, else llm_score_type's alone where a
    # client was passed
    want_llm = [t for t, on in (("difficulty", run_llm_difficulty),
                                ("value", run_llm_value)) if on]
    if not want_llm and llm_client is not None:
        want_llm = [llm_score_type]
    from bayesvlm_tpu_torch.train.al_common import refuse_unported, setup_context

    device = refuse_unported(device)
    ctx = setup_context(
        model_str, dataset, hessian_dir, experiment_dir, hessian_scale,
        precompute_batch_size, precompute_num_workers, weights_dir, tokenizer_dir,
        mlp_int8=mlp_int8, device=device, dtype=dtype,
        dataset_overrides=dataset_overrides)

    def llm(st: Strategies, score_type: str) -> dict:
        from bayesvlm_tpu_torch.select.llm import make_gemini_client, select_llm_score

        nonlocal llm_client
        if llm_client is None:
            llm_client = make_gemini_client(llm_model_name)
        idx, vals = select_llm_score(
            to_numpy(st.ctx.image_ids_test), to_numpy(st.ctx.class_ids_test),
            st.ctx.dm.class_prompts, k=subset_size, client=llm_client,
            llm_score_type=score_type, dataset_name=dataset,
            rate_limit_delay=llm_rate_limit_delay)
        return st.knn(idx, vals)

    def make_strategies(st: Strategies) -> None:
        if run_deterministic:
            st.deterministic()
        if run_epig:
            st.epig(epig_lr, epig_hessian_update_scale, epig_num_samples,
                    epig_pool_max_size, epig_target_max_size)
        if run_random:
            st.random()
        for score_type in want_llm:
            print(f"    - LLM {score_type} (on test) ...", flush=True)
            st.store.make(f"llm_{score_type}_test", lambda t=score_type: llm(st, t))

    return run_steps(
        ctx, f"llm_{llm_score_type}_subset_{subset_size}_k_{k_nearest}"
             f"_n_{hessian_scale}_knn_{knn_method}",
        "[3] Creating training subsets (LLM variant, full strategy set) ...",
        make_strategies, predictions_batch_size=predictions_batch_size,
        subset_size=subset_size, k_nearest=k_nearest, knn_method=knn_method,
        project_name=project_name, dataset=dataset, finetune_lr=finetune_lr,
        finetune_wd=finetune_wd, finetune_epochs=finetune_epochs,
        finetune_batch_size=finetune_batch_size,
        config=dict(llm_model=llm_model_name, llm_score_type=llm_score_type,
                    knn_method=knn_method, subset_size=subset_size))


def main(*args, **kwargs) -> dict:
    """The CLI's entry point: takes `run`'s arguments (and `llm_client`)
    and returns each trained strategy's best test metrics, as the JAX
    `main` does."""
    return run(*args, **kwargs)["results"]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", type=str, default="clip-base")
    parser.add_argument("--dataset", type=str, default="homeoffice-da-clipart")
    parser.add_argument("--hessian_dir", type=str,
                        default="hessians/hessian_CLIP-ViT-B-32-laion2B-s34B-b79K")
    parser.add_argument("--experiment_dir", type=str,
                        default="experiments/active-finetuning-llm")
    parser.add_argument("--project_name", type=str, default="active-finetuning-llm")
    parser.add_argument("--subset_size", type=int, default=50)
    parser.add_argument("--hessian_scale", type=float, default=10)
    parser.add_argument("--llm_model_name", type=str, default="gemini-1.5-flash-latest")
    parser.add_argument("--llm_score_type", type=str, default="difficulty",
                        choices=["difficulty", "value"])
    parser.add_argument("--run_llm_difficulty", action="store_true")
    parser.add_argument("--run_llm_value", action="store_true")
    parser.add_argument("--llm_batch_size", type=int, default=5,
                        help="accepted and unused (the scorer paces each call)")
    parser.add_argument("--llm_rate_limit_delay", type=float, default=1.1,
                        help="Min delay (sec) between LLM API calls")
    parser.add_argument("--epig_lr", type=float, default=1e-4)
    parser.add_argument("--epig_hessian_update_scale", type=float, default=10.0)
    parser.add_argument("--epig_num_samples", type=int, default=100,
                        help="EPIG Monte-Carlo samples (reference default 100)")
    parser.add_argument("--only_deterministic_strategies", action="store_true")
    parser.add_argument("--only_random_strategies", action="store_true")
    parser.add_argument("--only_epig", action="store_true")
    parser.add_argument("--without_epig", action="store_true")
    parser.add_argument("--predictions_batch_size", type=int, default=256)
    parser.add_argument("--precompute_batch_size", type=int, default=256)
    parser.add_argument("--precompute_num_workers", type=int, default=8)
    parser.add_argument("--finetune_lr", type=float, default=1e-5)
    parser.add_argument("--finetune_wd", type=float, default=5e-2)
    parser.add_argument("--finetune_epochs", type=int, default=100)
    parser.add_argument("--finetune_batch_size", type=int, default=30)
    parser.add_argument("--k_nearest", type=int, default=1)
    parser.add_argument("--knn_method", type=str, default="wasserstein")
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
