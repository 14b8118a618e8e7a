"""EPIG (expected predictive information gain) acquisition and the
online EPIG active-learning loop (ref:bayesvlm/epig.py).

Counterpart of `bayesvlm_tpu.select.epig`. EPIG scores go through the
joint-entropy row sums of `select/epig_joint.py`: on the card the
hand-written kernel (csrc/xlogy_rowsum.cu), whose [N_p*C, N_t*C] joint
never reaches device memory; on the CPU its plain version. Both keep the
contract of the JAX package: bf16 operands, fp32 products, sums and
xlogy.

`select_epig_online` keeps the reference's host-side budget loop (the
argmax that skips already-selected indices is data-dependent); inside it
run the probabilistic forward, the EPIG scores, one SGD step on the
image projection, the online Hessian update, the 20-step lambda
re-optimization and the covariance refresh.

With a mesh of several ranks (dist/mesh.py) each step's pool rows are
scored sharded (`epig_from_probs_sharded`): each rank takes the joint row
sums of its block of the rows, and the row sums are gathered. EPIG is
per pool row (the targets enter through replicated reductions), so the
scores are those of one device.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional, Union

import numpy as np
import torch

from bayesvlm_tpu_torch.bayes.hessians import hessian_infonce
from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
from bayesvlm_tpu_torch.dist.mesh import all_gather_rows, local_rows, resolve_auto_mesh
from bayesvlm_tpu_torch.probforward.smith import (
    ProbabilisticHead,
    _highest_fp32_matmul,
    activation_diag_covariance,
)
from bayesvlm_tpu_torch.select import draws
from bayesvlm_tpu_torch.select.epig_joint import (
    _flatten,
    epig_from_probs_fused,
    joint_xlogy_rowsums,
    scores_from_rowsums,
)
from bayesvlm_tpu_torch.select.knn import expected_cosine_similarity, wdist2
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits


def entropy_from_probs(probs: torch.Tensor) -> torch.Tensor:
    """H[p] with 0 log 0 = 0 (ref:bayesvlm/epig.py:275-292)."""
    xlogy = torch.where(probs > 0, probs * torch.log(probs), torch.zeros_like(probs))
    return -xlogy.sum(dim=-1)


def marginal_entropy_from_probs(probs: torch.Tensor) -> torch.Tensor:
    """H[mean_K p] for probs [N, K, C] (ref:bayesvlm/epig.py:294-311)."""
    if probs.dim() != 3:
        raise ValueError(f"probs must be [N, K, C], got {tuple(probs.shape)}")
    return entropy_from_probs(probs.mean(dim=1))


def epig_from_probs_using_matmul(probs_pool: torch.Tensor,
                                 probs_targ: torch.Tensor) -> torch.Tensor:
    """EPIG = H[pool] + E[H[targ]] - E[H[joint]]
    (ref:bayesvlm/epig.py:342-397): probs_pool [N_p, K, C], probs_targ
    [N_t, K, C] -> [N_p]. CUDA tensors go through the kernel, CPU
    tensors through its plain version."""
    return epig_from_probs_fused(probs_pool, probs_targ)


def epig_from_probs_sharded(probs_pool: torch.Tensor, probs_targ: torch.Tensor,
                            mesh) -> torch.Tensor:
    """EPIG scores [N_p] with the pool rows sharded over a mesh's ranks:
    the pool padded with uniform rows (1 / C) to a multiple of the world
    size, each rank's block of rows through the joint row sums (the
    kernel on the card: the whole [N_p*C, N_t*C] joint's work), the row
    sums gathered in rank order and the padding cut; the entropies, a
    pass over the probabilities, are computed whole on every rank. So a
    score takes the operations of the one-device call on the same shapes,
    and a row's joint sum is the kernel's for that row wherever it lies.
    Every rank takes the same full inputs and returns the full scores.
    With no mesh (None) it is `epig_from_probs_using_matmul`, the same
    operations on the same rows."""
    n, K, C = probs_pool.shape
    local, _ = local_rows(probs_pool, mesh, fill=1.0 / C)
    pool_flat, targ_flat = _flatten(probs_pool), _flatten(probs_targ)
    rows = joint_xlogy_rowsums(_flatten(local), targ_flat, K).reshape(-1, C)
    rowsums = all_gather_rows(rows, mesh)[:n].reshape(-1)
    return scores_from_rowsums(pool_flat, targ_flat, rowsums, n, probs_targ.shape[0], C)


def epig_from_logits_using_matmul(logits_pool: ProbabilisticLogits,
                                  logits_targ: ProbabilisticLogits, seed: int,
                                  num_samples: int, chunk_size: int = 4096,
                                  mesh=None) -> torch.Tensor:
    """Chunked-over-pool EPIG from logit distributions
    (ref:bayesvlm/epig.py:313-340): chunk i draws the targets' and its
    pool rows' samples with seed + i. With `mesh`, each chunk's scores
    are computed pool-row-sharded (the samples are drawn whole on every
    rank, so the chunks and seeds are those of one device)."""
    N_p = logits_pool.mean.shape[0]
    scores = []
    for i in range(0, N_p, chunk_size):
        probs_targ = logits_targ.sample_probas(num_samples, seed=seed + i)
        chunk = logits_pool[i:min(i + chunk_size, N_p)]
        probs_pool = chunk.sample_probas(num_samples, seed=seed + i)
        scores.append(epig_from_probs_sharded(probs_pool, probs_targ, mesh))
    return torch.cat(scores, dim=0)


def update_embeddings(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                      outputs: EncoderResult) -> EncoderResult:
    """Recompute embeds from the (updated) projection
    (ref:bayesvlm/epig.py:15-42): embeds = activations @ W (+b) + residuals,
    W [P, D]."""
    with _highest_fp32_matmul():
        embeds = outputs.activations @ kernel
    if bias is not None:
        embeds = embeds + bias
    embeds = embeds + outputs.residuals
    return EncoderResult(embeds=embeds, activations=outputs.activations,
                         residuals=outputs.residuals)


def _ones_column(a: torch.Tensor, has_bias: bool) -> torch.Tensor:
    return torch.cat([a, torch.ones_like(a[:, :1])], dim=-1) if has_bias else a


def _epig_sgd_step(kernel: torch.Tensor, bias: Optional[torch.Tensor],
                   best_activation: torch.Tensor, best_residual: torch.Tensor,
                   best_class_id: torch.Tensor, label_features: EncoderResult,
                   src_A_inv: torch.Tensor, src_B_diag: torch.Tensor,
                   tgt_A_inv: torch.Tensor, tgt_B_diag: torch.Tensor,
                   logit_scale: torch.Tensor, lr: float,
                   has_bias: bool) -> torch.Tensor:
    """One manual SGD step on the projection weight [P, D] only
    (ref:bayesvlm/epig.py:209-231: the bias is NOT updated there), with
    the gradient of the probabilistic forward's mean cross-entropy."""
    # clones: tensors made under inference mode cannot be saved for backward
    a = best_activation.clone()
    with torch.enable_grad(), _highest_fp32_matmul():
        W = kernel.detach().clone().requires_grad_(True)
        embeds = a @ W + (bias if bias is not None else 0.0) + best_residual
        a_s = _ones_column(a, has_bias)
        sigma_s = ((a_s @ src_A_inv) * a_s).sum(-1)[:, None] * src_B_diag[None, :]
        a_t = _ones_column(label_features.activations, has_bias)
        sigma_t = ((a_t @ tgt_A_inv) * a_t).sum(-1)[:, None] * tgt_B_diag[None, :]
        E_s = (embeds**2 + sigma_s).sum(-1, keepdim=True)
        E_t = (label_features.embeds**2 + sigma_t).sum(-1, keepdim=True)
        mean = (embeds / torch.sqrt(E_s)) @ (label_features.embeds / torch.sqrt(E_t)).T
        mean = mean * torch.exp(logit_scale)
        logp = torch.log_softmax(mean, dim=-1)
        loss = -logp.gather(-1, best_class_id[:, None]).mean()
        (grad,) = torch.autograd.grad(loss, W)
    return kernel - lr * grad


def _not_enough(found: int, budget: int) -> ValueError:
    return ValueError(f"Could not find enough samples in the pool. Found "
                      f"{found}, expected at least {budget}.")


def select_epig_online(
    label_features: EncoderResult,
    pool_features: EncoderResult,
    target_features: EncoderResult,
    pool_class_ids,
    projection_kernel,                 # [P, D], the JAX package's layout
    projection_bias,
    head: ProbabilisticHead,
    A_img,
    A_txt,
    B_img,
    B_txt,
    cov_info: dict,
    budget: int,
    lr: float,
    hessian_update_scale: float,
    num_samples: int,
    seed: int,
    projection_l2: float,
    projection_num_params: int,
    pool_max_size: Optional[int] = None,
    target_max_size: Optional[int] = None,
    chunk_size: int = 4096,
    pool_subsampling: Literal["random", "knn_cosine", "knn_wasserstein"] = "random",
    k_nearest_neighbors: int = 1,
    proj_has_bias: bool = False,
    hessian_n0: int = 327_680,
    mesh="auto",
    device: Union[str, torch.device] = "cuda",
):
    """Online EPIG active learning (ref:bayesvlm/epig.py:44-273).

    Returns (selected_indices, epig_scores): python ints and floats.
    Every input is moved to `device` as fp32 (the card unless the caller
    names another). `hessian_n0` is the reference's hard-coded
    initial-Hessian sample count (ref:bayesvlm/epig.py:248-251).

    Random subsampling permutes with `draws.permutation(seed, n,
    stream)`, the streams counted as the JAX package splits its key:
    stream 0 for the first subsample drawn (the targets when they are
    cut, else the pool), stream 1 for the pool after cut targets. It
    draws other permutations than the JAX package's keys.

    `mesh`: the mesh each step's scores are sharded over
    (`epig_from_probs_sharded`); "auto" (the default) is the world mesh
    when a process group of more than one rank is initialised, None one
    device.
    """
    mesh = resolve_auto_mesh(mesh)
    device = torch.device(device)

    def dev(x):
        return torch.as_tensor(x).to(device, torch.float32)

    def dev_features(f: EncoderResult) -> EncoderResult:
        return EncoderResult(dev(f.embeds), dev(f.activations), dev(f.residuals))

    label_features = dev_features(label_features)
    pool_features = dev_features(pool_features)
    target_features = dev_features(target_features)
    class_ids = np.asarray(torch.as_tensor(pool_class_ids).cpu())
    kernel = dev(projection_kernel)
    bias = None if projection_bias is None else dev(projection_bias)
    A_img, A_txt, B_img, B_txt = (dev(F) for F in (A_img, A_txt, B_img, B_txt))
    cov_info = dict(cov_info)
    head = dataclasses.replace(head, logit_scale=dev(head.logit_scale),
                               logit_bias=dev(head.logit_bias))
    streams = iter(range(2))

    cov_img, cov_txt = compute_covariances(A_img, B_img, A_txt, B_txt, cov_info)
    head = head.set_covariances(cov_img, cov_txt)

    n_pool = len(pool_features)
    n_target = len(target_features)

    # --- target subsampling (ref:bayesvlm/epig.py:99-102) ---
    if target_max_size is not None and target_max_size < n_target:
        indices_target = draws.permutation(seed, n_target, next(streams))[:target_max_size]
    else:
        indices_target = np.arange(n_target)

    # --- pool subsampling (ref:bayesvlm/epig.py:104-164) ---
    if pool_subsampling == "random":
        if pool_max_size is not None and pool_max_size < n_pool:
            indices_pool = draws.permutation(seed, n_pool, next(streams))[:pool_max_size]
        else:
            indices_pool = np.arange(n_pool)
    elif pool_subsampling in ("knn_cosine", "knn_wasserstein"):
        targ_sub = target_features[torch.as_tensor(indices_target, device=device)]
        if pool_subsampling == "knn_cosine":
            sims = expected_cosine_similarity(
                targ_sub, pool_features, cov_img.A_inv,
                torch.diagonal(cov_img.B_inv), has_bias=proj_has_bias)
        else:
            pool_diag = activation_diag_covariance(
                pool_features.activations, cov_img, proj_has_bias)
            targ_diag = activation_diag_covariance(
                targ_sub.activations, cov_img, proj_has_bias)
            sims = -wdist2(targ_sub.embeds, pool_features.embeds, targ_diag, pool_diag)
        # np.unique erases the top-k order, so only float ties straddling
        # the k boundary could pick other rows than the JAX top-k
        nn = torch.topk(sims, min(k_nearest_neighbors, sims.shape[1]), dim=1).indices
        indices_pool = np.unique(nn.cpu().numpy().flatten())
        if len(indices_pool) < budget:
            raise _not_enough(len(indices_pool), budget)
    else:
        raise ValueError(f"Unknown subsampling method: {pool_subsampling}")

    indices_pool_t = torch.as_tensor(indices_pool, device=device)
    indices_target_t = torch.as_tensor(indices_target, device=device)

    selected_indices: list = []
    epig_scores: list = []

    for i in range(budget):
        pool_sub = pool_features[indices_pool_t]
        targ_sub = target_features[indices_target_t]

        logits_pool = head(pool_sub, label_features)
        logits_targ = head(targ_sub, label_features)

        epig = epig_from_logits_using_matmul(
            logits_pool, logits_targ, num_samples=num_samples,
            chunk_size=chunk_size, seed=seed + i, mesh=mesh)
        # a stable ascending sort, reversed, as the JAX package's order
        order = torch.argsort(epig, stable=True).cpu().numpy()[::-1]
        best = None
        for idx in order:
            if int(indices_pool[idx]) in selected_indices:
                continue
            best = int(idx)
            break
        if best is None:
            raise ValueError(
                f"EPIG pool exhausted at step {i}/{budget}: all "
                f"{len(order)} subsampled candidates are already selected "
                f"(budget too large for the pool subsample).")

        best_activation = pool_sub.activations[best][None]
        best_residual = pool_sub.residuals[best][None]
        best_class_id = torch.as_tensor(
            [int(class_ids[indices_pool[best]])], device=device)
        best_pool_embed = pool_sub.embeds[best][None]

        selected_indices.append(int(indices_pool[best]))
        epig_scores.append(float(epig[best]))

        # --- SGD step on the projection weight (ref:bayesvlm/epig.py:209-231) ---
        kernel = _epig_sgd_step(
            kernel, bias, best_activation, best_residual, best_class_id,
            label_features,
            head.source_covariance.A_inv, torch.diagonal(head.source_covariance.B_inv),
            head.target_covariance.A_inv, torch.diagonal(head.target_covariance.B_inv),
            head.logit_scale, lr, proj_has_bias)

        # --- refresh pool/target embeds (ref:bayesvlm/epig.py:233-235) ---
        pool_features = update_embeddings(kernel, bias, pool_features)
        target_features = update_embeddings(kernel, bias, target_features)

        # --- online Hessian update (ref:bayesvlm/epig.py:237-255) ---
        # The rank-1 activation outer product (the reference's 1-D
        # `a @ a.T` is a scalar dot product, a latent bug the JAX package
        # fixed), with the bias column's 1 for biased projections so that
        # A_new matches A_img's [P+1, P+1]. B_new is the InfoNCE GGN even
        # for sigmoid heads, as ref:bayesvlm/epig.py:242-246.
        act = _ones_column(best_activation, proj_has_bias)[0]
        A_new = torch.outer(act, act)
        B_new = hessian_infonce(best_pool_embed, label_features.embeds, head.logit_scale)
        n = hessian_n0 + i
        s0 = torch.sqrt(torch.tensor(float(n), dtype=torch.float32, device=device))
        s1 = torch.sqrt(torch.tensor(float(n + 1), dtype=torch.float32, device=device))
        A_img = (s0 * A_img + A_new * hessian_update_scale) / s1
        B_img = (s0 * B_img + B_new * hessian_update_scale) / s1

        # --- lambda re-opt, 20 steps (ref:bayesvlm/epig.py:257-268) ---
        lmbda = optimize_prior_precision(
            projection_l2_norm=projection_l2,
            projection_num_params=projection_num_params,
            A=A_img, B=B_img,
            lmbda_init=cov_info["lambda_img"], n=cov_info["n_img"],
            lr=1e-3, num_steps=20)
        cov_info["lambda_img"] = float(lmbda)

        cov_img, cov_txt = compute_covariances(A_img, B_img, A_txt, B_txt, cov_info)
        head = head.set_covariances(cov_img, cov_txt)

    return selected_indices, epig_scores
