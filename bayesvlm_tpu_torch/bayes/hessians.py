"""Analytic GGN Hessian of the InfoNCE loss as weighted Gram products.

Counterpart of `bayesvlm_tpu.bayes.hessians.hessian_infonce` (the exact
reformulation of ref:bayesvlm/hessians.py:10-48). With u_b = x_b/||x_b||,
r_b = ||x_b||, the normalization Jacobian is J_b = (I - u_b u_b^T)/r_b,
and every sum over the source batch collapses into [B, C] x [C, D] and
[D, B] x [B, D] products; no [B, D, D] tensor exists:

    H = Y^T diag(w) Y - Qbar^T Qbar - Ubar^T Vbar - Vbar^T Ubar
        + Ubar^T diag(s) Ubar                       (times e^{2s})

Everything runs in fp32 at "highest" matmul precision (`_highest_fp32_
matmul`: no TF32 on the card), as the JAX package's parity default.
Stage 3 uses it for the online B update; Stage 1 will reuse it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bayesvlm_tpu_torch.probforward.smith import _highest_fp32_matmul


def _l2_normalize(x: torch.Tensor, dim: int = -1,
                  keepdim: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    norm = torch.linalg.norm(x, dim=dim, keepdim=True)
    normalized = x / norm
    if not keepdim:
        norm = norm.squeeze(dim)
    return normalized, norm


def _assemble_factor(w: torch.Tensor, G: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Final [D, D] factor Y^T diag(w) Y + G, as the sqrt-weighted Gram
    (sqrt(w) Y)^T (sqrt(w) Y), whose (i, j) and (j, i) products are the
    same, then projected onto the symmetric part: the cross terms of G
    are two GEMMs whose tilings may differ by an ulp."""
    with _highest_fp32_matmul():
        Yw = torch.sqrt(torch.clamp_min(w, 0.0))[:, None] * Y
        H = Yw.T @ Yw + G
        return 0.5 * (H + H.T)


def _infonce_block_stats(source_embeds: torch.Tensor, Y: torch.Tensor,
                         logit_scale: torch.Tensor):
    """Per-block partial sums (w [C], G [D, D]) such that the block's
    Hessian contribution is Y^T diag(w) Y + G (e^{2s} included)."""
    with _highest_fp32_matmul():
        scale = torch.exp(logit_scale)
        U, r = _l2_normalize(source_embeds)       # [B, D], [B]
        inv_r = torch.reciprocal(r)
        inv_r2 = inv_r * inv_r

        Z = U @ Y.T                                # [B, C] cosine sims
        P = torch.softmax(Z * scale, dim=-1)       # [B, C]
        w = P.T @ inv_r2                           # [C]

        Q = P @ Y                                  # [B, D]  q_b = Y^T p_b
        PZ = P * Z                                 # [B, C]
        T = PZ @ Y                                 # [B, D]  Y^T (p*z)
        pz_dot = PZ.sum(dim=-1)                    # [B]     p^T z
        V = T - Q * pz_dot[:, None]                # [B, D]  v_b
        s = (PZ * Z).sum(dim=-1) - pz_dot**2       # [B]     u^T v

        Ub = U * inv_r[:, None]
        Vb = V * inv_r[:, None]
        Qb = Q * inv_r[:, None]
        # s_b = Var_{p_b}(z_b) >= 0; the clamp removes its rounding, and
        # the sqrt-weighted form keeps the Gram symmetric to the last ulp
        Us = Ub * torch.sqrt(torch.clamp_min(s, 0.0))[:, None]
        G = -(Qb.T @ Qb) - (Ub.T @ Vb) - (Vb.T @ Ub) + Us.T @ Us
        return w * scale**2, G * scale**2


def hessian_infonce(source_embeds, target_embeds, logit_scale,
                    block_size: Optional[int] = None) -> torch.Tensor:
    """GGN of -log softmax_C(sim * e^s) with respect to the source
    embeddings, summed over the batch: source [B, D], target [C, D] (the
    contrastive "classes"), scalar log-temperature -> [D, D] fp32 on the
    source's device. `block_size` chunks B to bound the [B, C]
    intermediates; the blocks are summed in order, as the JAX scan."""
    source = torch.as_tensor(source_embeds).float()
    device = source.device
    target = torch.as_tensor(target_embeds).to(device, torch.float32)
    scale = torch.as_tensor(logit_scale).to(device, torch.float32)
    Y, _ = _l2_normalize(target)
    B = source.shape[0]
    if block_size is None or block_size >= B:
        w, G = _infonce_block_stats(source, Y, scale)
    else:
        n_full = B // block_size
        w = torch.zeros(Y.shape[0], dtype=torch.float32, device=device)
        G = torch.zeros(Y.shape[1], Y.shape[1], dtype=torch.float32, device=device)
        for i in range(n_full):
            w_b, G_b = _infonce_block_stats(
                source[i * block_size:(i + 1) * block_size], Y, scale)
            w, G = w + w_b, G + G_b
        if n_full * block_size < B:
            w_r, G_r = _infonce_block_stats(source[n_full * block_size:], Y, scale)
            w, G = w + w_r, G + G_r
    return _assemble_factor(w, G, Y)
