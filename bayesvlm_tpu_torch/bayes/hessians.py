"""Analytic GGN Hessians of the contrastive losses as weighted Gram products.

Counterpart of `bayesvlm_tpu.bayes.hessians` (the exact reformulation of
ref:bayesvlm/hessians.py:10-117). With u_b = x_b/||x_b||, r_b = ||x_b||,
the normalization Jacobian is J_b = (I - u_b u_b^T)/r_b, and every sum
over the source batch collapses into [B, C] x [C, D] and [D, B] x [B, D]
products; no [B, D, D] tensor exists:

    InfoNCE: H = Y^T diag(w) Y - Qbar^T Qbar - Ubar^T Vbar - Vbar^T Ubar
                 + Ubar^T diag(s) Ubar                    (times e^{2s})
    SigLIP:  the same without the Qbar term, with sigmoid pair weights

Precision. "highest" (the default) runs every product in fp32 inside
`_highest_fp32_matmul`, so no TF32 reaches them whatever the process
setting. "high" is the counterpart of the JAX package's opt-in bf16x3:
3xTF32, each fp32 operand split into a TF32 part `hi` (its low 13
mantissa bits cleared) and `lo = x - hi`, and hi.hi + hi.lo + lo.hi
summed from three products with TF32 allowed in their scope only. The
assembly of the factor and the activation Gram always run "highest", as
in JAX. Both precision scopes are restored when the body raises.

The block statistics keep their operands' dtype, so the same formula
runs in float64 as a reference (`_hessian_infonce`, `_hessian_siglip`);
the public entry points compute in fp32.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from bayesvlm_tpu_torch.probforward.smith import _highest_fp32_matmul

PRECISIONS = ("highest", "high")


@contextlib.contextmanager
def _tf32_matmul():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi is x with its low 13 mantissa bits cleared, exact in
    TF32; lo = x - hi is exact in fp32."""
    hi = (x.view(torch.int32) & -8192).view(torch.float32)  # 0xFFFFE000
    return hi, x - hi


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at `precision`; "high" is 3xTF32 on fp32 operands."""
    if precision == "highest" or a.dtype != torch.float32:
        return a @ b
    a_hi, a_lo = _tf32_split(a)
    b_hi, b_lo = _tf32_split(b)
    with _tf32_matmul():
        return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


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


def _masked_normalize(x: torch.Tensor, row_mask: Optional[torch.Tensor]):
    """(U, 1/r, 1/r^2) of the source rows; rows with mask 0 are kept
    finite under 1/||x|| and get zero weight."""
    if row_mask is not None:
        x = torch.where(row_mask[:, None] > 0, x, 1.0)
    U, r = _l2_normalize(x)
    inv_r = torch.reciprocal(r)
    if row_mask is not None:
        inv_r = inv_r * row_mask
    return U, inv_r, inv_r * inv_r


def _sum_blocks(stats, B: int, block_size: Optional[int]):
    """Sum of the block statistics (w, G) over source rows in blocks of
    `block_size` (the full blocks, then the remainder), in order."""
    if block_size is None or block_size >= B:
        return stats(0, B)
    n_full = B // block_size
    edges = [(i * block_size, (i + 1) * block_size) for i in range(n_full)]
    if n_full * block_size < B:
        edges.append((n_full * block_size, B))
    w, G = stats(*edges[0])
    for lo, hi in edges[1:]:
        w_b, G_b = stats(lo, hi)
        w, G = w + w_b, G + G_b
    return w, G


def _infonce_block_stats(source_embeds: torch.Tensor, Y: torch.Tensor,
                         logit_scale: torch.Tensor,
                         row_mask: Optional[torch.Tensor] = None,
                         precision: str = "highest"):
    """Per-block partial sums (w [C], G [D, D]) such that the block's
    Hessian contribution is Y^T diag(w) Y + G (e^{2s} included).
    `row_mask` [B] (1 valid, 0 padded) zeroes the padded rows'
    contribution."""
    with _highest_fp32_matmul():
        scale = torch.exp(logit_scale)
        U, inv_r, inv_r2 = _masked_normalize(source_embeds, row_mask)

        Z = _mm(U, Y.T, precision)                 # [B, C] cosine sims
        P = torch.softmax(Z * scale, dim=-1)       # [B, C]
        w = _mm(P.T, inv_r2, precision)            # [C]

        Q = _mm(P, Y, precision)                   # [B, D]  q_b = Y^T p_b
        PZ = P * Z                                 # [B, C]
        T = _mm(PZ, Y, precision)                  # [B, D]  Y^T (p*z)
        pz_dot = PZ.sum(dim=-1)                    # [B]     p^T z
        V = T - Q * pz_dot[:, None]                # [B, D]  v_b
        s = (PZ * Z).sum(dim=-1) - pz_dot**2       # [B]     u^T v

        Ub = U * inv_r[:, None]
        Vb = V * inv_r[:, None]
        Qb = Q * inv_r[:, None]
        # s_b = Var_{p_b}(z_b) >= 0; the clamp removes its rounding, and
        # the sqrt-weighted form keeps the Gram symmetric to the last ulp
        Us = Ub * torch.sqrt(torch.clamp_min(s, 0.0))[:, None]
        G = (-_mm(Qb.T, Qb, precision) - _mm(Ub.T, Vb, precision)
             - _mm(Vb.T, Ub, precision) + _mm(Us.T, Us, precision))
        return w * scale**2, G * scale**2


def _hessian_infonce(source: torch.Tensor, target: torch.Tensor,
                     scale: torch.Tensor, block_size: Optional[int] = None,
                     precision: str = "highest") -> torch.Tensor:
    """`hessian_infonce` in the operands' dtype (one device)."""
    _check_precision(precision)
    Y, _ = _l2_normalize(target)
    w, G = _sum_blocks(lambda lo, hi: _infonce_block_stats(
        source[lo:hi], Y, scale, precision=precision), source.shape[0], block_size)
    return _assemble_factor(w, G, Y)


def _to_fp32(source, *others):
    """fp32 tensors on the first operand's device."""
    source = torch.as_tensor(source).float()
    return (source, *(torch.as_tensor(t).to(source.device, torch.float32)
                      for t in others))


def hessian_infonce(source_embeds, target_embeds, logit_scale,
                    block_size: Optional[int] = None,
                    precision: str = "highest") -> torch.Tensor:
    """GGN of -log softmax_C(sim * e^s) with respect to the source
    embeddings, summed over the batch: source [B, D], target [C, D] (the
    contrastive "classes"), scalar log-temperature -> [D, D] fp32 on the
    source's device. `block_size` chunks B to bound the [B, C]
    intermediates; the blocks are summed in order, as the JAX scan.
    `precision`: "highest" (fp32) or "high" (3xTF32)."""
    source, target, scale = _to_fp32(source_embeds, target_embeds, logit_scale)
    return _hessian_infonce(source, target, scale, block_size, precision)


def _siglip_block_stats(x_block: torch.Tensor, diag_idx: torch.Tensor,
                        Yn: torch.Tensor, logit_scale: torch.Tensor,
                        logit_bias: torch.Tensor,
                        row_mask: Optional[torch.Tensor] = None,
                        chunk_j: Optional[int] = None,
                        precision: str = "highest"):
    """Per-block partial sums (w [N], G [D, D]) for the SigLIP GGN.
    `diag_idx[b]` is the target column labelled +1 for source row b.

    `chunk_j` walks the target axis in chunks of that size, bounding the
    [B, N] logits buffers to [B, chunk_j] (ref:bayesvlm/hessians.py:
    98-115): the targets are padded with zero rows to a multiple of it,
    the padded columns get zero weight, and w is cut back to N."""
    with _highest_fp32_matmul():
        scale = torch.exp(logit_scale)
        U, inv_r, inv_r2 = _masked_normalize(x_block, row_mask)
        B, N, D = x_block.shape[0], Yn.shape[0], Yn.shape[1]

        def stats_for(Y_c, col, col_valid):
            # Y_c: [n, D] target chunk; col: [n] global column ids
            Z = _mm(U, Y_c.T, precision)               # [B, n] cosine sims
            logits = Z * scale + logit_bias
            labels = (col[None, :] == diag_idx[:, None]).to(Z.dtype) * 2 - 1
            t = logits * labels
            # sig(t) (1 - sig(t)) as sig(t) sig(-t): at SigLIP's bias the
            # negatives' sig(t) lies within an ulp of 1, where JAX's
            # 1 - sig(t) keeps no digit and B strays from its float64 value
            C = (scale**2) * torch.sigmoid(t) * torch.sigmoid(-t)  # [B, n] pair weights
            if col_valid is not None:
                C = C * col_valid[None, :]
            w_c = _mm(C.T, inv_r2, precision)          # [n]
            CZ = C * Z
            V_c = _mm(CZ, Y_c, precision)              # [B, D] partial v_b
            s_c = (CZ * Z).sum(dim=-1)                 # [B]    partial u^T v
            return w_c, V_c, s_c

        cols = torch.arange(N, device=Yn.device)
        if chunk_j is None or chunk_j >= N:
            w, V, s = stats_for(Yn, cols, None)
        else:
            pad = (-N) % chunk_j
            Yp = torch.nn.functional.pad(Yn, (0, 0, 0, pad))
            valid = torch.ones(N + pad, dtype=Yn.dtype, device=Yn.device)
            valid[N:] = 0
            local = torch.arange(chunk_j, device=Yn.device)
            V = torch.zeros(B, D, dtype=Yn.dtype, device=Yn.device)
            s = torch.zeros(B, dtype=Yn.dtype, device=Yn.device)
            ws = []
            for b0 in range(0, N + pad, chunk_j):
                w_c, V_c, s_c = stats_for(Yp[b0:b0 + chunk_j], b0 + local,
                                          valid[b0:b0 + chunk_j])
                V, s = V + V_c, s + s_c
                ws.append(w_c)
            w = torch.cat(ws)[:N]

        Ub = U * inv_r[:, None]
        Vb = V * inv_r[:, None]
        # s_b = sum_j c_j z_j^2 >= 0 (c is a sigmoid product); the
        # sqrt-weighted Gram keeps the GEMM symmetric
        Us = Ub * torch.sqrt(torch.clamp_min(s, 0.0))[:, None]
        G = (-_mm(Ub.T, Vb, precision) - _mm(Vb.T, Ub, precision)
             + _mm(Us.T, Us, precision))
        return w, G


def _hessian_siglip(x: torch.Tensor, indices: torch.Tensor, y: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    block_size: Optional[int] = None,
                    chunk_size_j: Optional[int] = None,
                    precision: str = "highest") -> torch.Tensor:
    """`hessian_siglip` in the operands' dtype (one device)."""
    _check_precision(precision)
    Yn, _ = _l2_normalize(y)
    w, G = _sum_blocks(lambda lo, hi: _siglip_block_stats(
        x[lo:hi], indices[lo:hi], Yn, scale, bias, chunk_j=chunk_size_j,
        precision=precision), x.shape[0], block_size)
    return _assemble_factor(w, G, Yn)


def hessian_siglip(x_batch, indices_batch, y, logit_scale, logit_bias,
                   block_size: Optional[int] = None,
                   chunk_size_j: Optional[int] = None,
                   precision: str = "highest") -> torch.Tensor:
    """GGN of the SigLIP sigmoid loss with respect to the source
    embeddings, summed over the batch (ref:bayesvlm/hessians.py:50-117):
    x [B, D], `indices_batch[b]` the row of the [N, N] label matrix
    (2I - 1) used for sample b, y [N, D] -> [D, D] fp32 on x's device.
    `block_size` chunks the source axis, `chunk_size_j` the target axis;
    results are invariant to both. `precision` as in hessian_infonce."""
    x, y, scale, bias = _to_fp32(x_batch, y, logit_scale, logit_bias)
    indices = torch.as_tensor(indices_batch).to(x.device, torch.long)
    return _hessian_siglip(x, indices, y, scale, bias, block_size, chunk_size_j,
                           precision)


def activation_gram(activations, append_bias_column: bool = False) -> torch.Tensor:
    """A-factor partial sum activations^T activations in fp32, with an
    appended ones column for biased projections
    (ref:scripts/hessian_estimation.py:100-104)."""
    a = torch.as_tensor(activations).float()
    if append_bias_column:
        a = torch.cat([a, torch.ones_like(a[:, :1])], dim=-1)
    with _highest_fp32_matmul():
        return a.T @ a
