"""Expected Gradient Length acquisition, in closed form
(ref:scripts/activelearning_elg.py:319-491), the counterpart of
`bayesvlm_tpu.select.egl`.

The reference takes one `autograd.grad` per (candidate, class) pair. For
a linear projection the gradient of the CE is rank-1, so its norm has a
closed form and the score is a few [B, C] products:

    e_i = W a_i (+ b) + res_i,  u_i = e_i / r_i,  r_i = |e_i|
    logits_i = e^s * Y_hat u_i (+ logit_bias),  p_det = softmax(logits_i)
    dCE(c)/de_i = e^s * (I - u_i u_i^T) / r_i * (q_i - y_hat_c),
        q_i = Y_hat^T p_det_i
    ||dCE(c)/dW|| = ||dCE(c)/de_i|| * |a_i|
        (with a bias: ||dCE(c)/de_i|| * sqrt(|a_i|^2 + 1))

    EGL_i = sum_c p_probit_ic * ||grad_ic||

with p_probit the probit posterior predictive probabilities
(ref:scripts/activelearning_elg.py:392-393) and p_det those of the
deterministic logits of the CE. The products are plain `torch.matmul`
in fp32, as the JAX package computes them outside any Pallas kernel;
the [N, C] scores are chunked over N.

EGL is per candidate row, so with a mesh of several ranks each chunk's
candidate rows are sharded over the ranks (padded with ones and uniform
probabilities, as JAX pads them), the text replicated, and the scores
gathered.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bayesvlm_tpu_torch.dist.mesh import all_gather_rows, local_rows, resolve_auto_mesh
from bayesvlm_tpu_torch.ops import topk_exact
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits


def _egl_chunk(embeds: torch.Tensor, activations: torch.Tensor,
               probit_probs: torch.Tensor, Yn: torch.Tensor,
               logit_scale: torch.Tensor, logit_bias: torch.Tensor,
               proj_has_bias: bool) -> torch.Tensor:
    """EGL of B candidates: embeds [B, D], activations [B, P], probit_probs
    [B, C] (the expectation's weights), Yn [C, D] normalised class
    embeddings -> [B]."""
    scale = torch.exp(logit_scale)
    r = torch.linalg.norm(embeds, dim=-1, keepdim=True)          # [B, 1]
    U = embeds / r
    UY = U @ Yn.T                                                # [B, C]
    p_det = torch.softmax(UY * scale + logit_bias, dim=-1)
    q = p_det @ Yn                                               # [B, D]
    # v_c = q - y_c; |J v_c|^2 = (|v_c|^2 - (u.v_c)^2) / r^2, J never formed
    v_norm2 = (q.square().sum(-1)[:, None] - 2.0 * (q @ Yn.T)
               + Yn.square().sum(-1)[None, :])
    uv = (U * q).sum(-1)[:, None] - UY
    g_norm = scale * torch.sqrt(torch.clamp_min(v_norm2 - uv.square(), 0.0)) / r
    a_norm = torch.linalg.norm(activations, dim=-1)
    if proj_has_bias:
        a_norm = torch.sqrt(a_norm.square() + 1.0)
    return (probit_probs * g_norm).sum(-1) * a_norm


def expected_gradient_length(
    image_outputs: EncoderResult,
    text_outputs: EncoderResult,
    prob_logits: ProbabilisticLogits,
    logit_scale,
    logit_bias=0.0,
    proj_has_bias: bool = False,
    chunk_size: int = 8192,
    mesh="auto",
) -> torch.Tensor:
    """EGL scores [N] of every candidate, on the candidates' device.

    `prob_logits` are the candidates' probabilistic logits; their probit
    softmax weighs the classes (ref:scripts/activelearning_elg.py:392,461).
    `mesh`: each chunk's candidate rows sharded over a mesh's ranks
    ("auto": the world mesh when a group of more than one rank is
    initialised; None: one device)."""
    mesh = resolve_auto_mesh(mesh)
    dev = image_outputs.embeds.device
    f32 = dict(device=dev, dtype=torch.float32)
    Y = text_outputs.embeds.to(**f32)
    Yn = Y / torch.linalg.norm(Y, dim=-1, keepdim=True)
    probs = prob_logits.probit_softmax().to(**f32)
    s = torch.as_tensor(logit_scale, **f32)
    b = torch.as_tensor(logit_bias, **f32)

    def score_rows(emb, act, prb):
        # no mesh: this device's block is every row, the gather a no-op
        local = (local_rows(emb, mesh)[0], local_rows(act, mesh)[0],
                 local_rows(prb, mesh, fill=1.0 / prb.shape[-1])[0])
        scores = _egl_chunk(*local, Yn, s, b, proj_has_bias)
        return all_gather_rows(scores, mesh)[:emb.shape[0]]

    N = len(image_outputs)
    out = []
    for start in range(0, N, chunk_size):
        sl = slice(start, min(start + chunk_size, N))
        out.append(score_rows(image_outputs.embeds[sl].to(**f32),
                              image_outputs.activations[sl].to(**f32), probs[sl]))
    return torch.cat(out, dim=0)


def select_egl(
    image_outputs: EncoderResult,
    text_outputs: EncoderResult,
    prob_logits: ProbabilisticLogits,
    k: int,
    logit_scale,
    logit_bias=0.0,
    proj_has_bias: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, scores) of the k highest EGL scores, in descending order,
    ties by ascending index (`ops.topk_exact`, `lax.top_k`'s order)
    (ref:scripts/activelearning_elg.py:474-491)."""
    scores = expected_gradient_length(image_outputs, text_outputs, prob_logits,
                                      logit_scale, logit_bias, proj_has_bias)
    values, indices = topk_exact(scores, k)
    return indices, values
