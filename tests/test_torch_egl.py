"""The port's closed-form EGL (`bayesvlm_tpu_torch.select.egl`) against the
JAX package's (`bayesvlm_tpu.select.egl`) and against torch.autograd, on
the CPU, inputs made from numpy seeds.

Tolerances:
  - against JAX: rtol 1e-4, atol 1e-5: the same fp32 formula, one
    summation order apart; the norms' difference of squares
    |v|^2 - (u.v)^2 cancels up to a few digits where q is near a class
    embedding;
  - against autograd of the CE of each (sample, class) pair (the port's
    version of tests/test_selection.py's test_egl_matches_autodiff):
    rtol 1e-3, atol 1e-4, that test's bound: autograd takes another route
    through the normalisation and the softmax;
  - indices: exact, ties by ascending index (`lax.top_k`'s order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.select import egl as jax_egl
from bayesvlm_tpu.types import EncoderResult as JaxResult
from bayesvlm_tpu.types import ProbabilisticLogits as JaxLogits
from bayesvlm_tpu_torch.select import egl
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

JAX_RTOL, JAX_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


def _case(seed, N=37, C=5, D=12, P=9, bias=False):
    """Candidates e = a W (+ b) + residual, class embeddings and
    probabilistic logits, for both packages."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    W, acts = f(P, D), f(N, P)
    b = f(D, scale=0.3) if bias else np.zeros(D, np.float32)
    res = f(N, D, scale=0.5) if bias else np.zeros((N, D), np.float32)
    embeds = acts @ W + b + res
    txt = f(C, D)
    mean, var = f(N, C, scale=2.0), rng.uniform(0.1, 1.0, size=(N, C)).astype(np.float32)
    arrays = dict(embeds=embeds, acts=acts, res=res, txt=txt, mean=mean, var=var, W=W, b=b)
    jx = (JaxResult(embeds=jnp.asarray(embeds), activations=jnp.asarray(acts),
                    residuals=jnp.asarray(res)),
          JaxResult(embeds=jnp.asarray(txt), activations=jnp.asarray(txt),
                    residuals=jnp.zeros_like(jnp.asarray(txt))),
          JaxLogits(mean=jnp.asarray(mean), var=jnp.asarray(var)))
    t = torch.from_numpy
    pt = (EncoderResult(t(embeds), t(acts), t(res)),
          EncoderResult.create(t(txt), t(txt)),
          ProbabilisticLogits(mean=t(mean), var=t(var)))
    return arrays, jx, pt


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("chunk_size", [8, 8192])
def test_egl_matches_jax(bias, chunk_size):
    scale, lbias = (0.7, -2.0) if bias else (2.3, 0.0)
    _, jx, pt = _case(1 + bias, bias=bias)
    want = np.asarray(jax_egl.expected_gradient_length(
        *jx, scale, lbias, proj_has_bias=bias, chunk_size=chunk_size, mesh=None))
    got = egl.expected_gradient_length(*pt, scale, lbias, proj_has_bias=bias,
                                       chunk_size=chunk_size)
    assert got.shape == (37,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_chunks_do_not_change_the_scores():
    _, _, pt = _case(3)
    whole = egl.expected_gradient_length(*pt, 1.0)
    for size in (1, 5, 36, 37):
        np.testing.assert_allclose(
            egl.expected_gradient_length(*pt, 1.0, chunk_size=size).numpy(),
            whole.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bias", [False, True])
def test_egl_matches_autograd(bias):
    """sum_c p_probit[i, c] * ||d CE(c) / d (W, b)|| by one autograd call
    per (sample, class)."""
    B, C = 6, 4
    a, _, pt = _case(4 + bias, N=B, C=C, D=7, P=5, bias=bias)
    scale, lbias = torch.tensor(0.7), torch.tensor(-1.0 if bias else 0.0)
    got = egl.expected_gradient_length(*pt, scale, lbias, proj_has_bias=bias)
    probit = pt[2].probit_softmax()
    Y = torch.from_numpy(a["txt"])
    Yn = Y / torch.linalg.norm(Y, dim=-1, keepdim=True)
    want = torch.zeros(B, dtype=torch.float64)
    for i in range(B):
        for c in range(C):
            W = torch.from_numpy(a["W"]).double().requires_grad_()
            b = torch.from_numpy(a["b"]).double().requires_grad_()
            e = torch.from_numpy(a["acts"][i]).double() @ W + b + torch.from_numpy(
                a["res"][i]).double()
            logits = (e / torch.linalg.norm(e)) @ Yn.double().T * torch.exp(scale) + lbias
            ce = -torch.log_softmax(logits, -1)[c]
            grads = torch.autograd.grad(ce, (W, b) if bias else (W,))
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            want[i] += float(probit[i, c]) * norm
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_select_egl_indices_and_ties_match_jax():
    """Candidates 3, 10 and 20 are copies of candidate 0 (equal scores):
    the tie is kept in ascending index order, as `lax.top_k` keeps it."""
    _, jx, pt = _case(6)
    e, a = pt[0].embeds.clone(), pt[0].activations.clone()
    m, v = pt[2].mean.clone(), pt[2].var.clone()
    for j in (3, 10, 20):
        e[j], a[j], m[j], v[j] = e[0], a[0], m[0], v[0]
    pt = (EncoderResult(e, a, pt[0].residuals), pt[1], ProbabilisticLogits(mean=m, var=v))
    jx = (JaxResult(embeds=jnp.asarray(e.numpy()), activations=jnp.asarray(a.numpy()),
                    residuals=jx[0].residuals), jx[1],
          JaxLogits(mean=jnp.asarray(m.numpy()), var=jnp.asarray(v.numpy())))
    scores = egl.expected_gradient_length(*pt, 1.5)
    assert len({float(scores[j]) for j in (0, 3, 10, 20)}) == 1
    j_idx, j_vals = jax_egl.select_egl(*jx, k=37, logit_scale=1.5)
    idx, vals = egl.select_egl(*pt, k=37, logit_scale=1.5)
    assert idx.tolist() == np.asarray(j_idx).tolist()
    tied = [i for i in idx.tolist() if i in (0, 3, 10, 20)]
    assert tied == [0, 3, 10, 20]
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    top, _ = egl.select_egl(*pt, k=5, logit_scale=1.5)
    assert top.tolist() == idx[:5].tolist()


def test_a_mesh_is_not_ported():
    """The mesh path is ported (tests/test_torch_dist_selection.py runs it
    over 2 and 3 ranks): without a process group "auto" is one device, the
    same scores as None, and a mesh of more than one rank needs a group."""
    _, _, pt = _case(7)
    dense = egl.expected_gradient_length(*pt, 1.0, mesh=None)
    assert dense.shape == (37,)
    assert torch.equal(egl.expected_gradient_length(*pt, 1.0, mesh="auto"), dense)

    class _Mesh:
        def size(self):
            return 2

        def get_local_rank(self):
            return 0

    with pytest.raises((ValueError, RuntimeError)):
        egl.expected_gradient_length(*pt, 1.0, mesh=_Mesh())
