"""Port's Bayesian core and head against the JAX package: the Smith
forward, the K-FAC covariances, the lambda optimisation, the probit /
MAP / Monte-Carlo softmax, and the Hessian artifact files. Inputs are
made with numpy from a seed and handed to both packages; everything runs
in fp32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.bayes.kfac import compute_covariance as jax_compute_covariance
from bayesvlm_tpu.bayes.prior import (
    optimize_prior_precision as jax_optimize_prior_precision,
)
from bayesvlm_tpu.io.artifacts import save_hessians as jax_save_hessians
from bayesvlm_tpu.io.torch_compat import _save_pt_numpy
from bayesvlm_tpu.probforward.smith import _smith_forward
from bayesvlm_tpu.types import ProbabilisticLogits as JaxProbabilisticLogits
from bayesvlm_tpu_torch.bayes.kfac import (
    KroneckerFactorizedCovariance,
    compute_covariance,
)
from bayesvlm_tpu_torch.bayes.prior import optimize_prior_precision
from bayesvlm_tpu_torch.io.artifacts import load_hessians, save_hessians
from bayesvlm_tpu_torch.probforward.smith import (
    ProbabilisticHead,
    probabilistic_logits,
)
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits


def _spd(rng, d, scale=0.5):
    M = rng.normal(size=(d, d)).astype(np.float32)
    return (M @ M.T / d * scale + np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("has_bias", [False, True])
def test_smith_forward_matches_jax(has_bias):
    # fp32 on both sides at "highest" precision: only summation order
    # differs; the JAX head's own NumPy parity uses rtol 1e-4 / atol 1e-5
    rng = np.random.default_rng(int(has_bias))
    B, C, P, Pt, D = 5, 7, 12, 10, 6
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    emb_s, act_s, emb_t, act_t = f(B, D), f(B, P), f(C, D), f(C, Pt)
    extra = 1 if has_bias else 0
    A_s, B_s = _spd(rng, P + extra), _spd(rng, D)
    A_t, B_t = _spd(rng, Pt + extra), _spd(rng, D)
    scale = np.float32(2.3)

    ref_mean, ref_var = _smith_forward(
        emb_s, act_s, emb_t, act_t, A_s, np.diag(B_s).copy(), A_t,
        np.diag(B_t).copy(), scale, has_bias, has_bias)

    T = torch.from_numpy
    cov = lambda A, B: KroneckerFactorizedCovariance(T(A), T(B))
    head = ProbabilisticHead.create(float(scale), has_bias=has_bias,
                                    device="cpu")
    head = head.set_covariances(cov(A_s, B_s), cov(A_t, B_t))
    out = probabilistic_logits(head, EncoderResult.create(T(emb_s), T(act_s)),
                               EncoderResult.create(T(emb_t), T(act_t)))
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref_mean),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.var.numpy(), np.asarray(ref_var),
                               rtol=1e-4, atol=1e-5)


def test_map_logits_match_jax():
    # the head's MAP path: scaled cosine logits, zero variance
    from bayesvlm_tpu.probforward.smith import deterministic_logits

    rng = np.random.default_rng(9)
    src = rng.normal(size=(5, 6)).astype(np.float32)
    tgt = rng.normal(size=(7, 6)).astype(np.float32)
    ref = deterministic_logits(src, tgt, np.float32(4.6052), np.float32(0.0))
    T = torch.from_numpy
    head = ProbabilisticHead.create(4.6052, device="cpu")
    out = head(EncoderResult.create(T(src), T(src)),
               EncoderResult.create(T(tgt), T(tgt)), map_estimate=True)
    np.testing.assert_allclose(out.mean.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert not out.var.any()


def test_covariances_match_jax():
    # inverse of a well-conditioned SPD factor: fp32 LU vs fp32 LU,
    # rounding amplified by the condition number (< 10 here)
    rng = np.random.default_rng(3)
    A, B = _spd(rng, 16), _spd(rng, 9)
    ref = jax_compute_covariance(A, B, 10.0, 7.5)
    out = compute_covariance(torch.from_numpy(A), torch.from_numpy(B), 10.0, 7.5)
    np.testing.assert_allclose(out.A_inv.numpy(), np.asarray(ref.A_inv),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.B_inv.numpy(), np.asarray(ref.B_inv),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,init", [(10.0, 300.0), (1.0, 50.0)])
def test_prior_precision_matches_jax(n, init):
    # the same Adam (optax's defaults are torch's) on the same objective
    # in fp32; 300 steps of slightly different rounding stay within 1e-4
    rng = np.random.default_rng(4)
    A, B = _spd(rng, 20), _spd(rng, 8)
    w = rng.normal(size=(8, 20)).astype(np.float32) * 0.05
    l2 = float((w.astype(np.float64) ** 2).sum())
    ref = float(jax_optimize_prior_precision(l2, w.size, A=A, B=B,
                                             lmbda_init=init, n=n, lr=1e-2,
                                             num_steps=300))
    got = float(optimize_prior_precision(l2, w.size, A=torch.from_numpy(A),
                                         B=torch.from_numpy(B),
                                         lmbda_init=init, n=n, lr=1e-2,
                                         num_steps=300))
    assert got == pytest.approx(ref, rel=1e-4)
    assert got != pytest.approx(init, rel=1e-2)  # it moved


def test_probit_and_map_softmax_match_jax():
    rng = np.random.default_rng(5)
    mean = rng.normal(size=(6, 9)).astype(np.float32) * 3
    var = rng.uniform(0.1, 4.0, size=(6, 9)).astype(np.float32)
    ref = JaxProbabilisticLogits(mean=jnp.asarray(mean), var=jnp.asarray(var))
    out = ProbabilisticLogits(torch.from_numpy(mean), torch.from_numpy(var))
    np.testing.assert_allclose(out.softmax(num_samples=0).numpy(),
                               np.asarray(ref.softmax(num_samples=0)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(out.map_softmax().numpy(),
                               np.asarray(ref.map_softmax()),
                               rtol=1e-5, atol=1e-7)


def test_mc_softmax_matches_jax_in_distribution():
    # different generators: compare estimates. Each entry averages S
    # softmax samples in [0, 1], so its std is at most 0.5/sqrt(S); with
    # S = 20000 the two estimates' difference has std < 0.005 and 0.03
    # is six of those
    rng = np.random.default_rng(6)
    mean = rng.normal(size=(4, 5)).astype(np.float32) * 2
    var = rng.uniform(0.5, 3.0, size=(4, 5)).astype(np.float32)
    S = 20000
    ref = np.asarray(JaxProbabilisticLogits(jnp.asarray(mean), jnp.asarray(var))
                     .softmax(num_samples=S, seed=0))
    out = ProbabilisticLogits(torch.from_numpy(mean), torch.from_numpy(var))
    mc = out.softmax(num_samples=S, seed=0).numpy()
    np.testing.assert_allclose(mc, ref, atol=0.03)
    np.testing.assert_allclose(mc.sum(-1), 1.0, rtol=1e-5)
    # seeded: the same seed gives the same draw, another seed another
    np.testing.assert_array_equal(out.softmax(num_samples=64, seed=1).numpy(),
                                  out.softmax(num_samples=64, seed=1).numpy())
    assert not np.array_equal(out.softmax(num_samples=64, seed=1).numpy(),
                              out.softmax(num_samples=64, seed=2).numpy())


@pytest.mark.parametrize("writer", ["jax_save_hessians", "numpy_codec"])
def test_load_hessians_reads_jax_written_files(tmp_path, writer):
    """Files from the JAX package's save_hessians (torch codec) and from
    its torch-free NumPy writer load bit-exactly."""
    rng = np.random.default_rng(7)
    A, B = _spd(rng, 11), _spd(rng, 5)
    if writer == "jax_save_hessians":
        jax_save_hessians(tmp_path, A, B, "img")
    else:
        _save_pt_numpy(A, tmp_path / "A_img_analytic.pt")
        _save_pt_numpy(B, tmp_path / "B_img_analytic.pt")
    A2, B2 = load_hessians(tmp_path, "img")
    assert A2.dtype == torch.float32
    np.testing.assert_array_equal(A2.numpy(), A)
    np.testing.assert_array_equal(B2.numpy(), B)


def test_save_hessians_roundtrip_through_jax_loader(tmp_path):
    from bayesvlm_tpu.io.artifacts import load_hessians as jax_load_hessians

    rng = np.random.default_rng(8)
    A, B = _spd(rng, 6), _spd(rng, 4)
    save_hessians(tmp_path, torch.from_numpy(A), torch.from_numpy(B), "txt")
    A2, B2 = jax_load_hessians(tmp_path, "txt")
    np.testing.assert_array_equal(np.asarray(A2), A)
    np.testing.assert_array_equal(np.asarray(B2), B)
