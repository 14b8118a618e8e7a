"""Port of the online EPIG loop (`bayesvlm_tpu_torch.select.
select_epig_online`) and the modules it runs, against the JAX package's,
on the CPU: the InfoNCE GGN (`bayes/hessians.py`), the kNN similarities
(`select/knn.py`), the embedding refresh, one SGD step, and the whole
loop in each pool subsampling mode and with a biased projection, with the
JAX package's Monte-Carlo noise handed to the port, so that both must
select the same indices.

Tolerances: the JAX package's Hessian tests (rtol 1e-4, atol 1e-4; a
blocked sum 1e-5); 1e-5 for the similarities, the refresh and the SGD
step (fp32, one summation order apart); EPIG scores 2e-3
(tests/test_epig_pallas.py).
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import types as port_types
from bayesvlm_tpu_torch.bayes.hessians import hessian_infonce
from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.select import epig as port_epig
from bayesvlm_tpu_torch.select.knn import expected_cosine_similarity, wdist2
from bayesvlm_tpu_torch.types import EncoderResult


def jax_noise(seed, shape, device, dtype):
    """The JAX package's draw for `seed` (types._sample_logits)."""
    import jax
    import jax.numpy as jnp

    eps = jax.random.normal(jax.random.key(seed), tuple(shape), dtype=jnp.float32)
    return torch.from_numpy(np.array(eps)).to(device, dtype)


def _both(embeds, activations, residuals=None):
    """The same features as a JAX and a port EncoderResult."""
    import jax.numpy as jnp

    from bayesvlm_tpu.types import EncoderResult as JaxResult

    if residuals is None:
        residuals = np.zeros_like(embeds)
    jax_r = JaxResult(embeds=jnp.asarray(embeds), activations=jnp.asarray(activations),
                      residuals=jnp.asarray(residuals))
    port_r = EncoderResult(torch.from_numpy(embeds), torch.from_numpy(activations),
                           torch.from_numpy(residuals))
    return jax_r, port_r


def _spd(rng, d, s=0.1):
    M = rng.normal(size=(d, d)).astype(np.float32)
    return M @ M.T / d * s + np.eye(d, dtype=np.float32) * 0.2


# the fixtures of tests/test_epig_online.py, as numpy
def _setup(rng, n_pool=40, n_target=16, C=4, D=8, P=6, bias=False):
    kernel = (rng.normal(size=(P, D)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(D,)) * 0.1).astype(np.float32) if bias else None
    acts = [rng.normal(size=(n, P)).astype(np.float32) for n in (n_pool, n_target, C)]
    feats = [_both(a @ kernel + (0.0 if b is None else b), a) for a in acts]
    Pa = P + 1 if bias else P  # the bias column
    factors = dict(A_img=_spd(rng, Pa), B_img=_spd(rng, D),
                   A_txt=_spd(rng, Pa), B_txt=_spd(rng, D))
    return kernel, b, feats, factors


def _heads(scale=1.0, bias=0.0, has_bias=False):
    from bayesvlm_tpu.probforward.smith import ProbabilisticHead as JaxHead

    return (JaxHead.create(logit_scale=scale, logit_bias=bias, has_bias=has_bias),
            ProbabilisticHead.create(logit_scale=scale, logit_bias=bias,
                                     device="cpu", has_bias=has_bias))


def test_hessian_infonce_matches_jax():
    import jax.numpy as jnp

    from bayesvlm_tpu.bayes.hessians import hessian_infonce as jax_hessian

    rng = np.random.default_rng(0)
    src = rng.normal(size=(11, 6)).astype(np.float32)
    tgt = rng.normal(size=(5, 6)).astype(np.float32)
    ref = np.asarray(jax_hessian(jnp.asarray(src), jnp.asarray(tgt), 0.7))
    got = hessian_infonce(torch.from_numpy(src), torch.from_numpy(tgt), 0.7)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(got, got.T)
    blocked = hessian_infonce(torch.from_numpy(src), torch.from_numpy(tgt), 0.7,
                              block_size=4)
    np.testing.assert_allclose(blocked.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)
    ref_b = np.asarray(jax_hessian(jnp.asarray(src), jnp.asarray(tgt), 0.7,
                                   block_size=4))
    np.testing.assert_allclose(blocked.numpy(), ref_b, rtol=1e-4, atol=1e-4)


def test_similarities_match_jax():
    import jax.numpy as jnp

    from bayesvlm_tpu.select.knn import expected_cosine_similarity as jax_cos
    from bayesvlm_tpu.select.knn import wdist2 as jax_wdist2

    rng = np.random.default_rng(1)
    mu1, mu2 = rng.normal(size=(5, 8)), rng.normal(size=(7, 8))
    c1, c2 = rng.uniform(0.1, 1.0, size=(5, 8)), rng.uniform(0.1, 1.0, size=(7, 8))
    args = [x.astype(np.float32) for x in (mu1, mu2, c1, c2)]
    ref = np.asarray(jax_wdist2(*map(jnp.asarray, args)))
    got = wdist2(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    for has_bias in (False, True):
        P = 6 + has_bias
        (jt, pt), (jr, pr) = (_both(rng.normal(size=(n, 8)).astype(np.float32),
                                    rng.normal(size=(n, 6)).astype(np.float32))
                              for n in (5, 9))
        A_inv = np.linalg.inv(_spd(rng, P)).astype(np.float32)
        B_diag = rng.uniform(0.1, 1.0, size=(8,)).astype(np.float32)
        ref = np.asarray(jax_cos(jt, jr, jnp.asarray(A_inv), jnp.asarray(B_diag),
                                 has_bias=has_bias))
        got = expected_cosine_similarity(pt, pr, torch.from_numpy(A_inv),
                                         torch.from_numpy(B_diag), has_bias).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_update_embeddings_matches_jax():
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig import update_embeddings as jax_update

    rng = np.random.default_rng(2)
    kernel = rng.normal(size=(5, 4)).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    jf, pf = _both(np.zeros((3, 4), np.float32), rng.normal(size=(3, 5)).astype(np.float32),
                   rng.normal(size=(3, 4)).astype(np.float32))
    ref = jax_update(jnp.asarray(kernel), jnp.asarray(bias), jf)
    got = port_epig.update_embeddings(torch.from_numpy(kernel), torch.from_numpy(bias), pf)
    np.testing.assert_allclose(got.embeds.numpy(), np.asarray(ref.embeds),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(got.activations, pf.activations)


@pytest.mark.parametrize("has_bias", [False, True])
def test_sgd_step_matches_jax(has_bias):
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig import _epig_sgd_step as jax_step

    rng = np.random.default_rng(3)
    kernel, b, feats, factors = _setup(rng, bias=has_bias)
    (jp, pp), _, (jl, pl) = feats
    P = kernel.shape[0] + has_bias
    A_inv = [np.linalg.inv(_spd(rng, P)) for _ in range(2)]
    B_diag = [rng.uniform(0.1, 1.0, size=(8,)) for _ in range(2)]
    arrays = [x.astype(np.float32) for x in (A_inv[0], B_diag[0], A_inv[1], B_diag[1])]
    act, res = pp.activations[:1].numpy(), pp.residuals[:1].numpy()
    ref = jax_step(jnp.asarray(kernel), None if b is None else jnp.asarray(b),
                   jnp.asarray(act), jnp.asarray(res), jnp.asarray([2]), jl,
                   *map(jnp.asarray, arrays), jnp.float32(1.3), 0.5, has_bias)
    got = port_epig._epig_sgd_step(
        torch.from_numpy(kernel), None if b is None else torch.from_numpy(b),
        torch.from_numpy(act), torch.from_numpy(res), torch.tensor([2]), pl,
        *map(torch.from_numpy, arrays), torch.tensor(1.3), 0.5, has_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not np.allclose(got.numpy(), kernel)


def _run_both(rng, subsampling, bias=False, budget=3, n_pool=40, **kw):
    """select_epig_online of both packages on the same inputs and noise."""
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig import select_epig_online as jax_select

    kernel, b, feats, factors = _setup(rng, n_pool=n_pool, bias=bias)
    (jp, pp), (jt, pt), (jl, pl) = feats
    class_ids = rng.integers(0, 4, size=n_pool)
    jax_head, port_head = _heads(bias=-0.5 if bias else 0.0, has_bias=bias)
    info = dict(lambda_img=5.0, lambda_txt=5.0, n_img=10.0, n_txt=10.0)
    common = dict(cov_info=info, budget=budget, lr=1e-3, hessian_update_scale=10.0,
                  num_samples=8, seed=0, projection_l2=float(np.sum(kernel**2)),
                  projection_num_params=kernel.size, pool_subsampling=subsampling,
                  proj_has_bias=bias, hessian_n0=100, **kw)
    ref = jax_select(
        label_features=jl, pool_features=jp, target_features=jt,
        pool_class_ids=jnp.asarray(class_ids), projection_kernel=jnp.asarray(kernel),
        projection_bias=None if b is None else jnp.asarray(b), head=jax_head,
        **{k: jnp.asarray(v) for k, v in factors.items()}, mesh=None, **common)
    got = port_epig.select_epig_online(
        label_features=pl, pool_features=pp, target_features=pt,
        pool_class_ids=torch.from_numpy(class_ids),
        projection_kernel=torch.from_numpy(kernel),
        projection_bias=None if b is None else torch.from_numpy(b), head=port_head,
        **{k: torch.from_numpy(v) for k, v in factors.items()}, device="cpu", **common)
    return ref, got


@pytest.mark.parametrize("subsampling,bias,kw", [
    ("random", False, {}),
    ("knn_cosine", False, {"k_nearest_neighbors": 8}),
    ("knn_wasserstein", False, {"k_nearest_neighbors": 8}),
    ("random", True, {}),
])
def test_select_epig_online_matches_jax(monkeypatch, subsampling, bias, kw):
    monkeypatch.setattr(port_types, "_normal", jax_noise)
    (ref_idx, ref_scores), (idx, scores) = _run_both(
        np.random.default_rng(7), subsampling, bias=bias, **kw)
    assert idx == ref_idx
    assert len(set(idx)) == 3 and all(isinstance(i, int) for i in idx)
    np.testing.assert_allclose(scores, ref_scores, rtol=2e-3, atol=2e-3)


def test_select_epig_online_raises_when_pool_too_small():
    with pytest.raises(ValueError, match="Could not find enough samples"):
        _run_both(np.random.default_rng(1), "knn_cosine", budget=30,
                  k_nearest_neighbors=1)  # 16 targets x 1 < budget 30


def test_select_epig_online_pool_exhaustion_raises():
    rng = np.random.default_rng(3)
    kernel, b, ((_, pp), (_, pt), (_, pl)), factors = _setup(rng, n_pool=5)
    with pytest.raises(ValueError, match="EPIG pool exhausted"):
        port_epig.select_epig_online(
            label_features=pl, pool_features=pp, target_features=pt,
            pool_class_ids=torch.zeros(5, dtype=torch.long),
            projection_kernel=torch.from_numpy(kernel), projection_bias=None,
            head=_heads()[1], **{k: torch.from_numpy(v) for k, v in factors.items()},
            cov_info=dict(lambda_img=5.0, lambda_txt=5.0, n_img=10.0, n_txt=10.0),
            budget=8, lr=1e-3, hessian_update_scale=10.0, num_samples=4, seed=0,
            projection_l2=float(np.sum(kernel**2)), projection_num_params=kernel.size,
            pool_subsampling="random", pool_max_size=5, hessian_n0=100, device="cpu")


def test_random_subsampling_permutes_within_the_limits():
    """With max sizes the port draws its own permutation (torch, not
    jax.random): the selections come from the permuted pool subsample."""
    rng = np.random.default_rng(4)
    kernel, b, ((_, pp), (_, pt), (_, pl)), factors = _setup(rng)
    idx, scores = port_epig.select_epig_online(
        label_features=pl, pool_features=pp, target_features=pt,
        pool_class_ids=torch.from_numpy(rng.integers(0, 4, size=40)),
        projection_kernel=torch.from_numpy(kernel), projection_bias=None,
        head=_heads()[1], **{k: torch.from_numpy(v) for k, v in factors.items()},
        cov_info=dict(lambda_img=5.0, lambda_txt=5.0, n_img=10.0, n_txt=10.0),
        budget=3, lr=1e-3, hessian_update_scale=10.0, num_samples=8, seed=0,
        projection_l2=float(np.sum(kernel**2)), projection_num_params=kernel.size,
        pool_max_size=30, target_max_size=12, hessian_n0=100, device="cpu")
    assert len(set(idx)) == 3 and all(0 <= i < 40 for i in idx)
    assert all(np.isfinite(s) for s in scores)
