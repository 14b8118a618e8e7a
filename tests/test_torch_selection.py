"""The port's selectors against the JAX package's on the CPU: the rest of
`types.py` (full-covariance sampling and its jitter fallback, the
Monte-Carlo softmax, entropies and cross entropy), `select/scores.py`,
the kNN finders of `select/knn.py` and `select/knn_kmeans.py`, and
`select/kmeans.py`. Inputs are made from numpy seeds. Where the JAX
package draws random numbers, its draws are handed to the port: the
Gaussian noise through `types._normal` (per row by `fold_in` for a full
covariance), permutations and categorical samples through
`select/draws.py`. Without them the port's own draws are held to their
contract (a seeded permutation, the same draw for the same seed,
moments, chunk invariance).

Tolerances: 1e-5 (rtol and atol) for everything computed in fp32 from
the same inputs and noise, one summation order apart (a Monte-Carlo mean
over 1000 samples adds its terms in another order, a few ulps of the
mean); indices exact, with the JAX package's tie order.
"""

from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.bayes.kfac import KroneckerFactorizedCovariance as JaxCov
from bayesvlm_tpu.select import kmeans as jax_kmeans
from bayesvlm_tpu.select import knn as jax_knn
from bayesvlm_tpu.select import knn_kmeans as jax_knn_kmeans
from bayesvlm_tpu.select import scores as jax_scores
from bayesvlm_tpu.types import EncoderResult as JaxResult
from bayesvlm_tpu.types import ProbabilisticLogits as JaxLogits
from bayesvlm_tpu_torch import types as port_types
from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.ops import topk_exact
from bayesvlm_tpu_torch.select import draws, kmeans, knn, knn_kmeans, scores
from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

TOL = 1e-5


def jax_noise(seed, shape, device, dtype, rows=None):
    """The JAX package's draw for `seed` (types._sample_logits), per row
    by fold_in of the row's global index for a full covariance
    (types._fullcov_logits_chunk)."""
    key = jax.random.key(seed)
    if rows is None:
        eps = jax.random.normal(key, tuple(shape), dtype=jnp.float32)
    else:
        eps = jnp.stack([jax.random.normal(jax.random.fold_in(key, r), tuple(shape),
                                           dtype=jnp.float32) for r in range(*rows)])
    return torch.from_numpy(np.array(eps)).to(device, dtype)


def jax_key(seed, stream):
    """key(seed), or the sub-key of its (stream + 1)-th split."""
    key = jax.random.key(seed)
    if stream is None:
        return key
    for _ in range(stream + 1):
        key, sub = jax.random.split(key)
    return sub


def jax_permutation(seed, n, stream=None):
    return np.array(jax.random.permutation(jax_key(seed, stream), n))


def jax_categorical(seed, logits, k):
    return np.array(jax.random.categorical(
        jax.random.key(seed), jnp.asarray(logits.cpu().numpy()), shape=(k,)))


def inject_jax_draws(mp):
    """Hand the port the JAX package's draws (a monkeypatch context)."""
    mp.setattr(port_types, "_normal", jax_noise)
    mp.setattr(draws, "permutation", jax_permutation)
    mp.setattr(draws, "categorical", jax_categorical)


@pytest.fixture
def jax_draws(monkeypatch):
    inject_jax_draws(monkeypatch)


def _spd_batch(rng, n, C, scale=0.3):
    M = rng.normal(size=(n, C, C)).astype(np.float32)
    return (M @ M.transpose(0, 2, 1) / C * scale
            + np.eye(C, dtype=np.float32) * 0.05).astype(np.float32)


def _logits(rng, N=12, C=5, full=False, singular=False):
    """The same logit distribution in both packages: [N, C] variances or
    [N, C, C] covariances, rows 0 and 1 not positive definite when
    `singular` (a zero matrix and an all-ones one)."""
    mean = (rng.normal(size=(N, C)) * 2).astype(np.float32)
    if full:
        var = _spd_batch(rng, N, C)
        if singular:
            var[0] = 0.0
            var[1] = 1.0
    else:
        var = rng.uniform(0.05, 2.0, size=(N, C)).astype(np.float32)
    return (JaxLogits(mean=jnp.asarray(mean), var=jnp.asarray(var)),
            ProbabilisticLogits(torch.from_numpy(mean), torch.from_numpy(var)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# -- types.py ------------------------------------------------------------------------


def test_encoder_result_slice_and_astype_match_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(7, 3)).astype(np.float32) for _ in range(3)]
    j = JaxResult(*map(jnp.asarray, arrays))
    p = EncoderResult(*map(torch.from_numpy, arrays))
    for start, size in ((0, 3), (2, 4), (6, 3), (-2, 2), (5, 7)):
        js, ps = j.slice(start, size), p.slice(start, size)
        for field in ("embeds", "activations", "residuals"):
            np.testing.assert_array_equal(getattr(ps, field).numpy(),
                                          np.asarray(getattr(js, field)))
    half = p.astype(torch.float16)
    assert half.embeds.dtype == half.activations.dtype == half.residuals.dtype == torch.float16
    np.testing.assert_array_equal(half.embeds.numpy(),
                                  np.asarray(j.astype(jnp.float16).embeds))


@pytest.mark.parametrize("full", [False, True])
def test_deterministic_views_match_jax(full):
    jl, pl = _logits(np.random.default_rng(1), full=full)
    _close(pl.diag_var, jl.diag_var, 0)
    _close(pl.probs, jl.probs)
    _close(pl.log_probs, jl.log_probs)
    _close(pl.softmax(num_samples=0), jl.softmax(num_samples=0))


@pytest.mark.parametrize("full,singular,chunk", [
    (False, False, None), (True, False, None), (True, False, 5), (True, True, 4)])
def test_monte_carlo_methods_match_jax(jax_draws, full, singular, chunk):
    jl, pl = _logits(np.random.default_rng(2), full=full, singular=singular)
    kw = dict(seed=3, chunk_size=chunk)
    target = np.random.default_rng(3).integers(0, 5, size=12)
    _close(pl.softmax(num_samples=50, **kw), jl.softmax(num_samples=50, **kw))
    _close(pl.sample_probas(20, **kw), jl.sample_probas(20, **kw))
    _close(pl.expected_aleatoric_entropy(num_samples=50, **kw),
           jl.expected_aleatoric_entropy(num_samples=50, **kw))
    for n in (0, 30):
        for reduction in ("sum", "mean", "none"):
            _close(pl.cross_entropy(torch.from_numpy(target), num_samples=n,
                                    reduction=reduction, **kw),
                   jl.cross_entropy(jnp.asarray(target), num_samples=n,
                                    reduction=reduction, **kw))
    if singular:
        # the jitter fallback: finite samples for the two non-PD rows
        probs = pl.sample_probas(10, **kw)
        assert torch.isfinite(probs).all()


def test_full_covariance_sampling_is_chunk_invariant_with_the_ports_draws():
    _, pl = _logits(np.random.default_rng(4), N=9, full=True)
    whole = pl.sample_probas(16, seed=5, chunk_size=None)
    for chunk in (1, 2, 4, 8):
        assert torch.equal(pl.sample_probas(16, seed=5, chunk_size=chunk), whole)
    assert not torch.equal(pl.sample_probas(16, seed=6), whole)


def test_ports_normal_draws_are_seeded_with_unit_moments():
    a = port_types._normal(7, (200_000,), "cpu", torch.float32)
    assert torch.equal(a, port_types._normal(7, (200_000,), "cpu", torch.float32))
    assert not torch.equal(a, port_types._normal(8, (200_000,), "cpu", torch.float32))
    assert abs(float(a.mean())) < 0.01 and abs(float(a.std()) - 1.0) < 0.01
    rows = port_types._normal(7, (3, 4), "cpu", torch.float32, rows=(2, 6))
    assert rows.shape == (4, 3, 4)
    assert torch.equal(rows[1:], port_types._normal(7, (3, 4), "cpu", torch.float32,
                                                    rows=(3, 6)))


# -- select/scores.py -----------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("variant", ["map_alea", "comb", "comb_covar", "exp_alea"])
def test_entropy_score_matches_jax(jax_draws, full, variant):
    jl, pl = _logits(np.random.default_rng(5), full=full)
    _close(scores.entropy_score(pl, variant, seed=2, chunk_size=5),
           jax_scores.entropy_score(jl, variant, seed=2, chunk_size=5))


@pytest.mark.parametrize("variant,entropy_variant", [
    ("var", None), ("logdet", None), ("entropy", "comb"), ("exp_mutual_info", None),
    ("map_mutual_info", None)])
def test_complexity_score_matches_jax(jax_draws, variant, entropy_variant):
    for full in ((True,) if variant == "logdet" else (False, True)):
        jl, pl = _logits(np.random.default_rng(6), full=full)
        _close(scores.complexity_score(pl, variant, entropy_variant, seed=0),
               jax_scores.complexity_score(jl, variant, entropy_variant, seed=0))
    with pytest.raises(ValueError, match="unknown complexity variant"):
        scores.complexity_score(pl, "nope")
    with pytest.raises(ValueError, match="unknown entropy variant"):
        scores.entropy_score(pl, "nope")


def test_topk_exact_keeps_jax_tie_order():
    x = np.array([[1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 1.0, -1.0, 1.0]], np.float32)
    for k in (1, 3, 5, 7):
        v, i = topk_exact(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("ignore", [0.0, 0.25])
def test_select_topk_with_ties_matches_jax(jax_draws, ignore):
    rng = np.random.default_rng(7)
    mean = rng.normal(size=(16, 4)).astype(np.float32)
    var = rng.uniform(0.1, 1.0, size=(16, 4)).astype(np.float32)
    var[[2, 5, 9, 13]] = var[7]  # equal complexity ("var": the same row sums)
    jl = JaxLogits(mean=jnp.asarray(mean), var=jnp.asarray(var))
    pl = ProbabilisticLogits(torch.from_numpy(mean), torch.from_numpy(var))
    for variant, ev in (("var", None), ("entropy", "map_alea"), ("exp_mutual_info", None)):
        idx, vals = scores.select_topk(pl, 6, variant, ev, ignore_percentage=ignore,
                                       return_values=True, seed=0)
        jidx, jvals = jax_scores.select_topk(jl, 6, variant, ev, ignore_percentage=ignore,
                                             return_values=True, seed=0)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        _close(vals, jvals)
        assert torch.equal(scores.select_topk(pl, 6, variant, ev, ignore_percentage=ignore,
                                              seed=0), idx)


@pytest.mark.parametrize("full", [False, True])
def test_classbalanced_and_randomized_selectors_match_jax(jax_draws, full):
    jl, pl = _logits(np.random.default_rng(8), N=20, full=full)
    class_ids = np.random.default_rng(9).integers(0, 3, size=20)
    for variant, ev in (("var", None), ("entropy", "comb")):
        got = scores.select_topk_classbalanced(pl, torch.from_numpy(class_ids), 7, variant, ev)
        want = jax_scores.select_topk_classbalanced(jl, jnp.asarray(class_ids), 7, variant, ev)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = scores.select_topk_randomized(pl, 9, 1.5, variant, ev, seed=4)
        want = jax_scores.select_topk_randomized(jl, 9, 1.5, variant, ev, seed=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for seed in (0, 3):
        np.testing.assert_array_equal(scores.select_random(pl, 6, seed=seed).numpy(),
                                      np.asarray(jax_scores.select_random(jl, 6, seed=seed)))
        np.testing.assert_array_equal(
            scores.select_random_classbalanced(class_ids, 8, seed).numpy(),
            np.asarray(jax_scores.select_random_classbalanced(jnp.asarray(class_ids), 8,
                                                              seed)))


def test_ports_own_random_selectors_keep_their_contract():
    _, pl = _logits(np.random.default_rng(10), N=30)
    a = scores.select_random(pl, 10, seed=1)
    assert torch.equal(a, scores.select_random(pl, 10, seed=1))
    assert torch.equal(a, torch.as_tensor(draws.permutation(1, 30)[:10]))
    assert sorted(draws.permutation(1, 30).tolist()) == list(range(30))
    assert not torch.equal(a, scores.select_random(pl, 10, seed=2))
    assert torch.equal(scores.select_random(pl, 10, seed=None),
                       scores.select_random(pl, 10, seed=0))
    class_ids = np.arange(30) % 4
    b = scores.select_random_classbalanced(class_ids, 10, seed=1).numpy()
    assert len(set(b.tolist())) == 10
    assert np.bincount(class_ids[b], minlength=4).tolist() == [3, 3, 2, 2]
    # categorical draws follow softmax(logits)
    logits = torch.tensor([0.0, np.log(3.0)])
    draws_ = draws.categorical(0, logits, 40_000)
    assert abs(float(np.mean(draws_ == 1)) - 0.75) < 0.01


def test_create_subset_json_matches_jax(jax_draws):
    jl, pl = _logits(np.random.default_rng(11), N=15)
    got = scores.create_subset_json(pl, None, 4)
    want = jax_scores.create_subset_json(jl, None, 4)
    assert list(got) == list(want)
    assert len(got) == 19
    for key, ids in want.items():
        assert got[key] == ids, key


# -- select/knn.py --------------------------------------------------------------------


def _features(rng, n, d=8, p=6, residuals=False):
    e = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.normal(size=(n, p)).astype(np.float32)
    r = (rng.normal(size=(n, d)) * 0.1).astype(np.float32) if residuals else np.zeros_like(e)
    return (JaxResult(*map(jnp.asarray, (e, a, r))),
            EncoderResult(*map(torch.from_numpy, (e, a, r))))


def _covs(rng, P, D):
    A = _spd_batch(rng, 1, P, 1.0)[0]
    B = _spd_batch(rng, 1, D, 1.0)[0]
    return (JaxCov(A_inv=jnp.asarray(A), B_inv=jnp.asarray(B)),
            KroneckerFactorizedCovariance(torch.from_numpy(A), torch.from_numpy(B)))


def _assert_knn_equal(got: OrderedDict, want: OrderedDict, tol=TOL):
    assert isinstance(got, OrderedDict)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k]["indices"] == w["indices"], k
        assert got[k]["score"] == pytest.approx(w["score"], rel=tol)
        np.testing.assert_allclose(got[k]["similarities"], w["similarities"],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("method", ["cosine", "wasserstein"])
@pytest.mark.parametrize("k_nearest,buffersize,has_bias", [(1, 150, False), (3, 4, True),
                                                           (2, 0, False)])
def test_find_similar_samples_match_jax(method, k_nearest, buffersize, has_bias):
    rng = np.random.default_rng(12)
    (jtr, ptr), (jte, pte) = _features(rng, 40, residuals=True), _features(rng, 20)
    jcov, pcov = _covs(rng, 6 + has_bias, 8)
    idx_test = np.array([3, 17, 8, 0, 11])
    vals_test = rng.uniform(size=5).astype(np.float32)
    fn = f"find_similar_samples_{method}"
    got = getattr(knn, fn)(ptr, pte, torch.from_numpy(idx_test), vals_test, k_nearest,
                           pcov, buffersize=buffersize, has_bias=has_bias)
    want = getattr(jax_knn, fn)(jtr, jte, idx_test, vals_test, k_nearest, jcov,
                                buffersize=buffersize, has_bias=has_bias, mesh=None)
    _assert_knn_equal(got, want)
    assert knn.extract_test_train_indices(got) == jax_knn.extract_test_train_indices(want)
    # without a process group "auto" is one device (the sharded search runs
    # over ranks in tests/test_torch_dist_selection.py)
    auto = getattr(knn, fn)(ptr, pte, torch.from_numpy(idx_test), vals_test, k_nearest,
                            pcov, buffersize=buffersize, has_bias=has_bias, mesh="auto")
    assert auto == got


def test_dedup_loop_terminates_when_the_pool_cannot_reach_the_goal():
    """tests/test_selection.py::test_knn_dedup_terminates_when_pool_cannot_reach_goal's
    input: the goal of 20 unique neighbours exceeds the 10 train rows."""
    rng = np.random.default_rng(11)
    (jtr, ptr) = _features(rng, 10)
    (jte, pte) = _features(rng, 20)
    eye = (np.eye(6, dtype=np.float32), np.eye(8, dtype=np.float32))
    pcov = KroneckerFactorizedCovariance(*map(torch.from_numpy, eye))
    jcov = JaxCov(*map(jnp.asarray, eye))
    idx_test, vals_test = np.arange(5), np.zeros(5, np.float32)
    got = knn.find_similar_samples_cosine(ptr, pte, idx_test, vals_test, k_nearest=4,
                                          source_covariance=pcov, buffersize=3)
    want = jax_knn.find_similar_samples_cosine(jtr, jte, idx_test, vals_test, k_nearest=4,
                                               source_covariance=jcov, buffersize=3,
                                               mesh=None)
    _assert_knn_equal(got, want)
    assert sorted(knn.extract_test_train_indices(got)["train"]) == list(range(10))
    assert all(len(v["indices"]) == 7 for v in got.values())


# -- select/kmeans.py and select/knn_kmeans.py ----------------------------------------


def test_kmeans_matches_jax(jax_draws):
    rng = np.random.default_rng(13)
    x = np.concatenate([rng.normal(size=(30, 5)) + 6, rng.normal(size=(30, 5)) - 6,
                        rng.normal(size=(20, 5))]).astype(np.float32)
    c, a = kmeans.kmeans_fit(torch.from_numpy(x), 7, seed=2, num_iters=15)
    jc, ja = jax_kmeans.kmeans_fit(jnp.asarray(x), 7, seed=2, num_iters=15)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    _close(c, jc)
    (jf, pf) = _features(rng, 80, d=5)
    jf = JaxResult(jnp.asarray(x), jf.activations, jf.residuals)
    pf = EncoderResult(torch.from_numpy(x), pf.activations, pf.residuals)
    rep, reps = kmeans.cluster_and_select_representatives(pf, 9, seed=1, num_iters=10)
    jrep, jreps = jax_kmeans.cluster_and_select_representatives(jf, 9, seed=1,
                                                                num_iters=10, mesh=None)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(jrep))
    np.testing.assert_array_equal(reps.activations.numpy(), np.asarray(jreps.activations))


def test_ports_own_kmeans_separates_clusters():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(np.concatenate([rng.normal(size=(50, 4)) + 10,
                                         rng.normal(size=(50, 4)) - 10]).astype(np.float32))
    _, assign = kmeans.kmeans_fit(x, 2, seed=0, num_iters=20)
    assert len(set(assign[:50].tolist())) == len(set(assign[50:].tolist())) == 1
    assert assign[0] != assign[50]


def _kmeans_case(seed=0, n_reps=40, n_test=20, D=8, P=6):
    """tests/test_reference_parity_knn_kmeans.py's case: every test row a
    small perturbation of one anchor, so all rows rank the same
    representatives on top and k' must grow past the first fetch."""
    rng = np.random.default_rng(seed)
    train_e = rng.normal(size=(n_reps, D)).astype(np.float32)
    train_a = rng.normal(size=(n_reps, P)).astype(np.float32)
    test_e = (rng.normal(size=(1, D)) + 1e-2 * rng.normal(size=(n_test, D))).astype(np.float32)
    test_a = (rng.normal(size=(1, P)) + 1e-2 * rng.normal(size=(n_test, P))).astype(np.float32)
    jcov, pcov = _covs(rng, P, D)
    orig = rng.choice(1000, size=n_reps, replace=False).astype(np.int64)
    idx_test = np.array([1, 4, 9, 11, 14, 17])
    vals_test = rng.uniform(0, 1, size=len(idx_test)).astype(np.float32)
    z = np.zeros
    return ((JaxResult(*map(jnp.asarray, (train_e, train_a, z((n_reps, D), np.float32)))),
             EncoderResult.create(torch.from_numpy(train_e), torch.from_numpy(train_a))),
            (JaxResult(*map(jnp.asarray, (test_e, test_a, z((n_test, D), np.float32)))),
             EncoderResult.create(torch.from_numpy(test_e), torch.from_numpy(test_a))),
            (jcov, pcov), orig, idx_test, vals_test)


@pytest.mark.parametrize("method", ["cosine", "wasserstein"])
@pytest.mark.parametrize("k_nearest,buffersize", [(4, 5), (1, 10)])
def test_knn_kmeans_finders_match_jax(method, k_nearest, buffersize, monkeypatch):
    (jtr, ptr), (jte, pte), (jcov, pcov), orig, idx_test, vals_test = _kmeans_case()
    fetches = []
    real = knn_kmeans.topk_exact
    monkeypatch.setattr(knn_kmeans, "topk_exact",
                        lambda x, k: fetches.append(k) or real(x, k))
    fn = f"find_similar_samples_{method}"
    got = getattr(knn_kmeans, fn)(ptr, pte, idx_test, vals_test, torch.from_numpy(orig),
                                  k_nearest, pcov, buffersize=buffersize)
    want = getattr(jax_knn_kmeans, fn)(jtr, jte, idx_test, vals_test, orig, k_nearest, jcov,
                                       buffersize=buffersize)
    _assert_knn_equal(got, want)
    assert all(len(v["indices"]) <= k_nearest for v in got.values())
    assert {i for v in got.values() for i in v["indices"]} <= set(orig.tolist())
    # (4, 5): goal 24 unique with a first fetch of 9 columns forces re-fetches
    assert (len(fetches) > 1) == (k_nearest == 4), fetches
