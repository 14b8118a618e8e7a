"""Port of the EPIG scores and the joint-entropy row sums
(`bayesvlm_tpu_torch.select.epig`, `select/epig_joint.py`) against the
JAX package's, on the CPU: the Pallas kernel in interpret mode (as
tests/test_epig_pallas.py runs it) and the XLA path (`use_pallas=False`);
the entropies; Monte-Carlo sampling with the JAX package's noise handed
to the port; plus the CUDA kernel against its plain version on the card
(marked `cuda`, skipped without a GPU).

Tolerances are the JAX package's own (tests/test_epig_pallas.py): row
sums 5e-3 (bf16) and 1e-3 (int8); EPIG scores 2e-3 with the argmax
equal; int8 scores 1e-2.

    python -m pytest --noconftest -m cuda tests/test_torch_epig.py
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import types as port_types
from bayesvlm_tpu_torch.select import epig as port_epig
from bayesvlm_tpu_torch.select.epig_joint import (
    epig_from_probs_fused,
    joint_xlogy_rowsums,
    joint_xlogy_rowsums_reference,
)
from bayesvlm_tpu_torch.types import ProbabilisticLogits


def _probs(rng, n, k, c):
    z = rng.normal(size=(n, k, c)).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def jax_noise(seed, shape, device, dtype):
    """The JAX package's draw for `seed` (types._sample_logits)."""
    import jax
    import jax.numpy as jnp

    eps = jax.random.normal(jax.random.key(seed), tuple(shape), dtype=jnp.float32)
    return torch.from_numpy(np.array(eps)).to(device, dtype)


def test_rowsums_match_jax_kernel_interpret():
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig_pallas import joint_xlogy_rowsums as jax_rowsums

    rng = np.random.default_rng(1)
    m, n, k = 37, 29, 11
    a = rng.uniform(0.0, 1.0, size=(m, k)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, size=(n, k)).astype(np.float32)
    ref = np.asarray(jax_rowsums(jnp.asarray(a), jnp.asarray(b), num_samples=k,
                                 interpret=True))
    got = joint_xlogy_rowsums(torch.from_numpy(a), torch.from_numpy(b), k)
    assert got.dtype == torch.float32 and got.shape == (m,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-3, atol=5e-3)


def test_rowsums_int8_match_jax_kernel_interpret():
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig_pallas import joint_xlogy_rowsums as jax_rowsums

    rng = np.random.default_rng(8)
    M, N, K = 50, 30, 12
    pool = rng.uniform(0.01, 1.0, size=(M, K)).astype(np.float32)
    targ = rng.uniform(0.01, 1.0, size=(N, K)).astype(np.float32)
    ref = np.asarray(jax_rowsums(jnp.asarray(pool), jnp.asarray(targ), num_samples=K,
                                 interpret=True, use_int8=True))
    got = joint_xlogy_rowsums(torch.from_numpy(pool), torch.from_numpy(targ), K,
                              use_int8=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_p,n_t,c,k", [(12, 7, 5, 9), (33, 17, 3, 16)])
def test_epig_scores_match_jax(n_p, n_t, c, k):
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig import epig_from_probs_using_matmul as jax_epig
    from bayesvlm_tpu.select.epig_pallas import epig_from_probs_pallas

    rng = np.random.default_rng(0)
    pp, pt = _probs(rng, n_p, k, c), _probs(rng, n_t, k, c)
    got = port_epig.epig_from_probs_using_matmul(torch.from_numpy(pp),
                                                 torch.from_numpy(pt)).numpy()
    assert got.shape == (n_p,)
    for ref in (jax_epig(jnp.asarray(pp), jnp.asarray(pt), use_pallas=False),
                epig_from_probs_pallas(jnp.asarray(pp), jnp.asarray(pt),
                                       interpret=True)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
        assert np.argmax(got) == np.argmax(ref)


@pytest.mark.parametrize("n_p,n_t,c,k", [(12, 7, 5, 9), (33, 17, 3, 16)])
def test_epig_int8_scores_match_jax(n_p, n_t, c, k):
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig_pallas import epig_from_probs_pallas

    rng = np.random.default_rng(7)
    pp, pt = _probs(rng, n_p, k, c), _probs(rng, n_t, k, c)
    ref = np.asarray(epig_from_probs_pallas(jnp.asarray(pp), jnp.asarray(pt),
                                            interpret=True, use_int8=True))
    got = epig_from_probs_fused(torch.from_numpy(pp), torch.from_numpy(pt),
                                use_int8=True).numpy()
    assert np.abs(got - ref).max() <= 1e-2


def test_entropies_match_jax():
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig import (
        entropy_from_probs,
        marginal_entropy_from_probs,
    )

    rng = np.random.default_rng(3)
    p = _probs(rng, 6, 5, 4)
    p[0, 0] = np.array([1.0, 0.0, 0.0, 0.0], np.float32)  # 0 log 0 = 0
    got = port_epig.entropy_from_probs(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, np.asarray(entropy_from_probs(jnp.asarray(p))),
                               rtol=1e-6, atol=1e-6)
    got = port_epig.marginal_entropy_from_probs(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(marginal_entropy_from_probs(jnp.asarray(p))),
        rtol=1e-6, atol=1e-6)


def _logits(rng, n, c):
    mean = rng.normal(size=(n, c)).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=(n, c)).astype(np.float32)
    return mean, var


def test_sample_probas_shape_and_rows():
    mean, var = _logits(np.random.default_rng(4), 5, 3)
    pl = ProbabilisticLogits(torch.from_numpy(mean), torch.from_numpy(var))
    p = pl.sample_probas(7, seed=2)
    assert p.shape == (5, 7, 3) and p.dtype == torch.float32
    torch.testing.assert_close(p.sum(-1), torch.ones(5, 7))
    assert torch.equal(p, pl.sample_probas(7, seed=2))
    assert not torch.equal(p, pl.sample_probas(7, seed=3))
    assert len(pl) == 5 and pl[1:3].mean.shape == (2, 3)


def test_sample_probas_matches_jax_with_its_noise(monkeypatch):
    import jax.numpy as jnp

    from bayesvlm_tpu.types import ProbabilisticLogits as JaxLogits

    monkeypatch.setattr(port_types, "_normal", jax_noise)
    mean, var = _logits(np.random.default_rng(5), 6, 4)
    got = ProbabilisticLogits(torch.from_numpy(mean),
                              torch.from_numpy(var)).sample_probas(9, seed=11)
    ref = JaxLogits(mean=jnp.asarray(mean), var=jnp.asarray(var)).sample_probas(9, seed=11)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_epig_from_logits_chunks_match_jax(monkeypatch):
    """Chunked over the pool with seed + i per chunk, as the JAX package."""
    import jax.numpy as jnp

    from bayesvlm_tpu.select.epig import epig_from_logits_using_matmul as jax_fn
    from bayesvlm_tpu.types import ProbabilisticLogits as JaxLogits

    monkeypatch.setattr(port_types, "_normal", jax_noise)
    rng = np.random.default_rng(6)
    (mp, vp), (mt, vt) = _logits(rng, 11, 4), _logits(rng, 5, 4)
    got = port_epig.epig_from_logits_using_matmul(
        ProbabilisticLogits(torch.from_numpy(mp), torch.from_numpy(vp)),
        ProbabilisticLogits(torch.from_numpy(mt), torch.from_numpy(vt)),
        seed=3, num_samples=8, chunk_size=4).numpy()
    ref = np.asarray(jax_fn(JaxLogits(jnp.asarray(mp), jnp.asarray(vp)),
                            JaxLogits(jnp.asarray(mt), jnp.asarray(vt)),
                            seed=3, num_samples=8, chunk_size=4))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(size=(20, 7)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(9, 7)).astype(np.float32))
    before = joint_xlogy_rowsums.launches, joint_xlogy_rowsums.launches_int8
    for use_int8 in (False, True):
        assert torch.equal(joint_xlogy_rowsums(a, b, 7, use_int8=use_int8),
                           joint_xlogy_rowsums_reference(a, b, 7, use_int8=use_int8))
    assert (joint_xlogy_rowsums.launches, joint_xlogy_rowsums.launches_int8) == before
    with pytest.raises(ValueError, match="K differs"):
        joint_xlogy_rowsums(a, b[:, :6], 7)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        joint_xlogy_rowsums(a[0], b, 7)


def test_plain_version_chunks_the_pool(monkeypatch):
    """The ~1 GB joint chunks of the plain version change nothing."""
    from bayesvlm_tpu_torch.select import epig_joint

    rng = np.random.default_rng(10)
    a = torch.from_numpy(rng.uniform(size=(23, 5)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(6, 5)).astype(np.float32))
    whole = joint_xlogy_rowsums_reference(a, b, 5)
    monkeypatch.setattr(epig_joint, "_CHUNK_ELEMS", 6 * 4)  # 4 rows a chunk
    torch.testing.assert_close(joint_xlogy_rowsums_reference(a, b, 5), whole)


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_probs(cuda, n, k, c, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    p = torch.softmax(torch.randn(n, k, c, generator=gen, device=cuda), dim=-1)
    return p.transpose(1, 2).reshape(n * c, k)


@pytest.mark.cuda
@pytest.mark.parametrize("use_int8", [False, True])
@pytest.mark.parametrize("n_p,n_t,c,k", [
    (3, 2, 5, 9), (37, 29, 7, 9), (41, 23, 13, 100), (300, 77, 65, 100),
    (41, 23, 13, 200),
])
def test_kernel_matches_plain_on_card(cuda, use_int8, n_p, n_t, c, k):
    """M and N are no multiple of the 128-row tiles; K = 9 and 100 pad;
    K = 200 reads the A fragments past the register-held k-steps from
    shared memory. The two differ in fp32 summation order and in the log (__log2f):
    1e-4 of the largest row sum."""
    a, b = _card_probs(cuda, n_p, k, c, 1), _card_probs(cuda, n_t, k, c, 2)
    before = joint_xlogy_rowsums.launches, joint_xlogy_rowsums.launches_int8
    out = joint_xlogy_rowsums(a, b, k, use_int8=use_int8)
    torch.cuda.synchronize()
    after = joint_xlogy_rowsums.launches, joint_xlogy_rowsums.launches_int8
    assert after == (before[0] + (not use_int8), before[1] + use_int8)
    ref = joint_xlogy_rowsums_reference(a, b, k, use_int8=use_int8)
    assert out.shape == (n_p * c,) and out.dtype == torch.float32
    tol = 1e-4 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=tol)


@pytest.mark.cuda
def test_kernel_takes_strided_and_bf16_operands(cuda):
    a, b = _card_probs(cuda, 19, 100, 9, 3), _card_probs(cuda, 11, 100, 9, 4)
    out = joint_xlogy_rowsums(a, b, 100)
    # a transposed copy's view, and bf16 operands: the same bf16 values
    torch.testing.assert_close(joint_xlogy_rowsums(a.T.contiguous().T, b, 100), out)
    torch.testing.assert_close(
        joint_xlogy_rowsums(a.bfloat16(), b.bfloat16(), 100), out)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    a = torch.rand(10, 100, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        joint_xlogy_rowsums(a.half(), a.half(), 100)
    with pytest.raises(ValueError, match="shared memory"):
        joint_xlogy_rowsums(torch.rand(10, 400, device=cuda),
                            torch.rand(10, 400, device=cuda), 400)
    with pytest.raises(ValueError, match="two devices"):
        joint_xlogy_rowsums(a, a.cpu(), 100)


@pytest.mark.cuda
def test_epig_scores_count_one_launch_per_call(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    pp = torch.softmax(torch.randn(30, 16, 6, generator=gen, device=cuda), -1)
    pt = torch.softmax(torch.randn(20, 16, 6, generator=gen, device=cuda), -1)
    before = joint_xlogy_rowsums.launches
    got = port_epig.epig_from_probs_using_matmul(pp, pt)
    assert joint_xlogy_rowsums.launches == before + 1
    ref = port_epig.epig_from_probs_using_matmul(pp.cpu(), pt.cpu())
    torch.testing.assert_close(got.cpu(), ref, rtol=2e-3, atol=2e-3)
