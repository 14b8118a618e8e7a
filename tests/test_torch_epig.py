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

import ctypes

from bayesvlm_tpu_torch import types as port_types
from bayesvlm_tpu_torch.select import epig as port_epig
from bayesvlm_tpu_torch.select import epig_joint as ej
from bayesvlm_tpu_torch.select.epig_joint import (
    ROWSUM_RTOL,
    epig_from_probs_fused,
    joint_xlogy_rowsums,
    joint_xlogy_rowsums_reference,
    kernel_resources,
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


# -- the wrapper's host side, through a stub library -----------------------------


@pytest.mark.parametrize("K,use_int8,k_pad,streamed", [
    (9, False, 16, False), (100, False, 112, False), (112, False, 112, False),
    (128, False, 128, False), (129, False, 144, True), (400, False, 400, True),
    (9, True, 32, False), (100, True, 128, False), (256, True, 256, False),
    (257, True, 288, True), (1000, True, 1024, True),
])
def test_plan_pads_k_and_picks_the_instantiation(K, use_int8, k_pad, streamed):
    # K to whole wgmma k-steps of 32 bytes; the resident block holds at
    # most 256 bytes of K a row (128 bf16, 256 int8), longer rows stream
    plan = ej._plan(7, 5, K, use_int8)
    assert (plan["k_pad"], plan["streamed"]) == (k_pad, streamed)
    assert plan["k_pad"] * (1 if use_int8 else 2) > ej.RESIDENT_K_BYTES or not streamed


def test_plan_forces_an_instantiation_or_refuses():
    assert ej._plan(7, 5, 100, False, streamed=True)["streamed"]
    assert not ej._plan(7, 5, 128, False, streamed=False)["streamed"]
    assert not ej._plan(7, 5, 256, True, streamed=False)["streamed"]
    for K, use_int8 in ((129, False), (257, True)):
        with pytest.raises(ValueError, match="resident xlogy_rowsum kernel holds at most "
                                             "256 bytes"):
            ej._plan(7, 5, K, use_int8, streamed=False)


@pytest.mark.parametrize("use_int8", [False, True])
def test_plan_scratch_sizes(use_int8):
    scratch = ej._plan(300, 77, 100, use_int8)["scratch"]
    if not use_int8:
        assert scratch == {}
        return
    assert scratch == {"aq": ((300, 128), torch.int8), "a_scale": ((300,), torch.float32),
                       "bq": ((77, 128), torch.int8), "b_scale": ((77,), torch.float32)}


def _view(ptr, n, ctype, dtype):
    return torch.frombuffer((ctype * n).from_address(ptr), dtype=dtype) if n else \
        torch.empty(0, dtype=dtype)


class _StubLibrary:
    """The kernel library's entry points on the CPU: each call's scalars
    are recorded, the padded bf16 operands read at the pointers given, and
    the plain row sums of those operands written at `out` (or `err`
    returned)."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def bvt_xlogy_rowsum_bf16(self, a, b, out, M, N, k, inv_k, streamed, stream):
        return self._run("bf16", (a, b), (), out, M, N, k, inv_k, streamed, stream)

    def bvt_xlogy_rowsum_int8(self, a, b, aq, a_scale, bq, b_scale, out, M, N, k, inv_k,
                              streamed, stream):
        return self._run("int8", (a, b), (aq, a_scale, bq, b_scale), out, M, N, k, inv_k,
                         streamed, stream)

    def _run(self, kind, ab, scratch, out, M, N, k, inv_k, streamed, stream):
        a, b = (_view(p, rows * k, ctypes.c_uint16, torch.bfloat16).view(rows, k)
                for p, rows in zip(ab, (M, N)))
        self.calls.append(dict(kind=kind, M=M, N=N, k=k, inv_k=inv_k, streamed=streamed,
                               stream=stream, a=a.clone(), b=b.clone(), scratch=scratch,
                               out=out))
        if not self.err:
            _view(out, M, ctypes.c_float, torch.float32)[:] = joint_xlogy_rowsums_reference(
                a, b, round(1 / inv_k), use_int8=kind == "int8")
        return self.err

    def bvt_error_string(self, err):
        return b"stub refusal"


@pytest.mark.parametrize("use_int8", [False, True])
@pytest.mark.parametrize("K,streamed", [(9, None), (100, None), (129, None), (400, None),
                                        (100, True)])
def test_call_hands_the_library_padded_operands(use_int8, K, streamed):
    rng = np.random.default_rng(K)
    a = torch.from_numpy(rng.uniform(size=(37, K)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(size=(29, K)).astype(np.float32))
    lib = _StubLibrary()
    out = ej._call(lib, a, b, K, use_int8, streamed, stream=7)
    plan = ej._plan(37, 29, K, use_int8, streamed)
    (call,) = lib.calls
    assert call["kind"] == ("int8" if use_int8 else "bf16")
    assert (call["M"], call["N"], call["k"], call["streamed"], call["stream"]) == (
        37, 29, plan["k_pad"], int(plan["streamed"]), 7)
    assert call["inv_k"] == 1.0 / K and call["out"] == out.data_ptr()
    # the operands as bf16, zero past K
    for got, x in ((call["a"], a), (call["b"], b)):
        assert torch.equal(got[:, :K], x.bfloat16())
        assert not got[:, K:].any()
    # int8: four distinct scratch buffers, each 16-byte aligned
    assert len(set(call["scratch"])) == len(call["scratch"]) == (4 if use_int8 else 0)
    assert all(p % 16 == 0 for p in call["scratch"])
    assert out.shape == (37,) and out.dtype == torch.float32
    torch.testing.assert_close(out, joint_xlogy_rowsums_reference(a, b, K, use_int8),
                               rtol=1e-6, atol=0)


def test_call_raises_when_the_library_refuses():
    a = torch.rand(5, 100)
    with pytest.raises(RuntimeError, match="xlogy_rowsum kernel launch failed: stub "
                                           "refusal"):
        ej._call(_StubLibrary(err=1), a, a, 100, False, None, stream=0)
    lib = _StubLibrary()
    with pytest.raises(ValueError, match="resident"):
        ej._call(lib, a[:, :60].repeat(1, 3), a, 180, False, False, stream=0)
    assert lib.calls == []  # refused before the library


def test_kernel_resources_reads_the_library(monkeypatch):
    seen = []

    class Lib:
        def bvt_xlogy_rowsum_resources(self, int8, streamed, k, out):
            seen.append((int8, streamed, k))
            out[0], out[1], out[2], out[3], out[4], out[5] = 66624, 1, 96, 0, 232448, 640
            return 0

    monkeypatch.setattr(ej, "_library", Lib)
    r = kernel_resources(False, 100, device=-1)
    assert r == {"body": "wgmma", "streamed": False, "k_pad": 112, "smem_bytes": 66624,
                 "smem_limit": 232448, "blocks_per_sm": 1, "threads": 640, "registers": 96,
                 "local_bytes": 0}
    assert kernel_resources(True, 400, device=-1)["streamed"]
    assert seen == [(0, 0, 112), (1, 1, 416)]


def test_compare_builds_epig_has_no_cpu_mode(tmp_path, capsys):
    # --epig builds two trees' xlogy_rowsum.cu and times them on the card
    # only: without a CUDA device it raises before it builds anything
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--a", str(tmp_path), "--b", str(tmp_path), "--epig"]
    assert compare_builds.parse_args(argv).epig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.main(argv)
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        compare_builds.parse_args(argv + ["--int8"])


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
    (41, 23, 13, 200), (41, 23, 13, 112), (41, 23, 13, 128), (41, 23, 13, 129),
    (41, 23, 13, 256), (41, 23, 13, 257),
])
def test_kernel_matches_plain_on_card(cuda, use_int8, n_p, n_t, c, k):
    """M and N are no multiple of the 256-row block or the 64-target
    tile; K = 9 and 100 pad (100: 112 bf16 in two TMA boxes, the second
    part zero-filled; 128 int8 in one); 112 and 128 fill whole boxes; the
    resident limit is 128 bf16 / 256 int8 and 129 / 257 just past it
    stream; K = 200 streams in bf16 and stays resident in int8. The two
    differ in fp32 summation order and in the log (lg2.approx): 1e-4 of
    the largest row sum."""
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
@pytest.mark.parametrize("use_int8", [False, True])
@pytest.mark.parametrize("n_p,n_t,c,k", [(41, 23, 13, 400), (37, 29, 7, 1000)])
def test_streamed_kernel_matches_plain_on_card(cuda, use_int8, n_p, n_t, c, k):
    """K past what the resident block holds (128 bf16 / 256 int8): the
    streamed instantiation, 1e-4 of each row sum. K = 1000: bf16 rows of
    2016 bytes end in a partial 128-byte chunk (3 k-steps), int8 rows of
    1024 in whole ones, converted by I2F (|s32| may pass 2^22)."""
    a, b = _card_probs(cuda, n_p, k, c, 7), _card_probs(cuda, n_t, k, c, 8)
    before = joint_xlogy_rowsums.launches, joint_xlogy_rowsums.launches_int8
    out = joint_xlogy_rowsums(a, b, k, use_int8=use_int8)
    torch.cuda.synchronize()
    after = joint_xlogy_rowsums.launches, joint_xlogy_rowsums.launches_int8
    assert after == (before[0] + (not use_int8), before[1] + use_int8)
    ref = joint_xlogy_rowsums_reference(a, b, k, use_int8=use_int8)
    assert bool(((out - ref).abs() <= 1e-4 * ref.abs()).all())


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


def _card_rows(cuda, rows, k, seed):
    """[rows, k] of uniform [0, 1) values: every s = a . b / k lies in
    [0, 1), so every term s log s <= 0 and no row sum cancels."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.rand(rows, k, generator=gen, device=cuda)


def _assert_rowsums(out, ref):
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert bool(((out - ref).abs() <= ROWSUM_RTOL * ref.abs()).all()), \
        float(((out - ref).abs() / ref.abs()).max())


EDGE_ROWS = (1, 63, 64, 65, 255, 256, 257)


@pytest.mark.cuda
@pytest.mark.parametrize("use_int8", [False, True])
@pytest.mark.parametrize("M,N", [(m, 300) for m in EDGE_ROWS + (3001,)]
                         + [(300, n) for n in EDGE_ROWS + (5003,)])
def test_kernel_edges_match_plain_on_card(cuda, use_int8, M, N):
    """M at the edges of a warp's 16 pool rows, a consumer's 128 and a
    block's 256, N at those of a 128-target B tile (N < 128: less than
    one tile), and ragged large ones; K = 100, the resident
    instantiation: 1e-4 of each row sum."""
    a, b = _card_rows(cuda, M, 100, M), _card_rows(cuda, N, 100, N + 1)
    out = joint_xlogy_rowsums(a, b, 100, use_int8=use_int8)
    torch.cuda.synchronize()
    _assert_rowsums(out, joint_xlogy_rowsums_reference(a, b, 100, use_int8=use_int8))


@pytest.mark.cuda
def test_int8_conversion_at_its_largest_product(cuda):
    """int8 at K = 256, the resident limit, every value its row's absmax:
    every q = 127 and every s32 = 256 * 127^2 = 4,129,024, the largest a
    resident block converts to fp32 (exactly: < 2^24). A = 0.5 and B = 1.0
    put s at 0.5, far from a term of 0: 1e-4 of each row sum. All 1.0 puts
    s at 1 within a few ulp, so each term is 0 up to lg2.approx's absolute
    error (2^-22 near 1): within N 2^-21 of plain."""
    N = 200
    for a_val in (0.5, 1.0):
        a = torch.full((300, 256), a_val, device=cuda)
        b = torch.ones(N, 256, device=cuda)
        out = joint_xlogy_rowsums(a, b, 256, use_int8=True)
        torch.cuda.synchronize()
        ref = joint_xlogy_rowsums_reference(a, b, 256, use_int8=True)
        if a_val == 0.5:
            _assert_rowsums(out, ref)
        else:
            assert float((out - ref).abs().max()) <= N * 2.0 ** -21


@pytest.mark.cuda
@pytest.mark.parametrize("use_int8", [False, True])
def test_kernel_takes_zero_rows(cuda, use_int8):
    b = _card_rows(cuda, 50, 100, 5)
    before = joint_xlogy_rowsums.launches + joint_xlogy_rowsums.launches_int8
    out = joint_xlogy_rowsums(b[:0], b, 100, use_int8=use_int8)
    assert out.shape == (0,)
    # no targets: every row sums nothing
    out = joint_xlogy_rowsums(b, b[:0], 100, use_int8=use_int8)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros(50, device=cuda))
    assert joint_xlogy_rowsums.launches + joint_xlogy_rowsums.launches_int8 == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("use_int8", [False, True])
@pytest.mark.parametrize("K", [100, 400])
def test_kernel_ten_calls_in_a_row_agree(cuda, use_int8, K):
    """The ring's barriers start afresh at every launch and each row sum is
    written once: ten calls give the same bits."""
    a, b = _card_rows(cuda, 1000, K, 6), _card_rows(cuda, 700, K, 7)
    outs = [joint_xlogy_rowsums(a, b, K, use_int8=use_int8) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _assert_rowsums(outs[0], joint_xlogy_rowsums_reference(a, b, K, use_int8=use_int8))


@pytest.mark.cuda
@pytest.mark.parametrize("use_int8,K", [(False, 9), (False, 100), (False, 128), (False, 400),
                                        (True, 100), (True, 256), (True, 400)])
def test_kernel_resources(cuda, use_int8, K):
    """One block an SM (resident: 640 threads, no register split;
    streamed: 384, the registers at launch its setmaxnreg split needs), no
    local memory (no spill), shared memory under the opt-in limit."""
    r = kernel_resources(use_int8, K)
    streamed = ej._plan(1, 1, K, use_int8)["streamed"]
    assert r["body"] == "wgmma" and r["streamed"] == streamed
    assert r["blocks_per_sm"] == 1 and r["local_bytes"] == 0
    assert 0 < r["smem_bytes"] <= r["smem_limit"]
    assert r["threads"] == (384 if streamed else 640)
    assert r["registers"] * r["threads"] <= 65536
    if streamed:
        assert r["registers"] * 384 >= 128 * 40 + 256 * 232
