"""The port's fused probit head (`bayesvlm_tpu_torch.probforward.kernels`)
against the JAX package's: the plain version against JAX's unfused
reference and its Pallas kernel (interpret mode), at the JAX test's
shapes and tolerance (tests/test_pallas_smith.py: rtol 1e-4 / atol 1e-5,
row sums 1e-5); against the port's own head + probit chain on tiny-clip
and tiny-siglip features; the kernel's arithmetic (3xTF32 products, the
row scales after them) emulated on the CPU against JAX's reference, and
one TF32 pass shown to miss the tolerance; and the CUDA kernel against
the plain version on the card (marked `cuda`, skipped without a GPU).
JAX is imported inside the parity tests, so that the `cuda` tests also
run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_smith_fused.py
"""

import math

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
from bayesvlm_tpu_torch.io.artifacts import load_hessians, save_synthetic_hessians
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.models.encoders import load_model
from bayesvlm_tpu_torch.probforward.kernels import (
    _tma_rows,
    fused_probit_probs,
    smith_probit_probs_reference,
)
from bayesvlm_tpu_torch.probforward.smith import _highest_fp32_matmul, activation_diag_covariance

RTOL, ATOL, ROW_TOL = 1e-4, 1e-5, 1e-5


def _operands(B, C, D, seed=0):
    """The JAX test's inputs (test_pallas_smith.py:15-21)."""
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(B, D)).astype(np.float32)
    src_cov = rng.uniform(0.01, 0.5, size=(B, D)).astype(np.float32)
    tgt = rng.normal(size=(C, D)).astype(np.float32)
    tgt_cov = rng.uniform(0.01, 0.5, size=(C, D)).astype(np.float32)
    return src, src_cov, tgt, tgt_cov


@pytest.mark.parametrize("jax_fn", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("B,C,D", [(16, 10, 32), (130, 257, 64)])
def test_plain_matches_jax(B, C, D, jax_fn):
    import jax.numpy as jnp

    from bayesvlm_tpu.probforward.kernels.smith_pallas import (
        fused_probit_probs as jax_fused_probit_probs,
    )
    from bayesvlm_tpu.probforward.kernels.smith_pallas import (
        smith_probit_probs_reference as jax_smith_probit_probs_reference,
    )

    ops = _operands(B, C, D)
    if jax_fn == "reference":
        expected = jax_smith_probit_probs_reference(
            *(jnp.asarray(x) for x in ops), jnp.float32(2.0))
    else:
        expected = jax_fused_probit_probs(*(jnp.asarray(x) for x in ops),
                                          jnp.float32(2.0), block_b=64,
                                          interpret=True)
    got = smith_probit_probs_reference(*(torch.from_numpy(x) for x in ops), 2.0)
    assert got.shape == (B, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=ROW_TOL)


def test_cpu_tensors_take_the_plain_version():
    ops = [torch.from_numpy(x) for x in _operands(9, 5, 12, seed=1)]
    torch.testing.assert_close(fused_probit_probs(*ops, 1.5),
                               smith_probit_probs_reference(*ops, 1.5),
                               rtol=0, atol=0)


def test_wrapper_refuses_what_it_cannot_take():
    ops = [torch.from_numpy(x) for x in _operands(4, 3, 8)]
    with pytest.raises(ValueError, match="shapes"):
        fused_probit_probs(ops[0], ops[1][:, :4], ops[2], ops[3], 1.0)
    with pytest.raises(ValueError, match="C >= 1"):
        fused_probit_probs(ops[0], ops[1], ops[2][:0], ops[3][:0], 1.0)
    with pytest.raises(ValueError, match="no smith_head kernel"):
        fused_probit_probs(*(t.to("meta") for t in ops), 1.0)


@pytest.fixture(scope="module", params=["tiny-clip", "tiny-siglip"])
def head_features(request, tmp_path_factory):
    """A tiny model's image and label features, its covariances from the
    synthetic factors and its head, on the CPU in fp32."""
    model = request.param
    config = CONFIGS_BY_NAME[model]
    hdir = save_synthetic_hessians(tmp_path_factory.mktemp(model), config, seed=0)
    image, text, head = load_model(model, dtype=torch.float32, device="cpu")
    A_img, B_img = load_hessians(hdir, "img")
    A_txt, B_txt = load_hessians(hdir, "txt")
    info = {"n_img": 10, "n_txt": 10, "lambda_img": 30.0, "lambda_txt": 25.0}
    head = head.set_covariances(*compute_covariances(A_img, B_img, A_txt, B_txt, info))
    rng = np.random.default_rng(3)
    pixels = rng.normal(size=(11, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(0, config.text.vocab_size, size=(7, config.text.max_length))
    return head, image(pixels), text(ids)


def test_plain_matches_the_heads_probit_chain(head_features):
    """The fused head's function is the Smith forward's mean and variance
    through the probit softmax (scripts/zeroshot.py:145-158), with sigma
    from the activations (the ones column on SigLIP's biased
    projections)."""
    head, img, txt = head_features
    chain = head(img, txt).probit_softmax()
    sigma_s = activation_diag_covariance(img.activations, head.source_covariance,
                                         head.source_projection_has_bias)
    sigma_t = activation_diag_covariance(txt.activations, head.target_covariance,
                                         head.target_projection_has_bias)
    got = fused_probit_probs(img.embeds, sigma_s, txt.embeds, sigma_t,
                             head.logit_scale)
    np.testing.assert_allclose(got.numpy(), chain.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=ROW_TOL)


# -- the kernel's arithmetic, emulated on the CPU -------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half of the 13 dropped bits to the
    magnitude's bit pattern, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a . b^T as the kernel's wgmma products: with 3 passes a = a_hi +
    a_lo (each TF32) and hi.hi + hi.lo + lo.hi summed in fp32; with 1 pass
    the TF32-rounded operands alone."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    with _highest_fp32_matmul():
        if passes == 1:
            return a_hi @ b_hi.T
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        return a_hi @ b_hi.T + a_hi @ b_lo.T + a_lo @ b_hi.T


def _kernel_emulation(se, sc, te, tc, logit_scale, passes=3) -> torch.Tensor:
    """csrc/smith_head.cu's function on fp32 tensors: the three products of
    the unscaled operands in TF32 passes, then the row scales 1 / sqrt(E)
    and 1 / E of both sides, e^s and e^{2s}, the probit and the softmax."""
    n_s, t2 = se * se + sc, te * te
    E_s, E_t = n_s.sum(-1, keepdim=True), (t2 + tc).sum(-1)
    mean = _tf32_product(se, te, passes) / (torch.sqrt(E_s) * torch.sqrt(E_t))
    var = (_tf32_product(n_s, tc, passes) + _tf32_product(sc, t2, passes)) / (E_s * E_t)
    scale = torch.exp(torch.tensor(logit_scale, dtype=torch.float32))
    kappa = mean * scale / torch.sqrt(1.0 + math.pi / 8.0 * var * scale**2)
    return torch.softmax(kappa, dim=-1)


def _worst(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest |got - ref| / (atol + rtol |ref|): <= 1 passes."""
    return float((np.abs(got - ref) / (ATOL + RTOL * np.abs(ref))).max())


def _jax_reference(ops, logit_scale) -> np.ndarray:
    import jax.numpy as jnp

    from bayesvlm_tpu.probforward.kernels.smith_pallas import (
        smith_probit_probs_reference as jax_smith_probit_probs_reference,
    )

    return np.asarray(jax_smith_probit_probs_reference(
        *(jnp.asarray(x) for x in ops), jnp.float32(logit_scale)))


def test_tf32_rounding_keeps_ten_mantissa_bits_to_nearest_away():
    one = 1.0 + 2.0**-10
    x = torch.tensor([1.0, one, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 2.0**-11),
                      1.0 + 3 * 2.0**-11], dtype=torch.float32)
    want = torch.tensor([1.0, one, one, 1.0, -one, 1.0 + 2 * 2.0**-10])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    hi = _tf32(r)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    assert float(((r - hi).abs() / r.abs()).max()) <= 2.0**-11


@pytest.mark.parametrize("logit_scale", [2.0, 4.7651])
@pytest.mark.parametrize("B,C,D", [(16, 10, 32), (130, 257, 64), (256, 100, 1024)])
def test_kernel_arithmetic_matches_jax(B, C, D, logit_scale):
    """Three TF32 passes with the row scales after the products hold the
    JAX tolerance at the card tests' scale and at SigLIP's."""
    ops = _operands(B, C, D, seed=5)
    got = _kernel_emulation(*(torch.from_numpy(x) for x in ops), logit_scale).numpy()
    expected = _jax_reference(ops, logit_scale)
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=ROW_TOL)


def test_one_tf32_pass_misses_the_tolerance():
    """A kernel that dropped the lo terms would fail the tests at SigLIP's
    logit scale: one TF32 pass strays past the JAX tolerance there, where
    three passes keep well inside it."""
    ops = _operands(256, 100, 1024, seed=5)
    expected = _jax_reference(ops, 4.7651)
    tensors = [torch.from_numpy(x) for x in ops]
    assert _worst(_kernel_emulation(*tensors, 4.7651, passes=1).numpy(), expected) > 1.0
    assert _worst(_kernel_emulation(*tensors, 4.7651, passes=3).numpy(), expected) < 0.1


def test_image_side_is_padded_for_the_tma_only_where_it_must_be():
    se = torch.arange(2 * 13, dtype=torch.float32).reshape(2, 13)
    sc = se + 100.0
    pse, psc, lds = _tma_rows(se, sc)
    assert lds == 16 and pse.shape == psc.shape == (2, 16)
    assert torch.equal(pse[:, :13], se) and torch.equal(psc[:, :13], sc)
    assert not pse[:, 13:].any() and not psc[:, 13:].any()
    se, sc = torch.zeros(3, 8), torch.ones(3, 8)
    assert _tma_rows(se, sc)[2] == 8 and _tma_rows(se, sc)[0] is se
    base = torch.zeros(3 * 8 + 1)
    view = base[1:].view(3, 8)  # 4 bytes past a 16-byte boundary
    pse, psc, lds = _tma_rows(view, sc)
    assert lds == 8 and pse is not view and torch.equal(pse, view)


def test_kernel_resources_and_the_class_limit_through_a_stub_library(monkeypatch):
    from bayesvlm_tpu_torch.probforward import kernels as pk

    class Lib:
        limit = 2771

        @staticmethod
        def bvt_smith_head_resources(B, C, D, out):
            for i, v in enumerate((104, 1, 3, 4, 203504, 251, 0, 39, 64)):
                out[i] = v
            return 0

        @classmethod
        def bvt_smith_head_max_classes(cls):
            return cls.limit

    monkeypatch.setattr(pk, "_library", Lib)
    assert pk.kernel_resources(2048, 100, 1024) == {
        "nt": 104, "tiles": 1, "cluster": 3, "stages": 4, "smem_bytes": 203504,
        "registers": 251, "local_bytes": 0, "max_active_clusters": 39, "k_stages": 64}
    assert pk.max_classes() == 2771
    Lib.limit = -100  # a cudaError_t from the device query
    with pytest.raises(RuntimeError, match="cudaError 100"):
        pk.max_classes()


def test_compare_builds_smith_has_no_cpu_mode(tmp_path, capsys):
    # --smith builds two trees' smith_head.cu and times them on the card
    # only: without a CUDA device it raises before it builds anything
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--a", str(tmp_path), "--b", str(tmp_path), "--smith"]
    assert compare_builds.parse_args(argv).smith
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.main(argv)
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        compare_builds.parse_args(argv + ["--packed"])


def test_compare_builds_smith_checks_the_shapes_chip_smoke_checks():
    # compare_builds --smith holds both trees at chip_smoke.py's shapes and
    # then at the zero-shot run's
    import importlib.util
    from pathlib import Path

    from bayesvlm_tpu_torch.probes import compare_builds

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_smith_shapes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert compare_builds.SMITH_SHAPES == smoke.SMITH_SHAPES
    assert list(compare_builds.SMITH_CASES.values())[-1] == (
        smoke.ZS_IMAGES, smoke.ZS_CLASSES, 1024)
    assert compare_builds.SMITH_LOGIT_SCALE == 4.7651


def test_smith_phases_instruments_the_kernel_and_has_no_cpu_mode():
    # the probe stamps the phases of csrc/smith_head.cu as it stands: every
    # text it edits is still there once; without a card it raises
    from bayesvlm_tpu_torch import kernels
    from bayesvlm_tpu_torch.probes import smith_phases

    source = (kernels.CSRC / "smith_head.cu").read_text()
    text = smith_phases.instrumented(source)
    assert text.count("bvt_now()") == 10 and "int bvt_smith_stamps(" in text
    with pytest.raises(ValueError, match="not found once"):
        smith_phases.instrumented(source.replace("const int g = lane / 4", "const int g=lane/4"))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smith_phases.main([])


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("logit_scale", [2.0, 4.7651])
@pytest.mark.parametrize("B,C,D", [(16, 10, 32), (130, 257, 64), (37, 13, 80),
                                   (5, 1, 16), (64, 100, 768), (33, 129, 1000),
                                   (2048, 100, 1024), (2048, 1000, 768), (7, 3, 13)])
def test_kernel_matches_plain_on_card(cuda, B, C, D, logit_scale):
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(B, C, D, seed=4)]
    before = fused_probit_probs.launches
    got = fused_probit_probs(*ops, logit_scale)
    torch.cuda.synchronize()
    assert fused_probit_probs.launches == before + 1
    ref = smith_probit_probs_reference(*ops, logit_scale)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).cpu().numpy(), 1.0, rtol=ROW_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,D", [(2048, 100, 1024), (2048, 1000, 768), (64, 100, 768)])
def test_kernel_gives_equal_bits_twice(cuda, B, C, D):
    # the cluster's partial sums are added in rank order, the softmax's in
    # a fixed order: no atomics
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(B, C, D, seed=6)]
    first = fused_probit_probs(*ops, 4.7651)
    assert torch.equal(first, fused_probit_probs(*ops, 4.7651))


@pytest.mark.cuda
def test_kernel_refuses_classes_past_its_shared_memory(cuda):
    from bayesvlm_tpu_torch.probforward.kernels import max_classes

    limit = max_classes()
    assert limit >= 1648  # every C the CUDA-core version took on an H100
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(3, limit + 1, 8)]
    with pytest.raises(ValueError, match="shared memory"):
        fused_probit_probs(*ops, 1.0)
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(3, limit, 8)]
    assert fused_probit_probs(*ops, 1.0).shape == (3, limit)


@pytest.mark.cuda
def test_kernel_resources_fit_the_card(cuda):
    from bayesvlm_tpu_torch.probforward.kernels import kernel_resources

    r = kernel_resources(2048, 100, 1024)
    assert r["nt"] == 104 and r["tiles"] == 1 and 1 <= r["cluster"] <= 8
    assert 2 <= r["stages"] <= 8 and r["max_active_clusters"] >= 1
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert r["smem_bytes"] <= limit and r["registers"] <= 255
