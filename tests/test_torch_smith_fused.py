"""The port's fused probit head (`bayesvlm_tpu_torch.probforward.kernels`)
against the JAX package's: the plain version against JAX's unfused
reference and its Pallas kernel (interpret mode), at the JAX test's
shapes and tolerance (tests/test_pallas_smith.py: rtol 1e-4 / atol 1e-5,
row sums 1e-5); against the port's own head + probit chain on tiny-clip
and tiny-siglip features; and the CUDA kernel against the plain version
on the card (marked `cuda`, skipped without a GPU). JAX is imported
inside the parity test, so that the `cuda` tests also run where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_smith_fused.py
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.bayes.kfac import compute_covariances
from bayesvlm_tpu_torch.io.artifacts import load_hessians, save_synthetic_hessians
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.models.encoders import load_model
from bayesvlm_tpu_torch.probforward.kernels import (
    fused_probit_probs,
    smith_probit_probs_reference,
)
from bayesvlm_tpu_torch.probforward.smith import activation_diag_covariance

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


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,D", [(16, 10, 32), (130, 257, 64), (37, 13, 80),
                                   (5, 1, 16), (64, 100, 768), (33, 129, 1000)])
def test_kernel_matches_plain_on_card(cuda, B, C, D):
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(B, C, D, seed=4)]
    before = fused_probit_probs.launches
    got = fused_probit_probs(*ops, 2.0)
    torch.cuda.synchronize()
    assert fused_probit_probs.launches == before + 1
    ref = smith_probit_probs_reference(*ops, 2.0)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).cpu().numpy(), 1.0, rtol=ROW_TOL)


@pytest.mark.cuda
def test_kernel_refuses_classes_past_its_shared_memory(cuda):
    from bayesvlm_tpu_torch.probforward.kernels import max_classes

    limit = max_classes()
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(3, limit + 1, 8)]
    with pytest.raises(ValueError, match="shared memory"):
        fused_probit_probs(*ops, 1.0)
    ops = [torch.from_numpy(x).to(cuda) for x in _operands(3, limit, 8)]
    assert fused_probit_probs(*ops, 1.0).shape == (3, limit)
