"""Port of the fused attention (`bayesvlm_tpu_torch.models.attention`)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_pallas_attention.py runs it; plus the CUDA kernel against
its plain version on the card (marked `cuda`, skipped without a GPU).

JAX is imported inside the parity tests, so that the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.models.attention import (
    fused_attention,
    fused_attention_reference,
)


def _qkv(B, T, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, D)).astype(np.float32) for _ in range(3)]


def _jax_fused_attention(q, k, v, H, dtype):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.attention_pallas import fused_attention as jfa

    out = jfa(*(jnp.asarray(x, dtype) for x in (q, k, v)), H)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("T", [17, 50])
@pytest.mark.parametrize("H", [2, 4])
def test_matches_jax_kernel_fp32(T, H):
    # fp32 end to end: only the summation order differs -> 1e-5, the
    # tolerance of the JAX kernel's own parity test
    q, k, v = _qkv(2, T, H * 16, seed=T + H)
    ref = _jax_fused_attention(q, k, v, H, np.float32)
    out = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), H)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_matches_jax_kernel_bf16():
    # both round p and the output to bf16 at the same points; an fp32 sum
    # taken in another order can still push a value across a rounding
    # boundary, i.e. one bf16 ulp (2^-8 relative) of p or of the output
    import jax.numpy as jnp

    T, H = 50, 4
    q, k, v = _qkv(2, T, H * 16, seed=3)
    q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in (q, k, v))
    ref = _jax_fused_attention(q, k, v, H, jnp.bfloat16)
    out = fused_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                          H).float()
    np.testing.assert_allclose(out.numpy(), ref, rtol=2**-7, atol=2**-7)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 17, 32, seed=0))
    before = fused_attention.launches
    out = fused_attention(q, k, v, 2)
    assert torch.equal(out, fused_attention_reference(q, k, v, 2))
    assert fused_attention.launches == before


@pytest.mark.parametrize("shapes", [
    ((2, 17, 32), (2, 16, 32), (2, 17, 32)),   # k shorter than q
    ((2, 17, 32), (2, 17, 32), (1, 17, 32)),   # batch mismatch
    ((17, 32), (17, 32), (17, 32)),            # not [B, T, D]
])
def test_rejects_mismatched_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fused_attention(q, k, v, 2)


def test_rejects_head_count_that_does_not_divide():
    q = torch.zeros(1, 5, 30)
    with pytest.raises(ValueError, match="multiple"):
        fused_attention(q, q, q, 4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


# bf16: p and the output are rounded to bf16 by both; a different fp32
# summation order moves a value across a rounding boundary by one ulp
# (2^-8 relative), and a p flip and an output flip can stack
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-6}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,Dh,spread", [
    (17, 2, 16, 1.0), (50, 12, 64, 1.0), (257, 16, 64, 1.0), (257, 16, 80, 1.0),
    (257, 16, 64, 8.0),  # scores of a few hundred: the softmax must subtract the max
])
def test_kernel_matches_plain_on_card(cuda, dtype, T, H, Dh, spread):
    gen = torch.Generator(device=cuda).manual_seed(T)
    q, k, v = ((torch.randn(4, T, H * Dh, generator=gen, device=cuda) * s)
               .to(dtype) for s in (spread, spread, 1.0))
    before = fused_attention.launches
    out = fused_attention(q, k, v, H)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = fused_attention_reference(q, k, v, H)
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    big = torch.zeros(1, 4096, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(big, big, big, 1)
    half = torch.zeros(1, 17, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention(half, half, half, 1)
    x = torch.zeros(1, 64, 17, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(x, x, x, 1)
