"""Port of the fused attention (`bayesvlm_tpu_torch.models.attention`)
against the JAX package's Pallas kernels (one-block, split-key and
packed-pair schedules), run in interpret mode on the CPU as
tests/test_pallas_attention.py runs them; plus the CUDA kernel's three
schedules against the plain version on the card (marked `cuda`, skipped
without a GPU).

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


def _jax_fused_attention(q, k, v, H, dtype, **schedule):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.attention_pallas import fused_attention as jfa

    out = jfa(*(jnp.asarray(x, dtype) for x in (q, k, v)), H, **schedule)
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


@pytest.mark.parametrize("T", [129, 133, 200, 255, 257])
def test_split_key_matches_jax_kernel(T):
    # the JAX split-key kernel (t_main = 128 floor(T/128) keys, then a
    # remainder of r keys; r = 1 at T = 129 and 257, the path the TPU
    # handled apart) computes the port's one function: fp32 summation
    # order only -> 1e-5
    H = 2
    q, k, v = _qkv(2, T, H * 16, seed=T)
    ref = _jax_fused_attention(q, k, v, H, np.float32, split_key=True)
    out = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), H,
                          split_key=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [29, 64, 131])
def test_packed_heads_matches_jax_kernel(T):
    # the JAX packed-pair kernel (two heads per program, block-diagonal
    # K'/V', a softmax segmented at column T): the same function, 1e-5
    H = 4
    q, k, v = _qkv(2, T, H * 16, seed=T + 1)
    ref = _jax_fused_attention(q, k, v, H, np.float32, packed_heads=True)
    out = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), H,
                          packed_heads=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_packed_heads_rejects_an_odd_head_count():
    q = torch.zeros(1, 5, 48)
    with pytest.raises(ValueError, match="even head count"):
        fused_attention(q, q, q, 3, packed_heads=True)
    with pytest.raises(ValueError, match="even head count"):
        _jax_fused_attention(*(np.zeros((1, 5, 48), np.float32),) * 3, 3,
                             np.float32, packed_heads=True)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 17, 32, seed=0))
    counts = ("launches", "launches_split", "launches_packed")
    before = [getattr(fused_attention, c) for c in counts]
    for schedule in ({}, {"split_key": True}, {"packed_heads": True}):
        out = fused_attention(q, k, v, 2, **schedule)
        assert torch.equal(out, fused_attention_reference(q, k, v, 2))
    assert [getattr(fused_attention, c) for c in counts] == before


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule,T,H,Dh", [
    ("split_key", 129, 2, 16), ("split_key", 200, 4, 64),
    ("split_key", 255, 2, 80), ("split_key", 257, 16, 64),
    ("packed_heads", 29, 2, 16), ("packed_heads", 50, 12, 64),
    ("packed_heads", 131, 4, 80), ("packed_heads", 257, 16, 64),
])
def test_schedule_matches_plain_on_card(cuda, dtype, schedule, T, H, Dh):
    gen = torch.Generator(device=cuda).manual_seed(T + H)
    q, k, v = (torch.randn(3, T, H * Dh, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    count = {"split_key": "launches_split", "packed_heads": "launches_packed"}[schedule]
    before = getattr(fused_attention, count), fused_attention.launches
    out = fused_attention(q, k, v, H, **{schedule: True})
    torch.cuda.synchronize()
    assert (getattr(fused_attention, count), fused_attention.launches) == (
        before[0] + 1, before[1])
    ref = fused_attention_reference(q, k, v, H)
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [50, 128, 256])
def test_split_key_without_remainder_takes_one_block(cuda, T):
    # t_main = 0 (T < 128) or r = 0: the one-block schedule, as in JAX
    q = torch.randn(2, T, 64, device=cuda)
    before = fused_attention.launches, fused_attention.launches_split
    out = fused_attention(q, q, q, 1, split_key=True)
    torch.cuda.synchronize()
    assert (fused_attention.launches, fused_attention.launches_split) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(out, fused_attention_reference(q, q, q, 1),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    big = torch.zeros(1, 4096, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(big, big, big, 1)
    # the packed pair's two score tiles do not fit at T = 400
    pair = torch.zeros(1, 400, 128, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(pair, pair, pair, 2, packed_heads=True)
    half = torch.zeros(1, 17, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention(half, half, half, 1)
    x = torch.zeros(1, 64, 17, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(x, x, x, 1)
