"""Port of the fused attention (`bayesvlm_tpu_torch.models.attention`)
against the JAX package's Pallas kernels (one-block, split-key and
packed-pair schedules), run in interpret mode on the CPU as
tests/test_pallas_attention.py runs them; plus the CUDA kernel's three
schedules against the plain version on the card (marked `cuda`, skipped
without a GPU): the tensor-core body (bf16, all three schedules,
csrc/attention_mma.cuh; the packed pair equal to one-block bit for bit)
and the CUDA-core body (fp32).

JAX is imported inside the parity tests, so that the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.models.attention import (
    ONE_BLOCK,
    PACKED_PAIR,
    SPLIT_KEY,
    fused_attention,
    fused_attention_reference,
    kernel_resources,
    schedule_for,
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


@pytest.mark.parametrize("T", [50, 257, 400])
def test_packed_heads_matches_jax_kernel_bf16(T):
    # the JAX packed-pair kernel in bf16 against the port's: the same
    # rounding points (p and the output to bf16), so an fp32 sum taken in
    # another order moves a value by one bf16 ulp at most, the tolerance of
    # test_matches_jax_kernel_bf16. T=400 is past what the CUDA-core body's
    # two score tiles held; the tensor-core body takes any T
    import jax.numpy as jnp

    H = 2
    q, k, v = _qkv(1, T, H * 16, seed=T + 7)
    q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in (q, k, v))
    ref = _jax_fused_attention(q, k, v, H, jnp.bfloat16, packed_heads=True)
    out = fused_attention(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)), H,
                          packed_heads=True).float()
    np.testing.assert_allclose(out.numpy(), ref, rtol=2**-7, atol=2**-7)


def test_packed_heads_rejects_an_odd_head_count():
    q = torch.zeros(1, 5, 48)
    with pytest.raises(ValueError, match="even head count"):
        fused_attention(q, q, q, 3, packed_heads=True)
    with pytest.raises(ValueError, match="even head count"):
        _jax_fused_attention(*(np.zeros((1, 5, 48), np.float32),) * 3, 3,
                             np.float32, packed_heads=True)


@pytest.mark.parametrize("T,split_key,packed_heads,want", [
    (257, True, False, SPLIT_KEY), (129, True, False, SPLIT_KEY),
    (256, True, False, ONE_BLOCK),   # no remainder past 128 floor(T/128)
    (50, True, False, ONE_BLOCK),    # no 128-key main block
    (257, False, False, ONE_BLOCK), (257, True, True, PACKED_PAIR),
])
def test_schedule_for_splits_only_with_a_main_block_and_a_remainder(
        T, split_key, packed_heads, want):
    # the JAX package's rule (attention_pallas.fused_attention), which
    # chip_smoke.py also reads to name the body a launch takes
    assert schedule_for(T, split_key, packed_heads) == want


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
    (256, 16, 64, 1.0),  # SigLIP-L/16: no class token, no row past the 128-key tiles
    # T around the 64-key tiles and 16-key groups of the tensor-core body,
    # and ViT-L/14 at 336 px (577)
    *[(T, 4, Dh, spread) for T in (1, 17, 50, 63, 64, 65, 128, 256, 257, 577)
      for Dh in (16, 64, 80) for spread in (1.0, 8.0)],
])
def test_kernel_matches_plain_on_card(cuda, dtype, T, H, Dh, spread):
    gen = torch.Generator(device=cuda).manual_seed(T)
    q, k, v = ((torch.randn(4, T, H * Dh, generator=gen, device=cuda) * s)
               .to(dtype) for s in (spread, spread, 1.0))
    # bf16 takes the tensor-core body, fp32 the CUDA-core one
    body = "mma" if dtype == torch.bfloat16 else "simt"
    assert kernel_resources(T, Dh, dtype)["body"] == body
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
    # one or two masked remainder tiles (r = 1, 72, 127, 1) at every head dim
    *[("split_key", T, 4, Dh) for T in (129, 200, 255, 257) for Dh in (16, 64, 80)],
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
    # the fp32 packed pair's two score tiles do not fit at T = 400 (bf16
    # takes the tensor-core body, which keeps no score tile)
    pair = torch.zeros(1, 400, 128, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(pair, pair, pair, 2, packed_heads=True)
    half = torch.zeros(1, 17, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention(half, half, half, 1)
    x = torch.zeros(1, 64, 17, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(x, x, x, 1)


# -- the tensor-core body (bf16: one-block, split-key, packed pair) -----------


def _card_qkv(device, B, T, H, Dh, spread=1.0, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(B, T, H * Dh, generator=gen, device=device) * s)
            .to(torch.bfloat16) for s in (spread, spread, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,schedule", [(50, {}), (257, {}), (200, {"split_key": True}),
                                        (257, {"split_key": True}),
                                        (50, {"packed_heads": True}),
                                        (257, {"packed_heads": True})])
def test_tensor_core_body_reads_nothing_past_the_last_row(cuda, T, schedule):
    # q, k, v at the front of buffers whose tails are NaN: a key row read
    # past T (or a V row not zero-filled) gives p = 0 times NaN = NaN
    B, H, Dh = 2, 4, 64
    n = B * T * H * Dh
    views = []
    for x in _card_qkv(cuda, B, T, H, Dh, seed=T):
        buf = torch.full((n + 128 * H * Dh,), float("nan"), device=cuda,
                         dtype=torch.bfloat16)
        views.append(buf[:n].view(B, T, H * Dh))
        views[-1].copy_(x)
    out = fused_attention(*views, H, **schedule)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out.float()).all())
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(),
                               fused_attention_reference(*views, H).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_tensor_core_body_takes_what_the_score_tile_could_not(cuda):
    # T=1024: the CUDA-core body's scores need 312,832 B of shared memory
    # (refused, as fp32 still is); the tensor-core body a fixed 36,864 B
    q, k, v = _card_qkv(cuda, 1, 1024, 2, 64, seed=1)
    assert kernel_resources(1024, 64, torch.bfloat16)["smem_bytes"] == 36864
    out = fused_attention(q, k, v, 2)
    torch.cuda.synchronize()
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(),
                               fused_attention_reference(q, k, v, 2).float(),
                               rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention(q.float(), k.float(), v.float(), 2)


@pytest.mark.cuda
def test_tensor_core_body_refuses_unaligned_operands(cuda):
    buf = torch.zeros(17 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    x = buf[1:].view(1, 17, 64)  # contiguous, 2 bytes past an aligned start
    with pytest.raises(ValueError, match="aligned"):
        fused_attention(x, x, x, 1)
    # the CUDA-core body reads elements: fp32 at a 4-byte offset runs
    f = torch.randn(17 * 64 + 1, device=cuda)[1:].view(1, 17, 64)
    torch.testing.assert_close(fused_attention(f, f, f, 1),
                               fused_attention_reference(f, f, f, 1),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_resources_name_the_body_on_card(cuda):
    # two stages of two 64-row tiles, rows of 2 Dh + 16 bytes, whatever T
    for T, Dh, smem in ((257, 64, 36864), (4096, 64, 36864), (50, 16, 12288),
                        (257, 80, 45056)):
        for schedule in (ONE_BLOCK, SPLIT_KEY):
            r = kernel_resources(T, Dh, torch.bfloat16, schedule)
            assert (r["body"], r["smem_bytes"]) == ("mma", smem)
            assert r["registers"] > 0 and r["blocks_per_sm"] >= 1
    # one-block is built for 4 blocks an SM: 128 registers a thread
    r = kernel_resources(257, 64, torch.bfloat16)
    assert (r["registers"], r["blocks_per_sm"]) == (128, 4)
    # the packed pair: 8 warps, both heads' rows of 4 Dh + 16 bytes in one
    # ring, built for 2 blocks an SM (at most 128 registers, 16 warps an SM)
    for T, Dh, smem in ((257, 64, 69632), (1024, 64, 69632), (50, 16, 20480),
                        (257, 80, 86016)):
        r = kernel_resources(T, Dh, torch.bfloat16, PACKED_PAIR)
        assert (r["body"], r["smem_bytes"]) == ("mma", smem)
    r = kernel_resources(257, 64, torch.bfloat16, PACKED_PAIR)
    assert r["registers"] <= 128 and r["blocks_per_sm"] == 2
    # fp32 keeps the CUDA-core body (its T scores: 104,208 B at T=257,
    # Dh=64; the packed pair's two tiles 207,904 B)
    r = kernel_resources(257, 64, torch.float32)
    assert (r["body"], r["smem_bytes"]) == ("simt", 104208)
    assert r["blocks_per_sm"] >= 1
    r = kernel_resources(257, 64, torch.float32, PACKED_PAIR)
    assert (r["body"], r["smem_bytes"]) == ("simt", 207904)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [17, 50, 257, 1024])
@pytest.mark.parametrize("Dh", [16, 64, 80])
@pytest.mark.parametrize("H", [2, 12, 16])
def test_packed_pair_equals_one_block_on_card(cuda, T, Dh, H):
    # each warp of the pair does what a one-block warp does for its head
    # and 16 rows: the same bits, the query tile's rows past T included
    # (none of these T is a multiple of 64 but 1024)
    q, k, v = _card_qkv(cuda, 2, T, H, Dh, spread=4.0, seed=T + Dh + H)
    before = fused_attention.launches_packed
    out = fused_attention(q, k, v, H, packed_heads=True)
    torch.cuda.synchronize()
    assert fused_attention.launches_packed == before + 1
    assert torch.equal(out, fused_attention(q, k, v, H))
