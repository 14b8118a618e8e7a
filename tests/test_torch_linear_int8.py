"""Port of the W8A8 int8 linear layer (`bayesvlm_tpu_torch.models.
linear_int8`) against the JAX package's, on the CPU: the JAX Pallas kernel
in interpret mode (as tests/test_linear_int8.py runs it) and its pure-jnp
emulation, with and without bias, ragged row counts, a leading shape
that flattens, and the fused QKV split; the attention projections of a
tiny tower; plus the CUDA kernel against its plain version on the card
(marked `cuda`, skipped without a GPU).

Tolerance: the JAX package's own flip tolerance (see
tests/test_torch_mlp_int8.py), max |d| <= 0.02 max|ref| and mean |d| <=
0.002 max|ref| (`FLIP_TOL_MAX`, `FLIP_TOL_MEAN` of `models/mlp_int8.py`).

    python -m pytest --noconftest -m cuda tests/test_torch_linear_int8.py
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.models.linear_int8 import (
    linear_int8,
    linear_int8_reference,
)
from bayesvlm_tpu_torch.models.mlp_int8 import FLIP_TOL_MAX, FLIP_TOL_MEAN


def assert_flip_close(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() + 1e-12
    d = np.abs(out - ref)
    assert d.max() <= FLIP_TOL_MAX * scale, (d.max(), scale)
    assert d.mean() <= FLIP_TOL_MEAN * scale, (d.mean(), scale)


def _case(m, k, n, seed, bias=True):
    """x [m, k], w [k, n] (the JAX layout), b [n] or None."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, size=(k, n)).astype(np.float32)
    b = rng.normal(0, 0.02, size=(n,)).astype(np.float32) if bias else None
    return x, w, b


def _port(x, w, b, dtype=torch.float32, **kw):
    return linear_int8(torch.from_numpy(x).to(dtype),
                       torch.from_numpy(w.T.copy()),
                       None if b is None else torch.from_numpy(b), **kw)


def _to_np(x):
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m", [64, 40, 33, 1])
def test_matches_jax_kernel_interpret(bias, m):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.linear_int8 import linear_int8 as jax_linear_int8

    x, w, b = _case(m, 64, 96, seed=m, bias=bias)
    jb = None if b is None else jnp.asarray(b)
    ref = jax_linear_int8(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jb,
                          block_m=32)
    out = _port(x, w, b, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (m, 96)
    assert_flip_close(out.float().numpy(), _to_np(ref))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m", [1, 33, 40])
def test_matches_jax_emulation(bias, m):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.linear_int8 import linear_int8_reference as jax_ref

    x, w, b = _case(m, 32, 48, seed=m + 100, bias=bias)
    ref = jax_ref(jnp.asarray(x), jnp.asarray(w),
                  None if b is None else jnp.asarray(b))
    assert_flip_close(_port(x, w, b).numpy(), _to_np(ref))


def test_leading_shape_flattens():
    import jax.numpy as jnp

    from bayesvlm_tpu.models.linear_int8 import linear_int8 as jax_linear_int8

    x, w, _ = _case(10, 32, 64, seed=1, bias=False)
    x = x.reshape(2, 5, 32)
    out = _port(x, w, None)
    assert out.shape == (2, 5, 64)
    assert_flip_close(out.numpy(), _to_np(jax_linear_int8(jnp.asarray(x),
                                                          jnp.asarray(w))))


def test_chunks_are_contiguous_splits():
    """The fused QKV form: three contiguous [..., N/3] tensors that are
    the plain output's thirds."""
    x, w, b = _case(6, 32, 96, seed=2)
    x = x.reshape(2, 3, 32)
    whole = _port(x, w, b)
    parts = _port(x, w, b, chunks=3)
    assert len(parts) == 3
    for i, p in enumerate(parts):
        assert p.shape == (2, 3, 32) and p.is_contiguous()
        assert torch.equal(p, whole[..., 32 * i:32 * (i + 1)])
    with pytest.raises(ValueError, match="chunks"):
        _port(x, w, b, chunks=5)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    x, w, b = _case(5, 32, 16, seed=3)
    before = linear_int8.launches
    tx, tw, tb = torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b)
    assert torch.equal(linear_int8(tx, tw, tb), linear_int8_reference(tx, tw, tb))
    assert linear_int8.launches == before


def test_attention_projections_match_jax():
    """MultiHeadAttention(use_int8_proj) on a tiny self-attention against
    the JAX module with the same weights: fused [3D, D] QKV product, the
    attention core, the int8 out-projection."""
    import jax
    import jax.numpy as jnp

    from bayesvlm_tpu.models.layers import MultiHeadAttention as JaxMHA
    from bayesvlm_tpu_torch.models.layers import MultiHeadAttention

    D, H, T = 32, 2, 17
    x = np.random.default_rng(4).normal(size=(2, T, D)).astype(np.float32)
    jmod = JaxMHA(hidden_size=D, num_heads=H, use_int8_proj=True)
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    mod = MultiHeadAttention(D, H, use_int8_proj=True)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin = getattr(mod, name)
            lin.weight.copy_(torch.from_numpy(np.array(params[name]["kernel"]).T))
            lin.bias.copy_(torch.from_numpy(np.array(params[name]["bias"])))
        out = mod(torch.from_numpy(x))
    assert_flip_close(out.numpy(), np.asarray(ref))
    # a mask keeps the float projections (the causal text path)
    mask = torch.zeros(T, T)
    with torch.no_grad():
        plain = MultiHeadAttention(D, H)
        plain.load_state_dict(mod.state_dict())
        torch.testing.assert_close(mod(torch.from_numpy(x), mask),
                                   plain(torch.from_numpy(x), mask))


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("M,K,N,chunks", [
    (1, 64, 96, 1), (33, 64, 96, 3), (40, 32, 48, 1),
    (4 * 257, 1024, 3072, 3), (4 * 257, 1024, 1024, 1), (300, 4096, 1024, 1),
])
def test_kernel_matches_plain_on_card(cuda, dtype, bias, M, K, N, chunks):
    gen = torch.Generator(device=cuda).manual_seed(M)
    x = torch.randn(M, K, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(N, K, generator=gen, device=cuda) * 0.05).to(dtype)
    b = torch.randn(N, generator=gen, device=cuda) * 0.02 if bias else None
    before = linear_int8.launches
    out = linear_int8(x, w, b, chunks=chunks)
    torch.cuda.synchronize()
    assert linear_int8.launches == before + 1
    out = torch.cat(out, dim=-1) if chunks > 1 else out
    assert out.dtype == dtype and out.shape == (M, N)
    ref = linear_int8_reference(x, w, b)
    assert_flip_close(out.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="multiple of 16"):
        linear_int8(torch.zeros(2, 24, device=cuda), torch.zeros(8, 24, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        linear_int8(torch.zeros(2, 32, device=cuda, dtype=torch.float16),
                    torch.zeros(8, 32, device=cuda))


# the wgmma body's dequantising epilogue (csrc/wgmma_gemm.cuh EpiDequant):
# N = 16 and 96 (mod 128: the last tile's boxes past N are skipped), chunks
# that are no multiple of the box's 32 fp32 / 64 bf16 columns (48, 40, 24:
# plain stores from the box) and that are (32 fp32, 64: one 3-D TMA map),
# K = 32 and 96 (less than one 128-byte stage, the TMA zero-fills) and
# 4096, M = 1, 333 (ragged) and 64 x 257 (the lane's rows)
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,chunks", [
    (1, 32, 144, 3), (333, 96, 120, 3), (333, 32, 72, 3), (333, 64, 192, 3),
    (333, 4096, 2064, 1), (64 * 257, 96, 2144, 1), (64 * 257, 1024, 3072, 3),
    (1, 4096, 96, 1), (333, 1024, 16, 1),
])
def test_epilogue_shapes_match_plain_on_card(cuda, dtype, M, K, N, chunks):
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(N, K, generator=gen, device=cuda) * K ** -0.5).to(dtype)
    b = torch.randn(N, generator=gen, device=cuda) * 0.02
    out = linear_int8(x, w, b, chunks=chunks)
    out = torch.cat(out, dim=-1) if chunks > 1 else out
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (M, N)
    ref = linear_int8_reference(x, w, b)
    assert_flip_close(out.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [2064, 2144], ids=["n16", "n96"])
def test_ten_calls_at_a_ragged_n_on_card(cuda, dtype, N):
    # the last column block of every tile row stores some of its boxes and
    # skips the rest; ten calls back to back keep the two epilogue buffers
    # busy, so a box that overwrote a buffer still being stored would show
    gen = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(8192, 128, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(N, 128, generator=gen, device=cuda) * 0.1).to(dtype)
    b = torch.randn(N, generator=gen, device=cuda) * 0.02
    outs = [linear_int8(x, w, b) for _ in range(10)]
    torch.cuda.synchronize()
    ref = linear_int8_reference(x, w, b)
    assert_flip_close(outs[0].float().cpu().numpy(), ref.float().cpu().numpy())
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.cuda
def test_zero_rows_on_card(cuda):
    # no rows: nothing to launch, the right empty shapes; all-zero rows:
    # absmax 0, the 1e-12 floor, the bias alone
    w = torch.randn(96, 64, device=cuda) * 0.1
    b = torch.randn(96, device=cuda) * 0.02
    assert linear_int8(torch.zeros(0, 64, device=cuda), w, b).shape == (0, 96)
    parts = linear_int8(torch.zeros(2, 0, 64, device=cuda), w, b, chunks=3)
    assert [tuple(p.shape) for p in parts] == [(2, 0, 32)] * 3
    x = torch.randn(40, 64, device=cuda)
    x[::3] = 0
    out = linear_int8(x, w, b)
    torch.cuda.synchronize()
    ref = linear_int8_reference(x, w, b)
    assert torch.equal(out[::3], ref[::3])
    assert_flip_close(out.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_resources_on_card(cuda, dtype):
    # one persistent block of 384 threads an SM, started with the registers
    # its setmaxnreg split asks for (40 x 128 + 232 x 256)
    from bayesvlm_tpu_torch.models.linear_int8 import kernel_resources

    r = kernel_resources(dtype, 3072, 3)
    assert r["body"] == "wgmma" and r["blocks_per_sm"] == 1
    assert r["smem_bytes"] <= 227 * 1024
    assert r["registers"] * 384 >= 40 * 128 + 232 * 256
    # one matrix or whole-box chunks go out by the TMA, other chunks by
    # plain stores
    assert r["tma_store"] and kernel_resources(dtype, 96, 1)["tma_store"]
    assert not kernel_resources(dtype, 144, 3)["tma_store"]
    assert kernel_resources(dtype, 192, 3)["tma_store"]
    assert kernel_resources(dtype, 96, 3)["tma_store"] == (dtype == torch.float32)
