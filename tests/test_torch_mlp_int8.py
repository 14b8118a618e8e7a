"""Port of the W8A8 int8 MLP (`bayesvlm_tpu_torch.models.mlp_int8`) against
the JAX package's, on the CPU: the weight quantization bit for bit; the
sublayer's math against the JAX Pallas kernel run in interpret mode (as
tests/test_mlp_int8.py runs it) and against its pure-jnp emulation; the
tiny-clip vision tower with both int8 lanes against the JAX tower with
bridged weights; the prequantized weight cache. Plus the CUDA kernel
against its plain version on the card (marked `cuda`, skipped without a
GPU).

Tolerance, the JAX package's own (tests/test_mlp_int8.py:50-62): the
frameworks now and then round a pre-round value one ulp apart (the
LayerNorm's summation order, tanh, FMA contraction), which flips one
int8 step of one element. Flips are sparse and small; a systematic
fault (a wrong scale axis, a missing /127) moves every element. So
max |d| <= 0.02 max|ref| and mean |d| <= 0.002 max|ref| (`FLIP_TOL_MAX`,
`FLIP_TOL_MEAN` of `models/mlp_int8.py`).

JAX is imported inside the parity tests, so that the `cuda` tests also
run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_mlp_int8.py
"""

import warnings

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.models.mlp_int8 import (
    FLIP_TOL_MAX,
    FLIP_TOL_MEAN,
    mlp_int8,
    mlp_int8_reference,
    quantize_mlp_weights,
    quantize_weight,
)

D, F = 64, 256


def assert_flip_close(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max() + 1e-12
    d = np.abs(out - ref)
    assert d.max() <= FLIP_TOL_MAX * scale, (d.max(), scale)
    assert d.mean() <= FLIP_TOL_MEAN * scale, (d.mean(), scale)


def _mlp(seed, d=D, f=F):
    """w1 [d, f], b1, w2 [f, d], b2, LN weight and bias: the JAX layout."""
    rng = np.random.default_rng(seed)
    return [rng.normal(mu, s, size=shape).astype(np.float32)
            for mu, s, shape in ((0, 0.05, (d, f)), (0, 0.01, (f,)),
                                 (0, 0.05, (f, d)), (0, 0.01, (d,)),
                                 (1, 0.1, (d,)), (0, 0.1, (d,)))]


def _port_args(w1, b1, w2, b2):
    """The same weights in torch's nn.Linear layout ([out, in])."""
    return (torch.from_numpy(w1.T.copy()), torch.from_numpy(b1),
            torch.from_numpy(w2.T.copy()), torch.from_numpy(b2))


def _to_np(x):
    import jax.numpy as jnp

    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("wdtype", ["fp32", "bf16"])
def test_quantize_weight_bit_equal_to_jax(bits, wdtype):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.mlp_int8 import quantize_weight as jax_quantize_weight

    rng = np.random.default_rng(bits)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # a zero channel: the absmax clamp
    jw = jnp.asarray(w)
    tw = torch.from_numpy(w.T.copy())
    if wdtype == "bf16":
        jw, tw = jw.astype(jnp.bfloat16), tw.bfloat16()
    jq, js = jax_quantize_weight(jw, bits)
    wq, s = quantize_weight(tw, bits)
    assert wq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jq.astype(jnp.int8)).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[0])
    assert int(wq.abs().max()) == (127 if bits == 8 else 7)


def test_quantize_weight_rejects_other_widths():
    with pytest.raises(ValueError, match="8 or 4"):
        quantize_weight(torch.ones(2, 2), bits=2)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("M", [1, 33, 40])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu"])
def test_matches_jax_emulation(act, M, fused, dtype):
    """Both variants (plain, fused pre-LN + fp32 residual), every
    activation (gelu becomes tanh-GELU, as in the JAX package), ragged M."""
    import jax.numpy as jnp

    from bayesvlm_tpu.models.mlp_int8 import mlp_int8_reference as jax_ref

    w1, b1, w2, b2, g, bb = _mlp(M)
    x = np.random.default_rng(M + 1).normal(size=(M, D)).astype(np.float32)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jln = dict(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(bb), ln_eps=1e-5)
    tln = dict(ln_weight=torch.from_numpy(g), ln_bias=torch.from_numpy(bb),
               ln_eps=1e-5)
    ref = jax_ref(jnp.asarray(x, jdt), *map(jnp.asarray, (w1, b1, w2, b2)),
                  act_name=act, **(jln if fused else {}))
    out = mlp_int8(torch.from_numpy(x).to(tdt), *_port_args(w1, b1, w2, b2),
                   act_name=act, **(tln if fused else {}))
    assert out.dtype == tdt and out.shape == (M, D)
    assert_flip_close(out.float().numpy(), _to_np(ref))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
def test_matches_jax_kernel_interpret(act, fused):
    """Against the Pallas kernel itself (interpret mode on the CPU), with
    a ragged last row block, a leading shape that flattens, bf16 x."""
    import jax.numpy as jnp

    from bayesvlm_tpu.models.mlp_int8 import mlp_int8 as jax_mlp_int8

    w1, b1, w2, b2, g, bb = _mlp(7)
    x = np.random.default_rng(8).normal(size=(2, 20, D)).astype(np.float32)
    jln = dict(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(bb), ln_eps=1e-5)
    tln = dict(ln_weight=torch.from_numpy(g), ln_bias=torch.from_numpy(bb),
               ln_eps=1e-5)
    ref = jax_mlp_int8(jnp.asarray(x, jnp.bfloat16),
                       *map(jnp.asarray, (w1, b1, w2, b2)), act_name=act,
                       block_m=16, **(jln if fused else {}))
    out = mlp_int8(torch.from_numpy(x).bfloat16(), *_port_args(w1, b1, w2, b2),
                   act_name=act, **(tln if fused else {}))
    assert out.shape == (2, 20, D)
    assert_flip_close(out.float().numpy(), _to_np(ref))


@pytest.mark.parametrize("fused", [False, True])
def test_zero_rows_are_safe(fused):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.mlp_int8 import mlp_int8_reference as jax_ref

    w1, b1, w2, b2, g, bb = _mlp(3)
    x = np.zeros((4, D), np.float32)
    jln = dict(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(bb), ln_eps=1e-5)
    tln = dict(ln_weight=torch.from_numpy(g), ln_bias=torch.from_numpy(bb),
               ln_eps=1e-5)
    out = mlp_int8(torch.from_numpy(x), *_port_args(w1, b1, w2, b2),
                   **(tln if fused else {})).numpy()
    assert np.isfinite(out).all()
    ref = jax_ref(jnp.asarray(x), *map(jnp.asarray, (w1, b1, w2, b2)),
                  **(jln if fused else {}))
    assert_flip_close(out, _to_np(ref))


@pytest.mark.parametrize("fused", [False, True])
def test_weight_bits4_matches_jax(fused):
    """W4A8: the same kernel with weights in +-7 (int8 storage here,
    jnp.int4 in the JAX package), against its kernel and its emulation."""
    import jax.numpy as jnp

    from bayesvlm_tpu.models.mlp_int8 import mlp_int8 as jax_mlp_int8
    from bayesvlm_tpu.models.mlp_int8 import mlp_int8_reference as jax_ref

    w1, b1, w2, b2, g, bb = _mlp(4)
    x = np.random.default_rng(5).normal(size=(40, D)).astype(np.float32)
    jargs = (jnp.asarray(x), *map(jnp.asarray, (w1, b1, w2, b2)))
    jln = dict(ln_scale=jnp.asarray(g), ln_bias=jnp.asarray(bb), ln_eps=1e-5)
    tln = dict(ln_weight=torch.from_numpy(g), ln_bias=torch.from_numpy(bb),
               ln_eps=1e-5)
    out4 = mlp_int8(torch.from_numpy(x), *_port_args(w1, b1, w2, b2),
                    weight_bits=4, **(tln if fused else {})).numpy()
    ln = jln if fused else {}
    assert_flip_close(out4, _to_np(jax_ref(*jargs, weight_bits=4, **ln)))
    assert_flip_close(out4, _to_np(jax_mlp_int8(*jargs, block_m=32,
                                                weight_bits=4, **ln)))
    out8 = mlp_int8(torch.from_numpy(x), *_port_args(w1, b1, w2, b2),
                    **(tln if fused else {})).numpy()
    assert not np.allclose(out4, out8)  # the width reached the weights


def test_prequantized_weights_match_per_call():
    w1, b1, w2, b2, _, _ = _mlp(6)
    args = _port_args(w1, b1, w2, b2)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(9, D))
                         .astype(np.float32))
    quant = quantize_mlp_weights(args[0], args[2])
    assert torch.equal(mlp_int8(x, *args, quant=quant), mlp_int8(x, *args))


def test_rejects_unknown_activation_and_partial_ln():
    w1, b1, w2, b2, g, _ = _mlp(0)
    x = torch.zeros(2, D)
    with pytest.raises(ValueError, match="activation"):
        mlp_int8(x, *_port_args(w1, b1, w2, b2), act_name="relu")
    with pytest.raises(ValueError, match="together"):
        mlp_int8(x, *_port_args(w1, b1, w2, b2), ln_weight=torch.from_numpy(g))


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    w1, b1, w2, b2, _, _ = _mlp(1)
    args = _port_args(w1, b1, w2, b2)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(5, D))
                         .astype(np.float32))
    before = mlp_int8.launches
    assert torch.equal(mlp_int8(x, *args), mlp_int8_reference(x, *args))
    assert mlp_int8.launches == before


# -- the tiny-clip vision tower with both int8 lanes -----------------------


@pytest.fixture(scope="module")
def int8_towers(tmp_path_factory):
    """The JAX tiny-clip encoders with mlp_int8 + attn_int8 (fp32, seed 0)
    and the port's, loaded from the bridged weights."""
    import jax
    import jax.numpy as jnp

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models import load_model
    from bayesvlm_tpu_torch.models.bridge import save_weights

    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=jnp.float32, seed=0,
                                     mlp_int8=True, attn_int8=True)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp_path_factory.mktemp("int8_bridged"),
                      to_np(j_img.params), to_np(j_txt.params))
    return j_img, wd


def _port_image_encoder(wd, **flags):
    from bayesvlm_tpu_torch.models import load_model

    img, _, _ = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32,
                           device="cpu", **flags)
    return img


def _pixels(n=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def test_int8_vision_tower_matches_jax(int8_towers):
    j_img, wd = int8_towers
    img = _port_image_encoder(wd, mlp_int8=True, attn_int8=True)
    x = _pixels()
    ref = j_img(x)
    out = img(x)
    assert_flip_close(out.activations.numpy(), np.asarray(ref.activations))
    assert_flip_close(out.embeds.numpy(), np.asarray(ref.embeds))
    # the lanes were taken: the float tower of the same weights differs
    plain = _port_image_encoder(wd)(x)
    assert not torch.allclose(plain.embeds, out.embeds, rtol=1e-5, atol=1e-6)


def test_int8_lanes_reach_the_vision_tower_only(int8_towers):
    from bayesvlm_tpu_torch.models import load_model
    from bayesvlm_tpu_torch.models.layers import MLP, MultiHeadAttention

    _, wd = int8_towers
    img, txt, _ = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32,
                             device="cpu", mlp_int8=True, attn_int8=True,
                             mlp_weight_bits=4)
    vis = [m for m in img.module.modules() if isinstance(m, (MLP, MultiHeadAttention))]
    text = [m for m in txt.module.modules() if isinstance(m, (MLP, MultiHeadAttention))]
    assert vis and all(getattr(m, "use_int8", getattr(m, "use_int8_proj", None))
                       for m in vis)
    assert all(m.weight_bits == 4 for m in vis if isinstance(m, MLP))
    assert text and not any(getattr(m, "use_int8", getattr(m, "use_int8_proj", None))
                            for m in text)
    assert img.config.vision.mlp_int8 and img.config.vision.attn_int8


def test_prequantize_cache_matches_per_call(int8_towers):
    _, wd = int8_towers
    img = _port_image_encoder(wd, mlp_int8=True, attn_int8=True)
    x = _pixels(seed=1)
    per_call = img(x).embeds
    assert img.prequantize_int8() is img
    mlp = img.module.encoder.layers[0].mlp
    assert mlp.w1q is not None and mlp.w1q.dtype == torch.int8
    assert "w1q" not in img.module.state_dict()  # a cache, not a parameter
    assert torch.equal(img(x).embeds, per_call)
    # no int8 MLP: nothing to cache
    plain = _port_image_encoder(wd)
    assert plain.prequantize_int8() is plain
    assert plain.module.encoder.layers[0].mlp.w1q is None


def test_prequantize_cache_recomputed_after_weight_swap(int8_towers):
    """Weights replaced after prequantize_int8 are caught at the next call:
    the cache is recomputed with a warning, never used stale. A change to
    the projection alone (outside the MLPs) keeps it."""
    from bayesvlm_tpu_torch.models import load_model

    _, wd = int8_towers
    img = _port_image_encoder(wd, mlp_int8=True).prequantize_int8()
    x = _pixels(seed=2)
    other, _, _ = load_model("tiny-clip", dtype=torch.float32, device="cpu",
                             seed=1, mlp_int8=True)
    fresh = other.prequantize_int8()(x).embeds
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with torch.no_grad():
            img.module.visual_projection.weight.mul_(1.0)
        img(x)
    img.module.load_state_dict(other.module.state_dict())
    with pytest.warns(RuntimeWarning, match="recomputing"):
        out = img(x).embeds
    assert torch.equal(out, fresh)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(img(x).embeds, fresh)


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("M,d,f,bits", [
    (1, 64, 256, 8), (33, 64, 256, 8), (40, 32, 64, 8),
    (4 * 257, 1024, 4096, 8), (4 * 257, 1024, 4096, 4), (300, 768, 3072, 8),
])
def test_kernel_matches_plain_on_card(cuda, dtype, fused, act, M, d, f, bits):
    w1, b1, w2, b2, g, bb = (torch.from_numpy(a).to(cuda) for a in _mlp(M, d, f))
    w1, w2 = w1.T.contiguous().to(dtype), w2.T.contiguous().to(dtype)
    x = torch.randn(M, d, generator=torch.Generator(device=cuda).manual_seed(M),
                    device=cuda).to(dtype)
    ln = dict(ln_weight=g, ln_bias=bb, ln_eps=1e-5) if fused else {}
    quant = quantize_mlp_weights(w1, w2, bits)
    before = mlp_int8.launches
    out = mlp_int8(x, w1, b1, w2, b2, act, quant=quant, **ln)
    torch.cuda.synchronize()
    assert mlp_int8.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = mlp_int8_reference(x, w1, b1, w2, b2, act, quant=quant, **ln)
    assert_flip_close(out.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    w1, b1, w2, b2, _, _ = (torch.from_numpy(a).to(cuda) for a in _mlp(0, 24, 64))
    with pytest.raises(ValueError, match="multiples of 16"):
        mlp_int8(torch.zeros(2, 24, device=cuda), w1.T, b1, w2.T, b2)
    w1, b1, w2, b2, _, _ = (torch.from_numpy(a).to(cuda) for a in _mlp(0))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mlp_int8(torch.zeros(2, D, device=cuda, dtype=torch.float16),
                 w1.T, b1, w2.T, b2)


# the wgmma body's dequantising epilogue (csrc/wgmma_gemm.cuh EpiDequant):
# GEMM1 (N = F) and GEMM2 (N = D) at N = 16 and 96 (mod 128), K = D and F
# of 32, 96, 144, 224, 2064 and 4096, M = 1, 333 and 64 x 257; 4-bit
# weights; the activation and requantize between them in one row pass
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("act", ["gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("M,d,f,bits", [
    (1, 32, 96, 8), (333, 144, 2064, 8), (333, 96, 224, 4),
    (64 * 257, 1024, 4096, 8), (333, 1024, 4096, 4),
])
def test_epilogue_shapes_match_plain_on_card(cuda, dtype, fused, act, M, d, f, bits):
    w1, b1, w2, b2, g, bb = (torch.from_numpy(a).to(cuda) for a in _mlp(M + d, d, f))
    w1, w2 = w1.T.contiguous().to(dtype), w2.T.contiguous().to(dtype)
    x = torch.randn(M, d, generator=torch.Generator(device=cuda).manual_seed(d),
                    device=cuda).to(dtype)
    ln = dict(ln_weight=g, ln_bias=bb, ln_eps=1e-5) if fused else {}
    quant = quantize_mlp_weights(w1, w2, bits)
    out = mlp_int8(x, w1, b1, w2, b2, act, quant=quant, **ln)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == x.shape
    ref = mlp_int8_reference(x, w1, b1, w2, b2, act, quant=quant, **ln)
    assert_flip_close(out.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ten_calls_at_a_ragged_n_on_card(cuda, dtype):
    # D = 144 and F = 2064 (16 mod 128): both GEMMs' last column blocks
    # skip boxes; ten calls back to back give the same bits
    w1, b1, w2, b2, g, bb = (torch.from_numpy(a).to(cuda) for a in _mlp(7, 144, 2064))
    w1, w2 = w1.T.contiguous().to(dtype), w2.T.contiguous().to(dtype)
    x = torch.randn(4096, 144, generator=torch.Generator(device=cuda).manual_seed(7),
                    device=cuda).to(dtype)
    ln = dict(ln_weight=g, ln_bias=bb, ln_eps=1e-5)
    quant = quantize_mlp_weights(w1, w2)
    outs = [mlp_int8(x, w1, b1, w2, b2, quant=quant, **ln) for _ in range(10)]
    torch.cuda.synchronize()
    ref = mlp_int8_reference(x, w1, b1, w2, b2, quant=quant, **ln)
    assert_flip_close(outs[0].float().cpu().numpy(), ref.float().cpu().numpy())
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_zero_rows_on_card(cuda, fused):
    # no rows: nothing to launch; all-zero rows with b1 = 0: GEMM1's rows
    # are 0, their absmax 0, and the requantize takes the 1e-12 floor
    w1, b1, w2, b2, g, bb = (torch.from_numpy(a).to(cuda) for a in _mlp(5))
    ln = dict(ln_weight=g, ln_bias=bb, ln_eps=1e-5) if fused else {}
    assert mlp_int8(torch.zeros(0, D, device=cuda), w1.T, b1, w2.T, b2, **ln).shape == (0, D)
    x = torch.randn(40, D, device=cuda)
    x[::4] = 0
    b1 = torch.zeros_like(b1)
    out = mlp_int8(x, w1.T, b1, w2.T, b2, **ln)
    torch.cuda.synchronize()
    ref = mlp_int8_reference(x, w1.T, b1, w2.T, b2, **ln)
    if not fused:
        assert torch.equal(out[::4], ref[::4])
    assert_flip_close(out.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_resources_on_card(cuda, dtype):
    # both GEMMs: one persistent block of 384 threads an SM, started with
    # the registers their setmaxnreg split asks for (40 x 128 + 232 x 256)
    from bayesvlm_tpu_torch.models.mlp_int8 import kernel_resources

    r = kernel_resources(dtype)
    assert r["body"] == "wgmma" and r["blocks_per_sm"] == 1
    assert r["smem_bytes"] <= 227 * 1024
    assert all(regs * 384 >= 40 * 128 + 232 * 256 for regs in r["registers_gemm"])


def test_compare_builds_int8_has_no_cpu_mode(tmp_path, capsys):
    # --int8 builds two trees' mlp_int8.cu and linear_int8.cu and drives
    # them on the card only: without a CUDA device it raises before it
    # builds anything; --gemm and --int8 together are refused
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--a", str(tmp_path), "--b", str(tmp_path), "--int8"]
    args = compare_builds.parse_args(argv)
    assert args.int8 and not args.gemm and args.a == tmp_path
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.main(argv)
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        compare_builds.parse_args(argv + ["--gemm"])
