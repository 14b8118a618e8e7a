"""Port of the whole-sublayer attention kernel (`bayesvlm_tpu_torch.models.
attention.fused_attention_block`, the `attn_pallas_block` lane) against
the JAX package's `fused_attention_block`, run in interpret mode on the
CPU as tests/test_pallas_attention.py runs it: the sublayer alone (fp32
and bf16), the tiny-clip vision tower with the flag, the flag beside the
int8 lanes, and the causal text tower it leaves alone; the wrapper's
refusals of what the TMA cannot address, through a stub library; plus
the CUDA kernel chain and its two projections (the wgmma GEMM with its
bias and residual epilogue) against their plain versions on the card
(marked `cuda`, skipped without a GPU).

    python -m pytest --noconftest -m cuda tests/test_torch_attention_block.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.models import attention, layers
from bayesvlm_tpu_torch.models.attention import (
    _layer_norm_fp32,
    _proj,
    fused_attention_block,
    fused_attention_block_reference,
    fused_attention_reference,
)


def _case(B, T, D, seed):
    """x [B, T, D], LN scale and bias [D], four weights [D, D] in the JAX
    layout ([in, out]) and four biases [D]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    ln_w = (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=D)).astype(np.float32)
    ws = [rng.normal(0, D ** -0.5, size=(D, D)).astype(np.float32) for _ in range(4)]
    bs = [rng.normal(0, 0.02, size=D).astype(np.float32) for _ in range(4)]
    return x, ln_w, ln_b, ws, bs


def assert_flip_close(out, ref):
    """The int8 lanes' flip tolerance (tests/test_torch_mlp_int8.py)."""
    scale = np.abs(ref).max() + 1e-12
    d = np.abs(np.asarray(out, np.float32) - ref)
    assert d.max() <= 0.02 * scale, (d.max(), scale)
    assert d.mean() <= 0.002 * scale, (d.mean(), scale)


def _bf16_round(a):
    return torch.from_numpy(a).bfloat16().float().numpy()


def _jax_block(x, ln_w, ln_b, ws, bs, H, dtype):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.attention_pallas import fused_attention_block as jfab

    flat = []
    for w, b in zip(ws, bs):
        flat += [jnp.asarray(w, dtype), jnp.asarray(b, dtype)]
    out = jfab(jnp.asarray(x, dtype), jnp.asarray(ln_w), jnp.asarray(ln_b), *flat,
               num_heads=H)
    return np.asarray(out.astype(jnp.float32))


def _port_args(ws, bs, dtype, device="cpu"):
    flat = []
    for w, b in zip(ws, bs):
        flat += [torch.from_numpy(w.T.copy()).to(device, dtype),
                 torch.from_numpy(b).to(device, dtype)]
    return flat


def _port_block(x, ln_w, ln_b, ws, bs, H, dtype):
    return fused_attention_block(torch.from_numpy(x).to(dtype), torch.from_numpy(ln_w),
                                 torch.from_numpy(ln_b), *_port_args(ws, bs, dtype),
                                 num_heads=H)


@pytest.mark.parametrize("T", [17, 50])
@pytest.mark.parametrize("H", [2, 4])
def test_matches_jax_block_kernel_fp32(T, H):
    # fp32 end to end: only the summation order differs -> 1e-5
    x, ln_w, ln_b, ws, bs = _case(2, T, 64, seed=T + H)
    ref = _jax_block(x, ln_w, ln_b, ws, bs, H, np.float32)
    out = _port_block(x, ln_w, ln_b, ws, bs, H, torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_matches_jax_block_kernel_bf16():
    """bf16 operands (rounded once here so that both packages see the
    same values). The LN output, q, k, v, p, the attention output, the
    out-projection and x + out are each rounded to bf16 once, at the same
    points in both; an fp32 sum taken in another order moves a value
    across a rounding boundary by one ulp (<= 2^-7 relative). Flips
    upstream are damped by the sums after them, so the output differs by
    the last two roundings at most: 2^-6 relative and absolute. The
    per-op lane rounds each projection twice (the product, then the bias
    add): the port's plain version must sit closer to JAX's single
    rounding than that variant does."""
    import jax.numpy as jnp

    T, H, D = 50, 4, 64
    x, ln_w, ln_b, ws, bs = _case(2, T, D, seed=7)
    x, ws, bs = _bf16_round(x), [_bf16_round(w) for w in ws], [_bf16_round(b) for b in bs]
    ref = _jax_block(x, ln_w, ln_b, ws, bs, H, jnp.bfloat16)
    out = _port_block(x, ln_w, ln_b, ws, bs, H, torch.bfloat16).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=2 ** -6, atol=2 ** -6)

    def proj_twice(x, w, b):  # the per-op lane's rounding of a projection
        return (x.float() @ w.float().T).to(x.dtype) + b

    args = _port_args(ws, bs, torch.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    hn = _layer_norm_fp32(tx, torch.from_numpy(ln_w), torch.from_numpy(ln_b), 1e-5)
    q, k, v = (proj_twice(hn, args[2 * i], args[2 * i + 1]) for i in range(3))
    a = fused_attention_reference(q, k, v, H)
    twice = (tx + proj_twice(a, args[6], args[7])).float().numpy()
    assert (out != ref).mean() < (twice != ref).mean()


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    x, ln_w, ln_b, ws, bs = _case(2, 17, 32, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(ln_w), torch.from_numpy(ln_b),
            *_port_args(ws, bs, torch.float32))
    before = fused_attention_block.launches
    out = fused_attention_block(*args, num_heads=2)
    assert torch.equal(out, fused_attention_block_reference(*args, num_heads=2))
    assert fused_attention_block.launches == before


def test_rejects_mismatched_shapes():
    x, ln_w, ln_b, ws, bs = _case(1, 5, 32, seed=2)
    args = _port_args(ws, bs, torch.float32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, ln_w, ln_b))
    with pytest.raises(ValueError, match=r"\[32, 32\]"):
        fused_attention_block(tx, tw, tb, *args[:6], args[6][:16], args[7], num_heads=2)
    with pytest.raises(ValueError, match=r"\[32\]"):
        fused_attention_block(tx, tw[:8], tb, *args, num_heads=2)
    with pytest.raises(ValueError, match="multiple"):
        fused_attention_block(tx, tw, tb, *args, num_heads=3)
    with pytest.raises(ValueError, match=r"\[B, T, D\]"):
        fused_attention_block(tx[0], tw, tb, *args, num_heads=2)


def _meta_view(shape, dtype, offset):
    """A contiguous meta tensor of `shape` that starts `offset` elements
    into its storage (meta tensors report the address it implies)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype, device="meta")[offset:].view(*shape)


@pytest.mark.parametrize("operand", ["x", "wq", "wk", "wv", "wo"])
def test_wrapper_refuses_what_the_tma_cannot_address(operand, monkeypatch):
    # x and the four weights must start 16-byte aligned (the bf16 GEMMs read
    # the weights by the TMA, the residual x in pairs): the wrapper raises,
    # naming the operand, before it loads or launches anything (a stub
    # library fails the test if reached)
    def no_library():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(attention, "_block_library", no_library)
    monkeypatch.setattr(attention, "_library", no_library)
    B, T, D, H = 2, 5, 64, 1
    bf16 = torch.bfloat16
    names = ("x", "wq", "wk", "wv", "wo")

    def operands(misaligned):
        shapes = {"x": (B, T, D), **{w: (D, D) for w in names[1:]}}
        return {n: _meta_view(shapes[n], bf16, int(n == misaligned)) for n in names}

    def call(ops):
        vec = lambda dtype=bf16: _meta_view((D,), dtype, 0)
        return fused_attention_block(
            ops["x"], vec(torch.float32), vec(torch.float32), ops["wq"], vec(), ops["wk"],
            vec(), ops["wv"], vec(), ops["wo"], vec(), num_heads=H)

    before = fused_attention_block.launches
    # a view one element in: 2 bytes past an aligned base
    with pytest.raises(ValueError, match=f"{operand}'s base address 0x2 is not 16-byte"):
        call(operands(operand))
    # the same operands, aligned, reach the device check (no kernel for meta)
    with pytest.raises(ValueError, match="no attention block kernel for device meta"):
        call(operands(None))
    assert fused_attention_block.launches == before


def test_compare_builds_block_has_no_cpu_mode(tmp_path, capsys):
    # --block builds two trees' attention_block.cu and times them on the card
    # only: without a CUDA device it raises before it builds anything
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--a", str(tmp_path), "--b", str(tmp_path), "--block"]
    assert compare_builds.parse_args(argv).block
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.main(argv)
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        compare_builds.parse_args([*argv, "--epig"])


# -- the tiny-clip towers with the flag ----------------------------------------


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The JAX tiny-clip encoders (fp32, seed 0) and a directory holding
    their weights bridged to the port's state dicts."""
    import jax
    import jax.numpy as jnp

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models.bridge import save_weights

    j_img, j_txt, _ = jax_load_model("tiny-clip", dtype=jnp.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp_path_factory.mktemp("block_bridged"), to_np(j_img.params),
                      to_np(j_txt.params))
    return j_img, wd


def _pixels(n=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def _jax_tower(j_img, x, **flags):
    import jax.numpy as jnp

    from bayesvlm_tpu.models.clip import CLIPVisionTower
    from bayesvlm_tpu.models.configs import TINY_CLIP_CONFIG

    cfg = dataclasses.replace(TINY_CLIP_CONFIG.vision, **flags)
    embeds, acts = CLIPVisionTower(cfg, dtype=jnp.float32).apply(
        {"params": j_img.params}, jnp.asarray(x))
    return np.asarray(embeds), np.asarray(acts)


def _port_block_encoder(wd, **flags):
    from bayesvlm_tpu_torch.models import load_model
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder

    img, _, _ = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32,
                           device="cpu")
    return img, rebuild_image_encoder(img, attn_pallas_block=True, **flags)


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the sublayer calls the towers make (on the CPU the kernel's
    own count stays at 0)."""
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return fused_attention_block(*args, **kw)

    monkeypatch.setattr(layers, "fused_attention_block", counted)
    return calls


def test_block_lane_tower_matches_jax(bridged, block_calls):
    """The tiny-clip vision tower with attn_pallas_block=True against the
    JAX tower with the same flag and weights: fp32, 1e-5 (the JAX
    package's own block-lane tolerance, tests/test_pallas_attention.py).
    Its state_dict keys are the default tower's."""
    j_img, wd = bridged
    plain, img = _port_block_encoder(wd)
    x = _pixels()
    ref_e, ref_a = _jax_tower(j_img, x, attn_pallas_block=True)
    out = img(x)
    np.testing.assert_allclose(out.embeds.numpy(), ref_e, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.activations.numpy(), ref_a, rtol=1e-5, atol=1e-5)
    assert len(block_calls) == img.config.vision.num_layers
    assert img.config.vision.attn_pallas_block
    assert img.module.state_dict().keys() == plain.module.state_dict().keys()


@pytest.mark.parametrize("flags", [{"attn_int8": True}, {"mlp_int8": True}])
def test_block_lane_beside_the_int8_lanes_matches_jax(bridged, block_calls, flags,
                                                      monkeypatch):
    """With attn_int8 the block kernel wins and no W8A8 projection runs
    (1e-5, as without it); with mlp_int8 the MLP sublayers still take the
    int8 kernel (the int8 flip tolerance of tests/test_torch_mlp_int8.py)."""
    linear_calls = []
    monkeypatch.setattr(layers, "linear_int8",
                        lambda *a, **kw: linear_calls.append(1))
    j_img, wd = bridged
    _, img = _port_block_encoder(wd, **flags)
    x = _pixels(seed=1)
    ref_e, ref_a = _jax_tower(j_img, x, attn_pallas_block=True, **flags)
    out = img(x)
    L = img.config.vision.num_layers
    assert len(block_calls) == L and not linear_calls
    if "mlp_int8" in flags:
        assert_flip_close(out.embeds.numpy(), ref_e)
        assert_flip_close(out.activations.numpy(), ref_a)
    else:
        np.testing.assert_allclose(out.embeds.numpy(), ref_e, rtol=1e-5, atol=1e-5)


def test_causal_text_tower_is_unchanged_by_the_flag(bridged, block_calls):
    from bayesvlm_tpu_torch.models import load_model
    from bayesvlm_tpu_torch.models.clip import CLIPTextTower

    _, wd = bridged
    _, txt, _ = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32,
                           device="cpu")
    cfg = dataclasses.replace(txt.config.text, attn_pallas_block=True)
    tower = CLIPTextTower(cfg).eval()
    tower.load_state_dict(txt.module.state_dict())
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size - 1, size=(3, cfg.max_length)))
    ids[:, -1] = cfg.eos_token_id
    with torch.no_grad():
        out, acts = tower(ids)
        ref, ref_acts = txt.module(ids)
    assert torch.equal(out, ref) and torch.equal(acts, ref_acts)
    assert not block_calls


# -- the kernel on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


# fp32: summation order only. bf16: as in the JAX parity test above, the
# last two roundings (the out-projection, x + out) can each move a value
# by one ulp (<= 2^-7 relative)
_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,H", [
    (2, 17, 32, 2), (3, 50, 768, 12), (2, 33, 160, 2), (4, 257, 1024, 16),
    # D = 80: each part narrower than a 128-column tile; M = 111 and 257 no
    # multiple of 64; B = 1
    (3, 37, 80, 1), (1, 257, 1024, 16),
])
def test_kernel_matches_plain_on_card(cuda, dtype, B, T, D, H):
    x, ln_w, ln_b, ws, bs = _case(B, T, D, seed=D)
    args = (torch.from_numpy(x).to(cuda, dtype), torch.from_numpy(ln_w).to(cuda),
            torch.from_numpy(ln_b).to(cuda), *_port_args(ws, bs, dtype, cuda))
    before = fused_attention_block.launches
    out = fused_attention_block(*args, num_heads=H)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + 1
    assert out.dtype == dtype and out.shape == (B, T, D)
    ref = fused_attention_block_reference(*args, num_heads=H)
    tol = _TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(2, 577, 1024, 16), (1, 1024, 128, 2)])
def test_bf16_core_takes_long_sequences_on_card(cuda, B, T, D, H):
    # bf16: the core is the tensor-core body, whose shared memory does not
    # grow with T (ViT-L/14 at 336 px, T=577; T=1024, which the CUDA-core
    # body's score tile could not take and fp32 still cannot)
    x, ln_w, ln_b, ws, bs = _case(B, T, D, seed=T)
    ln = (torch.from_numpy(ln_w).to(cuda), torch.from_numpy(ln_b).to(cuda))
    args = (torch.from_numpy(x).to(cuda, torch.bfloat16), *ln,
            *_port_args(ws, bs, torch.bfloat16, cuda))
    out = fused_attention_block(*args, num_heads=H)
    torch.cuda.synchronize()
    ref = fused_attention_block_reference(*args, num_heads=H)
    tol = _TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    if T == 1024:
        with pytest.raises(ValueError, match="shared memory"):
            fused_attention_block(torch.from_numpy(x).to(cuda), *ln,
                                  *_port_args(ws, bs, torch.float32, cuda), num_heads=H)


@pytest.mark.cuda
def test_block_lane_tower_on_card_matches_cpu(cuda, tmp_path):
    """tiny-clip fp32 through the block lane on the card against the same
    tower on the CPU: one kernel launch per layer."""
    from bayesvlm_tpu_torch.models import load_model
    from bayesvlm_tpu_torch.models.encoders import rebuild_image_encoder

    cpu, _, _ = load_model("tiny-clip", dtype=torch.float32, device="cpu", seed=1)
    gpu, _, _ = load_model("tiny-clip", dtype=torch.float32, device=cuda, seed=1)
    gpu.module.load_state_dict(cpu.module.state_dict())
    cpu = rebuild_image_encoder(cpu, attn_pallas_block=True)
    gpu = rebuild_image_encoder(gpu, attn_pallas_block=True)
    x = _pixels(4, seed=4)
    before = fused_attention_block.launches
    out = gpu(x).embeds
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + gpu.config.vision.num_layers
    torch.testing.assert_close(out.cpu(), cpu(x).embeds, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(cuda):
    x, ln_w, ln_b, ws, bs = _case(1, 5, 32, seed=3)
    ln = (torch.from_numpy(ln_w).to(cuda), torch.from_numpy(ln_b).to(cuda))
    half = _port_args(ws, bs, torch.float16, cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_attention_block(torch.from_numpy(x).to(cuda, torch.float16), *ln, *half,
                              num_heads=2)
    mixed = _port_args(ws, bs, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="x's dtype"):
        fused_attention_block(torch.from_numpy(x).to(cuda), *ln, *mixed, num_heads=2)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,H", [(3, 37, 80, 1), (2, 257, 1024, 16)])
def test_kernel_gives_the_same_bits_twice_on_card(cuda, B, T, D, H):
    # no atomics and a fixed order of the sums: a call repeats its bits
    x, ln_w, ln_b, ws, bs = _case(B, T, D, seed=D + 1)
    args = (torch.from_numpy(x).to(cuda, torch.bfloat16), torch.from_numpy(ln_w).to(cuda),
            torch.from_numpy(ln_b).to(cuda), *_port_args(ws, bs, torch.bfloat16, cuda))
    first = fused_attention_block(*args, num_heads=H)
    second = fused_attention_block(*args, num_heads=H)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _project_on_card(a, ws, bs, residual=None):
    """One projection of the sublayer through its C entry: [parts, M, N]."""
    out = torch.full((len(ws), a.shape[0], ws[0].shape[0]), float("nan"), dtype=a.dtype,
                     device=a.device)
    attention._block_projection(a, ws, bs, residual, out)
    torch.cuda.synchronize()
    return out


def _bf16_ulp(t):
    """One unit in the last place of bf16 at each |t| (fp32 tensor)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,parts,residual", [
    (111, 80, 3, False), (111, 80, 1, False), (111, 80, 1, True), (333, 1024, 3, False),
    (333, 1024, 1, True), (257, 1024, 3, False), (16448, 1024, 3, False),
    (16448, 1024, 1, True), (1, 64, 3, False), (1, 64, 1, True),
])
def test_projection_matches_plain_on_card(cuda, dtype, M, D, parts, residual):
    """Each projection alone: QKV (3 parts) and the out-projection with and
    without its residual, at D = 80 (a part narrower than a tile), M no
    multiple of 64 or 128, ViT-L/14's M = 16,448 and one row. bf16: the
    tensor cores add each k16 group's products into the fp32 sum aligned
    to its largest term and truncated, where the plain version rounds
    every fused multiply-add, so the sums differ by up to ~2^-16 here
    (1024 terms of ~2^-5, 64 groups) and a rounded product by one ulp of
    itself besides; with the residual the sum's rounding adds one more
    ulp of the output. fp32: summation order only."""
    rng = np.random.default_rng(M + D + parts)
    a = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(cuda, dtype)
    ws = [torch.from_numpy(rng.normal(0, D ** -0.5, size=(D, D)).astype(np.float32))
          .to(cuda, dtype) for _ in range(parts)]
    bs = [torch.from_numpy(rng.normal(0, 0.5, size=D).astype(np.float32)).to(cuda, dtype)
          for _ in range(parts)]
    x = torch.from_numpy(rng.normal(size=(M, D)).astype(np.float32)).to(cuda, dtype)
    out = _project_on_card(a, ws, bs, x if residual else None).float()
    prods = torch.stack([_proj(a, w, b) for w, b in zip(ws, bs)])
    ref = (x + prods if residual else prods).float()
    assert out.shape == (parts, M, D) and bool(torch.isfinite(out).all())
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        return
    bound = (2 * _bf16_ulp(ref) + (2 * _bf16_ulp(prods.float()) if residual else 0)
             + 2.0 ** -12)
    ratio = (out - ref).abs() / bound
    at = int(ratio.argmax())
    assert float(ratio.max()) <= 1.0, (float(ratio.max()), float(out.flatten()[at]),
                                       float(ref.flatten()[at]))
    assert float((out != ref).float().mean()) < 0.02


@pytest.mark.cuda
def test_kernel_refuses_a_misaligned_weight_on_card(cuda):
    x, ln_w, ln_b, ws, bs = _case(1, 5, 64, seed=5)
    ln = (torch.from_numpy(ln_w).to(cuda), torch.from_numpy(ln_b).to(cuda))
    args = _port_args(ws, bs, torch.bfloat16, cuda)
    # wk one element into its storage: contiguous, 2 bytes past an aligned base
    store = torch.empty(64 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    store[1:].view(64, 64).copy_(args[2])
    args[2] = store[1:].view(64, 64)
    before = fused_attention_block.launches
    with pytest.raises(ValueError, match="wk's base address"):
        fused_attention_block(torch.from_numpy(x).to(cuda, torch.bfloat16), *ln, *args,
                              num_heads=1)
    assert fused_attention_block.launches == before


@pytest.mark.cuda
def test_block_gemm_resources_on_card(cuda):
    # one persistent block an SM: 6 stages of 32 KB, 32 KB of epilogue
    # boxes, the barriers and 1 KB of staged biases; the registers at launch
    # cover the setmaxnreg split (40 producer, 232 consumers)
    res = attention.block_gemm_resources()
    for name in ("qkv", "out_proj"):
        r = res[name]
        assert r["smem_bytes"] == 231_536 and r["blocks_per_sm"] == 1, r
        assert (r["producer_registers"], r["consumer_registers"]) == (40, 232), r
        assert r["registers"] * 384 >= 128 * 40 + 256 * 232, r
