"""The attention-schedule probes (`bayesvlm_tpu_torch.probes`) against the
TPU probe bodies of scripts/dev/ (`_kernel_v2`, `_kernel_v4`,
`_kernel_v5`, `_kernel_v6`), run in interpret mode on the CPU with the
scripts' grids, BlockSpecs and scratch shapes; the probes' command lines
on the CPU; and each CUDA kernel against its plain version on the card
(marked `cuda`, skipped without a GPU).

The scripts cannot be imported (they build B=80 inputs and time at
import), so each body is lifted out of its file with `ast` and executed
with the names it reads. JAX is imported inside the parity tests, so that
the `cuda` tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_attn_variants.py
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.models.attention import fused_attention_reference
from bayesvlm_tpu_torch.probes import attention_variants as av

DEV = Path(__file__).resolve().parent.parent / "scripts" / "dev"
# fp32: summation order only, the tolerance of the attention parity tests;
# bf16: both round p (or e) and the output at the same points, and an fp32
# sum or exp taken another way can push a value across a rounding
# boundary: one bf16 ulp (2^-8 relative), as tests/test_torch_attention.py
TOL = {"fp32": 1e-5, "bf16": 2 ** -7}


def _lift(script: str, name: str, **consts):
    """The function `name` of scripts/dev/<script>, executed alone with
    jax, jnp, pl, pltpu and the module constants it reads."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    path = DEV / script
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, **consts)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns[name]


def _qkv(B, T, H, Dh, dtype, seed):
    """numpy inputs, rounded to bf16 first for the bf16 cases, so that both
    packages get the same values."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, T, H * Dh)).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        xs = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in xs]
    return xs


def _jax_call(kernel, xs, dtype, grid, spec, scratch):
    """pl.pallas_call(kernel) in interpret mode, with the scripts' specs."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q, k, v = (jnp.asarray(x, jdt) for x in xs)
    out = pl.pallas_call(kernel, grid=grid, in_specs=[spec] * 3, out_specs=spec,
                         out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
                         scratch_shapes=scratch, interpret=True)(q, k, v)
    return np.asarray(out.astype(jnp.float32))


def _jax_one_row_program(body, xs, dtype, H, Dh, score_dtype, **kw):
    """bench_attn_variants.py:76-84 / bench_attn_variants2.py:100-116: grid
    (B,), one batch row a program, an [H, T, T] score scratch."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    B, T, D = xs[0].shape
    spec = pl.BlockSpec((1, T, D), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    kernel = functools.partial(body, num_heads=H, head_dim=Dh, scale=1.0 / (Dh ** 0.5),
                               **kw)
    return _jax_call(kernel, xs, dtype, (B,), spec,
                     [pltpu.VMEM((H, T, T), getattr(jnp, score_dtype))])


def _port(fn, xs, dtype, H):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    out = fn(*(torch.from_numpy(x).to(tdt) for x in xs), H)
    assert out.dtype == tdt and out.device.type == "cpu"
    return out.float().numpy()


def _close(out, ref, dtype):
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype], atol=TOL[dtype])


def _close_v4(out, ref):
    # v4 rounds its scores to bf16 for fp32 inputs too: an fp32 dot summed
    # in another order can flip one score's rounding (2^-8 relative), which
    # moves one output vector like a bf16 flip of p -> the bf16 tolerance
    # for the max; flips are sparse, a rounding left out moves every
    # output -> av.MEAN_TOL for the mean
    _close(out, ref, "bf16")
    mean = float(np.abs(out - ref).mean())
    assert mean <= av.MEAN_TOL["attention_v4"], f"mean |d| {mean:.3e}"


SHAPES = [(2, 17, 2), (4, 50, 4)]  # B, T, H at Dh = 16
# v2 also at Dh = 80, where the scale 1/sqrt(80) that moves into q is no
# power of two: q * scale is rounded to bf16 (the kernel does it on Q's
# fragments), where at Dh = 16 it is exact
V2_SHAPES = [(*s, 16) for s in SHAPES] + [(2, 17, 2, 80)]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("subtract_max", [True, False])
@pytest.mark.parametrize("B,T,H,Dh", V2_SHAPES, ids=[
    "-".join(map(str, s[:3])) + ("" if s[3] == 16 else f"-dh{s[3]}") for s in V2_SHAPES])
def test_v2_matches_jax_probe(dtype, subtract_max, B, T, H, Dh):
    # v3 is the same body with subtract_max=False (an unsafe probe: the
    # N(0, 1) inputs keep exp(s) small)
    xs = _qkv(B, T, H, Dh, dtype, seed=T + H)
    body = _lift("bench_attn_variants.py", "_kernel_v2")
    ref = _jax_one_row_program(body, xs, dtype, H, Dh, "float32",
                               subtract_max=subtract_max)
    out = _port(functools.partial(av.attention_v2, subtract_max=subtract_max), xs,
                dtype, H)
    _close(out, ref, dtype)
    mean = float(np.abs(out - ref).mean())
    assert mean <= av.MEAN_TOL["attention_v2"], f"mean |d| {mean:.3e}"


def _v2_unrounded_q(q, k, v, num_heads, subtract_max=True):
    """v2 with q * scale left in fp32: the function the kernel would
    compute if it skipped the rounding of Q's fragments."""
    import math

    Dh = q.shape[-1] // num_heads
    qs = q.float() * (1.0 / math.sqrt(Dh))
    s = av._heads(qs, num_heads) @ av._heads(k, num_heads).float().transpose(-1, -2)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True) if subtract_max else s)
    o = e.to(q.dtype).float() @ av._heads(v, num_heads).float()
    return av._merge(o / e.sum(dim=-1, keepdim=True)).to(q.dtype)


@pytest.mark.parametrize("subtract_max", [True, False])
def test_v2_check_pins_the_q_rounding(subtract_max):
    # bf16 at Dh = 80: leaving out the rounding of q * scale stays within
    # the max tolerance but moves every output, and fails the mean limit
    # that the port meets
    xs = _qkv(2, 17, 2, 80, "bf16", seed=19)
    body = _lift("bench_attn_variants.py", "_kernel_v2")
    ref = _jax_one_row_program(body, xs, "bf16", 2, 80, "float32",
                               subtract_max=subtract_max)
    unrounded = _port(functools.partial(_v2_unrounded_q, subtract_max=subtract_max), xs,
                      "bf16", 2)
    _close(unrounded, ref, "bf16")
    assert np.abs(unrounded - ref).mean() > 10 * av.MEAN_TOL["attention_v2"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_v4_matches_jax_probe(dtype, B, T, H):
    # the scores are bf16 in the scratch for fp32 inputs too
    xs = _qkv(B, T, H, 16, dtype, seed=2 * T + H)
    body = _lift("bench_attn_variants2.py", "_kernel_v4")
    ref = _jax_one_row_program(body, xs, dtype, H, 16, "bfloat16")
    _close_v4(_port(av.attention_v4, xs, dtype, H), ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_v4_check_pins_the_score_rounding(dtype, B, T, H):
    # #1's function is v4 without the bf16 rounding of its scores: it
    # differs from the JAX body everywhere a little (within the max
    # tolerance) and so fails the mean limit that the port meets
    xs = _qkv(B, T, H, 16, dtype, seed=5 * T + H)
    body = _lift("bench_attn_variants2.py", "_kernel_v4")
    ref = _jax_one_row_program(body, xs, dtype, H, 16, "bfloat16")
    _close_v4(_port(av.attention_v4_reference, xs, dtype, H), ref)
    unrounded = _port(fused_attention_reference, xs, dtype, H)
    _close(unrounded, ref, "bf16")
    assert np.abs(unrounded - ref).mean() > 10 * av.MEAN_TOL["attention_v4"]
    with pytest.raises(AssertionError, match="mean"):
        _close_v4(unrounded, ref)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,H", SHAPES + [(2, 17, 8), (2, 17, 12), (2, 17, 16)])
def test_v5_matches_jax_probe(dtype, B, T, H):
    # bench_attn_variants2.py:97-124: grid (B, GROUPS), HG = H / 2 heads a
    # program (1, 2, 4, 6 and 8 here: every block width the kernel is
    # built for), each writing its own lane range
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    xs = _qkv(B, T, H, 16, dtype, seed=3 * T + H)
    hg = H // av.GROUPS
    body = _lift("bench_attn_variants2.py", "_kernel_v5", HG=hg)
    D = H * 16
    spec = pl.BlockSpec((1, T, D), lambda b, g: (b, 0, 0), memory_space=pltpu.VMEM)
    ref = _jax_call(functools.partial(body, head_dim=16, scale=0.25), xs, dtype,
                    (B, av.GROUPS), spec, [pltpu.VMEM((hg, T, T), jnp.float32)])
    _close(_port(av.attention_group_heads, xs, dtype, H), ref, dtype)
    # the same function as #1
    _close(_port(fused_attention_reference, xs, dtype, H), ref, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_v6_matches_jax_probe(dtype, B, T, H):
    # bench_attn_variants3.py:62-82: grid (B // ROWS,), ROWS batch rows a
    # program, a [ROWS * H, T, T] scratch
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    xs = _qkv(B, T, H, 16, dtype, seed=4 * T + H)
    body = _lift("bench_attn_variants3.py", "_kernel_v6", ROWS=av.ROWS)
    D = H * 16
    spec = pl.BlockSpec((av.ROWS, T, D), lambda b: (b, 0, 0), memory_space=pltpu.VMEM)
    ref = _jax_call(functools.partial(body, num_heads=H, head_dim=16, scale=0.25), xs,
                    dtype, (B // av.ROWS,), spec,
                    [pltpu.VMEM((av.ROWS * H, T, T), jnp.float32)])
    _close(_port(av.attention_group_rows, xs, dtype, H), ref, dtype)
    _close(_port(fused_attention_reference, xs, dtype, H), ref, dtype)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 17, 2, 16, "fp32", seed=0))
    counts = [(av.attention_v2, "launches"), (av.attention_v2, "launches_v3"),
              (av.attention_v4, "launches"), (av.attention_group_heads, "launches"),
              (av.attention_group_rows, "launches")]
    before = [getattr(f, c) for f, c in counts]
    for name, (fn, plain) in av.KERNELS.items():
        assert torch.equal(fn(q, k, v, 2), plain(q, k, v, 2)), name
    assert [getattr(f, c) for f, c in counts] == before


def test_shapes_the_group_kernel_cannot_take_raise():
    odd_heads = torch.zeros(2, 5, 48)
    with pytest.raises(ValueError, match="even head count"):
        av.attention_group_heads(odd_heads, odd_heads, odd_heads, 3)
    ten = torch.zeros(2, 5, 160)
    with pytest.raises(ValueError, match="no block of 5 heads"):
        av.attention_group_heads(ten, ten, ten, 10)
    odd_batch = torch.zeros(3, 5, 32)
    with pytest.raises(ValueError, match="even batch"):
        av.attention_group_rows(odd_batch, odd_batch, odd_batch, 2)
    with pytest.raises(ValueError, match="one \\[B, T, D\\] shape"):
        av.attention_v4(odd_batch, odd_batch[:, :4], odd_batch, 2)


@pytest.mark.parametrize("probe,labels", [
    ("bench_attn_variants", ("v2", "v3")), ("bench_attn_variants2", ("v4", "v5")),
    ("bench_attn_variants3", ("v6",)), ("bench_split_attn", ("split-key",)),
])
def test_probe_main_runs_on_the_cpu(probe, labels, capsys):
    import importlib

    mod = importlib.import_module(f"bayesvlm_tpu_torch.probes.{probe}")
    argv = ["--device", "cpu", "--batch", "2", "--seq", "17", "--heads", "4",
            "--head-dim", "16"]
    assert mod.main(argv) == 0
    text = capsys.readouterr().out
    for label in labels:
        assert f"max |base - {label}| =" in text
        assert f"{label} (" in text
    # no time off the card
    assert "not measured" in text and "TFLOP/s" not in text


@pytest.mark.parametrize("probe,kernels", [
    ("bench_attn_variants", {"attention_v2", "attention_v3"}),
    ("bench_attn_variants2", {"attention_v4", "attention_group_heads"}),
    ("bench_attn_variants3", {"attention_group_rows"}), ("bench_split_attn", set()),
])
def test_probe_run_gives_each_kernel_under_its_name(probe, kernels, capsys):
    # every probe module has one entry (parse_args, run, report, main) and
    # gives each kernel's numbers under ["kernels"][name], as the
    # packed-head and GEMM probes do
    import importlib

    mod = importlib.import_module(f"bayesvlm_tpu_torch.probes.{probe}")
    results = mod.run(mod.parse_args(["--device", "cpu", "--batch", "2", "--seq", "17",
                                      "--heads", "4", "--head-dim", "16"]))
    assert set(results["kernels"]) == kernels
    for r in results["kernels"].values():
        assert {"max_abs_err", "vs_base", "bound_ms", "bound_by", "library_ms"} <= set(r)
    assert mod.report(results) == 0


# -- the kernels on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


# kernel vs plain on the card, chip_smoke.py's tolerance for #1: a p flip
# and an output flip can stack in bf16; fp32 is summation order only,
# but for the bf16 scores of BF16_SCORES (a flip of a score's rounding)
_CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -6}
_COUNTS = {"attention_v2": (av.attention_v2, "launches"),
           "attention_v3": (av.attention_v2, "launches_v3"),
           "attention_v4": (av.attention_v4, "launches"),
           "attention_group_heads": (av.attention_group_heads, "launches"),
           "attention_group_rows": (av.attention_group_rows, "launches")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(av.KERNELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,H,Dh", [(17, 2, 16), (50, 12, 64), (257, 16, 64),
                                    (257, 16, 80)])
def test_kernel_matches_plain_on_card(cuda, name, dtype, T, H, Dh):
    gen = torch.Generator(device=cuda).manual_seed(T + H)
    q, k, v = (torch.randn(4, T, H * Dh, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    fn, plain = av.KERNELS[name]
    owner, count = _COUNTS[name]
    before = getattr(owner, count)
    out = fn(q, k, v, H)
    torch.cuda.synchronize()
    assert getattr(owner, count) == before + 1
    tol = _CARD_TOL[torch.bfloat16 if name in av.BF16_SCORES else dtype]
    ref = plain(q, k, v, H).float()
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    assert float((out.float() - ref).abs().mean()) <= av.MEAN_TOL.get(name, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [2, 4, 8, 12, 16])
def test_group_heads_at_every_block_width_on_card(cuda, dtype, H):
    # H / 2 = 1, 2, 4, 6, 8 heads a block: every instantiation of v5; each
    # equal to #1 of its dtype bit for bit (bf16: the tensor-core body)
    from bayesvlm_tpu_torch.models.attention import fused_attention

    q, k, v = (torch.randn(2, 50, H * 16, device=cuda).to(dtype) for _ in range(3))
    out = av.attention_group_heads(q, k, v, H)
    assert torch.equal(out, fused_attention(q, k, v, H))
    torch.testing.assert_close(out.float(), fused_attention_reference(q, k, v, H).float(),
                               rtol=_CARD_TOL[dtype], atol=_CARD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,Dh", [(17, 16), (50, 64), (257, 64), (257, 80), (50, 80)])
def test_group_kernels_equal_one_block_on_card(cuda, dtype, T, Dh):
    # the same function, each warp (bf16: the tensor-core body) or thread
    # (fp32: the CUDA-core body) summing in #1's order: equal bit for bit
    from bayesvlm_tpu_torch.models.attention import fused_attention

    gen = torch.Generator(device=cuda).manual_seed(T + Dh)
    q, k, v = (torch.randn(4, T, 16 * Dh, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    base = fused_attention(q, k, v, 16)
    assert torch.equal(av.attention_group_heads(q, k, v, 16), base)
    assert torch.equal(av.attention_group_rows(q, k, v, 16), base)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attention_group_heads", "attention_group_rows",
                                  "attention_v2", "attention_v3", "attention_v4"])
def test_group_kernels_take_long_sequences_in_bf16_on_card(cuda, name):
    # T=1024: an fp32 kernel's score tile would pass the card's shared
    # memory; the tensor-core body (bf16 v2-v6) keeps no score tile
    gen = torch.Generator(device=cuda).manual_seed(1024)
    q, k, v = (torch.randn(2, 1024, 16 * 64, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    fn, plain = av.KERNELS[name]
    tol = _CARD_TOL[torch.bfloat16]
    torch.testing.assert_close(fn(q, k, v, 16).float(), plain(q, k, v, 16).float(),
                               rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="shared memory"):
        fn(q.float(), k.float(), v.float(), 16)


@pytest.mark.cuda
def test_block_resources_on_card(cuda):
    # T=257, Dh=64. fp32: v2, v4 and v6 take #1's 104,208 B (two blocks
    # an SM), v5's eight heads 120,848 B (one). bf16: every kernel the
    # tensor-core body's two stages of two 64-row tiles, 36,864 B whatever
    # T and the groups
    want = {"attention_v2": (104208, 2), "attention_v3": (104208, 2),
            "attention_v4": (104208, 2), "attention_group_rows": (104208, 2),
            "attention_group_heads": (120848, 1)}
    for name, (smem, blocks) in want.items():
        r = av.block_resources(name, 80, 257, 16, 64, torch.float32)
        assert (r["body"], r["smem_bytes"], r["blocks_per_sm"]) == (
            "simt", smem, blocks), name
    for name in ("attention_group_heads", "attention_group_rows"):
        r = av.block_resources(name, 80, 257, 16, 64, torch.bfloat16)
        assert (r["body"], r["smem_bytes"]) == ("mma", 36864), name
        assert r["blocks_per_sm"] >= 3 and r["registers"] > 0, name
    # v4 is #1's one-block instantiation with bf16 scores: #1's 128
    # registers and 4 blocks an SM
    r = av.block_resources("attention_v4", 80, 257, 16, 64, torch.bfloat16)
    assert (r["body"], r["smem_bytes"], r["registers"], r["blocks_per_sm"]) == (
        "mma", 36864, 128, 4)
    # v2 and v3 are #1's one-block instantiation with the deferred
    # normalisation, built for 4 blocks an SM (at most 128 registers)
    for name in ("attention_v2", "attention_v3"):
        r = av.block_resources(name, 80, 257, 16, 64, torch.bfloat16)
        assert (r["body"], r["smem_bytes"], r["blocks_per_sm"]) == ("mma", 36864, 4), name
        assert 0 < r["registers"] <= 128, name


def test_compare_builds_has_no_cpu_mode(tmp_path):
    # the two-tree comparison times kernels on the card only: without a
    # CUDA device it raises before it builds anything
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = compare_builds.parse_args(["--a", str(tmp_path), "--b", str(tmp_path)])
    assert (args.a, args.b) == (tmp_path, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.run(args)


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take(cuda):
    big = torch.zeros(2, 4096, 64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        av.attention_v2(big, big, big, 1)
    half = torch.zeros(2, 17, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        av.attention_v4(half, half, half, 1)
    odd = torch.zeros(3, 17, 64, device=cuda)
    with pytest.raises(ValueError, match="even batch"):
        av.attention_group_rows(odd, odd, odd, 1)
    # the tensor-core body copies 16-byte pieces
    off = torch.zeros(2 * 17 * 64 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(
        2, 17, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        av.attention_group_rows(off, off, off, 1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        av.attention_v2(off, off, off, 1)
