"""The GEMM probes (`bayesvlm_tpu_torch.probes.tile_gemm`, `bench_int8_mxu`,
`bench_int8_sweep`, `bench_int4_mxu`) against the TPU body they share,
`make_matmul` of scripts/dev/bench_int8_mxu.py, bench_int8_sweep.py and
bench_int4_mxu.py, run on the CPU under `pltpu.force_tpu_interpret_mode()`
(their `pallas_call` has no interpret flag); the s4 packing; the probes'
command lines on the CPU; and each CUDA kernel against its plain version
on the card (marked `cuda`, skipped without a GPU).

s4 x s4 is held to the int32 dot of the widened values, the script's own
gate (bench_int4_mxu.py:108-114): XLA:CPU's HLO verifier refuses the JAX
kernel on two int4 operands ("does not support custom element sizes on
non-sub-byte types"), with or without forced interpret mode.

The scripts cannot be imported (they set the JAX compilation cache at
import), so `make_matmul` is lifted out of each file with `ast` and
executed with a tiny M, K, N. JAX is imported inside the parity tests, so
that the `cuda` tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_gemm_probes.py
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.probes import tile_gemm as tg

DEV = Path(__file__).resolve().parent.parent / "scripts" / "dev"
# the lifted bodies' shape and tile: 2 x 2 x 2 grid steps
M, K, N = 64, 256, 128
TM, TN, TK = 32, 64, 128
# bf16: both sum fp32 products of the same bf16 values, in another order
BF16_TOL = 1e-5


def _make_matmul(script: str, k: int = K):
    """make_matmul of scripts/dev/<script>, with M, K, N set small (K = k)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    path = DEV / script
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_matmul")
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, M=M, K=k, N=N)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["make_matmul"]


def _interpret(mm, *args):
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(mm(*args))


def _operands(seed):
    rng = np.random.default_rng(seed)
    a8 = rng.integers(-127, 127, size=(M, K)).astype(np.int8)
    b8 = rng.integers(-127, 127, size=(K, N)).astype(np.int8)
    a16 = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).bfloat16()
    b16 = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).bfloat16()
    return a8, b8, a16, b16


def _call(script, in_name, acc_name):
    import jax.numpy as jnp

    make = _make_matmul(script)
    in_dt, acc_dt = getattr(jnp, in_name), getattr(jnp, acc_name)
    if script == "bench_int8_sweep.py":
        return make(in_dt, acc_dt, TM, TN, TK)
    return make(in_dt, acc_dt, TM=TM, TN=TN, TK=TK)


@pytest.mark.parametrize("script", ["bench_int8_mxu.py", "bench_int8_sweep.py"])
def test_s8_matches_jax_body_exactly(script):
    import jax.numpy as jnp

    a8, b8, _, _ = _operands(seed=1)
    ref = _interpret(_call(script, "int8", "int32"), jnp.asarray(a8), jnp.asarray(b8))
    out = tg.matmul(torch.from_numpy(a8), torch.from_numpy(b8))
    assert out.dtype == torch.int32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("script", ["bench_int8_mxu.py", "bench_int8_sweep.py"])
def test_bf16_matches_jax_body(script):
    import jax.numpy as jnp

    _, _, a16, b16 = _operands(seed=2)
    ref = _interpret(_call(script, "bfloat16", "float32"),
                     jnp.asarray(a16.float().numpy(), jnp.bfloat16),
                     jnp.asarray(b16.float().numpy(), jnp.bfloat16))
    out = tg.matmul(a16, b16)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= BF16_TOL * np.abs(ref).max()


def test_s8_by_s4_matches_jax_body_exactly():
    # bench_int4_mxu.py:117-127: int8 activations x int4 weights
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a8 = rng.integers(-127, 127, size=(M, K)).astype(np.int8)
    b4 = rng.integers(-7, 8, size=(K, N)).astype(np.int8)
    make = _make_matmul("bench_int4_mxu.py")
    ref = _interpret(make(jnp.int32, TM=TM, TN=TN, TK=TK), jnp.asarray(a8),
                     jnp.asarray(b4, jnp.int4))
    out = tg.matmul_s4(torch.from_numpy(a8), tg.pack_s4(torch.from_numpy(b4), 0))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_s4_by_s4_matches_the_widened_int32_dot():
    # the script's own gate; XLA:CPU refuses the JAX kernel here (above)
    rng = np.random.default_rng(0)
    a4 = rng.integers(-7, 8, size=(M, K))
    b4 = rng.integers(-7, 8, size=(K, N))
    ref = a4.astype(np.int32) @ b4.astype(np.int32)
    out = tg.matmul_s4(tg.pack_s4(torch.from_numpy(a4).to(torch.int8), 1),
                       tg.pack_s4(torch.from_numpy(b4).to(torch.int8), 0))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kind", ["s4xs4", "s8xs4"])
def test_s4_kinds_at_k_96_match_the_reference(kind):
    # K = 96: a multiple of the s4 kinds' depth 32, not of 64 (their depth
    # before the prepass design); s8 x s4 against the JAX body in interpret
    # mode (three k steps of 32), s4 x s4 against the widened int32 dot
    import jax.numpy as jnp

    Kr = 96
    rng = np.random.default_rng(96)
    b4 = rng.integers(-8, 8, size=(Kr, N)).astype(np.int8)
    b4p = tg.pack_s4(torch.from_numpy(b4), 0)
    if kind == "s8xs4":
        a = rng.integers(-128, 128, size=(M, Kr)).astype(np.int8)
        make = _make_matmul("bench_int4_mxu.py", k=Kr)
        ref = _interpret(make(jnp.int32, TM=TM, TN=TN, TK=32), jnp.asarray(a),
                         jnp.asarray(b4, jnp.int4))
        out = tg.matmul_s4(torch.from_numpy(a), b4p)
    else:
        a = rng.integers(-8, 8, size=(M, Kr)).astype(np.int8)
        ref = a.astype(np.int32) @ b4.astype(np.int32)
        out = tg.matmul_s4(tg.pack_s4(torch.from_numpy(a), 1), b4p)
    assert out.dtype == torch.int32 and out.shape == (M, N)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("with_a", [True, False], ids=["a-and-b", "b-only"])
def test_unpack_prepass_on_the_cpu_is_the_plain_unpacking(with_a):
    # the prepass's layouts: B^T [N, K] (K-major, as wgmma reads 8-bit B)
    # and A [M, K]; their product is the s4 kinds' product
    gen = torch.Generator().manual_seed(7)
    a4 = torch.randint(-8, 8, (M, 96), generator=gen, dtype=torch.int8)
    b4 = torch.randint(-8, 8, (96, N), generator=gen, dtype=torch.int8)
    a4p, b4p = tg.pack_s4(a4, 1), tg.pack_s4(b4, 0)
    a8, bt = tg.unpack_prepass(a4p if with_a else None, b4p)
    assert bt.dtype == torch.int8 and bt.shape == (N, 96) and bt.is_contiguous()
    assert torch.equal(bt, b4.t())
    if with_a:
        assert torch.equal(a8, a4)
        assert torch.equal(tg.matmul_reference(a8, bt.t()), tg.matmul_s4(a4p, b4p))
    else:
        assert a8 is None
    with pytest.raises(ValueError, match="packed s4"):
        tg.unpack_prepass(a4, b4p)


@pytest.mark.parametrize("dim", [0, 1])
def test_pack_s4_round_trip_and_signs(dim):
    x = torch.arange(-8, 8, dtype=torch.int8).repeat(4, 2)  # [4, 32]: every value
    x = x if dim == 1 else x.t().contiguous()
    p = tg.pack_s4(x, dim)
    assert p.dtype == torch.uint8 and p.shape[dim] == x.shape[dim] // 2
    assert torch.equal(tg.unpack_s4(p, dim), x)


def test_pack_s4_nibble_order():
    # element 2i in the low nibble, 2i+1 in the high one, two's complement
    x = torch.tensor([[1, -1, -8, 7, 0, -2]], dtype=torch.int8)
    assert tg.pack_s4(x, 1).tolist() == [[0xF1, 0x78, 0xE0]]
    assert tg.pack_s4(x.t(), 0).t().tolist() == [[0xF1, 0x78, 0xE0]]


def test_pack_s4_refuses_what_it_cannot_pack():
    with pytest.raises(ValueError, match="odd length"):
        tg.pack_s4(torch.zeros(3, 4, dtype=torch.int8), 0)
    with pytest.raises(ValueError, match=r"\[-8, 7\]"):
        tg.pack_s4(torch.full((2, 2), 8, dtype=torch.int8), 0)


def test_wrappers_refuse_what_the_kernel_cannot_take():
    a8 = torch.zeros(4, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="do not match"):
        tg.matmul(a8, torch.zeros(32, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="bf16 x bf16 or int8 x int8"):
        tg.matmul(a8, torch.zeros(64, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="packed s4"):
        tg.matmul_s4(a8, torch.zeros(32, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="do not match"):
        tg.matmul_s4(a8, torch.zeros(16, 16, dtype=torch.uint8))
    # what only a launch checks, reached through tensors that are not on
    # the CPU (meta tensors hold no data)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="not a multiple of 32"):
        tg.matmul(torch.zeros(4, 48, dtype=torch.int8, device=meta),
                  torch.zeros(48, 16, dtype=torch.int8, device=meta))
    with pytest.raises(ValueError, match="s8s4 GEMM: K = 48 is not a multiple of 32"):
        tg.matmul_s4(torch.zeros(4, 48, dtype=torch.int8, device=meta),
                     torch.zeros(24, 16, dtype=torch.uint8, device=meta))
    with pytest.raises(ValueError, match="multiple of 16"):
        tg.matmul(torch.zeros(4, 64, dtype=torch.int8, device=meta),
                  torch.zeros(64, 24, dtype=torch.int8, device=meta))
    with pytest.raises(ValueError, match="no tile"):
        tg.matmul(torch.zeros(4, 64, dtype=torch.int8, device=meta),
                  torch.zeros(64, 16, dtype=torch.int8, device=meta), tg.Tile(1, 2, 3, 4))
    with pytest.raises(ValueError, match="no GEMM kernel for device meta"):
        tg.matmul(torch.zeros(4, 64, dtype=torch.int8, device=meta),
                  torch.zeros(64, 16, dtype=torch.int8, device=meta))


@pytest.mark.parametrize("kind", ["s4xs4", "s8xs4"])
def test_s4_kinds_take_k_96_and_refuse_k_48_on_meta(kind, monkeypatch):
    # K = 96 passes every check the wrapper makes before the device's (K a
    # multiple of 32, packed A rows of 48 bytes); K = 48 is refused by name:
    # s8 x s4 by its K, s4 x s4 by its packed A's 24-byte rows (the TMA's
    # rule, checked first). A stub library fails the test if reached.
    def no_library():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(tg, "_library", no_library)
    meta = torch.device("meta")

    def a(Kr):
        if kind == "s4xs4":
            return torch.zeros(4, Kr // 2, dtype=torch.uint8, device=meta)
        return torch.zeros(4, Kr, dtype=torch.int8, device=meta)

    before = [getattr(*count) for _, count, _ in tg.KERNELS.values()]
    with pytest.raises(ValueError, match="no GEMM kernel for device meta"):
        tg.matmul_s4(a(96), torch.zeros(48, 16, dtype=torch.uint8, device=meta))
    what = ("operand a: rows are 24 bytes apart" if kind == "s4xs4"
            else "s8s4 GEMM: K = 48 is not a multiple of 32")
    with pytest.raises(ValueError, match=what):
        tg.matmul_s4(a(48), torch.zeros(24, 16, dtype=torch.uint8, device=meta))
    assert [getattr(*count) for _, count, _ in tg.KERNELS.values()] == before


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    a8, b8, a16, b16 = _operands(seed=4)
    a8, b8 = torch.from_numpy(a8), torch.from_numpy(b8)
    b4 = tg.pack_s4(torch.randint(-8, 8, (K, N), dtype=torch.int8), 0)
    before = [getattr(*count) for _, count, _ in tg.KERNELS.values()]
    assert torch.equal(tg.matmul(a8, b8), tg.matmul_reference(a8, b8))
    assert torch.equal(tg.matmul(a16, b16), tg.matmul_reference(a16, b16))
    assert torch.equal(tg.matmul_s4(a8, b4), tg.matmul_s4_reference(a8, b4))
    assert [getattr(*count) for _, count, _ in tg.KERNELS.values()] == before


def test_bounds_at_the_probe_shape():
    # the int32 output's bytes bound s8, s4 and s8 x s4; bf16 its operations:
    # the int8/bf16 ratio the card allows is 1.61x, not the peaks' 2x
    b = {kind: tg.gemm_bound(tg.M, tg.K, tg.N, kind) for kind in ("bf16", "s8", "s4", "s8s4")}
    assert b["bf16"]["bound_by"] == "operations" and abs(b["bf16"]["bound_ms"] - 0.139) < 1e-3
    assert all(b[k]["bound_by"] == "bytes" for k in ("s8", "s4", "s8s4"))
    assert abs(b["s8"]["bound_ms"] - 0.0864) < 1e-4
    assert abs(b["s4"]["bound_ms"] - 0.0833) < 1e-4
    assert round(b["bf16"]["bound_ms"] / b["s8"]["bound_ms"], 2) == 1.61


def test_device_alone_chooses_the_shape():
    assert tg.probe_shape("cpu") == tg.CPU_SHAPE
    assert tg.probe_shape("cuda") == (tg.M, tg.K, tg.N) == (16384, 1024, 4096)
    assert tg.parse_args([], "probe").device == "cuda"
    with pytest.raises(SystemExit):
        tg.parse_args(["--m", "64"], "probe")


def test_library_stand_in_on_the_cpu_is_the_fp32_product():
    # torch.mm(a, b, out_dtype=torch.float32) has no CPU version; the
    # sweep's gate takes the fp32 product of the same values there
    _, _, a16, b16 = _operands(seed=5)
    assert torch.equal(tg.library_bf16(a16, b16), tg.matmul_reference(a16, b16))


@pytest.mark.parametrize("probe,lines", [
    ("bench_int8_mxu", ("tile bf16xbf16->fp32:", "tile int8xint8->int32:",
                        "int8/bf16 kernel-vs-kernel speedup: not measured")),
    ("bench_int8_sweep", ("correctness: int8 exact", "tile s8 256x128/12w/4st/coop:",
                          "int8/bf16 best-vs-best: not measured")),
    ("bench_int4_mxu", ("s4 x s4 kernel runs: wgmma m64nNk32 s8 (TMA ring) after the "
                        "unpack_s4 prepass (A and B to s8); s8 x s4: wgmma m64nNk32 s8 "
                        "(TMA ring) after the unpack_s4 prepass (B to s8)",
                        "int4xint4->int32 correctness vs int32 dot: EXACT",
                        "int8xint4->int32 correctness vs int32 dot: EXACT")),
])
def test_probe_main_runs_on_the_cpu(probe, lines, capsys):
    import importlib

    mod = importlib.import_module(f"bayesvlm_tpu_torch.probes.{probe}")
    assert mod.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    for line in lines:
        assert line in text
    # no time off the card
    assert "not measured" in text and "TOP/s" not in text


def test_tiles_are_eight_wgmma_configurations_and_s4_keeps_its_own():
    # bf16 and s8 sweep 8 distinct configurations of the wgmma kernel (a
    # producer and two consumer warpgroups: 12 warps), both schedules: a
    # consumer takes half a tile's rows (coop) or all of them (pingpong) in
    # whole m64 products, at most 128 accumulators a thread, at 2-6 stages;
    # the s4 kinds keep one tile of their own, the s8 GEMM's first, and
    # refuse the other seven by name
    assert len(tg.TILES) == len(set(tg.TILES)) == 8 and tg.DEFAULT_TILE == tg.TILES[0]
    assert {t.schedule for t in tg.TILES} == {"coop", "pingpong"}
    for tile in tg.TILES:
        rows = tile.bm // 2 if tile.schedule == "coop" else tile.bm
        assert tile.warps == 12 and tile.bn in (128, 256) and rows % 64 == 0
        assert rows // 64 * tile.bn <= 256 and 2 <= tile.stages <= 6
    assert str(tg.DEFAULT_TILE) == "128x128/12w/6st/pingpong"
    assert not hasattr(tg, "S4_TILE")
    for kind in (tg.BF16, tg.S8):
        assert [tg._tile_index(t, kind) for t in tg.TILES] == list(range(8))
        with pytest.raises(ValueError, match="no tile"):
            tg._tile_index(tg.Tile(128, 128, 8, 4), kind)
    for kind in (tg.S4, tg.S8S4):
        assert tg._tile_index(tg.TILES[0], kind) == 0
        for tile in tg.TILES[1:]:
            with pytest.raises(ValueError, match=rf"{tg.KIND_NAMES[kind]} kernel is built "
                                                 rf"for {tg.DEFAULT_TILE} only"):
                tg._tile_index(tile, kind)
    assert tg.BODY == {tg.BF16: "wgmma", tg.S8: "wgmma", tg.S4: "wgmma", tg.S8S4: "wgmma"}
    assert all("wgmma" in tg.MMA[k] for k in tg.MMA)
    assert all("unpack_s4 prepass" in tg.MMA[k] for k in (tg.S4, tg.S8S4))


def _meta_view(shape, dtype, offset):
    """A contiguous meta tensor of `shape` that starts `offset` elements
    into its storage (meta tensors report the address it implies)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype, device="meta")[offset:].view(*shape)


@pytest.mark.parametrize("case", ["a_base", "b_base", "a_rows", "b_rows"])
def test_wrapper_refuses_what_the_tma_cannot_address(case, monkeypatch):
    # every operand must start 16-byte aligned and have rows a multiple of
    # 16 bytes apart; the wrapper raises, naming the operand, before it
    # loads or launches anything (a stub library fails the test if reached)
    def no_library():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(tg, "_library", no_library)
    bf16 = torch.bfloat16
    a, b = _meta_view((4, 64), bf16, 0), _meta_view((64, 16), bf16, 0)
    if case == "a_base":  # a view one element in: 2 bytes past an aligned base
        a, what = _meta_view((4, 64), bf16, 1), r"operand a: base address 0x2 is not 16-byte"
    elif case == "b_base":
        b, what = _meta_view((64, 16), bf16, 1), r"operand b: base address 0x2 is not 16-byte"
    elif case == "a_rows":  # K = 4 bf16: rows 8 bytes apart
        a, b = _meta_view((4, 4), bf16, 0), _meta_view((4, 16), bf16, 0)
        what = "operand a: rows are 8 bytes apart, not a multiple of 16"
    else:  # N = 24 int8: B's rows 24 bytes apart
        a, b = _meta_view((4, 64), torch.int8, 0), _meta_view((64, 24), torch.int8, 0)
        what = "operand b: rows are 24 bytes apart, not a multiple of 16"
    before = [getattr(*count) for _, count, _ in tg.KERNELS.values()]
    with pytest.raises(ValueError, match=what):
        tg.matmul(a, b)
    # the same operands, aligned, reach the device check (no kernel for meta)
    with pytest.raises(ValueError, match="no GEMM kernel for device meta"):
        tg.matmul(_meta_view((4, 64), bf16, 0), _meta_view((64, 16), bf16, 0))
    assert [getattr(*count) for _, count, _ in tg.KERNELS.values()] == before


def test_compare_builds_gemm_has_no_cpu_mode(tmp_path, capsys):
    # --gemm builds two trees' tile_gemm.cu and times them on the card only:
    # without a CUDA device it raises before it builds anything
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--a", str(tmp_path), "--b", str(tmp_path), "--gemm"]
    assert compare_builds.parse_args(argv).gemm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.main(argv)
    assert capsys.readouterr().out == ""


# -- the kernels on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_operands(Mr, Kr, Nr, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    a8 = torch.randint(-127, 127, (Mr, Kr), generator=gen, device=device, dtype=torch.int8)
    b8 = torch.randint(-127, 127, (Kr, Nr), generator=gen, device=device, dtype=torch.int8)
    a16 = torch.randn(Mr, Kr, generator=gen, device=device).bfloat16()
    b16 = torch.randn(Kr, Nr, generator=gen, device=device).bfloat16()
    return a8, b8, a16, b16


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tg.TILES, ids=str)
@pytest.mark.parametrize("Mr,Kr,Nr", [(1000, 96, 1008), (256, 1024, 512), (1, 32, 16)])
def test_gemm_matches_plain_on_card(cuda, tile, Mr, Kr, Nr):
    a8, b8, a16, b16 = _card_operands(Mr, Kr, Nr, cuda)
    before = (tg.matmul.launches, tg.matmul.launches_s8)
    assert torch.equal(tg.matmul(a8, b8, tile), tg.matmul_reference(a8, b8))
    ref = tg.matmul_reference(a16, b16)
    out = tg.matmul(a16, b16, tile)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())
    assert (tg.matmul.launches, tg.matmul.launches_s8) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("Mr,Kr,Nr", [(1000, 128, 1008), (512, 1024, 256), (3, 64, 16),
                                      (1000, 96, 1008), (333, 160, 272), (1, 32, 16),
                                      (4097, 96, 2144)])
def test_s4_kinds_match_plain_on_card(cuda, Mr, Kr, Nr):
    # K = 32, 96 and 160: whole k32 steps, not whole 128-byte stages (the
    # TMA zero-fills past K); ragged M and N
    gen = torch.Generator(device=cuda).manual_seed(Mr)
    a4 = torch.randint(-8, 8, (Mr, Kr), generator=gen, device=cuda, dtype=torch.int8)
    b4 = torch.randint(-8, 8, (Kr, Nr), generator=gen, device=cuda, dtype=torch.int8)
    a8 = torch.randint(-128, 128, (Mr, Kr), generator=gen, device=cuda, dtype=torch.int8)
    b4p = tg.pack_s4(b4, 0)
    before = (tg.matmul_s4.launches, tg.matmul_s4.launches_s8s4)
    assert torch.equal(tg.matmul_s4(tg.pack_s4(a4, 1), b4p), tg.matmul_reference(a4, b4))
    assert torch.equal(tg.matmul_s4(a8, b4p), tg.matmul_reference(a8, b4))
    assert (tg.matmul_s4.launches, tg.matmul_s4.launches_s8s4) == (before[0] + 1,
                                                                   before[1] + 1)


@pytest.mark.cuda
def test_tile_table_matches_the_library_on_card(cuda):
    # tile_resources raises if the library's tile differs from TILES; the
    # wgmma kernel is one persistent block an SM, and starts with the
    # registers its setmaxnreg split needs (40 x 128 + 232 x 256)
    for tile in tg.TILES:
        for kind in (tg.BF16, tg.S8):
            smem, blocks, registers = tg.tile_resources(kind, tile)
            assert smem <= 227 * 1024 and blocks == 1, (kind, tile)
            assert registers * 384 >= 40 * 128 + 232 * 256, (kind, tile, registers)
    # the s4 kinds report the s8 kernel their prepass feeds, at tile 0
    for kind in (tg.S4, tg.S8S4):
        assert tg.tile_resources(kind, tg.DEFAULT_TILE) == tg.tile_resources(
            tg.S8, tg.DEFAULT_TILE)


@pytest.mark.cuda
@pytest.mark.parametrize("Mr,Kr,Nr", [(1000, 96, 1008), (3, 32, 16), (257, 1024, 528),
                                      (1, 160, 4096)])
def test_unpack_prepass_matches_plain_on_card(cuda, Mr, Kr, Nr):
    # the prepass alone: B^T [N, K] and A [M, K] equal to the plain
    # unpacking bit for bit, with A and without it (s8 x s4's launch)
    gen = torch.Generator(device=cuda).manual_seed(Kr)
    a4 = torch.randint(-8, 8, (Mr, Kr), generator=gen, device=cuda, dtype=torch.int8)
    b4 = torch.randint(-8, 8, (Kr, Nr), generator=gen, device=cuda, dtype=torch.int8)
    a4p, b4p = tg.pack_s4(a4, 1), tg.pack_s4(b4, 0)
    before = [getattr(*count) for _, count, _ in tg.KERNELS.values()]
    a8, bt = tg.unpack_prepass(a4p, b4p)
    assert torch.equal(bt, tg.unpack_s4(b4p, 0).t()) and torch.equal(bt, b4.t())
    assert torch.equal(a8, tg.unpack_s4(a4p, 1)) and torch.equal(a8, a4)
    none, bt_only = tg.unpack_prepass(None, b4p)
    assert none is None and torch.equal(bt_only, bt)
    assert [getattr(*count) for _, count, _ in tg.KERNELS.values()] == before


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take_on_card(cuda):
    a = torch.zeros(4, 48, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="not a multiple of 32"):
        tg.matmul(a, torch.zeros(48, 16, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tg.matmul(torch.zeros(64, 4, dtype=torch.int8, device=cuda).t(),
                  torch.zeros(64, 16, dtype=torch.int8, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        tg.matmul(torch.zeros(4, 64, dtype=torch.int8, device=cuda),
                  torch.zeros(64, 16, dtype=torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tg.TILES, ids=str)
@pytest.mark.parametrize("kind,Kr", [(tg.BF16, 48), (tg.S8, 96), (tg.S8, 160)])
def test_ragged_k_matches_plain_on_card(cuda, tile, kind, Kr):
    # K not a multiple of a stage (64 bf16, 128 s8): the TMA zero-fills the
    # last stage past K; M and N ragged too
    a8, b8, a16, b16 = _card_operands(333, Kr, 272, cuda, seed=Kr)
    if kind == tg.S8:
        assert torch.equal(tg.matmul(a8, b8, tile), tg.matmul_reference(a8, b8))
    else:
        ref = tg.matmul_reference(a16, b16)
        out = tg.matmul(a16, b16, tile)
        assert float((out - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tg.TILES, ids=str)
def test_s8_extremes_are_exact_on_card(cuda, tile):
    # all -128 at K = 1024: every sum is 1024 x 16384 = 2^24, exact in int32
    a = torch.full((256, 1024), -128, dtype=torch.int8, device=cuda)
    b = torch.full((1024, 512), -128, dtype=torch.int8, device=cuda)
    out = tg.matmul(a, b, tile)
    assert out.dtype == torch.int32
    assert bool((out == 1024 * 128 * 128).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tg.TILES, ids=str)
@pytest.mark.parametrize("Mr,Nr", [(128, 256), (4096, 4096)], ids=["one-tile", "waves"])
def test_fewer_tiles_than_sms_and_many_waves_on_card(cuda, tile, Mr, Nr):
    # one output tile for 132 SMs, and 256-1024 tiles: several per block,
    # each of more k-blocks (K = 1024: 16 bf16, 8 s8) than the ring has
    # stages, so a ping-pong consumer's next tile lies rounds ahead
    a8, b8, a16, b16 = _card_operands(Mr, 1024, Nr, cuda, seed=Mr)
    assert torch.equal(tg.matmul(a8, b8, tile), tg.matmul_reference(a8, b8))
    ref = tg.matmul_reference(a16, b16)
    out = tg.matmul(a16, b16, tile)
    assert float((out - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


@pytest.mark.cuda
def test_m_zero_launches_nothing_on_card(cuda):
    before = [getattr(*count) for _, count, _ in tg.KERNELS.values()]
    for dtype, out_dtype in ((torch.bfloat16, torch.float32), (torch.int8, torch.int32)):
        out = tg.matmul(torch.zeros(0, 64, dtype=dtype, device=cuda),
                        torch.zeros(64, 32, dtype=dtype, device=cuda))
        assert out.shape == (0, 32) and out.dtype == out_dtype
    b4p = torch.zeros(32, 32, dtype=torch.uint8, device=cuda)
    for a in (torch.zeros(0, 32, dtype=torch.uint8, device=cuda),
              torch.zeros(0, 64, dtype=torch.int8, device=cuda)):
        out = tg.matmul_s4(a, b4p)
        assert out.shape == (0, 32) and out.dtype == torch.int32
    assert [getattr(*count) for _, count, _ in tg.KERNELS.values()] == before


@pytest.mark.cuda
def test_back_to_back_shapes_on_one_stream_on_card(cuda):
    # tensor maps and the s8 scratch are per call: two shapes queued without
    # a synchronise in between both come out right
    first = _card_operands(1000, 96, 1008, cuda, seed=1)
    second = _card_operands(300, 1024, 4096, cuda, seed=2)
    outs = [(tg.matmul(a8, b8), tg.matmul(a16, b16)) for a8, b8, a16, b16 in (first, second)]
    torch.cuda.synchronize()
    for (a8, b8, a16, b16), (o8, o16) in zip((first, second), outs):
        assert torch.equal(o8, tg.matmul_reference(a8, b8))
        ref = tg.matmul_reference(a16, b16)
        assert float((o16 - ref).abs().max()) <= BF16_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", tg.TILES, ids=str)
@pytest.mark.parametrize("Nr", [2064, 2144], ids=["n16", "n96"])
def test_epilogue_boxes_past_n_on_card(cuda, tile, Nr):
    # N = 16 and 96 (mod 128 and 256): the last column block of every tile
    # row stores 1 or 3 of its 32-column boxes and skips the rest (3 or 1
    # at BN = 128, 7 or 5 at 256), and the next box goes on through the
    # other buffer. One stage of K, many tiles a block and a repeated call
    # keep the stores back to back, as at the output-bound probe shape
    Mr = 8192
    for kind, Kr in ((tg.S8, 128), (tg.BF16, 64)):
        a8, b8, a16, b16 = _card_operands(Mr, Kr, Nr, cuda, seed=Nr + Kr)
        a, b = (a8, b8) if kind == tg.S8 else (a16, b16)
        ref = tg.matmul_reference(a, b)
        for _ in range(10):
            out = tg.matmul(a, b, tile)
            if kind == tg.S8:
                assert torch.equal(out, ref), (tile, Nr)
            else:
                err = float((out - ref).abs().max())
                assert err <= BF16_TOL * float(ref.abs().max()), (tile, Nr, err)
