"""The packed-head probe (`bayesvlm_tpu_torch.probes.packed_heads`,
`probe_packed_heads`) against the TPU bodies of
scripts/dev/probe_packed_heads.py (`_qk_perhead_kernel`,
`_qk_packed_kernel`, `_pv_perhead_kernel`, `_pv_packed_kernel`, called
through the script's own `make_qk` / `make_pv`, which run in interpret
mode off a TPU); the probe's command line on the CPU; and each CUDA kernel
against its plain version on the card (marked `cuda`, skipped without a
GPU).

The script cannot be imported (it sets B=80 at import and times in
main), so its functions are lifted out of the file with `ast` and
executed with a tiny B, T, H. JAX is imported inside the parity tests, so
that the `cuda` tests also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_packed_heads.py
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch.probes import packed_heads as ph

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "dev" / "probe_packed_heads.py"
# qk: both fp32 sums of the same exact bf16 products (summation order
# only); pv: bf16 out, one ulp (2^-7 relative at most) from a rounding flip
QK_TOL, PV_TOL = 1e-5, 2.0 ** -7
SHAPES = [(2, 17, 4), (1, 33, 2)]  # B, T, H at Dh = 64


def _script(B, T, H):
    """make_qk and make_pv of the script, with its module constants at
    this shape."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    tree = ast.parse(SCRIPT.read_text())
    names = {"_qk_perhead_kernel", "_qk_packed_kernel", "_pv_perhead_kernel",
             "_pv_packed_kernel", "_row_spec", "make_qk", "make_pv"}
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    Dh = 64
    ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, B=B, T=T, H=H, Dh=Dh, D=H * Dh,
              SCALE=1.0 / (Dh ** 0.5))
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns["make_qk"], ns["make_pv"]


def _bf16(x):
    """numpy fp32 -> bf16-representable fp32 (both packages then see the
    same values)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


def _draw(B, T, H, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng.normal(size=(B, T, H * 64)).astype(np.float32)) for _ in range(3))
    p = rng.normal(size=(B, H, T, T)).astype(np.float32)
    return q, k, v, p


def _port_bf16(x):
    return torch.from_numpy(x).bfloat16()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_qk_matches_jax_probe(packed, B, T, H):
    import jax.numpy as jnp

    q, k, _, _ = _draw(B, T, H, seed=T + H)
    make_qk, _ = _script(B, T, H)
    ref = np.asarray(make_qk(packed)(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)))
    out = ph.qk_scores(_port_bf16(q), _port_bf16(k), H, packed=packed)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_allclose(out.numpy(), ref, rtol=QK_TOL, atol=QK_TOL)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_pv_matches_jax_probe(packed, B, T, H):
    import jax.numpy as jnp

    _, _, v, p = _draw(B, T, H, seed=2 * T + H)
    if packed:
        # the script's p' layout (probe_packed_heads.py:227-230)
        p = np.concatenate([p[:, 0::2], p[:, 1::2]], axis=-1)
    _, make_pv = _script(B, T, H)
    ref = np.asarray(make_pv(packed)(jnp.asarray(p), jnp.asarray(v, jnp.bfloat16))
                     .astype(jnp.float32))
    out = ph.pv(torch.from_numpy(p), _port_bf16(v), H, packed=packed)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=PV_TOL, atol=PV_TOL)


def test_pv_check_pins_the_fp32_products():
    # a single bf16 rounding of p (what a bf16 or TF32 kernel would take)
    # moves every output: it fails the mean limit, by far, that the fp32
    # product (the port, and the JAX body) meets
    import jax.numpy as jnp

    B, T, H = 2, 33, 4
    _, _, v, p = _draw(B, T, H, seed=7)
    _, make_pv = _script(B, T, H)
    ref = torch.from_numpy(np.array(make_pv(False)(jnp.asarray(p), jnp.asarray(
        v, jnp.bfloat16)).astype(jnp.float32)))
    ph.pv_check(ph.pv(torch.from_numpy(p), _port_bf16(v), H), ref)
    rounded = ph.pv_reference(torch.from_numpy(p).bfloat16().float(), _port_bf16(v), H)
    mean = float((rounded.float() - ref).abs().mean())
    assert mean > 10 * ph.PV_MEAN_RTOL * float(ref.abs().mean())
    with pytest.raises(RuntimeError, match="disagrees|strays"):
        ph.pv_check(rounded, ref)


def test_pack_pairs_is_the_script_layout():
    p = np.random.default_rng(3).normal(size=(2, 6, 5, 5)).astype(np.float32)
    want = np.concatenate([p[:, 0::2], p[:, 1::2]], axis=-1)
    np.testing.assert_array_equal(ph.pack_pairs(torch.from_numpy(p)).numpy(), want)


@pytest.mark.parametrize("B,T,H", SHAPES)
def test_packed_equals_per_head_on_the_cpu(B, T, H):
    # the script's own checks (:214-235), on the port
    q, k, v, p = (torch.from_numpy(x) for x in _draw(B, T, H, seed=11))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    s1, s2 = ph.qk_scores(q, k, H), ph.qk_scores(q, k, H, packed=True)
    for h in range(H):
        seg = s2[:, h // 2, :, (h % 2) * T:(h % 2 + 1) * T]
        torch.testing.assert_close(seg, s1[:, h], rtol=1e-4, atol=1e-4)
    p_r = p.bfloat16().float()
    o1, o2 = ph.pv(p_r, v, H), ph.pv(ph.pack_pairs(p_r), v, H, packed=True)
    torch.testing.assert_close(o1.float(), o2.float(), rtol=2e-2, atol=2e-2)


def test_cpu_path_is_the_plain_version_and_counts_nothing():
    q, k, v, p = (torch.from_numpy(x) for x in _draw(2, 17, 4, seed=0))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    before = [getattr(*count) for _, _, count, _ in ph.KERNELS.values()]
    args = {"qk_scores": (q, k), "qk_scores_packed": (q, k), "pv": (p, v),
            "pv_packed": (ph.pack_pairs(p), v)}
    for name, (fn, plain, _, _) in ph.KERNELS.items():
        assert torch.equal(fn(*args[name], 4), plain(*args[name], 4)), name
    assert [getattr(*count) for _, _, count, _ in ph.KERNELS.values()] == before


def _meta_view(shape, offset):
    """A contiguous bf16 meta tensor of `shape` that starts `offset` elements
    into its storage (meta tensors report the address it implies)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16, device="meta")[offset:].view(*shape)


@pytest.mark.parametrize("operand", ["q", "k", "v"])
def test_wrapper_refuses_bf16_operands_the_tma_cannot_address(operand, monkeypatch):
    # q, k and v reach the kernels by tensor maps: off the CPU each must start
    # 16-byte aligned. The wrapper raises, naming the operand, before it loads
    # or launches anything (a stub library fails the test if reached); a view
    # two elements in (4 bytes) is refused, the same shape aligned reaches the
    # device check (no kernel for meta)
    def no_library():
        raise AssertionError("the wrapper reached the library")

    monkeypatch.setattr(ph, "_library", no_library)
    shape, H = (2, 5, 2 * 64), 2
    p = torch.zeros(2, H, 5, 5, device="meta")
    ops = {name: _meta_view(shape, 2 if name == operand else 0) for name in "qkv"}
    with pytest.raises(ValueError, match=f"{operand}'s base address 0x4 is not 16-byte aligned"):
        if operand == "v":
            ph.pv(p, ops["v"], H)
        else:
            ph.qk_scores(ops["q"], ops["k"], H)
    with pytest.raises(ValueError, match="kernel for device meta"):
        ph.pv(p, _meta_view(shape, 0), H) if operand == "v" else ph.qk_scores(
            _meta_view(shape, 0), _meta_view(shape, 0), H)
    # p may start at any 4-byte boundary: a p one float in reaches the device check
    p1 = torch.zeros(2 * H * 25 + 1, device="meta")[1:].view(2, H, 5, 5)
    with pytest.raises(ValueError, match="no pv kernel for device meta"):
        ph.pv(p1, _meta_view(shape, 0), H)


def test_kernel_resources_reads_the_library(monkeypatch):
    seen = []

    class Lib:
        def bvt_packed_heads_resources(self, kernel, packed, out):
            seen.append((kernel, packed))
            out[0], out[1], out[2], out[3], out[4] = 232448, 1, 71, 0, 288
            return 0

    monkeypatch.setattr(ph, "_library", Lib)
    r = ph.kernel_resources("qk_scores_packed", device=-1)
    assert r == {"body": "wgmma", "smem_bytes": 232448, "blocks_per_sm": 1, "registers": 71,
                 "local_bytes": 0, "threads": 288}
    ph.kernel_resources("pv", device=-1)
    assert seen == [(ph.QK, 1), (ph.PV, 0)]


def test_qk_plan_reads_the_library(monkeypatch):
    class Lib:
        def bvt_qk_plan(self, T, packed, out):
            out[0], out[1], out[2] = (64, 1, 131600) if packed else (64, 2, 65808)
            return 0 if T < 50000 else 1

        def bvt_error_string(self, err):
            return b"invalid argument"

    monkeypatch.setattr(ph, "_library", Lib)
    assert ph.qk_plan(257) == {"rows": 64, "buffers": 2, "pitch": 65808}
    assert ph.qk_plan(257, packed=True) == {"rows": 64, "buffers": 1, "pitch": 131600}
    with pytest.raises(RuntimeError, match="qk plan at T = 60000 launch failed"):
        ph.qk_plan(60000)


def test_compare_builds_packed_has_no_cpu_mode(tmp_path, capsys):
    # --packed builds two trees' packed_heads.cu and times them on the card
    # only: without a CUDA device it raises before it builds anything
    from bayesvlm_tpu_torch.probes import compare_builds

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--a", str(tmp_path), "--b", str(tmp_path), "--packed"]
    assert compare_builds.parse_args(argv).packed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare_builds.main(argv)
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        compare_builds.parse_args(argv + ["--gemm"])


def test_compare_builds_checks_the_shapes_chip_smoke_checks():
    # compare_builds --packed holds both trees at chip_smoke.py's shapes, the
    # probe's first (the one it times)
    import importlib.util

    from bayesvlm_tpu_torch.probes import compare_builds

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert compare_builds.PACKED_SHAPES == smoke.PACKED_SHAPES
    assert next(iter(smoke.PACKED_SHAPES.values())) == (80, 257, 16)


def test_what_the_kernels_cannot_take_raises():
    q = torch.zeros(2, 5, 3 * 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="even head count"):
        ph.qk_scores(q, q, 3, packed=True)
    with pytest.raises(ValueError, match="even head count"):
        ph.pv(torch.zeros(2, 1, 5, 10), q, 3, packed=True)
    with pytest.raises(ValueError, match="head dim 64, not 32"):
        ph.qk_scores(q, q, 6)
    with pytest.raises(ValueError, match="bfloat16"):
        ph.qk_scores(q.float(), q.float(), 3)
    with pytest.raises(ValueError, match="float32 p of shape"):
        ph.pv(torch.zeros(2, 3, 5, 5, dtype=torch.bfloat16), q, 3)
    with pytest.raises(ValueError, match="float32 p of shape"):
        ph.pv(torch.zeros(2, 3, 5, 6), q, 3)
    with pytest.raises(ValueError, match="one device"):
        ph.qk_scores(q, q.to("meta"), 3)
    with pytest.raises(ValueError, match="no qk_scores kernel for device meta"):
        ph.qk_scores(q.to("meta"), q.to("meta"), 3)


def test_bounds_count_the_function_not_the_kernel():
    # the probe's shape: every kernel moves the 338 MB fp32 tensor and the
    # bf16 operands once (0.126 ms); the operations are the function's
    # products at the bf16 rate, twice for the packed forms (the zero half)
    from bayesvlm_tpu_torch.probes import probe_packed_heads as pph

    b = pph.bounds((pph.B, pph.T, pph.H))
    assert all(r["bound_by"] == "bytes" and abs(r["bound_ms"] - 0.1261) < 1e-4
               and r["bytes"] == 338_170_880 + 84_213_760 for r in b.values())
    dots = 2 * pph.B * pph.H * pph.T ** 2 * ph.HEAD_DIM
    assert {name: r["ops"] for name, r in b.items()} == {
        "qk_scores": dots, "qk_scores_packed": 2 * dots, "pv": dots, "pv_packed": 2 * dots}


def test_device_alone_chooses_the_shape():
    from bayesvlm_tpu_torch.probes import probe_packed_heads as pph

    assert pph.probe_shape("cpu") == pph.CPU_SHAPE
    assert pph.probe_shape("cuda") == (pph.B, pph.T, pph.H) == (80, 257, 16)
    assert pph.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        pph.parse_args(["--batch", "4"])


def test_probe_main_runs_on_the_cpu(capsys):
    from bayesvlm_tpu_torch.probes import probe_packed_heads

    assert probe_packed_heads.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "qk packed == per-head: OK" in text and "pv packed == per-head: OK" in text
    for label in ("qk per-head", "qk packed", "pv per-head", "pv packed"):
        assert f"{label}" in text
    assert "qk+pv fraction of full kernel: not measured" in text
    # no time off the card
    assert "not measured" in text and " ms  plain" not in text


# -- the kernels on the card ---------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ph.KERNELS))
@pytest.mark.parametrize("B,T,H", [(4, 17, 2), (3, 50, 12), (2, 257, 16), (1, 1, 2),
                                   (2, 64, 4), (2, 65, 4), (2, 63, 4), (3, 300, 2),
                                   (16, 257, 16), (2, 577, 4)])
def test_kernel_matches_plain_on_card(cuda, name, B, T, H):
    # T mod 4 = 0 (64, 300), 1 (17, 65, 257, 577), 2 (50), 3 (63): every
    # per-head row alignment, and T odd and even packed; T = 1, and a last
    # strip of one row (65, 257, 577); 16 x 257 x 16 gives each persistent
    # block several strips; 300 and 577 take two p chunks a side, 577 qk
    # strips of fewer than 64 rows packed and one staging buffer per head
    gen = torch.Generator(device=cuda).manual_seed(T + H)
    q, k, v = (torch.randn(B, T, H * 64, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    p = torch.randn(B, H, T, T, generator=gen, device=cuda)
    fn, plain, (owner, count), _ = ph.KERNELS[name]
    x, y = ((q, k) if name.startswith("qk") else
            (ph.pack_pairs(p).contiguous() if name.endswith("packed") else p, v))
    before = getattr(owner, count)
    out = fn(x, y, H)
    torch.cuda.synchronize()
    assert getattr(owner, count) == before + 1
    ref = plain(x, y, H)
    if name.startswith("qk"):
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    else:
        ph.pv_check(out, ref)


@pytest.mark.cuda
def test_block_resources_on_card(cuda):
    # qk: the whole opt-in shared memory (key ring, q slots, the packed zero
    # tile, the rest staging), one block an SM; pv: the v ring, the output
    # boxes (and the packed zero region) and one p chunk of 64 rows of
    # 1,104 bytes, two blocks an SM
    want = {"qk_scores": (232448, 1), "qk_scores_packed": (232448, 1), "pv": (112704, 2),
            "pv_packed": (114752, 2)}
    for name, (smem, blocks) in want.items():
        r = ph.kernel_resources(name)
        assert (r["smem_bytes"], r["blocks_per_sm"]) == (smem, blocks), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ph.KERNELS))
def test_kernel_resources_on_card(cuda, name):
    """Threads, registers, shared memory and local memory: 288 threads (two
    consumer warpgroups and a producer warp) for qk, 160 (one consumer
    warpgroup and a producer warp) for pv; no local memory (no spill);
    registers and shared memory within an SM for the blocks it holds."""
    r = ph.kernel_resources(name)
    blocks = 1 if name.startswith("qk") else 2
    assert r["body"] == "wgmma" and r["blocks_per_sm"] == blocks
    assert r["threads"] == (288 if name.startswith("qk") else 160)
    assert r["local_bytes"] == 0
    assert 0 < r["registers"] * r["threads"] * blocks <= 65536
    assert blocks * (r["smem_bytes"] + 1024) <= 233472


@pytest.mark.cuda
def test_qk_plan_on_card(cuda):
    # two 64-row strips in flight per head at T = 257, one packed; fewer rows
    # where one 64-row strip no longer fits; a T past one row raises
    assert ph.qk_plan(257) == {"rows": 64, "buffers": 2, "pitch": 65808}
    assert ph.qk_plan(257, packed=True) == {"rows": 64, "buffers": 1, "pitch": 131600}
    assert ph.qk_plan(153, packed=True)["buffers"] == 2
    assert ph.qk_plan(577) == {"rows": 64, "buffers": 1, "pitch": 147728}
    assert ph.qk_plan(577, packed=True)["rows"] == 34
    with pytest.raises(RuntimeError, match="qk plan"):
        ph.qk_plan(50000)


def _operands(cuda, B, T, H, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(B, T, H * 64, generator=gen, device=cuda).bfloat16()
               for _ in range(3))
    return q, k, v, torch.randn(B, H, T, T, generator=gen, device=cuda)


@pytest.mark.cuda
def test_bases_not_16_byte_aligned_on_card(cuda):
    # a q, k or v view 4 bytes in is refused (the TMA's rule); a p view 4, 8
    # or 12 bytes in is read by the widened copies, and right
    B, T, H = 2, 65, 4
    q, k, v, p = _operands(cuda, B, T, H, 5)

    def shifted(x, elems):
        buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)
        view = buf[elems:elems + x.numel()].view(x.shape)
        view.copy_(x)
        return view

    for name, args in (("q", (shifted(q, 2), k)), ("k", (q, shifted(k, 2)))):
        with pytest.raises(ValueError, match=f"{name}'s base address"):
            ph.qk_scores(*args, H)
    with pytest.raises(ValueError, match="v's base address"):
        ph.pv(p, shifted(v, 2), H)
    for elems in (1, 2, 3):
        for packed, x in ((False, p), (True, ph.pack_pairs(p).contiguous())):
            xs = shifted(x, elems)
            assert xs.data_ptr() % 16 == 4 * elems
            ph.pv_check(ph.pv(xs, v, H, packed=packed), ph.pv_reference(x, v, H, packed))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [65, 66])
def test_nan_past_a_rows_keys_never_reaches_its_output_on_card(cuda, T):
    # a widened window runs past its row's last key into the next row's: NaN
    # there must not reach the row's output. NaN at key 0 of the odd rows
    # poisons those rows (as in plain; packed, both halves: the zero
    # products take 0 * NaN, as the TPU body's block-diagonal V' does) and
    # sits just past the even rows' windows (packed: past head 2p+1's)
    B, H = 2, 4
    _, _, v, p = _operands(cuda, B, T, H, 7)
    for packed in (False, True):
        x = ph.pack_pairs(p).contiguous() if packed else p.clone()
        x[..., 1::2, 0] = float("nan")
        out, ref = ph.pv(x, v, H, packed=packed), ph.pv_reference(x, v, H, packed)
        torch.cuda.synchronize()
        assert torch.equal(out.isnan(), ref.isnan())
        keep = ~ref.isnan()
        assert float(keep.float().mean()) == pytest.approx((T + 1) // 2 / T)  # even rows
        ph.pv_check(torch.where(keep, out, 0), torch.where(keep, ref, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("elems", [0, 1])
def test_nan_past_the_tensor_never_reaches_the_output_on_card(cuda, elems):
    # p ends 8 bytes past a 16-byte boundary (B H T^2 = 2 mod 4), or 12 when
    # its base is 4 bytes in: the last row's window is clamped there and its
    # last floats read by plain loads; the NaN after the tensor is never read
    B, T, H = 1, 65, 2
    _, _, v, p = _operands(cuda, B, T, H, 9)
    for packed, x in ((False, p), (True, ph.pack_pairs(p).contiguous())):
        buf = torch.full((x.numel() + 16,), float("nan"), device=cuda)
        xs = buf[elems:elems + x.numel()].view(x.shape)
        xs.copy_(x)
        assert (xs.data_ptr() + 4 * x.numel()) % 16 != 0
        out = ph.pv(xs, v, H, packed=packed)
        torch.cuda.synchronize()
        assert not out.isnan().any()
        ph.pv_check(out, ph.pv_reference(x, v, H, packed))


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take_on_card(cuda):
    q = torch.zeros(2, 5, 3 * 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="even head count"):
        ph.qk_scores(q, q, 3, packed=True)
    with pytest.raises(ValueError, match="contiguous"):
        ph.qk_scores(q[:, :, :128], q[:, :, :128], 2)
    with pytest.raises(ValueError, match="one device"):
        ph.pv(torch.zeros(2, 3, 5, 5), q, 3)
