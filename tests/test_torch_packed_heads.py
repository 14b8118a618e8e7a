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
                                   (2, 64, 4), (2, 65, 4)])
def test_kernel_matches_plain_on_card(cuda, name, B, T, H):
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
    # qk: the q tile, two key tiles (rows of 144 / 272 bytes) and the fp32
    # staging tile; pv: two stages of the fp32 p tile and the v tile
    want = {"qk_scores": 46080, "qk_scores_packed": 70656, "pv": 29696,
            "pv_packed": 37888}
    for name, smem in want.items():
        got, blocks = ph.block_resources(name)
        assert got == smem and blocks >= 1, name


@pytest.mark.cuda
def test_kernels_refuse_what_they_cannot_take_on_card(cuda):
    q = torch.zeros(2, 5, 3 * 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="even head count"):
        ph.qk_scores(q, q, 3, packed=True)
    with pytest.raises(ValueError, match="contiguous"):
        ph.qk_scores(q[:, :, :128], q[:, :, :128], 2)
    with pytest.raises(ValueError, match="one device"):
        ph.pv(torch.zeros(2, 3, 5, 5), q, 3)
