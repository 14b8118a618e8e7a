"""The port's Stage-1 GGN against the JAX package's on the same seeded
numpy inputs, on the CPU: `hessian_infonce` and `hessian_siglip` (blocked,
target-chunked, row-masked, "high" precision), `activation_gram`, and
`kfac_ggn` with its step checkpoints (bit-equal resume, stale and
unreadable directories). Tolerances are those of tests/test_hessians.py:
rtol 1e-4, atol 1e-5 (the "high" bound 1e-3 of the max, as JAX's
test_infonce_precision_high_close_to_highest)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesvlm_tpu_torch.bayes.estimation as est
from bayesvlm_tpu.bayes import estimation as jax_est
from bayesvlm_tpu.bayes import hessians as jax_h
from bayesvlm_tpu.bayes.kfac import KroneckerFactorizedCovariance as JaxKFC
from bayesvlm_tpu.bayes.prior import l2_norm_squared as jax_l2
from bayesvlm_tpu.bayes.prior import param_count as jax_param_count
from bayesvlm_tpu.utils import get_likelihood as jax_get_likelihood
from bayesvlm_tpu_torch.bayes import hessians as h
from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.bayes.prior import l2_norm_squared, param_count
from bayesvlm_tpu_torch.utils import get_likelihood, get_likelihood_for_model

RTOL, ATOL = 1e-4, 1e-5
HIGH_TOL = 1e-3


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _pairs(B, C, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(C, D)).astype(np.float32),
            rng.integers(0, C, size=B).astype(np.int32))


@pytest.mark.parametrize("B,C,D", [(1, 7, 4), (24, 31, 8), (64, 64, 16)])
@pytest.mark.parametrize("block_size", [None, 5])
def test_hessian_infonce_matches_jax(B, C, D, block_size):
    x, y, _ = _pairs(B, C, D)
    ref = jax_h.hessian_infonce(x, y, 2.0, block_size=block_size)
    got = h.hessian_infonce(x, y, 2.0, block_size=block_size)
    assert got.dtype == torch.float32 and got.shape == (D, D)
    _close(got, ref)
    assert torch.equal(got, got.T)


def test_infonce_at_clip_scale_as_close_to_float64_as_jax():
    """At CLIP's logit scale (4.6052, e^s ~ 100) B is a difference of terms
    ~1e4 times larger than itself, so fp32 carries ~4e-5 of max |B| in
    both packages: the port's B is no farther from the float64 evaluation
    of the formula than JAX's (within 2x), and within 1e-4 of max |B| of
    JAX's. (tests/test_hessians.py's rtol 1e-4 holds at scale 2.0, above.)"""
    x, y, _ = _pairs(16, 16, 16, seed=11)
    ref = h._hessian_infonce(torch.from_numpy(x).double(), torch.from_numpy(y).double(),
                             torch.tensor(4.6052, dtype=torch.float64), 3).numpy()
    ours = h.hessian_infonce(x, y, 4.6052, block_size=3).numpy()
    theirs = np.asarray(jax_h.hessian_infonce(x, y, 4.6052, block_size=3))
    err, jax_err = np.abs(ours - ref).max(), np.abs(theirs - ref).max()
    assert err <= 2 * jax_err
    assert np.abs(ours - theirs).max() <= RTOL * np.abs(theirs).max()


def test_siglip_at_siglip_bias_close_to_float64():
    """At SigLIP's scale and bias (4.7651, -16.5) and siglip-large's width
    the negatives' sigmoid lies within an ulp of 1: the port's pair
    weight sig(t) sig(-t) keeps B within 1e-5 of max |B| of the float64
    evaluation, where JAX's sig (1 - sig) is ~1e-4 off."""
    x, y, _ = _pairs(512, 512, 1024, seed=13)
    idx = np.arange(512)
    ref = h._hessian_siglip(
        torch.from_numpy(x).double(), torch.from_numpy(idx), torch.from_numpy(y).double(),
        torch.tensor(4.7651, dtype=torch.float64), torch.tensor(-16.5, dtype=torch.float64),
        256, 300).numpy()
    ours = h.hessian_siglip(x, idx, y, 4.7651, -16.5, block_size=256,
                            chunk_size_j=300).numpy()
    theirs = np.asarray(jax_h.hessian_siglip(x, idx.astype(np.int32), y, 4.7651, -16.5,
                                             block_size=256, chunk_size_j=300))
    scale = np.abs(ref).max()
    err, jax_err = np.abs(ours - ref).max() / scale, np.abs(theirs - ref).max() / scale
    assert err <= 1e-5
    assert jax_err > 10 * err


@pytest.mark.parametrize("B,N,D", [(12, 23, 6), (24, 31, 8)])
@pytest.mark.parametrize("block_size", [None, 5])
@pytest.mark.parametrize("chunk", [None, 4, 7, 23, 100])
def test_hessian_siglip_matches_jax(B, N, D, block_size, chunk):
    x, y, idx = _pairs(B, N, D, seed=7)
    ref = jax_h.hessian_siglip(x, idx, y, 1.2, -0.7, block_size=block_size,
                               chunk_size_j=chunk)
    got = h.hessian_siglip(x, idx, y, 1.2, -0.7, block_size=block_size,
                           chunk_size_j=chunk)
    _close(got, ref)
    assert torch.equal(got, got.T)


def _block_stats(pkg, likelihood, x, y, idx, mask):
    """(w, G) of one block in either package; y already normalized."""
    if likelihood == "info_nce":
        return pkg._infonce_block_stats(x, y, pkg_scalar(pkg, 2.0), row_mask=mask)
    return pkg._siglip_block_stats(x, idx, y, pkg_scalar(pkg, 1.2),
                                   pkg_scalar(pkg, -0.7), row_mask=mask, chunk_j=7)


def pkg_scalar(pkg, v):
    return torch.tensor(v) if pkg is h else jnp.float32(v)


@pytest.mark.parametrize("likelihood", ["info_nce", "siglip"])
def test_row_mask_zeroes_padded_rows(likelihood):
    """Rows padded with garbage and mask 0 give the unpadded statistics,
    in the port as in JAX (sharded accumulation pads to the device count)."""
    x, y, idx = _pairs(13, 19, 6, seed=3)
    yn = y / np.linalg.norm(y, axis=-1, keepdims=True)
    pad = 3
    xp = np.concatenate([x, np.zeros((pad, 6), np.float32)])  # 1/||0|| kept finite
    idx_p = np.concatenate([idx, np.zeros(pad, np.int32)])
    mask = np.concatenate([np.ones(13), np.zeros(pad)]).astype(np.float32)
    t = torch.from_numpy
    w0, G0 = _block_stats(h, likelihood, t(x), t(yn), t(idx).long(), None)
    w, G = _block_stats(h, likelihood, t(xp), t(yn), t(idx_p).long(), t(mask))
    assert torch.isfinite(G).all()
    _close(w, w0)
    _close(G, G0)
    jw, jG = _block_stats(jax_h, likelihood, xp, yn, idx_p, mask)
    _close(w, jw)
    _close(G, jG)


@pytest.mark.parametrize("bias", [False, True])
def test_activation_gram_matches_jax(bias):
    a = np.random.default_rng(2).normal(size=(10, 4)).astype(np.float32)
    got = h.activation_gram(a, append_bias_column=bias)
    assert got.shape == ((5, 5) if bias else (4, 4))
    _close(got, jax_h.activation_gram(a, append_bias_column=bias))


@pytest.mark.parametrize("likelihood", ["info_nce", "siglip"])
def test_precision_high_close_to_highest(likelihood):
    """3xTF32 ("high") within 1e-3 of the max of the fp32 factor, and the
    process setting untouched after it."""
    x, y, idx = _pairs(64, 64, 16, seed=5)
    if likelihood == "info_nce":
        def run(p):
            return h.hessian_infonce(x, y, 2.0, precision=p)
    else:
        def run(p):
            return h.hessian_siglip(x, idx, y, 2.0, -0.5, precision=p, chunk_size_j=23)
    before = torch.get_float32_matmul_precision()
    hi, high = run("highest"), run("high")
    assert torch.get_float32_matmul_precision() == before
    assert float((high - hi).abs().max() / hi.abs().max()) < HIGH_TOL


def test_tf32_split_is_exact():
    """hi keeps 10 mantissa bits (exact in TF32) and hi + lo == x."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(257,)).astype(np.float32))
    hi, lo = h._tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float((lo / x).abs().max()) < 2.0 ** -10


def test_precision_scope_restored_on_error():
    """A body that raises leaves the process matmul precision as it was
    (JAX's test_siglip_precision_scope_restored_on_error); an unknown
    precision is refused."""
    x, idx = np.ones((4, 5), np.float32), np.zeros(4, np.int32)
    y_bad = np.ones((3, 7), np.float32)  # D mismatch: 5 vs 7
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with pytest.raises(RuntimeError):
            h.hessian_siglip(x, idx, y_bad, 0.5, -0.5, precision="high")
        with pytest.raises(RuntimeError):
            h.hessian_infonce(x, y_bad, 0.5, precision="high")
        assert torch.get_float32_matmul_precision() == "medium"
        with pytest.raises(ValueError, match="precision"):
            h.hessian_infonce(x, x, 0.5, precision="medium")
    finally:
        torch.set_float32_matmul_precision(prev)


# -- kfac_ggn -------------------------------------------------------------------


def _ggn_inputs(n=32, d=8, p=6, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, p)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _ggn_kw(likelihood, num_classes=8):
    src, act, tgt = _ggn_inputs()
    return dict(logit_scale=0.3, logit_bias=-0.4, num_classes=num_classes,
                source_embeds=src, source_activations=act, target_embeds=tgt,
                likelihood=likelihood, block_size=3, chunk_size_j=5)


@pytest.mark.parametrize("likelihood", ["info_nce", "siglip"])
@pytest.mark.parametrize("num_classes", [8, 12])  # 12: 4 rows left over
def test_kfac_ggn_matches_jax(likelihood, num_classes):
    kw = _ggn_kw(likelihood, num_classes)
    A_ref, B_ref = jax_est.kfac_ggn(**kw)
    A, B = est.kfac_ggn(**kw, device="cpu")
    assert A.dtype == B.dtype == torch.float32
    bias = likelihood == "siglip"
    assert A.shape == (6 + bias, 6 + bias) and B.shape == (8, 8)
    _close(A, A_ref)
    _close(B, B_ref)


@pytest.mark.parametrize("likelihood", ["info_nce", "siglip"])
def test_kfac_ggn_too_few_points(likelihood):
    kw = _ggn_kw(likelihood, num_classes=33)
    with pytest.raises(ValueError, match="Need at least 33 datapoints"):
        est.kfac_ggn(**kw, device="cpu")


def _crash_at(monkeypatch, name, k):
    """Make est.<name> raise on its k-th call (a preemption in class batch
    k); returns the call record."""
    orig = getattr(est, name)
    calls = {"n": 0}

    def fn(*a, **kw):
        calls["n"] += 1
        if calls["n"] == k:
            raise RuntimeError("simulated preemption")
        return orig(*a, **kw)

    monkeypatch.setattr(est, name, fn)
    return calls


@pytest.mark.parametrize("likelihood", ["info_nce", "siglip"])
def test_kfac_ggn_resume_is_bit_for_bit(likelihood, tmp_path, monkeypatch):
    kw = _ggn_kw(likelihood)  # 4 class batches
    # kfac_ggn's B factor of a class batch (one device: mesh None)
    fn = ("sharded_hessian_infonce" if likelihood == "info_nce"
          else "sharded_hessian_siglip")
    A_ref, B_ref = est.kfac_ggn(**kw, device="cpu")
    ckpt = tmp_path / "_ggn_steps_img"
    _crash_at(monkeypatch, fn, 4)
    with pytest.raises(RuntimeError, match="preemption"):
        est.kfac_ggn(**kw, checkpoint_dir=ckpt, device="cpu")
    # steps 1, 2, 3 were written; the latest two are kept
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000002.pt",
                                                      "step_00000003.pt"]
    monkeypatch.undo()
    calls = _crash_at(monkeypatch, fn, 0)  # count only
    A, B = est.kfac_ggn(**kw, checkpoint_dir=ckpt, device="cpu")
    assert calls["n"] == 1  # resumed at class batch 4 of 4
    assert torch.equal(A, A_ref) and torch.equal(B, B_ref)
    assert not ckpt.exists()  # removed on success


def _stale(ckpt, kw, monkeypatch):
    _crash_at(monkeypatch, "sharded_hessian_infonce", 2)
    with pytest.raises(RuntimeError):
        est.kfac_ggn(**kw, checkpoint_dir=ckpt, device="cpu")
    monkeypatch.undo()


@pytest.mark.parametrize("kind", ["num_classes", "orbax", "corrupt"])
def test_kfac_ggn_unusable_steps_restart(kind, tmp_path, monkeypatch):
    """A step from another configuration, a directory of the JAX
    package's orbax steps and an unreadable step file all warn and
    restart from class batch 0, giving the fresh run's factors."""
    kw = _ggn_kw("info_nce")
    ckpt = tmp_path / "steps"
    if kind == "num_classes":
        _stale(ckpt, {**kw, "num_classes": 4}, monkeypatch)
    elif kind == "orbax":
        (ckpt / "2" / "default").mkdir(parents=True)
        (ckpt / "2" / "default" / "_METADATA").write_text("{}")
    else:
        ckpt.mkdir()
        (ckpt / "step_00000002.pt").write_bytes(b"not a checkpoint")
    A_ref, B_ref = est.kfac_ggn(**kw, device="cpu")
    with pytest.warns(RuntimeWarning, match="restarting the accumulation"):
        A, B = est.kfac_ggn(**kw, checkpoint_dir=ckpt, device="cpu")
    assert torch.equal(A, A_ref) and torch.equal(B, B_ref)
    assert not ckpt.exists()


def test_kfac_ggn_empty_dir_starts_quietly(tmp_path):
    (tmp_path / "steps").mkdir()
    kw = _ggn_kw("info_nce")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        est.kfac_ggn(**kw, checkpoint_dir=tmp_path / "steps", device="cpu")


class _Mesh:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def test_kfac_ggn_mesh_must_be_one_device():
    """A mesh of one device is the single-device path; a mesh of more than
    one rank takes the sharded path (tests/test_torch_dist.py), which needs
    an initialised process group."""
    kw = _ggn_kw("info_nce")
    A, _ = est.kfac_ggn(**kw, mesh=_Mesh(1), device="cpu")
    assert torch.equal(A, est.kfac_ggn(**kw, device="cpu")[0])
    with pytest.raises(ValueError, match="process group"):
        est.kfac_ggn(**kw, mesh=_Mesh(4), device="cpu")
    with pytest.raises(ValueError, match="Invalid likelihood"):
        est.kfac_ggn(**{**kw, "likelihood": "hinge"}, device="cpu")


# -- helpers the CLI uses ---------------------------------------------------------


def test_prior_helpers_and_kfac_dims_match_jax():
    rng = np.random.default_rng(4)
    params = [rng.normal(size=s).astype(np.float32) for s in ((3, 5), (5,), (2, 2, 2))]
    assert float(l2_norm_squared([torch.from_numpy(p) for p in params])) == pytest.approx(
        float(jax_l2(params)), rel=1e-6)
    assert param_count([torch.from_numpy(p) for p in params]) == jax_param_count(params) == 28
    cov = KroneckerFactorizedCovariance(torch.eye(7), torch.eye(3))
    jcov = JaxKFC(jnp.eye(7), jnp.eye(3))
    assert (cov.input_dim, cov.output_dim) == (jcov.input_dim, jcov.output_dim) == (7, 3)


@pytest.mark.parametrize("name", ["clip", "siglip", "clip-large", "siglip-base",
                                  "tiny-clip", "tiny-siglip", "other"])
def test_get_likelihood_matches_jax(name):
    assert get_likelihood(name) == jax_get_likelihood(name)


def test_get_likelihood_refuses_bare_tiny():
    with pytest.raises(ValueError, match="ambiguous"):
        get_likelihood("tiny")
    assert get_likelihood_for_model("tiny-siglip") == "siglip"
