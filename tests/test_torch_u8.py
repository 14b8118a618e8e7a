"""The port's uint8 ingest lane against the JAX package's, on the CPU: the
`*_uint8` transforms give JAX's crops byte for byte; the port's encoder
on a uint8 batch equals, bit for bit, its encoder on the host-normalised
float of the same images (the device normalisation is the host
transform's arithmetic: x / 255, then (x - mean) / std, true divisions),
and matches JAX's uint8 lane at the towers' tolerance
(test_torch_towers.py: rtol 2e-3 / atol 2e-4, the same contract in
another framework's kernels); and the Stage-1 CLI with `--u8_pipeline`
against the JAX CLI with it (tests/test_u8_pipeline.py:108), factors at
test_torch_stage1.py's tolerances."""

import io
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bayesvlm_tpu.data.transforms as jax_transforms
import bayesvlm_tpu.models as jax_models
import bayesvlm_tpu.models.encoders as jax_encoders
from bayesvlm_tpu.io.torch_compat import load_pt_array
from bayesvlm_tpu_torch import hessian_estimation
from bayesvlm_tpu_torch.data import transforms
from bayesvlm_tpu_torch.models import load_model
from bayesvlm_tpu_torch.models.bridge import save_weights

TOWER_RTOL, TOWER_ATOL = 2e-3, 2e-4
FACTOR_RTOL, FACTOR_ATOL = 1e-4, 1e-5


def _pil(rng, w, h):
    return Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8), "RGB")


@pytest.mark.parametrize("family", ["clip", "siglip"])
@pytest.mark.parametrize("size", [(37, 53), (64, 40), (16, 16)])
def test_uint8_transforms_match_jax_byte_for_byte(family, size):
    rng = np.random.default_rng(size[0])
    img = _pil(rng, *size)
    for image_size in (16, 24):
        ours = transforms.get_transform_uint8(family, image_size)(img)
        theirs = jax_transforms.get_transform_uint8(family, image_size)(img)
        assert ours.dtype == np.uint8 and ours.shape == (image_size, image_size, 3)
        np.testing.assert_array_equal(ours, theirs)
        # the float transform is the normalised uint8 crop, exactly
        mean, std = transforms.NORMALIZATION_BY_FAMILY[family]
        np.testing.assert_array_equal(
            transforms.get_transform(family, image_size)(img),
            transforms._normalize(ours.astype(np.float32) / 255.0, mean, std))
    named = {"clip": transforms.default_transform_uint8,
             "siglip": transforms.siglip_transform_uint8}[family]
    np.testing.assert_array_equal(named(16)(img), transforms.get_transform_uint8(family, 16)(img))


@pytest.fixture(scope="module", params=["tiny-clip", "tiny-siglip"])
def towers(request, tmp_path_factory):
    """JAX's fp32 seed-0 image tower and the port's, on the bridged weights."""
    model = request.param
    j_img, j_txt, _ = jax_models.load_model(model, dtype=jnp.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp_path_factory.mktemp(f"u8_{model}"), to_np(j_img.params),
                      to_np(j_txt.params))
    t_img, _, _ = load_model(model, weights_dir=wd, dtype=torch.float32, device="cpu")
    return j_img, t_img


def _batches(family, image_size, n=3, seed=1):
    rng = np.random.default_rng(seed)
    imgs = [_pil(rng, 48, 40) for _ in range(n)]
    u8 = np.stack([transforms.get_transform_uint8(family, image_size)(im) for im in imgs])
    flt = np.stack([transforms.get_transform(family, image_size)(im) for im in imgs])
    return u8, flt


def test_encoder_uint8_equals_host_normalised_float(towers):
    _, t_img = towers
    cfg = t_img.config
    u8, flt = _batches(cfg.family, cfg.vision.image_size)
    a, b = t_img(u8), t_img(flt)
    for field in ("embeds", "activations", "residuals"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    # NCHW uint8 takes the same lane
    assert torch.equal(t_img(u8.transpose(0, 3, 1, 2)).embeds, a.embeds)
    # the lane normalises exactly as the host float transform does
    assert torch.equal(t_img.normalize(torch.from_numpy(u8)), torch.from_numpy(flt))
    x = torch.from_numpy(flt)
    assert t_img.normalize(x) is x


def test_encoder_uint8_matches_jax_uint8_lane(towers):
    j_img, t_img = towers
    cfg = t_img.config
    u8, _ = _batches(cfg.family, cfg.vision.image_size, seed=2)
    ours, theirs = t_img(u8), j_img(jnp.asarray(u8))
    for field in ("embeds", "activations"):
        np.testing.assert_allclose(getattr(ours, field).numpy(),
                                   np.asarray(getattr(theirs, field)),
                                   rtol=TOWER_RTOL, atol=TOWER_ATOL, err_msg=field)


def test_encoder_refuses_integer_pixels_other_than_uint8():
    img, _, _ = load_model("tiny-clip", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="uint8 or normalized floats"):
        img(np.zeros((1, 32, 32, 3), np.int32))


def _make_laion(base, n_shards=2, per_shard=12):
    (base / "laion400m").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for s in range(n_shards):
        with tarfile.open(base / "laion400m" / f"{s:05d}.tar", "w") as tf:
            for i in range(per_shard):
                gid = s * per_shard + i
                buf = io.BytesIO()
                _pil(rng, 40, 40).save(buf, "JPEG", quality=95)
                for name, data in ((f"{gid:09d}.jpg", buf.getvalue()),
                                   (f"{gid:09d}.txt", f"caption {gid}".encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))


def test_stage1_cli_u8_pipeline_matches_jax(tmp_path, monkeypatch):
    """`hessian_estimation.main(u8_pipeline=True)` against the JAX CLI's
    `main(u8_pipeline=True)` on the same tars, tiny-clip in fp32 (the JAX
    CLI's loader and GEMM cast patched to fp32, as in
    test_torch_stage1.py), the port carrying the JAX towers' seed-0
    weights. A and lambda at the factors' tolerance; B, a difference of
    terms far larger than itself at CLIP's logit scale, at 1e-4 of max |B|
    (test_torch_stage1.py)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import hessian_estimation as jax_cli

    from bayesvlm_tpu_torch.io.artifacts import load_info

    _make_laion(tmp_path / "data")
    monkeypatch.setenv("DATA_BASE_DIR", str(tmp_path / "data"))
    load = jax_models.load_model
    monkeypatch.setattr(jax_models, "load_model",
                        lambda *a, **k: load(*a, **{**k, "dtype": jnp.float32}))
    monkeypatch.setattr(jax_encoders, "cast_gemm_params", lambda params, *a, **k: params)
    j_img, j_txt, _ = load("tiny-clip", dtype=jnp.float32, seed=0)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp_path / "weights", to_np(j_img.params), to_np(j_txt.params))
    kw = dict(dataset="laion400m", model_str="tiny-clip", precompute_batch_size=8,
              la_num_classes=16, la_batch_size=4, num_workers=1, num_files=2,
              max_datapoints=24, lambda_init_txt=10.0, lambda_init_img=10.0,
              n_init_txt=1.0, n_init_img=1.0, lr=1e-2, num_steps=20, u8_pipeline=True)
    jax_cli.main(hessian_dir=str(tmp_path / "jax"), use_mesh=False, **kw)
    from bayesvlm_tpu_torch.models.encoders import ImageEncoder

    seen, forward = [], ImageEncoder.forward_pixels
    monkeypatch.setattr(ImageEncoder, "forward_pixels",
                        lambda self, x: seen.append(x.dtype) or forward(self, x))
    hessian_estimation.main(hessian_dir=str(tmp_path / "port"), weights_dir=str(wd),
                            device="cpu", dtype="fp32", **kw)
    assert seen and set(seen) == {torch.uint8}
    for f in ("A_img", "B_img", "A_txt", "B_txt"):
        theirs = np.asarray(load_pt_array(tmp_path / "jax" / f"{f}_analytic.pt"))
        ours = torch.load(tmp_path / "port" / f"{f}_analytic.pt").numpy()
        if f.startswith("A"):
            np.testing.assert_allclose(ours, theirs, rtol=FACTOR_RTOL, atol=FACTOR_ATOL,
                                       err_msg=f)
        else:
            assert np.abs(ours - theirs).max() <= FACTOR_RTOL * np.abs(theirs).max(), f
    info, jinfo = load_info(tmp_path / "port"), load_info(tmp_path / "jax")
    for key in ("lambda_img", "lambda_txt"):
        assert info[key] == pytest.approx(jinfo[key], rel=1e-4)
    # the float lane's image features are the uint8 lane's, bit for bit
    float_dir = tmp_path / "port_float"
    hessian_estimation.main(hessian_dir=str(float_dir), weights_dir=str(wd),
                            device="cpu", dtype="fp32", **{**kw, "u8_pipeline": False})
    for f in ("embeddings_img", "activations_img"):
        assert torch.equal(torch.load(tmp_path / "port" / f"{f}.pt"),
                           torch.load(float_dir / f"{f}.pt")), f
