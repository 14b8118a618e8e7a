"""The port's Stage 1 end to end against the JAX package's, on the CPU:
the LAION webdataset lane (samples and batch order for num_workers 0, 2
and 3), `compute_features` (image and text, part-file resume, the caches
read both ways), and `bayesvlm_tpu_torch.hessian_estimation.main`
against `scripts/hessian_estimation.main` on the same tars with
tiny-clip and tiny-siglip in fp32 (the JAX CLI's tower loader patched to
fp32 inside the test). Factors within rtol 1e-4 / atol 1e-5, lambda
within rel 1e-4; the towers' features at test_torch_towers.py's 2e-3 /
2e-4."""

import io
import json
import shutil
import subprocess
import sys
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bayesvlm_tpu.models as jax_models
import bayesvlm_tpu.models.encoders as jax_encoders
from bayesvlm_tpu.data.laion400m import Laion400mDataModule as JaxLaion
from bayesvlm_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from bayesvlm_tpu.data.transforms import default_transform as jax_default_transform
from bayesvlm_tpu.data.wds import WebDataset as JaxWebDataset
from bayesvlm_tpu.inference.precompute import compute_features as jax_compute_features
from bayesvlm_tpu.io.artifacts import load_hessians as jax_load_hessians
from bayesvlm_tpu.io.torch_compat import load_pt_array
from bayesvlm_tpu_torch import hessian_estimation
from bayesvlm_tpu_torch.data.factory import DataModuleFactory
from bayesvlm_tpu_torch.data.laion400m import Laion400mDataModule
from bayesvlm_tpu_torch.data.tokenizer import HashTokenizer
from bayesvlm_tpu_torch.data.transforms import default_transform
from bayesvlm_tpu_torch.data.wds import NativeDecodeLoader, WebDataset
from bayesvlm_tpu_torch.inference.precompute import compute_features
from bayesvlm_tpu_torch.io.artifacts import (
    HessianArtifacts,
    load_covariances,
    load_hessians,
    load_info,
)
from bayesvlm_tpu_torch.models import load_model
from bayesvlm_tpu_torch.models.bridge import save_weights
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import hessian_estimation as jax_cli  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5           # the factors (tests/test_hessians.py)
TOWER_RTOL, TOWER_ATOL = 2e-3, 2e-4  # the towers' features (test_torch_towers.py)
TAR_SIZES = (10, 7, 12)
FACTORS = ("A_img", "B_img", "A_txt", "B_txt")


def _make_laion_tar(path, start, n):
    """LAION-style shard: {key}.jpg + {key}.txt, zero-padded numeric keys
    (tests/test_hessian_estimation_cli.py)."""
    with tarfile.open(path, "w") as tf:
        rng = np.random.default_rng(start)
        for i in range(start, start + n):
            img = Image.fromarray(rng.integers(0, 255, size=(40, 40, 3), dtype=np.uint8),
                                  "RGB")
            buf = io.BytesIO()
            img.save(buf, format="JPEG")
            for name, data in ((f"{i:09d}.jpg", buf.getvalue()),
                               (f"{i:09d}.txt", f"a photo number {i} of something".encode())):
                info = tarfile.TarInfo(name=name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def laion_base(tmp_path_factory):
    """DATA_BASE_DIR with a laion400m/ of three shards of 10, 7, 12 pairs."""
    base = tmp_path_factory.mktemp("data")
    (base / "laion400m").mkdir()
    start = 0
    for s, n in enumerate(TAR_SIZES):
        _make_laion_tar(base / "laion400m" / f"{s:05d}.tar", start, n)
        start += n
    return base


def _laion(cls, base, num_workers, transform, batch_size=4):
    dm = cls(data_dir=str(base / "laion400m"), batch_size=batch_size,
             num_workers=num_workers, train_transform=transform,
             test_transform=transform, shuffle_train=False)
    dm.setup()
    return dm


# -- the webdataset lane ------------------------------------------------------------


@pytest.mark.parametrize("shuffle_buffer", [0, 5])
def test_webdataset_samples_match_jax(laion_base, shuffle_buffer):
    tars = sorted((laion_base / "laion400m").glob("*.tar"))
    ours = list(WebDataset(tars, shuffle_buffer=shuffle_buffer, seed=3))
    theirs = list(JaxWebDataset(tars, shuffle_buffer=shuffle_buffer, seed=3,
                                use_native=False))
    assert len(ours) == sum(TAR_SIZES)
    assert ours == theirs
    assert [s["__key__"] for s in WebDataset(tars).shard_slice(1, 2)] == [
        f"{i:09d}" for i in range(10, 17)]


@pytest.mark.parametrize("num_workers", [0, 2, 3])
def test_laion_loader_matches_jax(laion_base, num_workers):
    """Batches, their order (round-robin over workers, drop_last per
    worker) and image_id = int(__key__) as the JAX package's."""
    ours = list(_laion(Laion400mDataModule, laion_base, num_workers,
                       default_transform(32)).test_dataloader())
    theirs = list(_laion(JaxLaion, laion_base, num_workers,
                         jax_default_transform(32)).test_dataloader())
    assert len(ours) == len(theirs) == {0: 7, 2: 6, 3: 6}[num_workers]
    for tb, jb in zip(ours, theirs):
        assert tb.keys() == jb.keys() == {"image", "text", "image_id"}
        np.testing.assert_array_equal(tb["image"], jb["image"])
        np.testing.assert_array_equal(tb["image_id"], jb["image_id"])
        assert tb["text"] == jb["text"]
        assert tb["image"].shape == (4, 32, 32, 3)
    ids = [int(i) for b in ours for i in b["image_id"]]
    assert sorted(ids) == ids if num_workers < 2 else len(set(ids)) == len(ids)


def test_laion_module_options(laion_base, tmp_path, monkeypatch):
    """DATA_BASE_DIR (or a .env in the working directory, or base_path)
    joined with laion400m/, sorted tars; subsets, few-shot and the native
    lane refused; no class prompts."""
    monkeypatch.delenv("DATA_BASE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text(f'# data\nDATA_BASE_DIR="{laion_base}"\n')
    dm = DataModuleFactory(batch_size=4).create("laion400m")
    assert dm.data_dir == laion_base / "laion400m"
    assert [Path(p).name for p in dm.data_path] == ["00000.tar", "00001.tar", "00002.tar"]
    assert dm.class_prompts == []
    other = DataModuleFactory(base_path=str(tmp_path)).create("laion400m")
    assert other.data_dir == tmp_path / "laion400m" and other.data_path == []
    assert DataModuleFactory().create("synthetic").data_dir == laion_base
    with pytest.raises(ValueError, match="Subset indices"):
        DataModuleFactory().create("laion400m", subset_indices=[0])
    with pytest.raises(ValueError, match="Few shot"):
        DataModuleFactory().create("laion400m", use_few_shot=True)
    # the native lane is taken: on the CPU through libjpeg, and without a
    # card the card's lane is refused by name
    dm.setup()
    dm.enable_native_decode(32, family="siglip", num_threads=3, out_uint8=True,
                            device="cpu")
    assert dm._native_decode == dict(image_size=32, num_threads=3, out_uint8=True,
                                     device="cpu", mean=(0.5, 0.5, 0.5),
                                     std=(0.5, 0.5, 0.5), square_resize=True)
    loader = dm.test_dataloader()
    assert isinstance(loader.loader, NativeDecodeLoader)
    batch = next(iter(loader))
    assert batch["image"].dtype == torch.uint8 and batch["image"].shape == (4, 32, 32, 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dm.enable_native_decode(32)


def test_data_lane_imports_no_pil():
    """The card machine has no PIL: the webdataset lane, the native decode
    lane, the factory and the CLI import without it."""
    code = ("import sys; import bayesvlm_tpu_torch.data.wds, "
            "bayesvlm_tpu_torch.data.native_io, "
            "bayesvlm_tpu_torch.data.laion400m, bayesvlm_tpu_torch.data.factory, "
            "bayesvlm_tpu_torch.hessian_estimation; assert 'PIL' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- compute_features -----------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_towers(tmp_path_factory):
    """tiny-clip in both packages (fp32, the JAX seed-0 weights bridged),
    with tokenizers; and the bridged weights directory."""
    j_img, j_txt, _ = jax_load_model_fp32("tiny-clip")
    wd = save_weights(tmp_path_factory.mktemp("weights"),
                      jax.tree_util.tree_map(np.asarray, j_img.params),
                      jax.tree_util.tree_map(np.asarray, j_txt.params))
    t_img, t_txt, _ = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32,
                                 device="cpu")
    cfg = CONFIGS_BY_NAME["tiny-clip"].text
    j_txt.tokenizer = JaxHashTokenizer(cfg.vocab_size, cfg.max_length,
                                       eos_id=cfg.eos_token_id)
    t_txt.tokenizer = HashTokenizer(cfg.vocab_size, cfg.max_length,
                                    eos_id=cfg.eos_token_id)
    return j_img, j_txt, t_img, t_txt


def jax_load_model_fp32(model):
    return jax_models.load_model(model, dtype=jnp.float32, seed=0)


class _Preempted(Exception):
    pass


def _stop_after(loader, k):
    """The loader's batches, then a preemption after the k-th."""
    for i, batch in enumerate(loader):
        if i == k:
            raise _Preempted
        yield batch


@pytest.mark.parametrize("modality", ["image", "text"])
def test_compute_features_match_jax_and_resume(clip_towers, laion_base, tmp_path,
                                               modality):
    j_img, j_txt, t_img, t_txt = clip_towers
    j_enc, t_enc = (j_img, t_img) if modality == "image" else (j_txt, t_txt)
    dm = _laion(Laion400mDataModule, laion_base, 0, default_transform(32))
    jdm = _laion(JaxLaion, laion_base, 0, jax_default_transform(32))

    j_act, j_emb = jax_compute_features(j_enc, jdm.test_dataloader(), tag="x",
                                        cache_dir=tmp_path / "jax", modality=modality)
    a_path, e_path = compute_features(t_enc, dm.test_dataloader(), tag="x",
                                      cache_dir=tmp_path / "ref", modality=modality)
    ref_act, ref_emb = torch.load(a_path), torch.load(e_path)
    assert ref_act.shape[0] == ref_emb.shape[0] == 28  # 7 batches of 4
    # the caches read both ways
    for ours, theirs in ((ref_act, j_act), (ref_emb, j_emb)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(load_pt_array(theirs)),
                                   rtol=TOWER_RTOL, atol=TOWER_ATOL)
    np.testing.assert_array_equal(np.asarray(load_pt_array(a_path)), ref_act.numpy())
    np.testing.assert_array_equal(torch.load(j_act).numpy(),
                                  np.asarray(load_pt_array(j_act)))

    # preempted after 5 batches with parts every 2: resumes after batch 4
    # and writes the uninterrupted run's caches
    cache = tmp_path / "resumed"
    with pytest.raises(_Preempted):
        compute_features(t_enc, _stop_after(dm.test_dataloader(), 5), tag="x",
                         cache_dir=cache, modality=modality, checkpoint_every=2)
    assert sorted(p.name for p in (cache / "_parts_x").iterdir()) == [
        "part_00000.npz", "part_00001.npz"]
    act, emb = compute_features(t_enc, dm.test_dataloader(), tag="x", cache_dir=cache,
                                modality=modality, checkpoint_every=2,
                                return_tensors=True)
    assert torch.equal(act, ref_act) and torch.equal(emb, ref_emb)
    assert not (cache / "_parts_x").exists()

    # a JAX-written part that ends mid-batch (11 rows) resumes too
    mid = tmp_path / "mid"
    (mid / "_parts_x").mkdir(parents=True)
    np.savez(mid / "_parts_x" / "part_00000.npz", activations=ref_act[:11].numpy(),
             embeddings=ref_emb[:11].numpy())
    act, emb = compute_features(t_enc, dm.test_dataloader(), tag="x", cache_dir=mid,
                                modality=modality, checkpoint_every=1,
                                return_tensors=True)
    assert torch.equal(act[:11], ref_act[:11])
    np.testing.assert_allclose(act.numpy(), ref_act.numpy(), rtol=1e-5, atol=1e-6)

    # a cache hit encodes nothing; without a cache_dir the tensors come back
    assert compute_features(None, [], tag="x", cache_dir=tmp_path / "ref") == (
        a_path, e_path)
    act, emb = compute_features(t_enc, dm.test_dataloader(), modality=modality)
    assert torch.equal(act, ref_act) and torch.equal(emb, ref_emb)


# -- the CLI --------------------------------------------------------------------------


CLI_KW = dict(dataset="laion400m", precompute_batch_size=4, la_num_classes=8,
              la_batch_size=3, num_workers=2, num_files=3, max_datapoints=20,
              siglip_chunk_size_j=5, lambda_init_txt=10.0, lambda_init_img=10.0,
              lr=1e-2, num_steps=30)


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_hessian_estimation_matches_jax(model, laion_base, tmp_path, monkeypatch):
    monkeypatch.setenv("DATA_BASE_DIR", str(laion_base))
    # the JAX CLI in fp32: its tower loader and GEMM cast patched here
    load = jax_models.load_model
    monkeypatch.setattr(jax_models, "load_model",
                        lambda *a, **k: load(*a, **{**k, "dtype": jnp.float32}))
    monkeypatch.setattr(jax_encoders, "cast_gemm_params", lambda params, *a, **k: params)
    j_img, j_txt, _ = jax_load_model_fp32(model)  # the JAX CLI's seed-0 towers
    wd = save_weights(tmp_path / "weights", jax.tree_util.tree_map(np.asarray, j_img.params),
                      jax.tree_util.tree_map(np.asarray, j_txt.params))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_cli.main(**CLI_KW, model_str=model, hessian_dir=str(jdir), use_mesh=False)
    run = hessian_estimation.main(**CLI_KW, model_str=model, hessian_dir=str(tdir),
                                  weights_dir=str(wd), device="cpu", dtype="fp32")
    assert set(run["seconds"]) == {"load", "img features", "txt features", "GGN img",
                                   "GGN txt", "lambda img", "lambda txt"}
    for f in ("activations_img", "embeddings_img", "activations_txt", "embeddings_txt",
              *(f"{n}_analytic" for n in FACTORS)):
        assert (tdir / f"{f}.pt").exists(), f
    assert not any(tdir.glob("_*"))  # no parts or step checkpoints left

    features = ("activations_img", "embeddings_img", "activations_txt", "embeddings_txt")
    for f in features:
        np.testing.assert_allclose(torch.load(tdir / f"{f}.pt").numpy(),
                                   np.asarray(load_pt_array(jdir / f"{f}.pt")),
                                   rtol=TOWER_RTOL, atol=TOWER_ATOL, err_msg=f)
    # the GGN and lambda on the same features: the JAX CLI's caches in a
    # fresh directory, which the port's CLI takes as cache hits
    same = tmp_path / "port_on_jax_features"
    same.mkdir()
    for f in features:
        shutil.copy(jdir / f"{f}.pt", same / f"{f}.pt")
    hessian_estimation.main(**CLI_KW, model_str=model, hessian_dir=str(same),
                            weights_dir=str(wd), device="cpu", dtype="fp32")
    for f in FACTORS:
        theirs = np.asarray(load_pt_array(jdir / f"{f}_analytic.pt"))
        for d in (same, tdir):
            ours = torch.load(d / f"{f}_analytic.pt").numpy()
            if f.startswith("A"):
                np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL, err_msg=f)
            else:
                # B at CLIP's logit scale (e^s ~ 100) is a difference of
                # terms ~1e4 times larger than itself: each package's fp32 B
                # is ~4e-5 of max |B| from the float64 evaluation, elementwise
                # beyond 1e-4 / 1e-5 (test_torch_hessians.py::
                # test_infonce_at_clip_scale_as_close_to_float64_as_jax), so
                # B is held at 1e-4 of its largest entry, the card's check
                assert np.abs(ours - theirs).max() <= RTOL * np.abs(theirs).max(), f
    info, jinfo, sinfo = load_info(tdir), load_info(jdir), load_info(same)
    for key in ("lambda_img", "lambda_txt"):
        assert info[key] == run[key] == pytest.approx(jinfo[key], rel=1e-4)
        assert sinfo[key] == pytest.approx(jinfo[key], rel=1e-4)
        assert info[key] != pytest.approx(10.0, rel=1e-2)
    assert info["n_img"] == jinfo["n_img"] == 1.0

    # each package reads the other's directory
    for tag in ("img", "txt"):
        A, B, tinfo = load_hessians(jdir, tag, return_info=True)
        jA, jB, jinfo2 = jax_load_hessians(tdir, tag, return_info=True)
        assert tinfo == jinfo and jinfo2 == info
        assert torch.equal(A, torch.load(jdir / f"A_{tag}_analytic.pt"))
        np.testing.assert_array_equal(np.asarray(jB), torch.load(
            tdir / f"B_{tag}_analytic.pt").numpy())
    cov_img, cov_txt, cinfo = load_covariances(tdir, return_info=True)
    assert cov_img.input_dim == torch.load(tdir / "A_img_analytic.pt").shape[0]
    assert cov_txt.output_dim == CONFIGS_BY_NAME[model].text.projection_dim
    assert cinfo == info and torch.isfinite(cov_img.B_inv).all()
    arts = HessianArtifacts(*(torch.load(tdir / f"{f}_analytic.pt") for f in FACTORS),
                            info)
    assert arts.B_txt.shape == cov_txt.B_inv.shape

    # a second run reuses the factors and the feature caches
    mtimes = {p.name: p.stat().st_mtime_ns for p in tdir.glob("*.pt")}
    hessian_estimation.main(**CLI_KW, model_str=model, hessian_dir=str(tdir),
                            weights_dir=str(wd), device="cpu", dtype="fp32")
    assert {p.name: p.stat().st_mtime_ns for p in tdir.glob("*.pt")} == mtimes


@pytest.fixture
def jax_native_lib(tmp_path, monkeypatch):
    """The JAX package's native library, built here by g++ (never `make -C
    native`, which the JAX tests run) and loaded from tmp_path."""
    if shutil.which("g++") is None or not Path("/usr/include/jpeglib.h").exists():
        pytest.skip("the JAX native lane needs g++ and libjpeg's jpeglib.h")
    from bayesvlm_tpu.data import native_io as jax_native_io

    sys.path.insert(0, str(REPO / "tests" / "torch_jpeg"))
    from make_fixtures import build_jax_reference

    (tmp_path / "jax_native").mkdir()
    monkeypatch.setattr(jax_native_io, "_LIB_PATH",
                        build_jax_reference(tmp_path / "jax_native"))
    monkeypatch.setattr(jax_native_io, "_lib", None)


@pytest.mark.parametrize("model,u8_pipeline", [("tiny-clip", False), ("tiny-siglip", True)])
def test_hessian_estimation_native_decode_matches_jax(model, u8_pipeline, laion_base,
                                                      tmp_path, monkeypatch,
                                                      jax_native_lib, capsys):
    """`main(native_decode=True)` against the JAX CLI's on the same tars,
    fp32 crops (CLIP: centre crop) and uint8 crops (SigLIP: square resize,
    normalised by the encoder): the same printed line, the features at the
    towers' tolerance, the factors and lambda as the PIL lane's test holds
    them."""
    monkeypatch.setenv("DATA_BASE_DIR", str(laion_base))
    load = jax_models.load_model
    monkeypatch.setattr(jax_models, "load_model",
                        lambda *a, **k: load(*a, **{**k, "dtype": jnp.float32}))
    monkeypatch.setattr(jax_encoders, "cast_gemm_params", lambda params, *a, **k: params)
    j_img, j_txt, _ = jax_load_model_fp32(model)
    wd = save_weights(tmp_path / "weights", jax.tree_util.tree_map(np.asarray, j_img.params),
                      jax.tree_util.tree_map(np.asarray, j_txt.params))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    kw = dict(**CLI_KW, model_str=model, native_decode=True, u8_pipeline=u8_pipeline)
    jax_cli.main(**kw, hessian_dir=str(jdir), use_mesh=False)
    jax_lines = capsys.readouterr().out.splitlines()
    run = hessian_estimation.main(**kw, hessian_dir=str(tdir), weights_dir=str(wd),
                                  device="cpu", dtype="fp32")
    lines = capsys.readouterr().out.splitlines()
    native_line = ("[native] batched C++ JPEG decode lane enabled (bilinear; see "
                   "BASELINE.md for the measured delta)")
    assert native_line in lines and native_line in jax_lines
    for f in ("activations_img", "embeddings_img", "activations_txt", "embeddings_txt"):
        ours = torch.load(tdir / f"{f}.pt").numpy()
        assert ours.shape[0] == 28  # 7 batches of 4, drop_last
        np.testing.assert_allclose(ours, np.asarray(load_pt_array(jdir / f"{f}.pt")),
                                   rtol=TOWER_RTOL, atol=TOWER_ATOL, err_msg=f)
    for f in FACTORS:
        ours = torch.load(tdir / f"{f}_analytic.pt").numpy()
        theirs = np.asarray(load_pt_array(jdir / f"{f}_analytic.pt"))
        if f.startswith("A"):
            np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL, err_msg=f)
        else:  # B at 1e-4 of its largest entry, as in the PIL lane's test
            assert np.abs(ours - theirs).max() <= RTOL * np.abs(theirs).max(), f
    info, jinfo = load_info(tdir), load_info(jdir)
    for key in ("lambda_img", "lambda_txt"):
        assert info[key] == run[key] == pytest.approx(jinfo[key], rel=1e-4)


def test_cli_runs_without_jax(laion_base, tmp_path):
    """`python -m bayesvlm_tpu_torch.hessian_estimation --device cpu`
    prints the JAX CLI's lines and loads no JAX, flax or JAX package."""
    code = ("import runpy, sys; sys.argv = ['hessian_estimation', '--model', "
            f"'tiny-clip', '--hessian_dir', {str(tmp_path / 'h')!r}, '--device', 'cpu', "
            "'--dtype', 'fp32', '--no_mesh', '--precompute_batch_size', '4', "
            "'--la_num_classes', '8', '--num_workers', '0', '--num_steps', '5']; "
            "runpy.run_module('bayesvlm_tpu_torch.hessian_estimation', "
            "run_name='__main__'); bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'bayesvlm_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={**__import__("os").environ, "DATA_BASE_DIR": str(laion_base)})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "Reducing number of files from 3 to 60"
    for expected in ("Loading embeddings and activations...",
                     "Computing Hessian for image encoder...",
                     "Computing Hessian for text encoder...",
                     "Optimizing prior precision for image encoder...",
                     "Optimizing prior precision for text encoder..."):
        assert expected in lines
    assert set(json.loads(lines[-1])) == {"lambda_img", "lambda_txt"}


def test_cli_defaults_to_the_card_and_laion():
    import inspect

    args = hessian_estimation._parser().parse_args([])
    assert args.device == "cuda" and args.dataset == "laion400m"
    assert (args.model, args.la_num_classes, args.la_batch_size, args.num_steps) == (
        "clip-base", 32768, 2048, 300)
    assert inspect.signature(hessian_estimation.main).parameters["device"].default == "cuda"


@pytest.mark.parametrize("flag", [
    {"tokenizer_dir": "tok", "native_decode": True}, {"native_decode": True},
    {"u8_pipeline": True, "save_orbax": True}, {"save_orbax": True},
    {"dist_global_batch": True}, "COORDINATOR_ADDRESS"])
def test_cli_refuses_unported_flags_before_loading(flag, tmp_path, monkeypatch):
    """No flag is left unported: the native decode lane (--native_decode,
    beside the ported --tokenizer_dir too), the distribution
    (--dist_global_batch on one process: it changes nothing there, as in
    JAX) and the checkpoint lane (--save_orbax, the factors_dcp/ lane) are
    taken and loading starts, and a launch named in part
    (COORDINATOR_ADDRESS without NUM_PROCESSES / PROCESS_ID) is refused
    before anything loads."""
    import bayesvlm_tpu_torch.data.factory as factory
    import bayesvlm_tpu_torch.models.encoders as encoders

    class _Loaded(Exception):
        pass

    loaded = []

    def stub(*a, _n=None, **k):
        loaded.append(_n)
        raise _Loaded

    for mod, attr in ((factory, "DataModuleFactory"), (encoders, "load_model")):
        monkeypatch.setattr(mod, attr, lambda *a, _n=attr, **k: stub(_n=_n))
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    kw = dict(**CLI_KW, model_str="tiny-clip", hessian_dir=str(tmp_path / "h"),
              device="cpu")
    if flag == "COORDINATOR_ADDRESS":
        monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
        with pytest.raises(ValueError, match="NUM_PROCESSES and PROCESS_ID"):
            hessian_estimation.main(**kw)
        assert loaded == [] and not (tmp_path / "h").exists()
        return
    with pytest.raises(_Loaded):
        hessian_estimation.main(**kw, **flag)
    assert loaded == ["load_model"]


def test_load_hessians_names_an_orbax_only_directory(tmp_path):
    """A directory whose factors exist only in the JAX package's orbax
    lane is refused by name (the port reads the .pt files)."""
    (tmp_path / "factors_orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="factors_orbax"):
        load_hessians(tmp_path, "img")
