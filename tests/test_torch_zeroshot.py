"""The port's Stage-2 zero-shot evaluation chain against the JAX package's:
metrics, the logits and feature caches (read both ways), part-file
resume, and `bayesvlm_tpu_torch.zeroshot.main` against `scripts/
zeroshot.main` on tiny-clip and tiny-siglip with the `synthetic` dataset,
the same weights and the same K-FAC factors. fp32 on the CPU: ACC equal,
NLPD and ECE within 1e-4, the lambdas as in test_torch_pipeline.py."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.data.synthetic import SyntheticDataModule as JaxSyntheticDataModule
from bayesvlm_tpu.inference import metrics as jax_metrics
from bayesvlm_tpu.inference.precompute import (
    precompute_image_features as jax_precompute_image_features,
)
from bayesvlm_tpu.inference.precompute import (
    precompute_text_features as jax_precompute_text_features,
)
from bayesvlm_tpu.inference.predictions import make_predictions as jax_make_predictions
from bayesvlm_tpu.io.torch_compat import load_pt_array
from bayesvlm_tpu.models import load_model as jax_load_model
from bayesvlm_tpu.probforward.smith import ProbabilisticHead as JaxProbabilisticHead
from bayesvlm_tpu.types import EncoderResult as JaxEncoderResult
from bayesvlm_tpu_torch import zeroshot
from bayesvlm_tpu_torch.data.factory import DataModuleFactory
from bayesvlm_tpu_torch.data.loader import DataLoader, ListDataset, default_collate
from bayesvlm_tpu_torch.data.synthetic import SyntheticDataModule
from bayesvlm_tpu_torch.data.tokenizer import HashTokenizer
from bayesvlm_tpu_torch.inference import metrics
from bayesvlm_tpu_torch.inference.precompute import (
    encode_images_batched,
    precompute_image_features,
    precompute_text_features,
)
from bayesvlm_tpu_torch.inference.predictions import make_predictions
from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
from bayesvlm_tpu_torch.models import load_model
from bayesvlm_tpu_torch.models.bridge import save_weights
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.types import EncoderResult

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import zeroshot as jax_zeroshot  # noqa: E402

RTOL, ATOL = 2e-3, 2e-4  # the towers' tolerance (test_torch_towers.py)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# -- metrics -------------------------------------------------------------------


def _probs_with_edges(n=120, c=5, seed=0):
    """Dirichlet rows, then rows whose top-1 confidence lies exactly on
    each of jnp.linspace's 20-bin edges above 0.2, and rows at 1.0."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(c, 0.3), size=n).astype(np.float32)
    edges = np.asarray(jnp.linspace(0.0, 1.0, 21))
    row = 0
    for e in edges[edges > 0.2]:
        p[row] = (1.0 - e) / (c - 1)
        p[row, row % c] = e
        row += 1
    p[row] = np.eye(c, dtype=np.float32)[0]
    p[row + 1] = np.eye(c, dtype=np.float32)[3]
    labels = rng.integers(0, c, size=n)
    labels[row], labels[row + 1] = 0, 1
    return p, labels


@pytest.mark.parametrize("case", ["random", "edges"])
def test_metrics_match_jax(case):
    if case == "random":
        rng = np.random.default_rng(1)
        p = rng.dirichlet(np.ones(7), size=200).astype(np.float32)
        y = rng.integers(0, 7, size=200)
    else:
        p, y = _probs_with_edges()
    j_acc, j_nlpd, j_ece = jax_metrics.evaluate_prediction(jnp.asarray(p),
                                                           jnp.asarray(y), p.shape[1])
    acc, nlpd, ece = metrics.evaluate_prediction(torch.from_numpy(p),
                                                 torch.from_numpy(y), p.shape[1])
    np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
    np.testing.assert_allclose(nlpd.numpy(), np.asarray(j_nlpd), rtol=1e-6)
    assert ece == pytest.approx(j_ece, abs=1e-6)


def test_ece_bins_a_confidence_on_an_edge_below_it():
    """Bins are right-closed: a confidence of exactly 0.65 or 0.9 (as
    jnp.linspace rounds them) or 1.0 falls in the bin that ends there."""
    edges = np.asarray(jnp.linspace(0.0, 1.0, 21))
    for k in (13, 18, 20):
        p = np.array([[edges[k], 1.0 - edges[k]]], np.float32)
        # one sample, correct: ECE = 1 - conf, whatever the bin; wrong: conf
        ece = float(metrics.expected_calibration_error(torch.from_numpy(p),
                                                       torch.tensor([1])))
        j_ece = float(jax_metrics.expected_calibration_error(jnp.asarray(p),
                                                             jnp.asarray([1])))
        assert ece == pytest.approx(j_ece, abs=0) and ece == pytest.approx(edges[k])
    conf = torch.tensor([edges[13], edges[18], 1.0], dtype=torch.float32)
    probs = torch.stack([conf, 1 - conf], dim=1)
    step = torch.tensor(0.05, dtype=torch.float32)
    bins = (torch.searchsorted(torch.arange(21, dtype=torch.float32) * step,
                               probs.max(-1).values) - 1).clamp(0, 19)
    assert bins.tolist() == [12, 17, 19]


def test_nlpd_renormalises():
    p = torch.tensor([[2.0, 2.0], [1.0, 3.0]])
    np.testing.assert_allclose(metrics.nlpd(p, torch.tensor([0, 1])).numpy(),
                               -np.log([0.5, 0.75]), rtol=1e-6)


# -- logits cache ----------------------------------------------------------------


def _features(n, d, p, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in ((n, d), (n, p))]


@pytest.fixture(scope="module")
def heads():
    """The same head in both packages: CLIP-shaped, no bias column."""
    rng = np.random.default_rng(7)

    def inv_spd(dim):
        M = rng.normal(size=(dim, dim)).astype(np.float32)
        return np.linalg.inv(M @ M.T / dim + np.eye(dim, dtype=np.float32))

    A_img, B_img, A_txt, B_txt = inv_spd(6), inv_spd(4), inv_spd(5), inv_spd(4)
    from bayesvlm_tpu.bayes.kfac import KroneckerFactorizedCovariance as JaxCov
    from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance

    jhead = JaxProbabilisticHead.create(logit_scale=3.0).set_covariances(
        JaxCov(jnp.asarray(A_img), jnp.asarray(B_img)),
        JaxCov(jnp.asarray(A_txt), jnp.asarray(B_txt)))
    thead = ProbabilisticHead.create(logit_scale=3.0, device="cpu").set_covariances(
        KroneckerFactorizedCovariance(torch.from_numpy(A_img), torch.from_numpy(B_img)),
        KroneckerFactorizedCovariance(torch.from_numpy(A_txt), torch.from_numpy(B_txt)))
    img, txt = _features(13, 4, 6, 8), _features(3, 4, 5, 9)
    return (jhead, JaxEncoderResult.create(*map(jnp.asarray, img)),
            JaxEncoderResult.create(*map(jnp.asarray, txt)),
            thead, EncoderResult.create(*map(torch.from_numpy, img)),
            EncoderResult.create(*map(torch.from_numpy, txt)))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_logits_cache_reads_both_ways(heads, writer, tmp_path):
    jhead, jimg, jtxt, thead, timg, ttxt = heads
    if writer == "jax":
        ref = jax_make_predictions(jhead, jimg, jtxt, batch_size=5,
                                   save_predictions=True, cache_dir=tmp_path)
        ref_mean, ref_var = np.asarray(ref.mean), np.asarray(ref.var)
    else:
        ref = make_predictions(thead, timg, ttxt, batch_size=5,
                               save_predictions=True, cache_dir=tmp_path)
        ref_mean, ref_var = ref.mean.numpy(), ref.var.numpy()
    assert {p.name for p in tmp_path.iterdir()} == {"logits_mean.pt", "logits_var.pt"}
    # the other package reads the files (a cache hit: the head is not run)
    if writer == "jax":
        got = make_predictions(None, timg, ttxt, cache_dir=tmp_path)
        got_mean, got_var = got.mean.numpy(), got.var.numpy()
    else:
        got = jax_make_predictions(None, jimg, jtxt, cache_dir=tmp_path)
        got_mean, got_var = np.asarray(got.mean), np.asarray(got.var)
    np.testing.assert_array_equal(got_mean, ref_mean)
    np.testing.assert_array_equal(got_var, ref_var)


def test_make_predictions_matches_jax_in_ragged_batches(heads):
    jhead, jimg, jtxt, thead, timg, ttxt = heads
    ref = jax_make_predictions(jhead, jimg, jtxt, batch_size=5)
    got = make_predictions(thead, timg, ttxt, batch_size=5)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(ref.var), rtol=1e-5, atol=1e-6)


# -- data + feature precompute -----------------------------------------------------


def test_synthetic_datamodule_and_loader_match_jax():
    kw = dict(batch_size=7, num_test=19, num_classes=4, image_size=8, num_workers=2)
    jdm, tdm = JaxSyntheticDataModule(**kw), SyntheticDataModule(**kw)
    jdm.setup()
    tdm.setup()
    assert tdm.class_prompts == jdm.class_prompts
    for jb, tb in zip(jdm.test_dataloader(), tdm.test_dataloader(), strict=True):
        assert jb.keys() == tb.keys()
        np.testing.assert_array_equal(tb["image"], jb["image"])
        np.testing.assert_array_equal(tb["class_id"], jb["class_id"])
        np.testing.assert_array_equal(tb["image_id"], jb["image_id"])
        assert tb["text"] == jb["text"]
    # seeded shuffling: the same order as the JAX loader's
    from bayesvlm_tpu.data.loader import DataLoader as JaxDataLoader

    ds = ListDataset([{"image": np.full(2, i, np.float32), "text": str(i)}
                      for i in range(10)])
    ours = [b["text"] for b in DataLoader(ds, 3, shuffle=True, seed=4)]
    theirs = [b["text"] for b in JaxDataLoader(ds, 3, shuffle=True, seed=4)]
    assert ours == theirs
    assert default_collate([ds[0], ds[1]])["image"].shape == (2, 2)


def test_factory_creates_synthetic_with_overrides():
    dm = DataModuleFactory(batch_size=4, num_workers=1).create(
        "synthetic", image_size=16, num_test=5, num_classes=3)
    dm.setup()
    batch = next(iter(dm.test_dataloader()))
    assert batch["image"].shape == (4, 16, 16, 3)
    assert len(dm.class_prompts) == 3
    with pytest.raises(ValueError, match="Unknown dataset"):
        DataModuleFactory().create("nonsense")


@pytest.fixture(scope="module")
def siglip_encoders(tmp_path_factory):
    """tiny-siglip in both packages (fp32, the JAX weights bridged), with
    tokenizers, and a synthetic test set of 3 batches (the last short)."""
    j_img, j_txt, _ = jax_load_model("tiny-siglip", dtype=jnp.float32, seed=0)
    wd = save_weights(tmp_path_factory.mktemp("zs_weights"), _np_tree(j_img.params),
                      _np_tree(j_txt.params))
    t_img, t_txt, _ = load_model("tiny-siglip", weights_dir=wd, dtype=torch.float32,
                                 device="cpu")
    cfg = CONFIGS_BY_NAME["tiny-siglip"].text
    from bayesvlm_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer

    j_txt.tokenizer = JaxHashTokenizer(cfg.vocab_size, cfg.max_length,
                                       eos_id=cfg.eos_token_id)
    t_txt.tokenizer = HashTokenizer(cfg.vocab_size, cfg.max_length,
                                    eos_id=cfg.eos_token_id)
    kw = dict(batch_size=8, num_test=21, num_classes=4, image_size=32, num_workers=2)
    jdm, tdm = JaxSyntheticDataModule(**kw), SyntheticDataModule(**kw)
    jdm.setup()
    tdm.setup()
    return j_img, j_txt, t_img, t_txt, jdm, tdm


def _assert_features_close(ours, theirs):
    for name in ("embeds", "activations", "residuals"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_precompute_features_match_jax(siglip_encoders):
    j_img, j_txt, t_img, t_txt, jdm, tdm = siglip_encoders
    j_res, j_cls, j_ids = jax_precompute_image_features(j_img, jdm.test_dataloader())
    t_res, t_cls, t_ids = precompute_image_features(t_img, tdm.test_dataloader())
    assert len(t_res) == 21
    _assert_features_close(t_res, j_res)
    np.testing.assert_array_equal(t_cls.numpy(), np.asarray(j_cls))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    j_lab = jax_precompute_text_features(j_txt, jdm.class_prompts, batch_size=3)
    t_lab = precompute_text_features(t_txt, tdm.class_prompts, batch_size=3)
    _assert_features_close(t_lab, j_lab)
    batched = encode_images_batched(t_img, np.concatenate(
        [b["image"] for b in tdm.test_dataloader()]), batch_size=8)
    torch.testing.assert_close(batched.embeds, t_res.embeds, rtol=0, atol=0)


_IMG_CACHE = ("embeddings_img.pt", "activations_img.pt", "residuals_img.pt",
              "class_ids_img.pt", "image_ids.pt")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_caches_read_both_ways(siglip_encoders, writer, tmp_path):
    j_img, j_txt, t_img, t_txt, jdm, tdm = siglip_encoders
    if writer == "jax":
        jax_precompute_image_features(j_img, jdm.test_dataloader(),
                                      save_predictions=True, cache_dir=tmp_path)
        jax_precompute_text_features(j_txt, jdm.class_prompts, 3,
                                     save_predictions=True, cache_dir=tmp_path)
    else:
        precompute_image_features(t_img, tdm.test_dataloader(), save_predictions=True,
                                  cache_dir=tmp_path)
        precompute_text_features(t_txt, tdm.class_prompts, 3, save_predictions=True,
                                 cache_dir=tmp_path)
    files = {p.name: load_pt_array(p) for p in tmp_path.glob("*.pt")}
    assert set(files) == {*_IMG_CACHE, "embeddings_txt.pt", "activations_txt.pt"}
    # cache hits in the other package: the loader and encoder are not used
    if writer == "jax":
        res, cls, ids = precompute_image_features(t_img, [], cache_dir=tmp_path)
        lab = precompute_text_features(t_txt, [], 3, cache_dir=tmp_path)
        got = {"embeddings_img.pt": res.embeds, "activations_img.pt": res.activations,
               "residuals_img.pt": res.residuals, "class_ids_img.pt": cls,
               "image_ids.pt": ids, "embeddings_txt.pt": lab.embeds,
               "activations_txt.pt": lab.activations}
        got = {k: v.numpy() for k, v in got.items()}
    else:
        res, cls, ids = jax_precompute_image_features(j_img, [], cache_dir=tmp_path)
        lab = jax_precompute_text_features(j_txt, [], 3, cache_dir=tmp_path)
        got = {"embeddings_img.pt": res.embeds, "activations_img.pt": res.activations,
               "residuals_img.pt": res.residuals, "class_ids_img.pt": cls,
               "image_ids.pt": ids, "embeddings_txt.pt": lab.embeds,
               "activations_txt.pt": lab.activations}
        got = {k: np.asarray(v) for k, v in got.items()}
    for name, arr in files.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


class _Preempted(Exception):
    pass


def _dies_after(loader, n_batches):
    for i, batch in enumerate(loader):
        if i == n_batches:
            raise _Preempted
        yield batch


def test_part_file_resume_gives_identical_caches(siglip_encoders, tmp_path):
    """Preempted after 2 of 3 batches with checkpoint_every=1, then resumed:
    the batch already on disk is not re-encoded, and the final caches equal
    an uninterrupted run's bit for bit (and the JAX package's features
    within the towers' tolerance)."""
    j_img, _, t_img, _, jdm, tdm = siglip_encoders
    whole = tmp_path / "whole"
    precompute_image_features(t_img, tdm.test_dataloader(), save_predictions=True,
                              cache_dir=whole)
    resumed = tmp_path / "resumed"
    with pytest.raises(_Preempted):
        precompute_image_features(t_img, _dies_after(tdm.test_dataloader(), 2),
                                  save_predictions=True, cache_dir=resumed,
                                  checkpoint_every=1)
    parts = sorted(p.name for p in (resumed / "_parts_img").iterdir())
    assert parts == ["part_00000.npz", "part_00001.npz"]
    encoded = []

    class Counting:
        device = t_img.device

        def __call__(self, images):
            encoded.append(len(images))
            return t_img(images)

    precompute_image_features(Counting(), tdm.test_dataloader(), save_predictions=True,
                              cache_dir=resumed, checkpoint_every=1)
    assert encoded == [21 - 16]  # only the third batch
    assert not (resumed / "_parts_img").exists()
    for name in _IMG_CACHE:
        a, b = torch.load(whole / name), torch.load(resumed / name)
        assert torch.equal(a, b), name
    j_res, _, _ = jax_precompute_image_features(j_img, jdm.test_dataloader())
    np.testing.assert_allclose(torch.load(resumed / "residuals_img.pt").numpy(),
                               np.asarray(j_res.residuals), rtol=RTOL, atol=ATOL)


def test_resume_mid_batch_from_jax_parts(siglip_encoders, tmp_path):
    """Part files the JAX package wrote (same layout and keys) resume in
    the port, here from a part that ends mid-batch."""
    j_img, _, t_img, _, jdm, tdm = siglip_encoders
    j_res, j_cls, j_ids = jax_precompute_image_features(j_img, jdm.test_dataloader())
    parts = tmp_path / "_parts_img"
    parts.mkdir()
    np.savez(parts / "part_00000.npz", embeds=np.asarray(j_res.embeds[:11]),
             activations=np.asarray(j_res.activations[:11]),
             residuals=np.asarray(j_res.residuals[:11]),
             class_ids=np.asarray(j_cls[:11]), image_ids=np.asarray(j_ids[:11]))
    res, cls, ids = precompute_image_features(t_img, tdm.test_dataloader(),
                                              save_predictions=True, cache_dir=tmp_path,
                                              checkpoint_every=1)
    _assert_features_close(res, j_res)
    np.testing.assert_array_equal(res.embeds[:11].numpy(), np.asarray(j_res.embeds[:11]))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


# -- the CLI -----------------------------------------------------------------------


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_zeroshot_main_matches_jax(model, tmp_path):
    hdir = save_synthetic_hessians(tmp_path / "hessians", CONFIGS_BY_NAME[model], seed=0)
    j_img, j_txt, _ = jax_load_model(model, dtype=jnp.float32, seed=0)
    wd = save_weights(tmp_path / "weights", _np_tree(j_img.params), _np_tree(j_txt.params))
    kw = dict(dataset="synthetic", hessian_dir=str(hdir), model_str=model,
              dtype="fp32", num_workers=2)
    ref = jax_zeroshot.main(**kw, use_mesh=False)  # same seed-0 towers
    run = zeroshot.run(**kw, weights_dir=str(wd), device="cpu")
    got = run["metrics"]
    assert got[0] == ref[0]
    assert got[1] == pytest.approx(ref[1], abs=1e-4)
    assert got[2] == pytest.approx(ref[2], abs=1e-4)
    for key in ("lambda_img", "lambda_txt"):
        assert run["info"][key] == pytest.approx(
            jax_zeroshot.main.last_info[key], rel=1e-4)
        assert run["info"][key] != pytest.approx(300.0, rel=1e-2)
    assert run["probs"].shape == (128, 10)
    assert set(run["seconds"]) == {"[1] lambda + covariances", "[2] image features",
                                   "[2] text features", "[3] predictions + probit",
                                   "[4] metrics"}


def test_zeroshot_cli_runs_without_jax(tmp_path):
    """`python -m bayesvlm_tpu_torch.zeroshot` with the JAX CLI's flags, on
    the CPU, prints the JAX CLI's lines and loads no JAX."""
    hdir = save_synthetic_hessians(tmp_path, CONFIGS_BY_NAME["tiny-clip"], seed=0)
    code = ("import runpy, sys; sys.argv = ['zeroshot', '--dataset', 'synthetic', "
            f"'--hessian_dir', {str(hdir)!r}, '--model', 'tiny-clip', '--device', "
            "'cpu', '--dtype', 'fp32', '--no_mesh', '--num_workers', '1']; "
            "runpy.run_module('bayesvlm_tpu_torch.zeroshot', run_name='__main__'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'bayesvlm_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for expected in ("[1] Optimizing prior precision...", "[2] Precomputing features...",
                     "[3] Making predictions...", "[4] Evaluate model ...",
                     "Zero shot CLIP on synthetic"):
        assert expected in lines
    assert any(line.startswith("ECE: ") for line in lines)


def test_cli_defaults_to_the_card():
    args = zeroshot._parser().parse_args([])
    assert args.device == "cuda" and args.dataset == "food101"
    assert args.model == "clip-base" and args.batch_size == 32
    import inspect

    assert inspect.signature(zeroshot.run).parameters["device"].default == "cuda"


def test_main_returns_the_metrics_and_exposes_last_info(monkeypatch):
    """`main` is `run` cut to the JAX CLI's return value and `last_info`."""
    info = {"lambda_img": 1.0, "lambda_txt": 2.0, "n_img": 10, "n_txt": 10}
    monkeypatch.setattr(zeroshot, "run", lambda *a, **k: dict(
        metrics=(0.5, 1.5, 0.1), info=info, probs=None))
    assert zeroshot.main("synthetic", "h") == (0.5, 1.5, 0.1)
    assert zeroshot.main.last_info == info


class _Loaded(Exception):
    """Raised by a stubbed loader: the CLI got past its dataset check."""


def _stub_loaders(monkeypatch) -> list:
    """Both CLIs' dataset, factor and tower loaders replaced by stubs that
    record their name and raise _Loaded; returns the record."""
    import bayesvlm_tpu.data.factory as jax_factory
    import bayesvlm_tpu.io.artifacts as jax_artifacts
    import bayesvlm_tpu.models as jax_models
    import bayesvlm_tpu_torch.data.factory as factory
    import bayesvlm_tpu_torch.io.artifacts as artifacts
    import bayesvlm_tpu_torch.models.encoders as encoders

    loaded = []

    def stub(name):
        def load(*args, **kwargs):
            loaded.append(name)
            raise _Loaded(name)
        return load

    for mod, attr in [(jax_factory, "DataModuleFactory"), (jax_artifacts, "load_hessians"),
                      (jax_models, "load_model"), (factory, "DataModuleFactory"),
                      (artifacts, "load_hessians"), (encoders, "load_model")]:
        monkeypatch.setattr(mod, attr, stub(f"{mod.__name__}.{attr}"))
    return loaded


@pytest.mark.parametrize("dataset", ["sun397", "oxfordpets", "nonsense"])
def test_both_clis_refuse_a_dataset_outside_the_list(dataset, monkeypatch, tmp_path):
    # sun397 and oxfordpets are in the JAX data registry but not in the
    # CLI's list: both CLIs refuse them first, with one message, before
    # any dataset, factor or tower is loaded
    loaded = _stub_loaders(monkeypatch)
    kw = dict(dataset=dataset, hessian_dir=str(tmp_path), model_str="tiny-clip",
              dtype="fp32")
    with pytest.raises(ValueError, match="Invalid dataset"):
        jax_zeroshot.main(**kw, use_mesh=False)
    with pytest.raises(ValueError, match="Invalid dataset"):
        zeroshot.main(**kw, device="cpu")
    assert loaded == []


def test_both_clis_take_synthetic_past_the_check(monkeypatch, tmp_path):
    # the same list in both, and a listed name goes on to the datamodule
    assert zeroshot.SUPPORTED_DATASETS == jax_zeroshot.SUPPORTED_DATASETS
    loaded = _stub_loaders(monkeypatch)
    kw = dict(dataset="synthetic", hessian_dir=str(tmp_path), model_str="tiny-clip",
              dtype="fp32")
    with pytest.raises(_Loaded):
        jax_zeroshot.main(**kw, use_mesh=False)
    with pytest.raises(_Loaded):
        zeroshot.main(**kw, device="cpu")
    assert loaded == ["bayesvlm_tpu.data.factory.DataModuleFactory",
                      "bayesvlm_tpu_torch.data.factory.DataModuleFactory"]
