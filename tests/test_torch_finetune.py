"""The port's projection fine-tune (`bayesvlm_tpu_torch.train`) and the
projection checkpoint API of its encoders against the JAX package's, on
the CPU: `evaluate_projection` on CLIP- and SigLIP-shaped heads (the
latter with a projection bias), `finetune_projection` for 2 epochs at
tiny widths, the early-stopping cases of tests/test_finetune_patience.py,
`ExperimentLogger`'s JSONL, and `img_projection.pt` read and written
both ways.

Tolerances: evaluation 1e-5 (fp32, one summation order apart). The
fine-tune: the loss and metrics trajectory at rtol 1e-4, and the
fine-tuned projection by the relative Frobenius norm of its update (W -
W0) against JAX's at 1e-3: Adam divides by sqrt(v), so where a gradient
element is near 0 an fp32 rounding difference in it can move its update
by up to lr, which no elementwise bound survives; the bias, whose
gradient has no such elements here, elementwise at 1e-4 of its update's
largest entry.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesvlm_tpu.bayes.kfac import KroneckerFactorizedCovariance as JaxCov
from bayesvlm_tpu.models import load_model as jax_load_model
from bayesvlm_tpu.probforward.smith import ProbabilisticHead as JaxHead
from bayesvlm_tpu.train import finetune as jax_finetune
from bayesvlm_tpu.train.logging import ExperimentLogger as JaxLogger
from bayesvlm_tpu.types import EncoderResult as JaxResult
from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
from bayesvlm_tpu_torch.models.bridge import save_weights
from bayesvlm_tpu_torch.models.encoders import load_model
from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
from bayesvlm_tpu_torch.train import ExperimentLogger, evaluate_projection, finetune_projection
from bayesvlm_tpu_torch.types import EncoderResult

EVAL_TOL = 1e-5
METRIC_RTOL = 1e-4
PROJ_TOL = 1e-3


class _Recorder:
    """A logger keeping every (step, metrics) it is given."""

    def __init__(self):
        self.lines = []

    def log(self, metrics, step):
        self.lines.append((step, {k: float(v) for k, v in metrics.items()}))


def _spd(rng, d, s=0.1):
    M = rng.normal(size=(d, d)).astype(np.float32)
    return (M @ M.T / d * s + np.eye(d, dtype=np.float32)).astype(np.float32)


def _setup(seed=0, P=6, D=4, C=3, N=20, bias=False):
    """The same features, labels, head and projections in both packages."""
    rng = np.random.default_rng(seed)

    def er(n):
        e = rng.normal(size=(n, D)).astype(np.float32)
        a = rng.normal(size=(n, P)).astype(np.float32)
        r = (rng.normal(size=(n, D)) * 0.1).astype(np.float32) if bias else np.zeros_like(e)
        return (JaxResult(*map(jnp.asarray, (e, a, r))),
                EncoderResult(*map(torch.from_numpy, (e, a, r))))

    Pa = P + bias
    A_s, B_s, A_t, B_t = _spd(rng, Pa), _spd(rng, D), _spd(rng, Pa), _spd(rng, D)
    scale, lbias = 2.3, (-1.5 if bias else 0.0)
    jhead = JaxHead.create(logit_scale=scale, logit_bias=lbias, has_bias=bias,
                           source_covariance=JaxCov(jnp.asarray(A_s), jnp.asarray(B_s)),
                           target_covariance=JaxCov(jnp.asarray(A_t), jnp.asarray(B_t)))
    phead = ProbabilisticHead.create(logit_scale=scale, logit_bias=lbias, device="cpu",
                                     has_bias=bias).set_covariances(
        KroneckerFactorizedCovariance(torch.from_numpy(A_s), torch.from_numpy(B_s)),
        KroneckerFactorizedCovariance(torch.from_numpy(A_t), torch.from_numpy(B_t)))
    projs = []
    for _ in range(2):  # image, text
        tree = {"kernel": (rng.normal(size=(P, D)) * 0.3).astype(np.float32)}
        if bias:
            tree["bias"] = (rng.normal(size=(D,)) * 0.1).astype(np.float32)
        projs.append(({k: jnp.asarray(v) for k, v in tree.items()},
                      {k: torch.from_numpy(v) for k, v in tree.items()}))
    labels = [rng.integers(0, C, size=n) for n in (N, 12, 16)]
    feats = [er(n) for n in (N, 12, 16)]
    text = er(C)
    return jhead, phead, projs, feats, labels, text, C


@pytest.mark.parametrize("bias", [False, True])
def test_evaluate_projection_matches_jax(bias):
    jhead, phead, ((jproj, pproj), _), feats, labels, (jtext, ptext), C = _setup(bias=bias)
    (jf, pf), y = feats[0], labels[0]
    for batch in (4096, 7):
        got = evaluate_projection(pproj, phead, pf, torch.from_numpy(y), ptext, C,
                                  batch_size=batch)
        want = jax_finetune.evaluate_projection(jproj, jhead, jf, jnp.asarray(y), jtext, C,
                                                batch_size=batch)
        assert set(got) == set(want) == {"accuracy", "accuracy_weighted", "ece", "loss"}
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=EVAL_TOL, abs=EVAL_TOL), k


@pytest.mark.parametrize("bias,batch", [(False, 8), (True, 6)])
def test_finetune_projection_matches_jax(bias, batch):
    jhead, phead, ((jimg, pimg), (jtxt, ptxt)), feats, labels, (jtext, ptext), C = \
        _setup(seed=1, bias=bias)
    args = []
    for (jf, pf), y in zip(feats, labels):
        args.append(((jf, jnp.asarray(y)), (pf, torch.from_numpy(y))))
    jrec, prec, stats = _Recorder(), _Recorder(), {}
    kw = dict(lr=5e-2, wd=1e-2, epochs=2, batch_size=batch, num_classes=C, seed=3)
    jbest, jtest = jax_finetune.finetune_projection(
        jimg, jtxt, jhead, *[x for a in args for x in a[0]], jtext, logger=jrec, **kw)
    pbest, ptest = finetune_projection(
        pimg, ptxt, phead, *[x for a in args for x in a[1]], ptext, logger=prec,
        stats=stats, **kw)
    assert stats == {"epochs": 2, "steps": 2 * -(-20 // batch)}
    assert [s for s, _ in prec.lines] == [s for s, _ in jrec.lines]
    for (_, got), (_, want) in zip(prec.lines, jrec.lines):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=METRIC_RTOL, abs=1e-7), k
    for k, v in jtest.items():
        assert ptest[k] == pytest.approx(v, rel=METRIC_RTOL), k
    assert set(pbest) == set(jbest)
    w0 = pimg["kernel"]
    d_port, d_jax = pbest["kernel"] - w0, torch.from_numpy(np.asarray(jbest["kernel"])) - w0
    assert float(torch.linalg.norm(d_jax)) > 0.0
    assert float(torch.linalg.norm(d_port - d_jax) / torch.linalg.norm(d_jax)) <= PROJ_TOL
    if bias:
        db_port = pbest["bias"] - pimg["bias"]
        db_jax = torch.from_numpy(np.asarray(jbest["bias"])) - pimg["bias"]
        assert float((db_port - db_jax).abs().max()) <= 1e-4 * float(db_jax.abs().max())
    # the caller's projection is left as it was
    assert torch.equal(pimg["kernel"], torch.from_numpy(np.asarray(jimg["kernel"])))


class _CountingLogger:
    def __init__(self):
        self.max_step = 0

    def log(self, metrics, step):
        self.max_step = max(self.max_step, step)


@pytest.mark.parametrize("epochs,patience,expected", [(50, 3, 4), (5, None, 5)])
def test_early_stopping_matches_jax(epochs, patience, expected):
    """tests/test_finetune_patience.py's cases: with lr = 0 every epoch
    gives the same val loss: epoch 1 improves on inf, epochs 2-4 tie, so
    patience 3 stops at epoch 4; without patience every epoch runs."""
    jhead, phead, ((jimg, pimg), _), feats, labels, (jtext, ptext), C = _setup(seed=2)
    (jf, pf), y = feats[0], labels[0]
    kw = dict(lr=0.0, wd=0.0, epochs=epochs, batch_size=8, num_classes=C,
              early_stopping_patience=patience)
    counters = _CountingLogger(), _CountingLogger()
    jy, py = jnp.asarray(y), torch.from_numpy(y)
    jax_finetune.finetune_projection(jimg, dict(jimg), jhead, jf, jy, jf, jy, jf, jy, jtext,
                                     logger=counters[0], **kw)
    stats = {}
    finetune_projection(pimg, dict(pimg), phead, pf, py, pf, py, pf, py, ptext,
                        logger=counters[1], stats=stats, **kw)
    assert counters[0].max_step == counters[1].max_step == expected
    assert stats["epochs"] == expected


def test_experiment_logger_writes_the_jax_loggers_jsonl(tmp_path):
    lines = {}
    for name, cls in (("jax", JaxLogger), ("port", ExperimentLogger)):
        logger = cls("proj", tmp_path / name, name="run/a",
                     config=dict(lr=1e-3, selection="bald_test"))
        logger.log({"val_loss": np.float32(0.25), "val_accuracy": 0.5}, step=0)
        logger.log({"best_test_ece": torch.tensor(0.125)
                    if name == "port" else jnp.float32(0.125)}, step=1)
        logger.finish()
        lines[name] = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"][0]) == {"_config": {"lr": 1e-3, "selection": "bald_test"},
                                           "_name": "run/a"}
    assert json.loads(lines["port"][2]) == {"best_test_ece": 0.125, "_step": 1}


# -- the projection checkpoint -----------------------------------------------------------


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """tiny-clip and tiny-siglip image encoders in both packages, the JAX
    package's seed-0 weights bridged into the port."""
    out = {}
    for model in ("tiny-clip", "tiny-siglip"):
        j_img, j_txt, _ = jax_load_model(model, dtype=jnp.float32, seed=0)
        wd = save_weights(tmp_path_factory.mktemp(model),
                          jax.tree_util.tree_map(np.asarray, j_img.params),
                          jax.tree_util.tree_map(np.asarray, j_txt.params))
        p_img, p_txt, _ = load_model(model, weights_dir=wd, dtype=torch.float32,
                                     device="cpu")
        out[model] = (j_img, p_img, j_txt, p_txt)
    return out


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_projection_tree_matches_jax(encoders, model):
    j_img, p_img, j_txt, p_txt = encoders[model]
    for j, p in ((j_img, p_img), (j_txt, p_txt)):
        jt, pt = j.projection_tree(), p.projection_tree()
        assert set(jt) == set(pt) == ({"kernel", "bias"} if model == "tiny-siglip"
                                      else {"kernel"})
        for k in jt:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(jt[k]))


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_projection_checkpoints_read_both_ways(encoders, model, tmp_path):
    j_img, p_img, _, _ = encoders[model]
    rng = np.random.default_rng(4)
    tree = {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in p_img.projection_tree().items()}
    original = p_img.projection_tree()
    try:
        # port writes, JAX reads
        p_img.with_projection({k: torch.from_numpy(v) for k, v in tree.items()})
        p_img.save_projection_weights(tmp_path / "port.pt")
        j_loaded = j_img.load_projection_weights(tmp_path / "port.pt").projection_tree()
        for k, v in tree.items():
            np.testing.assert_array_equal(np.asarray(j_loaded[k]), v)
        saved = torch.load(tmp_path / "port.pt", weights_only=True)
        assert set(saved) == ({"weight", "bias"} if "bias" in tree else {"weight"})
        assert saved["weight"].shape == tree["kernel"].T.shape
        # JAX writes, the port reads
        j_img.with_projection({k: jnp.asarray(v) * 2 for k, v in tree.items()}) \
            .save_projection_weights(tmp_path / "jax.pt")
        p_img.load_projection_weights(tmp_path / "jax.pt")
        for k, v in p_img.projection_tree().items():
            np.testing.assert_array_equal(v.numpy(), tree[k] * 2)
        # and a file of the fine-tune's (img_projection.pt is torch.save of it)
        torch.save({"weight": torch.from_numpy(tree["kernel"].T.copy()),
                    **({"bias": torch.from_numpy(tree["bias"])} if "bias" in tree else {})},
                   tmp_path / "ft.pt")
        p_img.load_projection_weights(tmp_path / "ft.pt")
        np.testing.assert_array_equal(p_img.projection_tree()["kernel"].numpy(),
                                      tree["kernel"])
    finally:
        p_img.with_projection(original)


def test_projection_checkpoint_keys_are_strict(encoders, tmp_path):
    _, clip, _, _ = encoders["tiny-clip"]
    _, siglip, _, _ = encoders["tiny-siglip"]
    clip.save_projection_weights(tmp_path / "clip.pt")
    siglip.save_projection_weights(tmp_path / "siglip.pt")
    w = torch.load(tmp_path / "clip.pt")["weight"]
    with pytest.raises(ValueError, match=r"missing: \['bias'\]"):
        siglip.load_projection_weights(tmp_path / "clip.pt")
    with pytest.raises(ValueError, match=r"unexpected: \['bias'\]"):
        clip.load_projection_weights(tmp_path / "siglip.pt")
    torch.save({"weight": w, "extra": w}, tmp_path / "extra.pt")
    with pytest.raises(ValueError, match=r"unexpected: \['extra'\]"):
        clip.load_projection_weights(tmp_path / "extra.pt")
    torch.save(w, tmp_path / "bare.pt")
    with pytest.raises(ValueError, match="bare kernel"):
        siglip.load_projection_weights(tmp_path / "bare.pt")
    before = clip.projection_tree()["kernel"].clone()
    clip.load_projection_weights(tmp_path / "bare.pt")
    assert torch.equal(clip.projection_tree()["kernel"], before)
    with pytest.raises(ValueError, match="do not match"):
        clip.with_projection({"kernel": before, "bias": before[0]})
    with pytest.raises(ValueError, match="does not match"):
        clip.with_projection({"kernel": before[:-1]})
