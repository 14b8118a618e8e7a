"""The port's real-weights preflight (`python -m bayesvlm_tpu_torch.preflight`)
against the JAX package's `scripts/preflight.py`, on the tiny offline
fixture of tests/test_preflight.py:21-62 (a random-init transformers
CLIPModel saved as a local snapshot, tiny SPD Hessians, the synthetic
dataset). Both pass their HF parity step; the port's ACC equals JAX's
and its NLPD / ECE agree at 1e-4, its lambdas at rel 1e-4 (the zero-shot
CLI's parity tolerance, tests/test_torch_zeroshot.py). With
`transformers` hidden the parity step is skipped and the summary says
why."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from bayesvlm_tpu_torch import preflight  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RUN = dict(dataset="synthetic", dtype="fp32", batch_size=16, num_workers=2, use_mesh=False)


@pytest.fixture(scope="module")
def tiny_snapshot(tmp_path_factory):
    d = tmp_path_factory.mktemp("snapshot")
    cfg = transformers.CLIPConfig(
        projection_dim=16,
        vision_config=dict(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=32, patch_size=8,
            hidden_act="gelu", projection_dim=16,
        ),
        text_config=dict(
            vocab_size=64, hidden_size=24, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=16, hidden_act="gelu",
            projection_dim=16, eos_token_id=63, bos_token_id=0,
            pad_token_id=1,
        ),
    )
    torch.manual_seed(0)
    transformers.CLIPModel(cfg).eval().save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def tiny_hessians(tmp_path_factory):
    from bayesvlm_tpu.io.artifacts import save_hessians

    d = tmp_path_factory.mktemp("hessians")
    rng = np.random.default_rng(0)

    def spd(n):
        M = rng.normal(size=(n, n)).astype(np.float32)
        return M @ M.T / n + np.eye(n, dtype=np.float32)

    save_hessians(d, spd(32), spd(16), "img")
    save_hessians(d, spd(24), spd(16), "txt")
    return d


@pytest.fixture(scope="module")
def jax_summary(tiny_snapshot, tiny_hessians, tmp_path_factory):
    sys.path.insert(0, str(REPO / "scripts"))
    import preflight as jax_preflight

    return jax_preflight.main(model_str="tiny-clip", snapshot=str(tiny_snapshot),
                              hessian_dir=str(tiny_hessians),
                              out=tmp_path_factory.mktemp("jax_weights"), **RUN)


def _assert_metrics_match(ours, theirs):
    assert ours["acc"] == theirs["acc"]
    assert ours["nlpd"] == pytest.approx(theirs["nlpd"], abs=1e-4)
    assert ours["ece"] == pytest.approx(theirs["ece"], abs=1e-4)
    for key in ("lambda_img", "lambda_txt"):
        assert ours[key] == pytest.approx(theirs[key], rel=1e-4)


def test_preflight_matches_jax(tiny_snapshot, tiny_hessians, jax_summary, capsys):
    """The snapshot read directly (no convert step), parity run."""
    ours = preflight.main(model_str="tiny-clip", snapshot=str(tiny_snapshot),
                          hessian_dir=str(tiny_hessians), device="cpu", **RUN)
    _assert_metrics_match(ours, jax_summary)
    for key in ("image_max_rel", "text_max_rel"):
        assert ours["parity"][key] <= preflight.PARITY_RTOL
        assert jax_summary["parity"][key] <= preflight.PARITY_RTOL
    lines = capsys.readouterr().out.strip().splitlines()
    assert "[convert] skipped" in lines[0]
    assert lines[-1] == "[preflight] " + json.dumps(ours)
    assert (ours["model"], ours["dataset"]) == ("tiny-clip", "synthetic")


def test_preflight_converts_when_asked(tiny_snapshot, tiny_hessians, jax_summary,
                                      tmp_path, capsys):
    kw = dict(model_str="tiny-clip", snapshot=str(tiny_snapshot),
              hessian_dir=str(tiny_hessians), out=tmp_path / "weights", skip_parity=True,
              device="cpu", **RUN)
    first = preflight.main(**kw)
    assert all((tmp_path / "weights" / f).exists()
               for f in ("vision.pt", "text.pt", "head.json"))
    assert first["parity"] is None
    _assert_metrics_match(first, jax_summary)
    second = preflight.main(**kw)  # the converted files are reused
    assert "cache exists" in capsys.readouterr().out
    assert second == first


def test_preflight_without_transformers_records_the_skip(tiny_snapshot, tiny_hessians,
                                                         jax_summary, monkeypatch,
                                                         capsys):
    monkeypatch.setitem(sys.modules, "transformers", None)
    ours = preflight.main(model_str="tiny-clip", snapshot=str(tiny_snapshot),
                          hessian_dir=str(tiny_hessians), device="cpu", **RUN)
    assert ours["parity"] == "skipped: transformers not installed"
    assert "[parity] skipped: transformers not installed" in capsys.readouterr().out
    _assert_metrics_match(ours, jax_summary)


@pytest.mark.parametrize("family", ["clip", "siglip"])
def test_hf_features_are_get_features(family):
    """`_hf_features` computes what get_image_features / get_text_features
    return in the installed transformers, bit for bit."""
    torch.manual_seed(0)
    if family == "clip":
        hf = transformers.CLIPModel(transformers.CLIPConfig(
            projection_dim=16,
            vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                               num_attention_heads=2, image_size=32, patch_size=8),
            text_config=dict(vocab_size=64, hidden_size=24, intermediate_size=48,
                             num_hidden_layers=1, num_attention_heads=2,
                             max_position_embeddings=16, eos_token_id=63))).eval()
    else:
        hf = transformers.SiglipModel(transformers.SiglipConfig(
            vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                               num_attention_heads=2, image_size=32, patch_size=8),
            text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=48,
                             num_hidden_layers=1, num_attention_heads=2,
                             max_position_embeddings=16))).eval()
    px = torch.randn(2, 3, 32, 32)
    ids = torch.randint(2, 62, (2, 16))
    ids[:, -1] = 63
    with torch.no_grad():
        img, txt = preflight._hf_features(hf, family, px, ids)
        want_img = hf.get_image_features(pixel_values=px)
        want_txt = hf.get_text_features(input_ids=ids)
    assert torch.equal(img, want_img) and torch.equal(txt, want_txt)


def test_preflight_cli_flags_match_jax():
    """Every JAX flag, with its default, plus --device (default cuda)."""
    import ast

    tree = ast.parse((REPO / "scripts" / "preflight.py").read_text())
    jax_flags = {node.args[0].value for node in ast.walk(tree)
                 if isinstance(node, ast.Call) and getattr(node.func, "attr", "") ==
                 "add_argument"}
    ours = preflight._parser()
    flags = {s for a in ours._actions for s in a.option_strings} - {"-h", "--help"}
    assert flags == jax_flags | {"--device"}
    args = ours.parse_args(["--model", "m", "--snapshot", "s", "--hessian_dir", "h"])
    assert (args.dataset, args.dtype, args.batch_size, args.num_workers, args.device) == (
        "cifar100", "bf16", 32, 4, "cuda")
