"""The HF tokenizer and real checkpoints through the port's entry points,
against the JAX package's.

A CLIP tokenizer is built offline from a tiny `vocab.json` / `merges.txt`
the test writes (64 ids: tiny-clip's vocabulary, `<|endoftext|>` its EOS
63) and saved with `save_pretrained`; both packages load it through
`HFTokenizer.from_local`. With it and a tiny-clip HF snapshot
(tests/test_torch_convert.py's `hf_model`, fp32 safetensors):
`from_pretrained(weights_dir=, tokenizer_dir=)`, `zeroshot.run` and the
Stage-1 CLI each match the JAX package's, at tests/test_torch_pipeline.py's
and tests/test_torch_zeroshot.py's tolerances. fp32 on the CPU.
"""

import json
import shutil
import string
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

import bayesvlm_tpu.models as jax_models
import bayesvlm_tpu.models.encoders as jax_encoders
from bayesvlm_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer
from bayesvlm_tpu.io.torch_compat import load_pt_array
from bayesvlm_tpu.pipeline import ProbabilisticVLM as JaxProbabilisticVLM
from bayesvlm_tpu_torch import hessian_estimation, zeroshot
from bayesvlm_tpu_torch.data.tokenizer import HashTokenizer, HFTokenizer, make_tokenizer
from bayesvlm_tpu_torch.io.artifacts import load_hessians, save_synthetic_hessians
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.pipeline import ProbabilisticVLM
from test_torch_convert import hf_model, save_snapshot

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import hessian_estimation as jax_cli  # noqa: E402
import zeroshot as jax_zeroshot  # noqa: E402

RTOL, ATOL = 2e-3, 2e-4  # the towers' tolerance (test_torch_towers.py)
PROMPTS = ["An image of a class 0", "a cat", "class 9 of a dog",
           "a very long prompt that runs past the length of sixteen ids"]
CFG = CONFIGS_BY_NAME["tiny-clip"]


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A CLIP tokenizer of 64 ids: start 0, <unk> 1, a-z, a-z</w>, 0-8</w>,
    <|endoftext|> 63 (the tiny-clip EOS; also its pad)."""
    root = tmp_path_factory.mktemp("tokenizer")
    vocab = {"<|startoftext|>": 0, "<unk>": 1}
    for suffix in ("", "</w>"):
        vocab.update({c + suffix: len(vocab) + i
                      for i, c in enumerate(string.ascii_lowercase)})
    vocab.update({c + "</w>": len(vocab) + i for i, c in enumerate("012345678")})
    vocab["<|endoftext|>"] = 63
    assert sorted(vocab.values()) == list(range(64))
    (root / "vocab.json").write_text(json.dumps(vocab))
    (root / "merges.txt").write_text("#version: 0.2\n")
    tok = transformers.CLIPTokenizer(str(root / "vocab.json"), str(root / "merges.txt"),
                                     unk_token="<unk>")
    tok.save_pretrained(str(root / "tok"))
    return str(root / "tok")


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return str(save_snapshot(hf_model("clip").state_dict(),
                             tmp_path_factory.mktemp("tok_snapshot"), "f32"))


@pytest.mark.parametrize("max_length", [16, 77])
def test_hf_tokenizer_ids_match_jax(tokenizer_dir, max_length):
    ours = HFTokenizer.from_local(tokenizer_dir, max_length)(PROMPTS)
    theirs = JaxHFTokenizer.from_local(tokenizer_dir, max_length)(PROMPTS)
    assert ours.dtype == np.int32 and ours.shape == (len(PROMPTS), max_length)
    np.testing.assert_array_equal(ours, theirs)
    assert (ours[:, 0] == 0).all() and (ours < 64).all()
    # padded with EOS to max_length; at 16 the long prompt is cut, its EOS kept
    assert (ours[:, -1] == 63).all()
    if max_length == 16:
        assert (ours[3, :-1] != 63).all()
    # make_tokenizer picks it by directory, HashTokenizer without one
    assert isinstance(make_tokenizer(CFG.text, tokenizer_dir), HFTokenizer)
    assert isinstance(make_tokenizer(CFG.text), HashTokenizer)


@pytest.fixture(scope="module")
def hessian_dir(tmp_path_factory):
    return str(save_synthetic_hessians(tmp_path_factory.mktemp("tok_hessians"), CFG,
                                       seed=0))


def test_from_pretrained_with_snapshot_and_tokenizer_matches_jax(
        snapshot, tokenizer_dir, hessian_dir):
    kw = dict(weights_dir=snapshot, tokenizer_dir=tokenizer_dir, dtype="fp32")
    jvlm = JaxProbabilisticVLM.from_pretrained("tiny-clip", hessian_dir, mesh=None, **kw)
    tvlm = ProbabilisticVLM.from_pretrained("tiny-clip", hessian_dir, device="cpu", **kw)
    assert isinstance(tvlm.text_encoder.tokenizer, HFTokenizer)
    for key in ("lambda_img", "lambda_txt"):
        assert tvlm.info[key] == pytest.approx(jvlm.info[key], rel=1e-4)
    np.testing.assert_array_equal(tvlm.text_encoder.tokenizer(PROMPTS),
                                  np.asarray(jvlm.text_encoder.tokenizer(PROMPTS)))
    imgs = np.random.default_rng(1).normal(size=(6, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvlm.set_class_prompts(PROMPTS).predict(imgs))
    probs = tvlm.set_class_prompts(PROMPTS).predict(imgs).numpy()
    np.testing.assert_allclose(probs, ref, rtol=1e-4, atol=1e-5)
    # the prompts went through the HF ids, not the hash stand-in
    hashed = ProbabilisticVLM.from_pretrained("tiny-clip", hessian_dir, device="cpu",
                                              weights_dir=snapshot, dtype="fp32",
                                              prior_num_steps=1)
    assert not np.allclose(hashed.encode_texts(PROMPTS).embeds.numpy(),
                           tvlm.encode_texts(PROMPTS).embeds.numpy(), atol=1e-3)


def test_zeroshot_with_snapshot_and_tokenizer_matches_jax(
        snapshot, tokenizer_dir, hessian_dir):
    kw = dict(dataset="synthetic", hessian_dir=hessian_dir, model_str="tiny-clip",
              dtype="fp32", num_workers=2, weights_dir=snapshot,
              tokenizer_dir=tokenizer_dir)
    ref = jax_zeroshot.main(**kw, use_mesh=False)
    run = zeroshot.run(**kw, device="cpu")
    got = run["metrics"]
    assert got[0] == ref[0]
    assert got[1] == pytest.approx(ref[1], abs=1e-4)
    assert got[2] == pytest.approx(ref[2], abs=1e-4)
    for key in ("lambda_img", "lambda_txt"):
        assert run["info"][key] == pytest.approx(jax_zeroshot.main.last_info[key],
                                                 rel=1e-4)
    assert run["probs"].shape == (128, 10)


def test_stage1_cli_takes_the_tokenizer_and_a_snapshot(snapshot, tokenizer_dir, tmp_path,
                                                       monkeypatch):
    """Both Stage-1 CLIs on `synthetic` with the snapshot and the tokenizer:
    the text features (the tokenizer's ids through the snapshot's text
    tower) and the image features agree, and so do the lambdas."""
    load = jax_models.load_model
    monkeypatch.setattr(jax_models, "load_model",
                        lambda *a, **k: load(*a, **{**k, "dtype": jnp.float32}))
    monkeypatch.setattr(jax_encoders, "cast_gemm_params", lambda params, *a, **k: params)
    kw = dict(dataset="synthetic", model_str="tiny-clip", precompute_batch_size=16,
              la_num_classes=8, la_batch_size=3, num_workers=2, num_files=None,
              max_datapoints=24, siglip_chunk_size_j=5, lambda_init_txt=10.0,
              lambda_init_img=10.0, lr=1e-2, num_steps=30, weights_dir=snapshot,
              tokenizer_dir=tokenizer_dir)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_cli.main(**kw, hessian_dir=str(jdir), use_mesh=False)
    run = hessian_estimation.main(**kw, hessian_dir=str(tdir), device="cpu",
                                  dtype="fp32")
    for f in ("activations_img", "embeddings_img", "activations_txt", "embeddings_txt"):
        np.testing.assert_allclose(torch.load(tdir / f"{f}.pt").numpy(),
                                   np.asarray(load_pt_array(jdir / f"{f}.pt")),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    info = json.loads((jdir / "prior_precision_analytic.json").read_text())
    for key in ("lambda_img", "lambda_txt"):
        assert run[key] == pytest.approx(info[key], rel=1e-4)
    A, _ = load_hessians(tdir, "txt")
    assert A.shape == (CFG.text.hidden_size, CFG.text.hidden_size)
    shutil.rmtree(jdir)
