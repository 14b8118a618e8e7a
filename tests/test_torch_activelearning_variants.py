"""The port's EGL and LLM active-learning CLIs
(`bayesvlm_tpu_torch.activelearning_elg` / `activelearning_llm`) against
the JAX package's (`scripts/activelearning_elg.py` / `activelearning_llm.py`)
on the CPU, with the setup, draws and tolerances of
tests/test_torch_activelearning.py (tiny-clip bridged, fp32, `synthetic`
cut to 64 / 16 / 32 images, 4 classes, 2 fine-tune epochs; indices exact,
kNN similarities and scores rtol 1e-4 / atol 1e-5, EPIG 2e-3, each
fine-tuned projection by the relative norm of its update at 1e-3):
  - the EGL CLI's whole strategy set (15 strategies, `egl_test` after
    `bald_test`);
  - the LLM CLI with `only_epig` and both `run_llm_*` flags, one
    deterministic stub client (a score from the prompt's crc32) passed
    to both: its calls counted;
  - the strategy gating of both CLIs against the JAX CLIs' over every
    combination of their flags, both run with the features, selectors and
    fine-tune stubbed (the keys each makes, in order, and the Gemini
    client built only where no client is passed and an LLM strategy is
    due);
  - every JAX flag with its default, the refusals, and both CLIs run in a
    child process with `jax` blocked.
"""

import itertools
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
from test_torch_activelearning import (
    AL_KW,
    _jax_flags,
    _stub_loaders,
    check_cli_matches_jax,
    check_resume,
    run_both,
)
from test_torch_llm import crc_client

import activelearning_elg as jax_elg
import activelearning_llm as jax_llm
import bayesvlm_tpu.inference.predictions as jax_predictions
import bayesvlm_tpu.select.egl as jax_egl_mod
import bayesvlm_tpu.select.epig as jax_epig_mod
import bayesvlm_tpu.select.knn as jax_knn_mod
import bayesvlm_tpu.select.llm as jax_llm_mod
import bayesvlm_tpu.select.scores as jax_scores_mod
import bayesvlm_tpu.train.al_common as jax_al_common
import bayesvlm_tpu_torch.inference.predictions as port_predictions
import bayesvlm_tpu_torch.select.egl as port_egl_mod
import bayesvlm_tpu_torch.select.knn as port_knn_mod
import bayesvlm_tpu_torch.select.llm as port_llm_mod
import bayesvlm_tpu_torch.select.scores as port_scores_mod
import bayesvlm_tpu_torch.train.al_common as port_al_common
from bayesvlm_tpu_torch import activelearning_elg, activelearning_llm
from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

REPO = Path(__file__).resolve().parent.parent
SHARED = (["entropy_map", "entropy_map_train", "bald_test"], ["epig_knn"],
          [f"random_on_test_{i}" for i in range(5)] + [f"random_on_train_{i}" for i in range(5)])
ELG_STRATEGIES = SHARED[0] + ["egl_test"] + SHARED[1] + SHARED[2]
LLM_STRATEGIES = ["epig_knn", "llm_difficulty_test", "llm_value_test"]
N_TEST = 32  # SIZES["num_test"], every class with a prompt


class CountingClient:
    def __init__(self):
        self.calls = 0

    def __call__(self, prompt):
        self.calls += 1
        return crc_client(prompt)


@pytest.fixture(scope="module")
def elg_runs(tmp_path_factory):
    return run_both(tmp_path_factory, jax_elg, activelearning_elg, AL_KW)


@pytest.fixture(scope="module")
def llm_runs(tmp_path_factory):
    client = CountingClient()
    kw = dict(AL_KW, only_epig=True, run_llm_difficulty=True, run_llm_value=True,
              llm_rate_limit_delay=0.0, llm_client=client)
    runs = run_both(tmp_path_factory, jax_llm, activelearning_llm, kw)
    runs["client_calls"] = client.calls
    runs["kw"] = kw
    return runs


def test_elg_matches_jax(elg_runs):
    check_cli_matches_jax(elg_runs, "elg_subset_", ELG_STRATEGIES)
    port = elg_runs["port"]
    assert port["subset_dir"].name == "elg_subset_4_k_1_n_10.0_knn_wasserstein"
    lines = (port["subset_dir"] / "egl_test" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[0])["_config"]["strategy"] == "egl"


def test_elg_resume_on_a_directory_the_jax_cli_wrote(elg_runs, tmp_path):
    check_resume(elg_runs, activelearning_elg, AL_KW, tmp_path)


def test_llm_matches_jax(llm_runs):
    check_cli_matches_jax(llm_runs, "llm_difficulty_subset_", LLM_STRATEGIES)
    # both CLIs scored every test image twice (difficulty, value)
    assert llm_runs["client_calls"] == 2 * 2 * N_TEST
    port = llm_runs["port"]
    assert port["subset_dir"].name == "llm_difficulty_subset_4_k_1_n_10.0_knn_wasserstein"
    cfg = json.loads((port["subset_dir"] / "llm_value_test" / "metrics.jsonl")
                     .read_text().splitlines()[0])["_config"]
    assert cfg["llm_model"] == "gemini-1.5-flash-latest" and cfg["llm_score_type"] == "difficulty"


def test_llm_resume_on_a_directory_the_jax_cli_wrote(llm_runs, tmp_path):
    client = CountingClient()
    check_resume(llm_runs, activelearning_llm, dict(llm_runs["kw"], llm_client=client),
                 tmp_path)
    assert client.calls == 0


# -- the gating, against the JAX CLIs, with everything heavy stubbed -------


def _stub_both(mp, tmp: Path, made_clients: list):
    """Both packages' CLIs run on a fake step [1] (a mock context), fake
    selectors and a fine-tune that returns the strategies' names in
    order: each run's result is the list of keys it made."""
    def ctx(experiment_dir):
        c = mock.MagicMock()
        c.run_dir = Path(experiment_dir)
        c.seconds = {"features": 0.0, "lambda + covariances": 0.0}
        c.device = torch.device("cpu")
        c.dm.class_prompts = ["a", "b"]
        c.image_ids_test, c.class_ids_test = np.arange(4), np.zeros(4, np.int64)
        c.image_encoder.projection_tree.return_value = {"kernel": None}
        return c

    topk = lambda *a, k, return_values=False, **kw: (
        (np.arange(k), np.ones(k)) if return_values else np.arange(k))
    knn = lambda train, test, idx, vals, *a, **k: {
        int(i): dict(score=1.0, indices=[int(i)], similarities=[1.0]) for i in idx}
    finetune = lambda c, subsets, *a, **k: list(subsets)
    gemini = lambda name="gemini-pro", **k: made_clients.append(name) or crc_client
    llm = lambda ids, cids, prompts, k, client, **kw: (np.arange(k), np.ones(k))
    for predictions, scores, knn_mod, llm_mod, egl_mod, al in (
            (jax_predictions, jax_scores_mod, jax_knn_mod, jax_llm_mod, jax_egl_mod,
             jax_al_common),
            (port_predictions, port_scores_mod, port_knn_mod, port_llm_mod, port_egl_mod,
             port_al_common)):
        mp.setattr(predictions, "make_predictions", lambda *a, **k: mock.MagicMock())
        mp.setattr(scores, "select_topk", topk)
        mp.setattr(scores, "select_random", lambda logits, k, seed: np.arange(k))
        for name in ("find_similar_samples_cosine", "find_similar_samples_wasserstein"):
            mp.setattr(knn_mod, name, knn)
        mp.setattr(llm_mod, "make_gemini_client", gemini)
        mp.setattr(llm_mod, "select_llm_score", llm)
        mp.setattr(egl_mod, "select_egl", lambda *a, k, **kw: (np.arange(k), np.ones(k)))
        # the experiment directory: setup_context's fourth argument in both
        mp.setattr(al, "setup_context", lambda *a, **k: ctx(a[3]))
        mp.setattr(al, "finetune_all_subsets", finetune)
    mp.setattr(jax_epig_mod, "select_epig_online", lambda **k: ([0], [0.0]))
    mp.setattr(port_al_common, "epig_subset", lambda *a, **k: {
        0: dict(score=0.0, indices=[0], similarities=[0.0])})


def _gated(mp, tmp, jax_main, port_run, flags):
    made = []
    _stub_both(mp, tmp, made)
    kw = dict(model_str="tiny-clip", dataset="synthetic", hessian_dir="h",
              project_name="p", hessian_scale=10.0, subset_size=2)
    want = jax_main(**kw, **flags, experiment_dir=str(tmp / "jax"))
    n_jax = len(made)
    got = port_run(**kw, **flags, experiment_dir=str(tmp / "port"),
                   device="cpu")["results"]
    return want, got, made[:n_jax], made[n_jax:]


ELG_FLAGS = ("only_deterministic_strategies", "only_random_strategies", "only_epig",
             "without_epig", "only_egl")


@pytest.mark.parametrize("on", [c for r in range(len(ELG_FLAGS) + 1)
                                for c in itertools.combinations(ELG_FLAGS, r)])
def test_elg_gating_matches_jax(on, tmp_path):
    flags = dict.fromkeys(on, True)
    with pytest.MonkeyPatch.context() as mp:
        want, got, _, _ = _gated(mp, tmp_path, jax_elg.main, activelearning_elg.run, flags)
    assert got == want
    if "only_egl" in on:
        assert got == ["egl_test"]


LLM_FLAGS = ("only_deterministic_strategies", "only_random_strategies", "only_epig",
             "without_epig", "run_llm_difficulty", "run_llm_value")


@pytest.mark.parametrize("client", [False, True])
@pytest.mark.parametrize("on", [c for r in range(len(LLM_FLAGS) + 1)
                                for c in itertools.combinations(LLM_FLAGS, r)
                                if r <= 2 or set(c) >= {"run_llm_difficulty",
                                                        "run_llm_value"}])
def test_llm_gating_matches_jax(on, client, tmp_path):
    flags = dict.fromkeys(on, True)
    if client:
        flags["llm_client"] = crc_client
    flags["llm_score_type"] = "value"
    with pytest.MonkeyPatch.context() as mp:
        want, got, jax_made, port_made = _gated(mp, tmp_path, jax_llm.main,
                                                activelearning_llm.run, flags)
    assert got == want
    llm_keys = [k for k in got if k.startswith("llm_")]
    if "run_llm_difficulty" in on or "run_llm_value" in on:
        assert llm_keys == [f"llm_{t}_test" for t in ("difficulty", "value")
                            if f"run_llm_{t}" in on]
    else:
        assert llm_keys == (["llm_value_test"] if client else [])
    # a Gemini client is built where no client was passed and an LLM
    # strategy is due, once, with the CLI's model name
    assert port_made == jax_made == ([] if client or not llm_keys
                                     else ["gemini-1.5-flash-latest"])


# -- flags, refusals, a run without JAX ------------------------------------


@pytest.mark.parametrize("cli,script", [(activelearning_elg, "activelearning_elg.py"),
                                        (activelearning_llm, "activelearning_llm.py")])
def test_cli_takes_every_jax_flag_with_its_default(cli, script):
    jax_flags = _jax_flags(script)
    assert len(jax_flags) >= 28
    args = vars(cli._parser().parse_args([]))
    assert set(args) == {f.lstrip("-") for f in jax_flags} | {"dtype"}
    for flag, default in jax_flags.items():
        got = args[flag.lstrip("-")]
        if flag == "--device":
            assert (default, got) == ("tpu", "cuda")
        else:
            assert got == default, flag
    assert args["dtype"] == "bf16"
    assert "TPU" not in cli._parser().format_help()


@pytest.mark.parametrize("cli", [activelearning_elg, activelearning_llm])
def test_no_card_or_several_processes_are_refused_before_loading(cli, monkeypatch,
                                                                 tmp_path):
    loaded = _stub_loaders(monkeypatch)
    kw = dict(model_str="tiny-clip", dataset="synthetic", hessian_dir=str(tmp_path / "h"),
              experiment_dir=str(tmp_path / "exp"), project_name="p", hessian_scale=10.0,
              subset_size=4)
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(**kw)
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="Unknown knn_method"):
        cli.main(**kw, device="cpu", knn_method="l2")
    assert loaded == [] and not (tmp_path / "exp").exists()
    # several processes are not refused: like the JAX CLI, this one never
    # joins a launch and starts loading as one process
    with pytest.raises(AttributeError):  # the stubbed factory returns None
        cli.main(**kw, device="cpu")
    assert loaded == ["DataModuleFactory"]


def test_clis_run_without_jax(tmp_path):
    """`python -m bayesvlm_tpu_torch.activelearning_elg --only_egl` and the
    LLM CLI's `run` with a stub client (the command line would build the
    Gemini client, which reaches a network) on its feature cache (the
    `synthetic` module's default 256 / 64 / 128 images, 10 classes) in a
    child process that loads no module of JAX or of the JAX package."""
    hdir = save_synthetic_hessians(tmp_path / "h", CONFIGS_BY_NAME["tiny-clip"], seed=0)
    common = ["--model", "tiny-clip", "--dataset", "synthetic", "--hessian_dir", str(hdir),
              "--experiment_dir", str(tmp_path / "exp"), "--device", "cpu", "--dtype",
              "fp32", "--subset_size", "4", "--finetune_epochs", "1",
              "--precompute_num_workers", "0"]
    code = f"""
import runpy, sys, zlib
sys.modules["jax"] = None
sys.argv = ["activelearning_elg"] + {common!r} + ["--only_egl"]
runpy.run_module("bayesvlm_tpu_torch.activelearning_elg", run_name="__main__")
from bayesvlm_tpu_torch import activelearning_llm
calls = []
def client(prompt):
    calls.append(prompt)
    return str(1 + zlib.crc32(prompt.encode()) % 5)
out = activelearning_llm.run(model_str="tiny-clip", dataset="synthetic",
    hessian_dir={str(hdir)!r}, experiment_dir={str(tmp_path / "exp")!r},
    project_name="p", hessian_scale=10.0, subset_size=4, finetune_epochs=1,
    precompute_num_workers=0, only_deterministic_strategies=True,
    run_llm_value=True, llm_rate_limit_delay=0.0, llm_client=client,
    device="cpu", dtype="fp32")
print("LLM", list(out["subsets"]), len(calls))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "bayesvlm_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert "[3] Creating training subsets (EGL variant, full strategy set) ..." in lines
    assert "[3] Creating training subsets (LLM variant, full strategy set) ..." in lines
    llm_line = next(line for line in lines if line.startswith("LLM "))
    assert llm_line == ("LLM ['entropy_map', 'entropy_map_train', 'bald_test', "
                        "'llm_value_test'] 128")
    exp = tmp_path / "exp" / "synthetic"
    # the parser's default --hessian_scale is the int 10, as in the JAX CLI
    assert (exp / "elg_subset_4_k_1_n_10_knn_wasserstein" / "egl_test"
            / "img_projection.pt").exists()
    assert len(list(exp.rglob("img_projection.pt"))) == 5
