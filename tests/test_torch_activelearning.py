"""The port's active-learning CLI (`bayesvlm_tpu_torch.activelearning`)
against the JAX package's (`scripts/activelearning.py`) on the CPU, and
what both of the port's active-learning CLIs refuse (the k-means
variant's parity: tests/test_torch_activelearning_kmeans.py): tiny-clip with the JAX CLI's seed-0 towers bridged into the port,
fp32 (the JAX CLI's tower loader and GEMM cast patched to fp32 inside
the test), the `synthetic` dataset cut to tests/test_activelearning.py's
sizes (64 train, 32 test, 4 classes) with 16 val images, 2 fine-tune
epochs, 8 EPIG samples. The JAX package's draws are handed to the port:
its Gaussian noise through `types._normal`, its permutations and
categorical draws through `select/draws.py`.

Tolerances, each package computing its own features from the same
weights and images:
  - indices of every strategy: exact;
  - kNN similarities and entropy scores: rtol 1e-4, atol 1e-5: the two
    packages' fp32 features differ by summation order (~1e-6 relative),
    and -wdist2 is a difference of squared norms, which loses up to two
    decimal digits to cancellation;
  - EPIG scores: 2e-3 (tests/test_torch_epig_online.py: bf16 operands);
  - each fine-tuned projection by the relative Frobenius norm of its
    update (W - W0) against JAX's, at 1e-3: Adam's m / sqrt(v) amplifies
    a rounding difference where a gradient element is near 0, which no
    elementwise bound survives;
  - metrics.jsonl: the same lines, keys and steps; the accuracies equal;
    ECE and losses at rtol 1e-4.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesvlm_tpu.data.factory as jax_factory
import bayesvlm_tpu.models as jax_models
import bayesvlm_tpu.models.encoders as jax_encoders
from bayesvlm_tpu_torch import activelearning, activelearning_kmeans
from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
from bayesvlm_tpu_torch.models.bridge import save_weights
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from test_torch_selection import inject_jax_draws

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
import activelearning as jax_al  # noqa: E402

SIZES = dict(num_train=64, num_val=16, num_test=32, num_classes=4, image_size=32)
KW = dict(model_str="tiny-clip", dataset="synthetic", project_name="test",
          hessian_scale=10.0, subset_size=4, predictions_batch_size=32,
          precompute_batch_size=16, precompute_num_workers=0, finetune_lr=1e-3,
          finetune_wd=1e-2, finetune_epochs=2, finetune_batch_size=8,
          epig_num_samples=8, k_nearest=1, knn_method="wasserstein")
AL_KW = dict(KW, epig_pool_max_size=32, epig_target_max_size=16)
SIM_RTOL, SIM_ATOL = 1e-4, 1e-5
EPIG_TOL = 2e-3
PROJ_TOL = 1e-3
METRIC_RTOL = 1e-4
AL_STRATEGIES = (["entropy_map", "entropy_map_train", "bald_test", "epig_knn"]
                 + [f"random_on_test_{i}" for i in range(5)]
                 + [f"random_on_train_{i}" for i in range(5)])


def _jax_cli_fp32_on_sizes(mp):
    """The JAX CLIs in fp32, on SIZES: its tower loader, GEMM cast and
    datamodule factory patched (the JAX package is not edited)."""
    load = jax_models.load_model
    mp.setattr(jax_models, "load_model",
               lambda *a, **k: load(*a, **{**k, "dtype": jnp.float32}))
    mp.setattr(jax_encoders, "cast_gemm_params", lambda params, *a, **k: params)
    create = jax_factory.DataModuleFactory.create
    mp.setattr(jax_factory.DataModuleFactory, "create",
               lambda self, name, **o: create(self, name, **{**SIZES, **o}))


def run_both(tmp_path_factory, jax_cli, port_cli, kw) -> dict:
    """One CLI of each package on the same weights, Hessians, images and
    draws, each in its own experiment directory."""
    tmp = tmp_path_factory.mktemp("al")
    hdir = save_synthetic_hessians(tmp / "hessians", CONFIGS_BY_NAME["tiny-clip"], seed=0)
    j_img, j_txt, _ = jax_models.load_model("tiny-clip", dtype=jnp.float32, seed=0)
    wd = save_weights(tmp / "weights", jax.tree_util.tree_map(np.asarray, j_img.params),
                      jax.tree_util.tree_map(np.asarray, j_txt.params))
    out = {"tmp": tmp, "hdir": hdir, "wd": wd,
           "w0": torch.from_numpy(np.asarray(j_img.params["visual_projection"]["kernel"]).T)}
    with pytest.MonkeyPatch.context() as mp:
        _jax_cli_fp32_on_sizes(mp)
        inject_jax_draws(mp)
        out["jax"] = jax_cli.main(**kw, hessian_dir=str(hdir),
                                  experiment_dir=str(tmp / "jax"))
        out["port"] = port_cli.run(**kw, **port_kwargs(out, tmp / "port"))
    return out


def port_kwargs(runs: dict, experiment_dir: Path) -> dict:
    return dict(hessian_dir=str(runs["hdir"]), experiment_dir=str(experiment_dir),
                weights_dir=str(runs["wd"]), device="cpu", dtype="fp32",
                dataset_overrides=SIZES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(tmp_path_factory, jax_al, activelearning, AL_KW)


def _subset_dir(root: Path, prefix: str) -> Path:
    (d,) = [p for p in (root / "synthetic").iterdir() if p.name.startswith(prefix)]
    return d


def _assert_subsets_match(port: dict, ref: dict) -> None:
    assert list(port) == list(ref)
    for name, by_test in ref.items():
        assert list(port[name]) == list(by_test), name
        tol = (EPIG_TOL, EPIG_TOL) if name.startswith("epig") else (SIM_RTOL, SIM_ATOL)
        for key, want in by_test.items():
            got = port[name][key]
            assert got["indices"] == want["indices"], (name, key)
            np.testing.assert_allclose(got["similarities"], want["similarities"],
                                       rtol=tol[0], atol=tol[1], err_msg=name)
            np.testing.assert_allclose(got["score"], want["score"], rtol=SIM_RTOL,
                                       atol=SIM_ATOL, err_msg=name)


def _read_jsonl(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def _assert_finetunes_match(port_dir: Path, jax_dir: Path, strategies, w0) -> None:
    for name in strategies:
        got = torch.load(port_dir / name / "img_projection.pt", weights_only=True)
        want = torch.load(jax_dir / name / "img_projection.pt", weights_only=True)
        assert set(got) == set(want) == {"weight"}, name
        d_port, d_jax = got["weight"] - w0, want["weight"] - w0
        rel = float(torch.linalg.norm(d_port - d_jax) / torch.linalg.norm(d_jax))
        assert rel <= PROJ_TOL, (name, rel)
        lines, ref = (_read_jsonl(d / name / "metrics.jsonl") for d in (port_dir, jax_dir))
        assert len(lines) == len(ref), name
        for a, b in zip(lines, ref):
            assert set(a) == set(b), name
            for k, v in b.items():
                if k in ("_config", "_name", "_step") or "accuracy" in k:
                    assert a[k] == v, (name, k)
                else:
                    assert a[k] == pytest.approx(v, rel=METRIC_RTOL, abs=1e-7), (name, k)


def check_cli_matches_jax(runs: dict, prefix: str, strategies: list) -> None:
    port, ref = runs["port"], runs["jax"]
    assert list(port["results"]) == list(ref) == strategies
    jax_dir = _subset_dir(runs["tmp"] / "jax", prefix)
    assert port["subset_dir"].name == jax_dir.name
    _assert_subsets_match(
        json.loads((port["subset_dir"] / "subset_indices_train.json").read_text()),
        json.loads((jax_dir / "subset_indices_train.json").read_text()))
    _assert_finetunes_match(port["subset_dir"], jax_dir, strategies, runs["w0"])
    for name, m in ref.items():
        for k, v in m.items():
            assert port["results"][name][k] == pytest.approx(v, rel=METRIC_RTOL), (name, k)
    assert list(port["strategy_seconds"]) == strategies
    assert list(port["finetune"]) == strategies
    assert all(t["steps"] >= t["epochs"] >= 1 for t in port["finetune"].values())


def check_resume(runs: dict, port_cli, kw: dict, tmp_path: Path) -> None:
    """The port's CLI on a copy of the JAX CLI's directory reads its
    feature caches and JSON, recomputes no strategy and re-trains no
    subset."""
    exp = tmp_path / "resume"
    shutil.copytree(runs["tmp"] / "jax", exp)

    def state(p):  # the JSON is saved again at the end of [3], as in JAX
        return (p.read_bytes(), None if p.suffix == ".json" else p.stat().st_mtime_ns)

    files = {p: state(p) for p in exp.rglob("*") if p.is_file()}
    out = port_cli.run(**kw, **port_kwargs(runs, exp))
    assert out["results"] == {} and out["strategy_seconds"] == {}
    assert out["finetune"] == {}
    assert {p: state(p) for p in files} == files
    assert not any(p.name == "img_projection.pt" and p not in files for p in exp.rglob("*"))


def test_activelearning_matches_jax(runs):
    check_cli_matches_jax(runs, "subset_", AL_STRATEGIES)
    assert set(runs["port"]["seconds"]) == {
        "[1] features", "[1] lambda + covariances", "[2] predictions", "[3] strategies",
        "[4] fine-tuning"}
    assert all(t["epochs"] == 2 for t in runs["port"]["finetune"].values())


def test_resume_on_a_directory_the_jax_cli_wrote(runs, tmp_path):
    check_resume(runs, activelearning, AL_KW, tmp_path)


@pytest.mark.parametrize("cli", [activelearning, activelearning_kmeans])
def test_conflicting_epig_flags_fail_fast(cli, monkeypatch):
    loaded = _stub_loaders(monkeypatch)
    with pytest.raises(ValueError, match="only_epig and without_epig"):
        cli.main(**{**KW, "only_epig": True, "without_epig": True},
                 hessian_dir="/nonexistent", experiment_dir="/nonexistent",
                 device="cpu")
    assert loaded == []


def _stub_loaders(monkeypatch) -> list:
    import bayesvlm_tpu_torch.data.factory as factory
    import bayesvlm_tpu_torch.models.encoders as encoders

    loaded = []
    for mod, attr in ((factory, "DataModuleFactory"), (encoders, "load_model")):
        monkeypatch.setattr(mod, attr, lambda *a, _n=attr, **k: loaded.append(_n))
    return loaded


@pytest.mark.parametrize("env", [{"COORDINATOR_ADDRESS": "localhost:1234"},
                                 {"JAX_COORDINATOR_ADDRESS": "localhost:1234"},
                                 {"NUM_PROCESSES": "2"}])
@pytest.mark.parametrize("cli", [activelearning, activelearning_kmeans])
def test_multi_process_launch_is_refused_before_loading(cli, env, monkeypatch, tmp_path):
    """The multi-process launch is ported (tests/test_torch_dist_activelearning.py):
    the main CLI refuses a launch named in part (an address without
    NUM_PROCESSES / PROCESS_ID, or NUM_PROCESSES > 1 without an address)
    before anything loads; the k-means CLI, like the JAX one, never joins
    a launch and starts loading as one process."""
    loaded = _stub_loaders(monkeypatch)
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(**KW, hessian_dir=str(tmp_path / "h"), experiment_dir=str(tmp_path / "exp"),
              device="cpu")
    if cli is activelearning:
        with pytest.raises(ValueError, match="names a launch"):
            cli.main(**kw)
        assert loaded == [] and not (tmp_path / "exp").exists()
    else:
        with pytest.raises(AttributeError):  # the stubbed factory returns None
            cli.main(**kw)
        assert loaded == ["DataModuleFactory"]


@pytest.mark.parametrize("cli", [activelearning, activelearning_kmeans])
def test_no_card_is_refused_unless_the_cpu_is_asked_for(cli, monkeypatch, tmp_path):
    loaded = _stub_loaders(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(**KW, hessian_dir=str(tmp_path / "h"),
                 experiment_dir=str(tmp_path / "exp"))
    assert loaded == [] and not (tmp_path / "exp").exists()


def _jax_flags(script: str) -> dict:
    """--flag -> default of every add_argument call in a JAX CLI script."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            kw = {k.arg: k.value for k in node.keywords}
            action = kw.get("action")
            default = (False if action is not None and ast.literal_eval(action) == "store_true"
                       else ast.literal_eval(kw["default"]) if "default" in kw else None)
            flags[node.args[0].value] = default
    return flags


@pytest.mark.parametrize("cli,script", [(activelearning, "activelearning.py"),
                                        (activelearning_kmeans, "activelearning_kmeans.py")])
def test_cli_takes_every_jax_flag_with_its_default(cli, script):
    jax_flags = _jax_flags(script)
    assert len(jax_flags) >= 25
    # the k-means CLI requires --hessian_dir (no default), as in JAX
    required = jax_flags["--hessian_dir"] is None
    args = vars(cli._parser().parse_args(["--hessian_dir", "h"] if required else []))
    for flag, default in jax_flags.items():
        got = args[flag.lstrip("-")]
        if flag == "--device":
            assert (default, got) == ("tpu", "cuda")
        elif not (required and flag == "--hessian_dir"):
            assert got == default, flag
    assert args["dtype"] == "bf16"
    assert "TPU" not in cli._parser().format_help()


def test_cli_runs_without_jax(tmp_path):
    """`python -m bayesvlm_tpu_torch.activelearning --device cpu --dtype
    fp32 --dataset synthetic` prints the JAX CLI's steps and loads no
    module of JAX or of the JAX package."""
    hdir = save_synthetic_hessians(tmp_path / "h", CONFIGS_BY_NAME["tiny-clip"], seed=0)
    argv = ["activelearning", "--model", "tiny-clip", "--dataset", "synthetic",
            "--hessian_dir", str(hdir), "--experiment_dir", str(tmp_path / "exp"),
            "--device", "cpu", "--dtype", "fp32", "--subset_size", "4",
            "--finetune_epochs", "1", "--epig_num_samples", "4",
            "--precompute_num_workers", "0"]
    code = (f"import runpy, sys; sys.argv = {argv!r}; "
            "runpy.run_module('bayesvlm_tpu_torch.activelearning', run_name='__main__'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'bayesvlm_tpu')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    for step in ("[1] Precomputing features ...", "[2] Making predictions ...",
                 "[3] Creating training subsets ...",
                 "[4] Fine-tuning based on training subsets ..."):
        assert step in lines
    assert len(list((tmp_path / "exp").rglob("img_projection.pt"))) == 14
