"""The port imports, and reads real checkpoints, on a machine without the
host-side packages the card machine lacks: `transformers`, `PIL`,
`sklearn`, `pandas`, `datasets`, `safetensors` and `wandb` are blocked in
a fresh interpreter (`sys.modules[name] = None`), which then imports every
module of the package (the serving and active-learning modules among
them), prints the CLIs' `--help` (`serve_cli` and both active-learning
CLIs too), writes a fine-tune's `metrics.jsonl` through `ExperimentLogger`
(wandb blocked), and loads fp16 safetensors and fp32 `.bin`
snapshots of tiny-siglip through `load_model` and `convert_weights`. No
module of JAX or of the JAX package is loaded on the way. The EGL and LLM
selectors, the backbone fine-tune and their CLIs also import with `jax`,
`triton` and `google.generativeai` blocked, and so do `dist/` and the
modules whose mesh paths it serves, and the serving mesh, `dist/tp.py`,
the checkpoint lane with `convert_artifacts`, `profiling` and the
preflight (whose two CLIs print their --help)."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.models.encoders import load_model

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("transformers", "PIL", "sklearn", "pandas", "datasets", "safetensors", "wandb")
PREAMBLE = textwrap.dedent(f"""
    import sys
    for name in {BLOCKED!r}:
        sys.modules[name] = None
""")


def _run(code: str):
    proc = subprocess.run([sys.executable, "-c", PREAMBLE + textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_every_module_imports_without_the_host_packages():
    out = _run("""
        import importlib, pkgutil, runpy
        import bayesvlm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(bayesvlm_tpu_torch.__path__,
                                                       "bayesvlm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        for cli in ("zeroshot", "hessian_estimation", "convert_weights", "serve_cli",
                    "activelearning", "activelearning_kmeans"):
            sys.argv = [cli, "--help"]
            try:
                runpy.run_module(f"bayesvlm_tpu_torch.{cli}", run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (cli, e.code)
        import tempfile
        from bayesvlm_tpu_torch.train import ExperimentLogger
        with tempfile.TemporaryDirectory() as d:
            logger = ExperimentLogger("p", d, name="n", config={"lr": 1.0})
            logger.log({"val_loss": 0.5}, step=1)
            logger.finish()
            with open(d + "/metrics.jsonl") as f:
                assert len(f.read().splitlines()) == 2
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "bayesvlm_tpu")]
        assert not bad, bad
        for name in %r:
            assert sys.modules[name] is None, name
        print("IMPORTED", len(names))
    """ % (BLOCKED,))
    count = int(out.split("IMPORTED ")[1].split()[0])
    assert count >= 60
    assert "usage: zeroshot" in out and "--tokenizer_dir" in out and "--snapshot" in out
    assert "usage: serve_cli" in out and "--pipeline_depth" in out
    assert "usage: activelearning " in out and "--epig_pool_max_size" in out
    assert "usage: activelearning_kmeans" in out and "--use_minibatch_kmeans" in out


NEW_MODULES = ("bayesvlm_tpu_torch.select.egl", "bayesvlm_tpu_torch.select.llm",
               "bayesvlm_tpu_torch.train.backbone", "bayesvlm_tpu_torch.activelearning_elg",
               "bayesvlm_tpu_torch.activelearning_llm")


def test_stage3_and_backbone_modules_import_without_jax_triton_or_gemini():
    """EGL, the LLM scorer, the backbone fine-tune and their CLIs import,
    and print their --help, with `jax`, `triton` and `google.generativeai`
    blocked besides the host packages (the Gemini client imports its
    package only when it is built)."""
    out = _run("""
        import importlib, runpy
        for name in ("jax", "triton", "google.generativeai"):
            sys.modules[name] = None
        for name in %r:
            importlib.import_module(name)
        for cli in ("activelearning_elg", "activelearning_llm"):
            sys.argv = [cli, "--help"]
            try:
                runpy.run_module(f"bayesvlm_tpu_torch.{cli}", run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (cli, e.code)
        from bayesvlm_tpu_torch.select import llm
        try:
            llm.make_gemini_client()
        except ImportError:
            print("GEMINI ABSENT")
        bad = [m for m in sys.modules if (m.split(".")[0] in
               ("jax", "flax", "bayesvlm_tpu", "triton")
               or m.startswith("google.generativeai")) and sys.modules[m] is not None]
        assert not bad, bad
    """ % (NEW_MODULES,))
    assert "usage: activelearning_elg" in out and "--only_egl" in out
    assert "usage: activelearning_llm" in out and "--run_llm_value" in out
    assert "GEMINI ABSENT" in out


DIST_MODULES = ("bayesvlm_tpu_torch.dist", "bayesvlm_tpu_torch.dist.mesh",
                "bayesvlm_tpu_torch.dist.init", "bayesvlm_tpu_torch.dist.hessian_allreduce",
                "bayesvlm_tpu_torch.bayes.estimation", "bayesvlm_tpu_torch.select.epig",
                "bayesvlm_tpu_torch.select.knn", "bayesvlm_tpu_torch.select.egl",
                "bayesvlm_tpu_torch.select.kmeans",
                "bayesvlm_tpu_torch.inference.predictions",
                "bayesvlm_tpu_torch.train.al_common", "bayesvlm_tpu_torch.hessian_estimation",
                "bayesvlm_tpu_torch.activelearning", "bayesvlm_tpu_torch.zeroshot")


def test_dist_modules_import_without_jax_or_triton():
    """`dist/` and the modules whose mesh paths it serves import with
    `jax` and `triton` blocked besides the host packages, and start no
    process group on import."""
    out = _run("""
        import importlib
        for name in ("jax", "triton"):
            sys.modules[name] = None
        for name in %r:
            importlib.import_module(name)
        import torch.distributed as dist
        from bayesvlm_tpu_torch.dist import __all__ as exports
        assert not dist.is_initialized()
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "flax", "bayesvlm_tpu", "triton") and sys.modules[m] is not None]
        assert not bad, bad
        print("EXPORTS", ",".join(exports))
    """ % (DIST_MODULES,))
    assert "make_mesh,local_rows,sharded_hessian_infonce" in out


LAST_MODULES = ("bayesvlm_tpu_torch.serving_mesh", "bayesvlm_tpu_torch.pipeline",
                "bayesvlm_tpu_torch.dist.tp", "bayesvlm_tpu_torch.io.dcp_ckpt",
                "bayesvlm_tpu_torch.convert_artifacts", "bayesvlm_tpu_torch.profiling",
                "bayesvlm_tpu_torch.preflight")


def test_last_modules_import_without_jax_or_triton():
    """The serving mesh, tensor parallelism, the checkpoint lane with its
    converter, profiling and the preflight import, and the two CLIs print
    their --help, with `jax` and `triton` blocked besides the host
    packages; the preflight then knows `transformers` is absent (its
    parity step is skipped on the card's machine)."""
    out = _run("""
        import importlib, runpy
        for name in ("jax", "triton"):
            sys.modules[name] = None
        for name in %r:
            importlib.import_module(name)
        for cli in ("preflight", "convert_artifacts"):
            sys.argv = [cli, "--help"]
            try:
                runpy.run_module(f"bayesvlm_tpu_torch.{cli}", run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (cli, e.code)
        from bayesvlm_tpu_torch import preflight
        assert not preflight._has_transformers()
        bad = [m for m in sys.modules if m.split(".")[0] in
               ("jax", "flax", "bayesvlm_tpu", "triton") and sys.modules[m] is not None]
        assert not bad, bad
    """ % (LAST_MODULES,))
    assert "usage: preflight" in out and "--skip_parity" in out and "--device" in out
    assert "usage: convert_artifacts" in out and "factors_dcp" in out


@pytest.mark.parametrize("fmt", ["f16", "bin"])
def test_snapshot_loads_without_the_host_packages(fmt, tmp_path):
    """A tiny-siglip snapshot written here (safetensors by the package, fp16)
    loads in the blocked interpreter to the same tensors as here."""
    from chip_smoke import to_hf_state_dict

    cfg = CONFIGS_BY_NAME["tiny-siglip"]
    img, txt, _ = load_model("tiny-siglip", dtype=torch.float32, device="cpu", seed=3)
    sd = to_hf_state_dict("siglip", img.module.state_dict(), txt.module.state_dict(),
                          cfg.vision.num_layers, cfg.text.num_layers, logit_scale=2.5,
                          logit_bias=-4.0)
    snap = tmp_path / "snap"
    snap.mkdir()
    if fmt == "bin":
        torch.save(sd, snap / "pytorch_model.bin")
    else:
        from safetensors.torch import save_file

        save_file({k: v.half().contiguous() for k, v in sd.items()},
                  str(snap / "model.safetensors"))
    _run(f"""
        import torch
        from bayesvlm_tpu_torch import convert_weights
        from bayesvlm_tpu_torch.models.encoders import load_model
        a = load_model("tiny-siglip", weights_dir={str(snap)!r}, dtype=torch.float32,
                       device="cpu")
        convert_weights.main("tiny-siglip", {str(snap)!r}, {str(tmp_path / "conv")!r})
        b = load_model("tiny-siglip", weights_dir={str(tmp_path / "conv")!r},
                       dtype=torch.float32, device="cpu")
        for x, y, name in zip(a[:2], b[:2], ("vision", "text")):
            torch.save(x.module.state_dict(), {str(tmp_path)!r} + f"/{{name}}_a.pt")
            assert all(torch.equal(v, y.module.state_dict()[k])
                       for k, v in x.module.state_dict().items())
        assert (float(a[2].logit_scale), float(a[2].logit_bias)) == (2.5, -4.0)
        assert float(b[2].logit_bias) == -4.0
    """)
    for enc, name in ((img, "vision"), (txt, "text")):
        got = torch.load(tmp_path / f"{name}_a.pt")
        for k, v in enc.module.state_dict().items():
            want = v.half().float() if fmt == "f16" else v
            assert torch.equal(got[k], want), (name, k)
