"""The port's checkpoint lane (`io/dcp_ckpt.py`, torch.distributed.checkpoint)
and `convert_artifacts` against the JAX package's orbax lane and
`scripts/convert_artifacts.py`: the counterparts of tests/test_orbax_ckpt.py,
test_convert_artifacts.py and test_orbax_multiprocess.py. A `.pt` Hessian
directory written by the JAX package's `io.artifacts` goes to
`factors_dcp/` and back bit for bit, read by both packages; trees round
trip exactly (dtypes kept); the Stage-1 CLI's `--save_orbax` writes the
factors it saves as `.pt`; and one spawn of 2 gloo ranks
(tests/_torch_dist_workers.py, job "dcp") saves a row-sharded tensor and
restores it at world 2 (each rank its rows) and, here, at world 1."""

import numpy as np
import pytest
import torch

from _torch_dist_workers import dcp_rows, spawn
from bayesvlm_tpu_torch import convert_artifacts
from bayesvlm_tpu_torch.io import artifacts
from bayesvlm_tpu_torch.io.dcp_ckpt import (
    FACTORS_SUBDIR,
    StepCheckpoints,
    async_save_pytree,
    checkpoint_metadata,
    dcp_to_hessians,
    has_dcp_factors,
    hessians_to_dcp,
    load_hessians_dcp,
    load_pytree,
    remove_checkpoint,
    save_pytree,
)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"kernel": torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)),
                       "bias": torch.from_numpy(rng.normal(size=(8,))).to(torch.bfloat16)},
            "step": np.int64(7), "ints": torch.arange(5, dtype=torch.int32), "lr": 0.5}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        elif isinstance(a[k], (torch.Tensor, np.ndarray, np.generic)):
            want = torch.as_tensor(np.asarray(a[k])) if not isinstance(a[k], torch.Tensor) \
                else a[k]
            assert b[k].dtype == want.dtype, k
            assert torch.equal(b[k], want), k
        else:
            assert b[k] == a[k], k


def _jax_pt_dir(d, seed=0, d_in=6, d_out=4):
    """A .pt Hessian directory as the JAX package writes it."""
    from bayesvlm_tpu.io.artifacts import save_hessians, save_prior_precision

    rng = np.random.default_rng(seed)
    f = {k: rng.standard_normal(shape).astype(np.float32) for k, shape in (
        ("A_img", (d_in, d_in)), ("B_img", (d_out, d_out)),
        ("A_txt", (d_in, d_in)), ("B_txt", (d_out, d_out)))}
    save_hessians(d, f["A_img"], f["B_img"], "img")
    save_hessians(d, f["A_txt"], f["B_txt"], "txt")
    save_prior_precision(d, 12.5, 3.0, 7.25, 2.0)
    return f


def test_roundtrip_and_overwrite(tmp_path):
    save_pytree(tmp_path / "ck", _tree(0))
    _assert_tree_equal(_tree(0), load_pytree(tmp_path / "ck"))
    save_pytree(tmp_path / "ck", _tree(1))
    _assert_tree_equal(_tree(1), load_pytree(tmp_path / "ck"))
    with pytest.raises(FileExistsError):
        save_pytree(tmp_path / "ck", _tree(2), overwrite=False)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]  # no temporaries left


def test_async_save_snapshots_and_waits(tmp_path):
    tree = _tree()
    kernel = tree["params"]["kernel"]
    want = kernel.clone()
    with async_save_pytree(tmp_path / "ck", tree) as handle:
        kernel.fill_(-1.0)  # the save holds its own copy
    handle.wait()  # a second wait is a no-op
    got = load_pytree(tmp_path / "ck")
    assert torch.equal(got["params"]["kernel"], want)


def test_metadata_reads_no_data(tmp_path, monkeypatch):
    save_pytree(tmp_path / "ck", _tree())
    import torch.distributed.checkpoint as dcp

    monkeypatch.setattr(dcp.FileSystemReader, "read_data",
                        lambda *a, **k: pytest.fail("tensor data was read"))
    meta = checkpoint_metadata(tmp_path / "ck")
    assert meta["params"]["kernel"].shape == (16, 8)
    assert meta["params"]["bias"].dtype == torch.bfloat16
    assert meta["step"].shape == () and meta["lr"].dtype is None


def test_restore_like_casts_nothing_and_keeps_layout(tmp_path):
    save_pytree(tmp_path / "ck", _tree())
    like = {"params": {"kernel": torch.zeros(16, 8), "bias": torch.zeros(8, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int64), "ints": torch.zeros(5, dtype=torch.int32),
            "lr": 0.0}
    _assert_tree_equal(_tree(), load_pytree(tmp_path / "ck", like=like))


def test_step_checkpoints_retention(tmp_path):
    with StepCheckpoints(tmp_path / "steps", max_to_keep=2) as mgr:
        for step in range(3):
            mgr.save(step, {"w": torch.full((4,), float(step))}, wait=True)
        assert mgr.latest_step() == 2
        assert list(mgr.all_steps()) == [1, 2]  # step 0 dropped
        assert torch.equal(mgr.restore()["w"], torch.full((4,), 2.0))
        assert torch.equal(mgr.restore(1)["w"], torch.full((4,), 1.0))
        mgr.save(3, {"w": torch.full((4,), 3.0)})  # in the background
    assert StepCheckpoints(tmp_path / "steps").all_steps() == [2, 3]
    with pytest.raises(FileNotFoundError):
        StepCheckpoints(tmp_path / "none").restore()


def test_pt_to_dcp_in_place_then_back_bit_for_bit(tmp_path):
    """tests/test_convert_artifacts.py:35-56 on the port's CLI: the JAX
    package's .pt directory to factors_dcp/ (the only lane left once the
    .pt files go: load_hessians falls back to it), then back to .pt files
    the JAX package reads."""
    from bayesvlm_tpu.io.artifacts import load_hessians as jax_load_hessians

    d = tmp_path / "hessian_X"
    f = _jax_pt_dir(d)
    assert not has_dcp_factors(d)
    assert convert_artifacts.main(str(d), "orbax") == d / FACTORS_SUBDIR
    assert has_dcp_factors(d)
    for p in d.glob("*_analytic.pt"):
        p.unlink()
    for tag in ("img", "txt"):
        A, B, info = artifacts.load_hessians(d, tag, return_info=True)
        assert A.dtype == B.dtype == torch.float32
        assert np.array_equal(A.numpy(), f[f"A_{tag}"])
        assert np.array_equal(B.numpy(), f[f"B_{tag}"])
    assert info == {"lambda_img": 12.5, "n_img": 3.0, "lambda_txt": 7.25, "n_txt": 2.0}
    convert_artifacts.main(str(d), "pt")
    for tag in ("img", "txt"):
        A, B = jax_load_hessians(d, tag)
        assert np.array_equal(np.asarray(A), f[f"A_{tag}"])
        assert np.array_equal(np.asarray(B), f[f"B_{tag}"])


def test_out_dir_copies_prior_precision(tmp_path):
    src, dst, back = tmp_path / "src", tmp_path / "dst", tmp_path / "back"
    f = _jax_pt_dir(src, seed=1)
    hessians_to_dcp(src, dst)
    assert artifacts.load_info(dst) == artifacts.load_info(src)
    assert not list(dst.glob("*.pt"))
    dcp_to_hessians(dst, back)
    assert artifacts.load_info(back) == artifacts.load_info(src)
    A, B = artifacts.load_hessians(back, "img")
    assert np.array_equal(A.numpy(), f["A_img"]) and np.array_equal(B.numpy(), f["B_img"])
    with pytest.raises(ValueError):
        load_hessians_dcp(dst, "imgg")
    remove_checkpoint(dst / FACTORS_SUBDIR)
    remove_checkpoint(dst / FACTORS_SUBDIR)  # idempotent
    assert not has_dcp_factors(dst)


def test_jax_orbax_directory_stays_refused_by_name(tmp_path):
    (tmp_path / "factors_orbax").mkdir()
    with pytest.raises(FileNotFoundError, match="factors_orbax.*convert_artifacts"):
        artifacts.load_hessians(tmp_path, "img")


def test_stage1_save_orbax_writes_factors_dcp(tmp_path):
    """hessian_estimation --save_orbax: the factors it writes as .pt, again
    under factors_dcp/, bit for bit."""
    from bayesvlm_tpu_torch import hessian_estimation

    out = tmp_path / "h"
    hessian_estimation.main(
        dataset="synthetic", model_str="tiny-clip", precompute_batch_size=8,
        la_num_classes=8, la_batch_size=4, num_workers=0, hessian_dir=str(out),
        max_datapoints=16, num_steps=3, use_mesh=False, save_orbax=True, device="cpu",
        dtype="fp32", dataset_overrides={"num_train": 16, "num_test": 8})
    for tag in ("img", "txt"):
        pt = [torch.load(out / f"{n}_{tag}_analytic.pt", weights_only=True) for n in "AB"]
        dcp = load_hessians_dcp(out, tag)
        assert all(torch.equal(a, b) for a, b in zip(pt, dcp))


@pytest.fixture(scope="module")
def dcp_outcomes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcp")
    one = tmp / "one_process"
    _jax_pt_dir(one, seed=2, d_in=9, d_out=5)
    hessians_to_dcp(one)
    return tmp, spawn(2, "dcp", {"dir": str(tmp), "one_process_dir": str(one)},
                      tmp / "run")


@pytest.mark.parametrize("check", ["sharded_save", "sharded_restore", "whole_restore",
                                   "like_restore", "other_world_restore"])
def test_two_rank_sharded_save_restore(dcp_outcomes, check):
    for rank, out in enumerate(dcp_outcomes[1]):
        assert out[check] == "ok", f"rank {rank}:\n{out[check]}"


def test_two_rank_checkpoint_restores_at_world_one(dcp_outcomes):
    got = load_pytree(dcp_outcomes[0] / "sharded")
    assert torch.equal(got["w"], torch.from_numpy(dcp_rows()))
    assert got["step"] == 3 and torch.equal(got["bias"], torch.ones(3))
