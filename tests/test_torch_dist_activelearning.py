"""The port's active-learning CLI as two gloo ranks on the CPU against
its own one-process run (each a torch.multiprocessing.spawn, with the
same threads), tiny-clip in fp32 on the synthetic split sizes of
tests/test_torch_activelearning.py: each rank encodes its stripe of the
batches, the selection (the sharded EPIG and kNN) and the fine-tune run
replicated, and the run selects the same indices and writes the same
metrics as one process. Rank 1 writes only under `_replica_host1`."""

import json
from pathlib import Path

import pytest

from _torch_dist_workers import spawn
from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

SIZES = dict(num_train=64, num_val=16, num_test=32, num_classes=4, image_size=32)
KW = dict(model_str="tiny-clip", dataset="synthetic", project_name="test",
          hessian_scale=10.0, subset_size=4, predictions_batch_size=32,
          precompute_batch_size=16, precompute_num_workers=0, finetune_lr=1e-3,
          finetune_wd=1e-2, finetune_epochs=2, finetune_batch_size=8,
          epig_num_samples=8, k_nearest=1, knn_method="wasserstein",
          epig_pool_max_size=32, epig_target_max_size=16, device="cpu", dtype="fp32",
          dataset_overrides=SIZES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    hdir = save_synthetic_hessians(tmp_path_factory.mktemp("hessians"),
                                   CONFIGS_BY_NAME["tiny-clip"], seed=0)
    out = {}
    for world in (1, 2):
        exp = tmp_path_factory.mktemp(f"exp{world}")
        ranks = spawn(world, "activelearning",
                      {"kw": dict(KW, hessian_dir=str(hdir), experiment_dir=str(exp))},
                      tmp_path_factory.mktemp(f"ranks{world}"))
        out[world] = dict(exp=exp, ranks=ranks)
    return out


def _files(root: Path) -> set:
    return {str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()}


def test_two_ranks_select_and_train_as_one_process(runs):
    for world in (1, 2):
        for rank, out in enumerate(runs[world]["ranks"]):
            assert out["cli"] == "ok", f"rank {rank} of {world}:\n{out['cli']}"
    (one,), (r0, r1) = (out["data"] for out in runs[1]["ranks"]), (
        out["data"] for out in runs[2]["ranks"])
    assert r0["subsets"] == r1["subsets"] == one["subsets"]
    assert len(one["subsets"]) == 14 and "epig_knn" in one["subsets"]
    assert r0["results"] == r1["results"] == one["results"]
    (subsets,) = (runs[2]["exp"] / "synthetic").glob("subset_*/subset_indices_train.json")
    (subsets1,) = (runs[1]["exp"] / "synthetic").glob("subset_*/subset_indices_train.json")
    assert json.loads(subsets.read_text()) == json.loads(subsets1.read_text())


def test_rank_one_writes_only_its_replica_logs(runs):
    one, two = _files(runs[1]["exp"]), _files(runs[2]["exp"])
    replica = {f for f in two if "_replica_host1" in Path(f).parts}
    assert two - replica == one
    strategies = {Path(f).parts[2] for f in replica}
    assert len(strategies) == 14
    for f in replica:
        assert Path(f).name == "metrics.jsonl", f
    # the replica trained as rank 0: the same logged metrics
    for f in replica:
        mine = Path(f).parent.parent / "metrics.jsonl"
        assert (runs[2]["exp"] / f).read_text() == (runs[2]["exp"] / mine).read_text()
