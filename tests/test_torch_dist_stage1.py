"""The port's Stage-1 CLI as two gloo ranks on the CPU (one
torch.multiprocessing.spawn, both modes), tiny-clip in fp32 on LAION-style
tars written as tests/test_torch_stage1.py writes them: each rank takes
its tars (`shard_for_host`) and caches its features as `*_host{rank}.pt`;
the factors are held against a JAX replay on those caches, JAX's
`kfac_ggn` on each host's features and then JAX's `allreduce_factors`
with an injected allgather, or, with `--dist_global_batch`, JAX's
`kfac_ggn` on the gathered rows, at tests/test_torch_stage1.py's
tolerances (A elementwise, B at 1e-4 of max |B|). Only rank 0 writes the
factors, the prior precision and the final JSON line; a dataset without
`shard_for_host` is refused."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesvlm_tpu.models as jax_models
from _torch_dist_workers import spawn
from bayesvlm_tpu.bayes.estimation import kfac_ggn as jax_kfac_ggn
from bayesvlm_tpu.dist.init import allreduce_factors as jax_allreduce_factors
from bayesvlm_tpu_torch.io.artifacts import load_info
from bayesvlm_tpu_torch.models.bridge import save_weights
from test_torch_stage1 import ATOL, RTOL, _make_laion_tar

TAR_SIZES = (10, 7, 12, 9)  # rank 0 takes tars 0 and 2, rank 1 tars 1 and 3
CLI = dict(dataset="laion400m", precompute_batch_size=4, la_num_classes=8,
           la_batch_size=3, num_workers=0, num_files=4, max_datapoints=24,
           siglip_chunk_size_j=5, lambda_init_txt=10.0, lambda_init_img=10.0, lr=1e-2,
           num_steps=30)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    (base / "laion400m").mkdir()
    start = 0
    for s, n in enumerate(TAR_SIZES):
        _make_laion_tar(base / "laion400m" / f"{s:05d}.tar", start, n)
        start += n
    j_img, j_txt, head = jax_models.load_model("tiny-clip", dtype=jnp.float32, seed=0)
    wd = save_weights(tmp_path_factory.mktemp("weights"),
                      jax.tree_util.tree_map(np.asarray, j_img.params),
                      jax.tree_util.tree_map(np.asarray, j_txt.params))
    return dict(data_dir=str(base), weights_dir=str(wd), head=head)


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Both modes in one spawn of two ranks."""
    tmp = tmp_path_factory.mktemp("stage1")
    hdirs = {mode: tmp / mode for mode in ("per_host", "global_batch")}
    spec = dict(data_dir=setup["data_dir"], weights_dir=setup["weights_dir"], cli=CLI,
                refused_dir=str(tmp / "refused"),
                modes={m: [str(d), m == "global_batch"] for m, d in hdirs.items()})
    ranks = spawn(2, "stage1", spec, tmp / "ranks")
    return {mode: dict(hdir=hdirs[mode], ranks=ranks) for mode in hdirs}


def _features(hdir, name, h):
    return torch.load(hdir / f"{name}_host{h}.pt").numpy()[:CLI["max_datapoints"]]


def _replay(head, hdir, global_batch):
    """The JAX package's factors on the ranks' feature caches: per tag
    (A, B)."""
    kw = dict(block_size=CLI["la_batch_size"])
    C = CLI["la_num_classes"]
    out = {}
    for tag, other in (("img", "txt"), ("txt", "img")):
        per_host = [(_features(hdir, f"embeddings_{tag}", h),
                     _features(hdir, f"activations_{tag}", h),
                     _features(hdir, f"embeddings_{other}", h)) for h in (0, 1)]
        if global_batch:
            cat = [np.concatenate(x) for x in zip(*per_host)]
            out[tag] = jax_kfac_ggn(head.logit_scale, head.logit_bias, C, *cat,
                                    "info_nce", **kw)
            continue
        partial = []
        for emb, act, tgt in per_host:
            A, B = jax_kfac_ggn(head.logit_scale, head.logit_bias, C, emb, act, tgt,
                                "info_nce", **kw)
            n = (len(emb) // C) * C
            root = np.sqrt(np.float64(n)).astype(np.float32)
            partial.append(((A, B, n), (A * root, B * root, np.float32(root**2))))
        payloads = [p for _, p in partial]

        def gather(_mine):
            return tuple(np.stack([p[i] for p in payloads]) for i in range(3))
        out[tag] = jax_allreduce_factors(*partial[0][0], num_hosts=2, _allgather=gather)
    return out


@pytest.mark.parametrize("mode", ["per_host", "global_batch"])
def test_two_rank_factors_match_a_jax_replay(runs, setup, mode):
    run = runs[mode]
    hdir = run["hdir"]
    for rank, out in enumerate(run["ranks"]):
        assert out[mode] == "ok", f"rank {rank}:\n{out[mode]}"
    want = _replay(setup["head"], hdir, mode == "global_batch")
    for tag in ("img", "txt"):
        A = torch.load(hdir / f"A_{tag}_analytic.pt").numpy()
        B = torch.load(hdir / f"B_{tag}_analytic.pt").numpy()
        jA, jB = (np.asarray(x) for x in want[tag])
        np.testing.assert_allclose(A, jA, rtol=RTOL, atol=ATOL, err_msg=tag)
        assert np.abs(B - jB).max() <= RTOL * np.abs(jB).max(), tag
    r0, r1 = (out["data"][mode] for out in run["ranks"])
    assert r0["lambdas"] == r1["lambdas"]
    info = load_info(hdir)
    assert [info["lambda_img"], info["lambda_txt"]] == r0["lambdas"]


@pytest.mark.parametrize("mode", ["per_host", "global_batch"])
def test_per_host_caches_and_primary_only_writes(runs, mode):
    run = runs[mode]
    hdir = run["hdir"]
    r0, r1 = (out["data"][mode] for out in run["ranks"])
    for h, n in ((0, 20), (1, 16)):  # 22 and 16 pairs in batches of 4
        assert f"[dist] host {h}/2 takes 2 tar shards" in (r0, r1)[h]["printed"]
        for name in ("activations_img", "embeddings_img", "activations_txt",
                     "embeddings_txt"):
            assert torch.load(hdir / f"{name}_host{h}.pt").shape[0] == n, (name, h)
    assert not list(hdir.glob("*_img.pt")) and not list(hdir.glob("_*"))
    assert sorted(r0["writes"]) == ["save_hessians", "save_hessians",
                                    "save_prior_precision"]
    assert r1["writes"] == []
    last = r0["printed"].strip().splitlines()[-1]
    assert json.loads(last) == {"lambda_img": r0["lambdas"][0],
                                "lambda_txt": r0["lambdas"][1]}
    assert "lambda_img" not in r1["printed"]
    if mode == "global_batch":
        assert "[dist] global class batches over 36 gathered pairs" in r0["printed"]


def test_a_dataset_without_shard_for_host_is_refused(runs):
    for rank, out in enumerate(runs["per_host"]["ranks"]):
        assert out["no_shard_for_host"] == "ok", f"rank {rank}:\n{out['no_shard_for_host']}"
