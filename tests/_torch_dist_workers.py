"""Worker processes of the port's multi-process CPU tests
(tests/test_torch_dist*.py): gloo ranks started by
torch.multiprocessing.spawn, meeting at a file:// rendezvous under the
test's tmp_path (no port, so parallel test workers cannot collide).

A worker imports torch, numpy and the port only; the JAX references come
from the test process in an .npz. Each rank runs every check of its job
and writes the outcomes to rank{r}.json: "ok" or the failure's
traceback, and values the tests compare across runs under "data".
"""

from __future__ import annotations

import json
import os
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

THREADS = 2  # each rank's intra-op threads (the same in every run compared)


def spawn(world: int, job: str, spec: dict, tmp, timeout: float = 300.0) -> list:
    """Run `job` on `world` gloo ranks; returns each rank's outcomes."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.spawn(_entry, args=(world, job, spec, str(tmp)), nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{job} on {world} ranks ran past {timeout} s")
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


def _entry(rank: int, world: int, job: str, spec: dict, tmp: str) -> None:
    torch.set_num_threads(THREADS)
    os.environ["WANDB_MODE"] = "disabled"
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank, timeout=timedelta(seconds=180))
    out = {"data": {}}
    try:
        JOBS[job](rank, world, spec, out)
    finally:
        Path(tmp, f"rank{rank}.json").write_text(json.dumps(out))
        dist.destroy_process_group()


def _check(out: dict, name: str, fn) -> None:
    """Run one check; its collectives come before its asserts, so a failed
    assert leaves the ranks in step."""
    try:
        fn()
        out[name] = "ok"
    except Exception:  # the outcome is the test's to report
        out[name] = traceback.format_exc()


def _close(got, want, rtol=1e-4, atol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# -- tests/test_torch_dist.py: dist/ itself ---------------------------------------------


def host_factors(h: int, D: int = 6):
    """Host h's per-host factors (already divided by sqrt(n_h)) and n_h."""
    rng = np.random.default_rng(100 + h)
    n = 16.0 * (h + 1)
    raw = rng.normal(size=(2, D, D)).astype(np.float32)
    return raw[0] / np.float32(np.sqrt(n)), raw[1] / np.float32(np.sqrt(n)), n


def job_core(rank: int, world: int, spec: dict, out: dict) -> None:
    from bayesvlm_tpu_torch.bayes import estimation, hessians
    from bayesvlm_tpu_torch.dist import hessian_allreduce as sh
    from bayesvlm_tpu_torch.dist import init, mesh as dmesh

    ref = dict(np.load(spec["npz"]))
    t = lambda k: torch.from_numpy(ref[k])
    mesh = dmesh.make_mesh()

    def mesh_basics():
        auto = dmesh.resolve_auto_mesh("auto")
        x = torch.arange(19 * 2, dtype=torch.float32).reshape(19, 2)
        width = -(-19 // world)
        rows, mask = dmesh.local_rows(x, mesh, fill=-1.0)
        edge, _ = dmesh.local_rows(x, mesh, fill="edge")
        gathered = dmesh.all_gather_rows(rows, mesh)
        gathered_mask = dmesh.all_gather_rows(mask, mesh)
        gathered_edge = dmesh.all_gather_rows(edge, mesh)
        total = dmesh.all_reduce_sum(torch.tensor([float(rank + 1)]), mesh)
        assert mesh.size() == world and mesh.mesh_dim_names == ("data",)
        assert mesh.get_local_rank() == rank
        assert (auto is None) if world == 1 else auto.size() == world
        assert dmesh.resolve_auto_mesh(None) is None
        assert dmesh.resolve_auto_mesh(mesh) is mesh
        assert rows.shape == (width, 2) and dmesh.pad_to_multiple(19, world) == width * world
        assert torch.equal(gathered[:19], x) and bool((gathered[19:] == -1.0).all())
        assert torch.equal(gathered_mask, (torch.arange(width * world) < 19).float())
        assert torch.equal(gathered_edge[:19], x)
        assert bool((gathered_edge[19:] == x[-1]).all())
        assert float(total) == world * (world + 1) / 2

    def infonce(block, precision, key, jax_tol):
        got = sh.sharded_hessian_infonce(t("inf_src"), t("inf_tgt"), 0.9, mesh,
                                         block_size=block, precision=precision)
        dense = hessians.hessian_infonce(t("inf_src"), t("inf_tgt"), 0.9,
                                         block_size=block, precision=precision)
        _close(got, ref[key], *jax_tol, msg="vs JAX")
        _close(got, dense, msg="vs the port's dense")

    def siglip(block, chunk, key):
        args = (t("sig_x"), t("sig_idx"), t("sig_y"), 0.6, -0.5)
        got = sh.sharded_hessian_siglip(*args, mesh, block_size=block, chunk_j=chunk)
        dense = hessians.hessian_siglip(*args, block_size=block, chunk_size_j=chunk)
        _close(got, ref[key], msg="vs JAX")
        _close(got, dense, msg="vs the port's dense")

    def gram(bias):
        got = sh.sharded_activation_gram(t("gram_a"), mesh, append_bias_column=bias)
        _close(got, ref[f"gram_{int(bias)}"], msg="vs JAX")
        _close(got, hessians.activation_gram(t("gram_a"), bias), msg="vs the port's dense")

    def kfac(lik):
        args = (0.9, -0.5, 16, t("kf_src"), t("kf_act"), t("kf_tgt"), lik)
        A, B = estimation.kfac_ggn(*args, block_size=5, mesh=mesh, device="cpu")
        A1, B1 = estimation.kfac_ggn(*args, block_size=5, device="cpu")
        for name, got, dense in (("A", A, A1), ("B", B, B1)):
            _close(got, ref[f"kf_{lik}_{name}"], msg=f"{name} vs JAX")
            _close(got, dense, msg=f"{name} vs the port's one device")

    def factors():
        A_h, B_h, n_h = host_factors(rank)
        A, B = init.allreduce_factors(A_h, B_h, n_h)
        if world == 1:
            assert A is A_h and B is B_h
            return
        _close(A, ref[f"arf_A_{world}"], 1e-6, 1e-6)
        _close(B, ref[f"arf_B_{world}"], 1e-6, 1e-6)
        assert A.dtype == np.float32

    def gather_rows():
        mine = np.arange(10 * rank, 10 * rank + 3 + 2 * rank, dtype=np.int64)
        rows = np.stack([mine, -mine], 1).astype(np.float32)
        got, counts = init.allgather_rows(rows, return_counts=True)
        got_t = init.allgather_rows(torch.from_numpy(mine))
        want = np.concatenate([np.arange(10 * h, 10 * h + 3 + 2 * h) for h in range(world)])
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert counts.tolist() == [3 + 2 * h for h in range(world)]
        np.testing.assert_array_equal(got[:, 0], want)
        np.testing.assert_array_equal(got[:, 1], -want)
        assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.int64
        np.testing.assert_array_equal(got_t.numpy(), want)

    checks = {
        "mesh": mesh_basics,
        "infonce": lambda: infonce(None, "highest", "inf_default", (1e-4, 1e-5)),
        "infonce_block": lambda: infonce(2, "highest", "inf_block", (1e-4, 1e-5)),
        # 3xTF32 against JAX's bf16x3: tests/test_dist.py's band for "high"
        "infonce_high": lambda: infonce(2, "high", "inf_high", (1e-3, 1e-4)),
        "siglip": lambda: siglip(None, None, "sig_default"),
        "siglip_block_chunk": lambda: siglip(2, 4, "sig_block_chunk"),
        "gram": lambda: gram(False),
        "gram_bias": lambda: gram(True),
        "kfac_infonce": lambda: kfac("info_nce"),
        "kfac_siglip": lambda: kfac("siglip"),
        "allreduce_factors": factors,
        "allgather_rows": gather_rows,
    }
    for name, fn in checks.items():
        _check(out, name, fn)


# -- tests/test_torch_dist_selection.py: the sharded selection -------------------------


def _spd(rng, d, s=0.3):
    M = rng.normal(size=(d, d)).astype(np.float32)
    return (M @ M.T / d * s + np.eye(d, dtype=np.float32) * 0.2).astype(np.float32)


def selection_inputs(seed: int = 0) -> dict:
    """The selection checks' inputs, the same in the test process and
    every rank."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)

    def probs(n, k, c):
        z = f(n, k, c)
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    a = dict(epig_pool=probs(37, 9, 5), epig_targ=probs(7, 9, 5),
             lg_mean=f(23, 5, scale=2.0), lg_var=rng.uniform(0.05, 2.0, (23, 5)),
             tr_e=f(40, 8), tr_a=f(40, 6), tr_r=f(40, 8, scale=0.1),
             te_e=f(20, 8), te_a=f(20, 6),
             cov_A6=_spd(rng, 6), cov_A7=_spd(rng, 7), cov_B=_spd(rng, 8),
             knn_idx=np.array([3, 17, 8, 0, 11]), knn_vals=rng.uniform(size=5),
             egl_W=f(9, 12), egl_acts=f(37, 9), egl_b=f(12, scale=0.3),
             egl_res=f(37, 12, scale=0.5), egl_txt=f(5, 12), egl_mean=f(37, 5, scale=2.0),
             egl_var=rng.uniform(0.1, 1.0, (37, 5)),
             km_x=np.concatenate([f(30, 5) + 6, f(30, 5) - 6, f(20, 5)]),
             pr_e=f(37, 8), pr_a=f(37, 6), pr_txt_e=f(5, 8), pr_txt_a=f(5, 6))
    return {k: np.asarray(v, np.float32) if v.dtype == np.float64 else v
            for k, v in a.items()}


def _egl_args(a: dict, bias: bool):
    from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

    t = torch.from_numpy
    b = a["egl_b"] if bias else np.zeros_like(a["egl_b"])
    res = a["egl_res"] if bias else np.zeros_like(a["egl_res"])
    embeds = a["egl_acts"] @ a["egl_W"] + b + res
    return (EncoderResult(t(embeds), t(a["egl_acts"]), t(res)),
            EncoderResult.create(t(a["egl_txt"]), t(a["egl_txt"])),
            ProbabilisticLogits(mean=t(a["egl_mean"]), var=t(a["egl_var"])))


def _epig_online_inputs(seed: int, bias: bool = False):
    """tests/test_torch_epig_online.py's fixtures: 40 pool, 16 target, 4
    classes, D 8, P 6."""
    from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead
    from bayesvlm_tpu_torch.types import EncoderResult

    rng = np.random.default_rng(seed)
    P, D = 6, 8
    kernel = (rng.normal(size=(P, D)) * 0.2).astype(np.float32)
    feats = []
    for n in (40, 16, 4):
        act = rng.normal(size=(n, P)).astype(np.float32)
        feats.append(EncoderResult.create(torch.from_numpy(act @ kernel),
                                          torch.from_numpy(act)))
    Pa = P + bias
    factors = {k: torch.from_numpy(_spd(rng, d, 0.1)) for k, d in (
        ("A_img", Pa), ("B_img", D), ("A_txt", Pa), ("B_txt", D))}
    return dict(label_features=feats[2], pool_features=feats[0], target_features=feats[1],
                pool_class_ids=torch.from_numpy(rng.integers(0, 4, size=40)),
                projection_kernel=torch.from_numpy(kernel), projection_bias=None,
                head=ProbabilisticHead.create(1.0, 0.0, device="cpu"), **factors,
                cov_info=dict(lambda_img=5.0, lambda_txt=5.0, n_img=10.0, n_txt=10.0),
                budget=3, lr=1e-3, hessian_update_scale=10.0, num_samples=8, seed=0,
                projection_l2=float(np.sum(kernel**2)), projection_num_params=kernel.size,
                hessian_n0=100, device="cpu")


def predictions_head(a: dict):
    from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
    from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead

    t = torch.from_numpy
    cov = KroneckerFactorizedCovariance(t(a["cov_A6"]), t(a["cov_B"]))
    return ProbabilisticHead.create(2.0, 0.0, device="cpu").set_covariances(cov, cov)


def job_selection(rank: int, world: int, spec: dict, out: dict) -> None:
    from bayesvlm_tpu_torch.bayes.kfac import KroneckerFactorizedCovariance
    from bayesvlm_tpu_torch.dist import mesh as dmesh
    from bayesvlm_tpu_torch.inference import predictions
    from bayesvlm_tpu_torch.ops import topk_exact
    from bayesvlm_tpu_torch.select import egl, epig, kmeans, knn
    from bayesvlm_tpu_torch.types import EncoderResult, ProbabilisticLogits

    ref = dict(np.load(spec["npz"]))
    a = selection_inputs()
    t = torch.from_numpy
    mesh = dmesh.make_mesh()

    def epig_scores():
        pp, pt = t(a["epig_pool"]), t(a["epig_targ"])
        got = epig.epig_from_probs_sharded(pp, pt, mesh)
        logits_p = ProbabilisticLogits(t(a["lg_mean"]), t(a["lg_var"]))
        logits_t = logits_p[:7]
        chunked = epig.epig_from_logits_using_matmul(logits_p, logits_t, seed=3,
                                                     num_samples=9, chunk_size=10,
                                                     mesh=mesh)
        dense = epig.epig_from_probs_using_matmul(pp, pt)
        assert torch.equal(got, dense), (got - dense).abs().max()
        _close(got, ref["epig"], 2e-3, 2e-3, "vs JAX's epig_from_probs_sharded")
        assert torch.equal(chunked, epig.epig_from_logits_using_matmul(
            logits_p, logits_t, seed=3, num_samples=9, chunk_size=10))

    def epig_online(name, subsampling, kw):
        sharded = epig.select_epig_online(**_epig_online_inputs(5), mesh=mesh,
                                          pool_subsampling=subsampling, **kw)
        dense = epig.select_epig_online(**_epig_online_inputs(5), mesh=None,
                                        pool_subsampling=subsampling, **kw)
        assert sharded == dense, (sharded, dense)
        out["data"][name] = sharded

    def knn_case(method, k_nearest, buffersize, has_bias):
        train = EncoderResult(t(a["tr_e"]), t(a["tr_a"]), t(a["tr_r"]))
        test = EncoderResult.create(t(a["te_e"]), t(a["te_a"]))
        cov = KroneckerFactorizedCovariance(t(a["cov_A7" if has_bias else "cov_A6"]),
                                            t(a["cov_B"]))
        fn = getattr(knn, f"find_similar_samples_{method}")
        args = (train, test, t(a["knn_idx"]), a["knn_vals"], k_nearest, cov)
        kw = dict(buffersize=buffersize, has_bias=has_bias)
        got = fn(*args, **kw, mesh=mesh)
        dense = fn(*args, **kw, mesh=None)
        assert got == dense
        key = f"knn_{method}_{k_nearest}_{buffersize}_{int(has_bias)}"
        for i, (test_idx, entry) in enumerate(got.items()):
            np.testing.assert_array_equal(entry["indices"], ref[f"{key}_ids_{i}"])
            _close(entry["similarities"], ref[f"{key}_sims_{i}"], 1e-5, 1e-5)

    def knn_neg_inf(n_train):
        rng = np.random.default_rng(7)
        train = EncoderResult.create(
            torch.from_numpy(rng.normal(size=(n_train, 4)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n_train, 4)).astype(np.float32)))

        def sims_fn(tr):
            n_local = tr.embeds.shape[0]
            row0 = torch.full((1, n_local), -torch.inf)
            # row 1: -inf but at global column 3, found by its embed value
            marker = torch.isclose(tr.embeds[:, 0], train.embeds[3, 0])
            row1 = torch.where(marker[None, :], 1.0, -torch.inf)
            return torch.cat([row0, row1])

        v, ids = knn._sims_topk_sharded(sims_fn, train, 5, mesh)
        dense_v, dense_i = topk_exact(sims_fn(train), 5)
        assert torch.equal(v, dense_v) and torch.equal(ids, dense_i), (ids, dense_i)
        assert bool((ids < n_train).all())

    def egl_case(bias, chunk_size):
        scale, lbias = (0.7, -2.0) if bias else (2.3, 0.0)
        args = _egl_args(a, bias)
        got = egl.expected_gradient_length(*args, scale, lbias, proj_has_bias=bias,
                                           chunk_size=chunk_size, mesh=mesh)
        dense = egl.expected_gradient_length(*args, scale, lbias, proj_has_bias=bias,
                                             chunk_size=chunk_size, mesh=None)
        _close(got, ref[f"egl_{int(bias)}_{chunk_size}"], msg="vs JAX")
        _close(got, dense, 1e-6, 1e-7, "vs the port's one device")

    def kmeans_case():
        x = t(a["km_x"])
        c, assign = kmeans.kmeans_fit(x, 7, seed=2, num_iters=15, mesh=mesh)
        c1, assign1 = kmeans.kmeans_fit(x, 7, seed=2, num_iters=15, mesh=None)
        rep, reps = kmeans.cluster_and_select_representatives(
            EncoderResult.create(x, x), 9, seed=1, num_iters=10, mesh=mesh)
        rep1, _ = kmeans.cluster_and_select_representatives(
            EncoderResult.create(x, x), 9, seed=1, num_iters=10, mesh=None)
        assert torch.equal(assign, assign1)
        # the per-centroid sums of at most N rows reassociated: each
        # coordinate within N fp32 ulps of max |x|, divided by its count
        bound = x.shape[0] * 2.0**-24 * float(x.abs().max())
        assert float((c - c1).abs().max()) <= bound, float((c - c1).abs().max())
        assert torch.equal(rep, rep1) and torch.equal(reps.embeds, x[rep])
        out["data"]["kmeans_max_centroid_diff"] = float((c - c1).abs().max())

    def predictions_case():
        head = predictions_head(a)
        img = EncoderResult.create(t(a["pr_e"]), t(a["pr_a"]))
        txt = EncoderResult.create(t(a["pr_txt_e"]), t(a["pr_txt_a"]))
        got = predictions.make_predictions_sharded(head, img, txt, mesh, batch_size=4)
        dense = predictions.make_predictions(head, img, txt, batch_size=4)
        for name in ("mean", "var"):
            g = getattr(got, name)
            assert g.shape == (37, 5)
            _close(g, ref[f"pred_{name}"], msg=f"{name} vs JAX")
            _close(g, getattr(dense, name), 1e-6, 1e-7, f"{name} vs one device")

    checks = {"epig": epig_scores,
              "epig_online_random": lambda: epig_online("epig_online_random", "random",
                                                        {}),
              "epig_online_knn": lambda: epig_online("epig_online_knn", "knn_wasserstein",
                                                     {"k_nearest_neighbors": 8}),
              "egl": lambda: egl_case(False, 8192),
              "egl_bias_chunked": lambda: egl_case(True, 8),
              "kmeans": kmeans_case,
              "predictions": predictions_case}
    for method in ("cosine", "wasserstein"):
        for case in KNN_CASES:
            checks[f"knn_{method}_{'_'.join(map(str, case))}"] = (
                lambda m=method, c=case: knn_case(m, *c))
    for n_train in (64, 67):
        checks[f"knn_neg_inf_{n_train}"] = lambda n=n_train: knn_neg_inf(n)
    for name, fn in checks.items():
        _check(out, name, fn)
    if spec.get("zeroshot"):
        _check(out, "zeroshot", lambda: _zeroshot(rank, spec, out))


KNN_CASES = ((1, 150, 0), (3, 4, 1), (2, 0, 0))


def _zeroshot(rank: int, spec: dict, out: dict) -> None:
    """zeroshot.main on the ranks, then on rank 0 alone as one process."""
    import contextlib
    import io

    from bayesvlm_tpu_torch import zeroshot

    kw = dict(dataset="synthetic", hessian_dir=spec["hessian_dir"], model_str="tiny-clip",
              dtype="fp32", num_workers=0, device="cpu")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        got = zeroshot.main(**kw)
    info = dict(zeroshot.main.last_info)
    dist.barrier()
    if rank == 0:
        ref = zeroshot.main(**kw, use_mesh=False)
        assert got[0] == ref[0], (got, ref)
        np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-6, atol=1e-7)
        assert info == zeroshot.main.last_info
        assert "ACC:" in printed.getvalue()
    else:
        assert "ACC:" not in printed.getvalue()
    assert "[mesh] batch-sharded inference over" in printed.getvalue()
    out["data"]["zeroshot"] = list(got)
    dist.barrier()


# -- tests/test_torch_dist_stage1.py: the Stage-1 CLI on two ranks -------------------


def job_stage1(rank: int, world: int, spec: dict, out: dict) -> None:
    """The Stage-1 CLI as one rank of `world` on LAION-style tars, in each
    mode of spec["modes"] (name -> [hessian_dir, --dist_global_batch]),
    the factor writes counted by rank; then a dataset without
    shard_for_host refused."""
    import contextlib
    import io

    from bayesvlm_tpu_torch import hessian_estimation
    from bayesvlm_tpu_torch.io import artifacts

    os.environ["DATA_BASE_DIR"] = spec["data_dir"]
    writes = []
    for name in ("save_hessians", "save_prior_precision"):
        fn = getattr(artifacts, name)
        setattr(artifacts, name, lambda *a, _fn=fn, _n=name, **k: (writes.append(_n),
                                                                   _fn(*a, **k))[1])
    kw = dict(spec["cli"], model_str="tiny-clip", weights_dir=spec["weights_dir"],
              device="cpu", dtype="fp32")

    def cli(mode, hdir, global_batch):
        writes.clear()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = hessian_estimation.main(**kw, hessian_dir=hdir,
                                          dist_global_batch=global_batch)
        out["data"][mode] = dict(printed=printed.getvalue(), writes=list(writes),
                                 lambdas=[run["lambda_img"], run["lambda_txt"]])

    def refused():
        try:
            hessian_estimation.main(**{**kw, "dataset": "synthetic"},
                                    hessian_dir=spec["refused_dir"])
        except ValueError as e:
            assert "shard_for_host" in str(e), e
        else:
            raise AssertionError("a dataset without shard_for_host ran on 2 ranks")

    for mode, (hdir, global_batch) in spec["modes"].items():
        _check(out, mode, lambda: cli(mode, hdir, global_batch))
    _check(out, "no_shard_for_host", refused)


# -- tests/test_torch_dist_activelearning.py: the AL CLI on two ranks ---------------------


def job_activelearning(rank: int, world: int, spec: dict, out: dict) -> None:
    """The active-learning CLI as one rank of `world`."""
    from bayesvlm_tpu_torch import activelearning

    def cli():
        run = activelearning.run(**spec["kw"])
        out["data"].update(results=run["results"], subsets=run["subsets"])

    _check(out, "cli", cli)


# -- tests/test_torch_tp.py: dist/tp.py ----------------------------------------------


def _tp_tower(wd: str, mesh=None, **lanes):
    """The tiny-clip vision encoder with the bridged weights (fp32, CPU),
    split over the mesh's "model" axis when a mesh is given."""
    from bayesvlm_tpu_torch.dist.tp import shard_tower_params
    from bayesvlm_tpu_torch.models.encoders import load_model, rebuild_image_encoder

    block = lanes.pop("attn_pallas_block", False)
    img, _, _ = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32,
                           device="cpu", **lanes)
    if block:
        img = rebuild_image_encoder(img, attn_pallas_block=True)
    if mesh is not None:
        shard_tower_params(img.module, mesh)
    return img


def job_tp(rank: int, world: int, spec: dict, out: dict) -> None:
    """Tensor parallelism on a ("data", "model") = spec["shape"] mesh: each
    rank feeds its data block through a tower split over its model group."""
    from bayesvlm_tpu_torch.dist.mesh import all_gather_rows, make_mesh
    from bayesvlm_tpu_torch.dist.tp import all_reduce_mean
    from bayesvlm_tpu_torch.models.mlp_int8 import FLIP_TOL_MAX, FLIP_TOL_MEAN
    from bayesvlm_tpu_torch.train.backbone import make_backbone_train_step

    a = dict(np.load(spec["npz"]))
    wd = spec["weights_dir"]
    mesh = make_mesh(("data", "model"), spec["shape"])
    data = mesh["data"]
    d = int(data.size())
    rows = a["pixels"].shape[0] // d
    lo = int(data.get_local_rank()) * rows
    block = torch.from_numpy(a["pixels"][lo:lo + rows])

    def gathered(img):
        res = img(block)
        return (all_gather_rows(res.embeds, data).numpy(),
                all_gather_rows(res.activations, data).numpy())

    def flip_close(got, want):
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert diff.max() <= FLIP_TOL_MAX * scale and diff.mean() <= FLIP_TOL_MEAN * scale

    def check_mesh():
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh.mesh.tolist() == np.arange(world).reshape(spec["shape"]).tolist()
        assert int(mesh["model"].size()) == spec["shape"][1]

    img = _tp_tower(wd, mesh)

    def check_split():
        m = spec["shape"][1]
        attn = img.module.encoder.layers[0].self_attn
        D = img.config.vision.hidden_size
        assert img.module.tensor_parallel == ("model", m)
        assert attn.num_heads == img.config.vision.num_heads // m
        assert tuple(attn.q_proj.weight.shape) == (D // m, D)
        assert tuple(attn.out_proj.weight.shape) == (D, D // m)
        mlp = img.module.encoder.layers[0].mlp
        assert tuple(mlp.fc1.weight.shape) == (img.config.vision.mlp_dim // m, D)
        assert tuple(img.module.visual_projection.weight.shape) == (
            img.config.vision.projection_dim, D)

    def check_forward():
        embeds, acts = gathered(img)
        _close(embeds, a["ref_embeds"], rtol=1e-5, atol=1e-5)
        _close(acts, a["ref_acts"], rtol=1e-5, atol=1e-5)

    def check_sgd_step():
        with torch.inference_mode():
            acts = img(block).activations
        acts = acts.clone()
        labels = torch.from_numpy(a["labels"][lo:lo + rows]).long()
        text = torch.from_numpy(a["text"])
        kernel = img.module.visual_projection.weight.detach().T.clone().requires_grad_(True)
        e = acts @ kernel
        e = e / e.norm(dim=-1, keepdim=True)
        t = text / text.norm(dim=-1, keepdim=True)
        logits = e @ t.T * torch.exp(torch.tensor(float(a["logit_scale"])))
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp[torch.arange(rows), labels].mean()
        loss.backward()
        grad = all_reduce_mean(kernel.grad, mesh, "data")
        loss = all_reduce_mean(loss.detach(), mesh, "data")
        new_kernel = kernel.detach() - 1e-2 * grad
        np.testing.assert_allclose(float(loss), float(a["ref_loss"]), rtol=1e-5)
        _close(new_kernel.numpy(), a["ref_kernel"], rtol=1e-5, atol=1e-6)

    def check_block_lane():
        embeds, acts = gathered(_tp_tower(wd, mesh, attn_pallas_block=True))
        _close(embeds, a["block_embeds"], rtol=1e-5, atol=1e-5)
        _close(acts, a["block_acts"], rtol=1e-5, atol=1e-5)

    def check_int8_lanes():
        tp = gathered(_tp_tower(wd, mesh, mlp_int8=True, attn_int8=True))
        whole = gathered(_tp_tower(wd, mlp_int8=True, attn_int8=True))
        for got, same, want in zip(tp, whole, (a["int8_embeds"], a["int8_acts"])):
            assert np.array_equal(got, same)  # every sublayer runs whole
            flip_close(got, want)

    def check_mlp_int8_lane():
        tp = gathered(_tp_tower(wd, mesh, mlp_int8=True))
        for got, want in zip(tp, (a["mlp8_embeds"], a["mlp8_acts"])):
            flip_close(got, want)

    def check_backbone_refused():
        try:
            make_backbone_train_step(img.module, lambda m, b: None, 2, 1,
                                     ("visual_projection",))
        except ValueError as exc:
            assert "tensor-parallel (TP)" in str(exc)
        else:
            raise AssertionError("a TP tower was taken")

    for name, fn in (("mesh_2d", check_mesh), ("split", check_split),
                     ("forward", check_forward), ("sgd_step", check_sgd_step),
                     ("block_lane", check_block_lane), ("int8_lanes", check_int8_lanes),
                     ("mlp_int8_lane", check_mlp_int8_lane),
                     ("backbone_refused", check_backbone_refused)):
        _check(out, name, fn)


# -- tests/test_torch_dcp_ckpt.py: io/dcp_ckpt.py ----------------------------------


def dcp_rows(n: int = 9, d: int = 3) -> np.ndarray:
    """The row-sharded tensor of the DCP checks (odd rows: uneven shards)."""
    return np.arange(n * d, dtype=np.float32).reshape(n, d) / 7.0


def job_dcp(rank: int, world: int, spec: dict, out: dict) -> None:
    """A row-sharded save over the world mesh, then restores at this world
    size: sharded (each rank its rows), whole, and into a `like` tree; and
    a checkpoint saved by one process restored sharded here."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from bayesvlm_tpu_torch.dist.mesh import make_mesh
    from bayesvlm_tpu_torch.io import dcp_ckpt

    mesh = make_mesh()
    full = torch.from_numpy(dcp_rows())
    rows = torch.chunk(full, world)[rank]  # DTensor Shard(0)'s blocks
    path = Path(spec["dir"]) / "sharded"

    def check_sharded_save():
        tree = {"w": distribute_tensor(full, mesh, [Shard(0)]),
                "bias": torch.ones(3), "step": 3}
        dcp_ckpt.save_pytree(path, tree)
        assert path.is_dir() and not path.with_name(".sharded.tmp").exists()

    def check_sharded_restore():
        got = dcp_ckpt.load_pytree(path, shardings=mesh)
        assert isinstance(got["w"], DTensor) and got["w"].placements == (Shard(0),)
        assert torch.equal(got["w"].to_local(), rows)
        assert tuple(got["w"].shape) == tuple(full.shape) and got["step"] == 3

    def check_whole_restore():
        got = dcp_ckpt.load_pytree(path)
        assert torch.equal(got["w"], full) and torch.equal(got["bias"], torch.ones(3))

    def check_like_restore():
        like = {"w": distribute_tensor(torch.zeros_like(full), mesh, [Shard(0)]),
                "bias": torch.zeros(3), "step": 0}
        got = dcp_ckpt.load_pytree(path, like=like)
        assert torch.equal(got["w"].to_local(), rows) and got["step"] == 3

    def check_other_world_restore():
        got = dcp_ckpt.load_hessians_dcp(spec["one_process_dir"], "img", shardings=mesh)
        want = dcp_ckpt.load_hessians_dcp(spec["one_process_dir"], "img")
        for g, w in zip(got, want):
            assert torch.equal(g.to_local(), torch.chunk(w, world)[rank])

    for name, fn in (("sharded_save", check_sharded_save),
                     ("sharded_restore", check_sharded_restore),
                     ("whole_restore", check_whole_restore),
                     ("like_restore", check_like_restore),
                     ("other_world_restore", check_other_world_restore)):
        _check(out, name, fn)


JOBS = {"dcp": job_dcp, "tp": job_tp, "core": job_core, "selection": job_selection, "stage1": job_stage1,
        "activelearning": job_activelearning}
