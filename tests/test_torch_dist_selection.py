"""The port's sharded selection on the CPU over 2 and 3 gloo ranks (one
torch.multiprocessing.spawn each): EPIG pool rows sharded (bit-equal to
the port's dense scores, and at tests/test_torch_epig.py's 2e-3 against
JAX's `epig_from_probs_sharded`), `select_epig_online` over an explicit
mesh (the one-device selection), the kNN finders (ids equal to dense and
to JAX, the -inf ties of tests/test_knn_sharded.py), EGL (JAX at
tests/test_torch_egl.py's 1e-4 / 1e-5), k-means (the one-device
representatives; centroids within the reassociation bound) and
`make_predictions_sharded`; then `zeroshot.main` on 2 ranks against one
process, and `resolve_auto_mesh`."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_workers import KNN_CASES, selection_inputs, spawn
from bayesvlm_tpu.bayes.kfac import KroneckerFactorizedCovariance as JaxCov
from bayesvlm_tpu.dist.mesh import make_mesh
from bayesvlm_tpu.inference.predictions import make_predictions_sharded
from bayesvlm_tpu.probforward.smith import ProbabilisticHead as JaxHead
from bayesvlm_tpu.select import egl as jax_egl
from bayesvlm_tpu.select import knn as jax_knn
from bayesvlm_tpu.select.epig import epig_from_probs_sharded
from bayesvlm_tpu.types import EncoderResult as JaxResult
from bayesvlm_tpu.types import ProbabilisticLogits as JaxLogits
from bayesvlm_tpu_torch.dist.mesh import resolve_auto_mesh
from bayesvlm_tpu_torch.io.artifacts import save_synthetic_hessians
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME

WORLDS = (2, 3)
CHECKS = (("epig", "epig_online_random", "epig_online_knn", "egl", "egl_bias_chunked",
           "kmeans", "predictions")
          + tuple(f"knn_{m}_{'_'.join(map(str, c))}" for m in ("cosine", "wasserstein")
                  for c in KNN_CASES)
          + ("knn_neg_inf_64", "knn_neg_inf_67"))


def _jax_egl_args(a: dict, bias: bool):
    b = a["egl_b"] if bias else np.zeros_like(a["egl_b"])
    res = a["egl_res"] if bias else np.zeros_like(a["egl_res"])
    embeds = a["egl_acts"] @ a["egl_W"] + b + res
    txt = jnp.asarray(a["egl_txt"])
    return (JaxResult(jnp.asarray(embeds), jnp.asarray(a["egl_acts"]), jnp.asarray(res)),
            JaxResult(txt, txt, jnp.zeros_like(txt)),
            JaxLogits(mean=jnp.asarray(a["egl_mean"]), var=jnp.asarray(a["egl_var"])))


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The JAX package's results on the ranks' inputs, as an .npz."""
    a = selection_inputs()
    mesh = make_mesh()
    r = {"epig": epig_from_probs_sharded(jnp.asarray(a["epig_pool"]),
                                         jnp.asarray(a["epig_targ"]), mesh,
                                         use_pallas=False)}
    train = JaxResult(*map(jnp.asarray, (a["tr_e"], a["tr_a"], a["tr_r"])))
    test = JaxResult(jnp.asarray(a["te_e"]), jnp.asarray(a["te_a"]),
                     jnp.zeros_like(jnp.asarray(a["te_e"])))
    for method in ("cosine", "wasserstein"):
        for k, buffersize, bias in KNN_CASES:
            cov = JaxCov(jnp.asarray(a["cov_A7" if bias else "cov_A6"]),
                         jnp.asarray(a["cov_B"]))
            got = getattr(jax_knn, f"find_similar_samples_{method}")(
                train, test, a["knn_idx"], a["knn_vals"], k, cov, buffersize=buffersize,
                has_bias=bool(bias), mesh=None)
            key = f"knn_{method}_{k}_{buffersize}_{bias}"
            for i, entry in enumerate(got.values()):
                r[f"{key}_ids_{i}"] = np.asarray(entry["indices"])
                r[f"{key}_sims_{i}"] = np.asarray(entry["similarities"])
    for bias, chunk in ((False, 8192), (True, 8)):
        scale, lbias = (0.7, -2.0) if bias else (2.3, 0.0)
        r[f"egl_{int(bias)}_{chunk}"] = jax_egl.expected_gradient_length(
            *_jax_egl_args(a, bias), scale, lbias, proj_has_bias=bias, chunk_size=chunk,
            mesh=mesh)
    cov = JaxCov(jnp.asarray(a["cov_A6"]), jnp.asarray(a["cov_B"]))
    head = JaxHead.create(logit_scale=2.0, logit_bias=0.0).set_covariances(cov, cov)
    img = JaxResult(jnp.asarray(a["pr_e"]), jnp.asarray(a["pr_a"]),
                    jnp.zeros_like(jnp.asarray(a["pr_e"])))
    txt = JaxResult(jnp.asarray(a["pr_txt_e"]), jnp.asarray(a["pr_txt_a"]),
                    jnp.zeros_like(jnp.asarray(a["pr_txt_e"])))
    logits = make_predictions_sharded(head, img, txt, mesh)
    r["pred_mean"], r["pred_var"] = logits.mean, logits.var
    path = tmp_path_factory.mktemp("selection_refs") / "refs.npz"
    np.savez(path, **{k: np.asarray(v) for k, v in r.items()})
    return path


@pytest.fixture(scope="module")
def outcomes(references, tmp_path_factory):
    runs = {}

    def get(world):
        if world not in runs:
            spec = {"npz": str(references)}
            if world == 2:  # zeroshot.main on 2 ranks against one process
                spec["zeroshot"] = True
                spec["hessian_dir"] = str(save_synthetic_hessians(
                    tmp_path_factory.mktemp("zs_hessians"), CONFIGS_BY_NAME["tiny-clip"],
                    seed=0))
            runs[world] = spawn(world, "selection", spec,
                                tmp_path_factory.mktemp(f"world{world}"))
        return runs[world]
    return get


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_selection_matches_dense_and_jax(outcomes, world, check):
    for rank, out in enumerate(outcomes(world)):
        assert out[check] == "ok", f"rank {rank} of {world}:\n{out[check]}"


def test_selections_agree_across_world_sizes(outcomes):
    two, three = outcomes(2), outcomes(3)
    for key in ("epig_online_random", "epig_online_knn"):
        assert two[0]["data"][key] == two[1]["data"][key] == three[2]["data"][key]


def test_zeroshot_on_two_ranks_matches_one_process(outcomes):
    ranks = outcomes(2)
    for rank, out in enumerate(ranks):
        assert out["zeroshot"] == "ok", f"rank {rank}:\n{out['zeroshot']}"
    assert ranks[0]["data"]["zeroshot"] == ranks[1]["data"]["zeroshot"]


def test_auto_mesh_is_none_without_a_group():
    assert resolve_auto_mesh("auto") is None
    assert resolve_auto_mesh(None) is None
