"""The port's `dist/` on the CPU over 1, 2 and 3 gloo ranks
(torch.multiprocessing.spawn, one run per world size): the mesh and its
row blocks, the sharded InfoNCE / SigLIP GGN and activation Gram (with
`block_size`, `chunk_j` and `precision`), `kfac_ggn(mesh)`,
`allreduce_factors` and `allgather_rows` (uneven counts). Each is held
inside the ranks against the JAX package's `dist/` on the conftest's
8-device CPU mesh and against the port's dense functions, at
tests/test_dist.py's rtol 1e-4 / atol 1e-5. A world of 3 splits 19 rows
unevenly, as tests/test_dist.py's non-divisible B."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_workers import host_factors, spawn
from bayesvlm_tpu.bayes.estimation import kfac_ggn as jax_kfac_ggn
from bayesvlm_tpu.dist.hessian_allreduce import (
    sharded_activation_gram,
    sharded_hessian_infonce,
    sharded_hessian_siglip,
)
from bayesvlm_tpu.dist.init import allreduce_factors as jax_allreduce_factors
from bayesvlm_tpu.dist.mesh import make_mesh
from bayesvlm_tpu_torch.dist import init as port_init
from bayesvlm_tpu_torch.dist import mesh as port_mesh

WORLDS = (1, 2, 3)
CHECKS = ("mesh", "infonce", "infonce_block", "infonce_high", "siglip",
          "siglip_block_chunk", "gram", "gram_bias", "kfac_infonce", "kfac_siglip",
          "allreduce_factors", "allgather_rows")


def _fake_allgather(payloads):
    """An allgather standing in for the hosts': every host's payload
    stacked in host order (numpy, for both packages)."""
    def gather(_mine):
        return tuple(np.stack([np.asarray(p[i]) for p in payloads])
                     for i in range(len(payloads[0])))
    return gather


def _payload(A, B, n):
    root = np.sqrt(np.float64(n)).astype(np.float32)
    return (A * root, B * root, np.float32(root**2))


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """The inputs and the JAX package's results, as an .npz for the ranks."""
    assert len(jax.devices()) == 8  # the conftest's virtual CPU mesh
    mesh = make_mesh()
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    a = dict(inf_src=f(19, 6), inf_tgt=f(11, 6), sig_x=f(13, 5), sig_y=f(9, 5),
             sig_idx=rng.integers(0, 9, size=13), gram_a=f(21, 4),
             kf_src=f(40, 6), kf_act=f(40, 5), kf_tgt=f(40, 6))
    r = dict(
        inf_default=sharded_hessian_infonce(a["inf_src"], a["inf_tgt"], 0.9, mesh),
        inf_block=sharded_hessian_infonce(a["inf_src"], a["inf_tgt"], 0.9, mesh,
                                          block_size=2),
        inf_high=sharded_hessian_infonce(a["inf_src"], a["inf_tgt"], 0.9, mesh,
                                         block_size=2, precision="high"),
        sig_default=sharded_hessian_siglip(a["sig_x"], a["sig_idx"], a["sig_y"], 0.6,
                                           -0.5, mesh),
        sig_block_chunk=sharded_hessian_siglip(a["sig_x"], a["sig_idx"], a["sig_y"], 0.6,
                                               -0.5, mesh, block_size=2, chunk_j=4),
        gram_0=sharded_activation_gram(a["gram_a"], mesh),
        gram_1=sharded_activation_gram(a["gram_a"], mesh, append_bias_column=True))
    for lik in ("info_nce", "siglip"):
        A, B = jax_kfac_ggn(0.9, -0.5, 16, a["kf_src"], a["kf_act"], a["kf_tgt"], lik,
                            block_size=5, mesh=mesh)
        r[f"kf_{lik}_A"], r[f"kf_{lik}_B"] = A, B
    for world in (2, 3):
        hosts = [host_factors(h) for h in range(world)]
        A, B = jax_allreduce_factors(*hosts[0], num_hosts=world,
                                     _allgather=_fake_allgather([_payload(*h) for h in
                                                                 hosts]))
        r[f"arf_A_{world}"], r[f"arf_B_{world}"] = A, B
    path = tmp_path_factory.mktemp("dist_refs") / "refs.npz"
    np.savez(path, **a, **{k: np.asarray(v) for k, v in r.items()})
    return path


@pytest.fixture(scope="module")
def outcomes(references, tmp_path_factory):
    """Each world size's rank outcomes, one spawn each, run on first use."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = spawn(world, "core", {"npz": str(references)},
                                tmp_path_factory.mktemp(f"world{world}"))
        return runs[world]
    return get


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_matches_jax_and_dense(outcomes, world, check):
    for rank, out in enumerate(outcomes(world)):
        assert out[check] == "ok", f"rank {rank} of {world}:\n{out[check]}"


@pytest.mark.parametrize("kind", ["infonce", "infonce_block_high", "siglip",
                                  "siglip_block_chunk", "gram", "gram_bias"])
def test_no_mesh_is_the_dense_function_bit_for_bit(kind):
    """With no mesh (None) the sharded functions are one device's: every
    row valid, the mask a multiplication by one, so kfac_ggn's one path
    gives the dense functions' bits (19 rows, as the ranks' inputs)."""
    import torch

    from bayesvlm_tpu_torch.bayes import hessians as dense
    from bayesvlm_tpu_torch.dist import hessian_allreduce as port_sh

    rng = np.random.default_rng(7)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    src, tgt, act = t(19, 6), t(11, 6), t(19, 5)
    idx = torch.from_numpy(rng.integers(0, 11, size=19))
    scale, bias = torch.tensor(0.9), torch.tensor(-2.0)
    block = dict(block_size=5, precision="high") if "block" in kind else {}
    if kind.startswith("infonce"):
        got = port_sh.sharded_hessian_infonce(src, tgt, scale, None, **block)
        want = dense.hessian_infonce(src, tgt, scale, **block)
    elif kind.startswith("siglip"):
        chunk = 4 if "chunk" in kind else None
        got = port_sh.sharded_hessian_siglip(src, idx, tgt, scale, bias, None,
                                             chunk_j=chunk, **block)
        want = dense.hessian_siglip(src, idx, tgt, scale, bias, chunk_size_j=chunk,
                                    **block)
    else:
        with_bias = kind == "gram_bias"
        got = port_sh.sharded_activation_gram(act, None, append_bias_column=with_bias)
        want = dense.activation_gram(act, append_bias_column=with_bias)
    assert torch.equal(got, want)


def test_allreduce_factors_match_jax_with_one_allgather():
    """The same injected allgather into both packages' allreduce_factors."""
    hosts = [host_factors(h) for h in range(3)]
    gather = _fake_allgather([_payload(*h) for h in hosts])
    got = port_init.allreduce_factors(*hosts[0], num_hosts=3, _allgather=gather)
    want = jax_allreduce_factors(*hosts[0], num_hosts=3, _allgather=gather)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    n = sum(h[2] for h in hosts)
    np.testing.assert_allclose(
        got[0], sum(h[0] * np.sqrt(h[2]) for h in hosts) / np.sqrt(n), rtol=1e-5,
        atol=1e-6)
    A1, B1 = port_init.allreduce_factors(*hosts[0], num_hosts=1)
    assert A1 is hosts[0][0] and B1 is hosts[0][1]


def test_one_process_needs_no_group(monkeypatch):
    """Without a launch: no group, no mesh, one host on the named device;
    a launch named in part is refused."""
    for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES",
              "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    ctx = port_init.initialize_distributed(device="cpu")
    assert (ctx.mesh, ctx.host_id, ctx.num_hosts) == (None, 0, 1)
    assert ctx.is_primary and str(ctx.device) == "cpu"
    assert port_mesh.resolve_auto_mesh("auto") is None
    with pytest.raises(ValueError, match="initialised process group"):
        port_mesh.make_mesh()
    x = np.arange(5)
    assert port_init.allgather_rows(x) is not None
    np.testing.assert_array_equal(port_init.allgather_rows(x, return_counts=True)[1], [5])
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="no COORDINATOR_ADDRESS"):
        port_init.initialize_distributed(device="cpu")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES and PROCESS_ID"):
        port_init.initialize_distributed(device="cpu")
