"""Tensor parallelism (`bayesvlm_tpu_torch/dist/tp.py`) against the JAX
package's (`bayesvlm_tpu/dist/tp.py`, held by tests/test_tp.py and
tests/test_multiprocess_tp.py): the rule table against JAX's
PartitionSpec tree, then one spawn of 4 gloo ranks on a ("data",
"model") = (2, 2) mesh (tests/_torch_dist_workers.py, job "tp") whose
split tiny-clip tower is held to JAX's unsharded forward at rtol / atol
1e-5 and whose projection SGD step is held to JAX's at loss rtol 1e-5,
kernel rtol 1e-5 / atol 1e-6 (JAX's own bounds, tests/test_tp.py:58-60,
107-110). The kernel lanes: the block lane at 1e-5 (its tolerance in
tests/test_torch_attention_block.py), the int8 lanes at the int8 flip
tolerance (tests/test_torch_mlp_int8.py), and with every sublayer whole
the int8 tower equal to the unsplit one bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_dist_workers import spawn
from bayesvlm_tpu_torch.dist.tp import tower_partition_specs
from bayesvlm_tpu_torch.models.configs import CONFIGS_BY_NAME
from bayesvlm_tpu_torch.models.encoders import TOWERS

MESH_SHAPE = [2, 2]
CHECKS = ["mesh_2d", "split", "forward", "sgd_step", "block_lane", "int8_lanes",
          "mlp_int8_lane", "backbone_refused"]


def _jax_split_dims(params, spec_tree):
    """Each leaf of JAX's tree as an array whose values count along its
    split axis (zeros where replicated), so the weight bridge carries the
    split axis into the port's layout."""
    import jax

    def encode(leaf, spec):
        shape = np.shape(leaf)
        axes = [i for i, name in enumerate(tuple(spec)) if name == "model"]
        if not axes:
            return np.zeros(shape, np.float32)
        ramp = np.arange(shape[axes[0]], dtype=np.float32).reshape(
            [-1 if i == axes[0] else 1 for i in range(len(shape))])
        return np.broadcast_to(ramp, shape).copy()

    return jax.tree_util.tree_map(encode, params, spec_tree)


def _varying_dim(t: torch.Tensor):
    dims = [d for d in range(t.dim())
            if t.shape[d] > 1 and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


@pytest.mark.parametrize("model", ["tiny-clip", "tiny-siglip"])
def test_partition_specs_match_jax(model):
    """tests/test_tp.py:20-31's table, for every parameter of the vision
    tower: the dim the port splits is the one JAX's spec splits, carried
    through the bridge (transposed kernels, unstacked layers)."""
    import jax.numpy as jnp

    from bayesvlm_tpu.dist.tp import tower_partition_specs as jax_specs
    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu_torch.models.bridge import vision_state_dict

    j_img, _, _ = jax_load_model(model, dtype=jnp.float32, seed=0)
    bridged = vision_state_dict(_jax_split_dims(j_img.params, jax_specs(j_img.params)))
    config = CONFIGS_BY_NAME[model]
    module = TOWERS[config.family][0](config.vision)
    ours = tower_partition_specs(module)
    assert set(ours) == set(bridged)
    want = {name: _varying_dim(t) for name, t in bridged.items()}
    assert ours == want
    layer = "encoder.layers.0"
    assert ours[f"{layer}.self_attn.q_proj.weight"] == 0
    assert ours[f"{layer}.self_attn.q_proj.bias"] == 0
    assert ours[f"{layer}.self_attn.out_proj.weight"] == 1
    assert ours[f"{layer}.self_attn.out_proj.bias"] is None
    assert ours[f"{layer}.mlp.fc1.weight"] == 0 and ours[f"{layer}.mlp.fc2.weight"] == 1


@pytest.fixture(scope="module")
def tp_outcomes(tmp_path_factory):
    """JAX's references (tests/test_tp.py's forward and step on the same
    seeds, the block and int8 lanes' forwards), then one 4-rank spawn."""
    import jax
    import jax.numpy as jnp

    from bayesvlm_tpu.models import load_model as jax_load_model
    from bayesvlm_tpu.models.clip import CLIPVisionTower
    from bayesvlm_tpu_torch.models.bridge import save_weights

    img, txt, head = jax_load_model("tiny-clip", dtype=jnp.float32, seed=0)
    module, params, cfg = img.module, img.params, img.config
    rng = np.random.default_rng(0)
    B, C = 8, 6
    pixels = rng.normal(size=(B, cfg.vision.image_size, cfg.vision.image_size, 3)
                        ).astype(np.float32)
    ref_embeds, ref_acts = module.apply({"params": params}, jnp.asarray(pixels))
    rng = np.random.default_rng(1)
    labels = rng.integers(0, C, size=(B,)).astype(np.int32)
    text = rng.normal(size=(C, cfg.vision.projection_dim)).astype(np.float32)

    def step(p, px, lb, tx):
        def loss_fn(kernel):
            _, acts = module.apply({"params": p}, px)
            e = acts @ kernel
            e = e / jnp.linalg.norm(e, axis=-1, keepdims=True)
            t = tx / jnp.linalg.norm(tx, axis=-1, keepdims=True)
            logits = e @ t.T * jnp.exp(head.logit_scale)
            logp = jax.nn.log_softmax(logits, axis=-1)
            return -jnp.take_along_axis(logp, lb[:, None], axis=-1).mean()

        kernel = p["visual_projection"]["kernel"]
        loss, grad = jax.value_and_grad(loss_fn)(kernel)
        return loss, kernel - 1e-2 * grad

    ref_loss, ref_kernel = jax.jit(step)(params, jnp.asarray(pixels),
                                         jnp.asarray(labels), jnp.asarray(text))

    def lane(**flags):
        lane_cfg = dataclasses.replace(cfg.vision, **flags)
        e, a = CLIPVisionTower(lane_cfg, dtype=jnp.float32).apply(
            {"params": params}, jnp.asarray(pixels))
        return np.asarray(e), np.asarray(a)

    refs = {"pixels": pixels, "labels": labels, "text": text,
            "logit_scale": np.asarray(head.logit_scale, np.float32),
            "ref_embeds": np.asarray(ref_embeds), "ref_acts": np.asarray(ref_acts),
            "ref_loss": np.asarray(ref_loss), "ref_kernel": np.asarray(ref_kernel)}
    for key, flags in (("block", {"attn_pallas_block": True}),
                       ("int8", {"mlp_int8": True, "attn_int8": True}),
                       ("mlp8", {"mlp_int8": True})):
        refs[f"{key}_embeds"], refs[f"{key}_acts"] = lane(**flags)
    tmp = tmp_path_factory.mktemp("tp")
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)
    wd = save_weights(tmp / "weights", to_np(params), to_np(txt.params))
    np.savez(tmp / "refs.npz", **refs)
    return spawn(4, "tp", {"npz": str(tmp / "refs.npz"), "weights_dir": str(wd),
                           "shape": MESH_SHAPE}, tmp / "run")


@pytest.mark.parametrize("check", CHECKS)
def test_tp_matches_jax(tp_outcomes, check):
    for rank, out in enumerate(tp_outcomes):
        assert out[check] == "ok", f"rank {rank}:\n{out[check]}"
