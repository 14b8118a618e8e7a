"""The port's partial-backbone fine-tune (`bayesvlm_tpu_torch.train.backbone`)
against the JAX package's (`bayesvlm_tpu.train.backbone`) on the CPU, the
gradient through the attention kernel's autograd.Function, `remat`, and
what refuses a gradient.

tiny-clip in fp32, the JAX package's seed-0 vision tower bridged into the
port (`models/bridge.py`), the loss of tests/test_backbone_finetune.py (CE
of cosine logits times 10 against seeded targets), two AdamW steps at lr
1e-2, wd 1e-2. Tolerances:
  - the losses: rtol 1e-5 (fp32, summation order only);
  - each trained parameter by the relative Frobenius norm of its update
    (W - W0) against JAX's, at 1e-3, as the projection fine-tune's
    parity holds Adam (tests/test_torch_activelearning.py): Adam's
    m / sqrt(v) amplifies a rounding difference where a gradient element
    is near 0, which no elementwise bound survives. The key projection's
    bias has a gradient of exactly 0 in exact arithmetic, so its update is
    Adam on rounding noise in both packages: its gradient is held below
    1e-6 of the query bias's instead;
  - frozen parameters: bit-identical to the weights both packages began
    from;
  - `remat=True` against `remat=False`: gradients bit-equal;
  - the autograd.Function's backward: `torch.autograd.gradcheck` in
    float64 (its defaults) with the launch stubbed by the plain forward.
The autograd.Function's forward on the card, and the kernels that refuse
a gradient there, are the `cuda` tests at the end (skipped here; JAX is
imported inside the parity tests, so that they also run on the card
machine, which has no JAX).
"""

import numpy as np
import pytest
import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.models import attention
from bayesvlm_tpu_torch.models.bridge import save_weights, vision_state_dict
from bayesvlm_tpu_torch.models.configs import TINY_CLIP_CONFIG
from bayesvlm_tpu_torch.models.encoders import load_model, rebuild_image_encoder
from bayesvlm_tpu_torch.train.backbone import (
    make_backbone_train_step,
    trainable_parameters,
)

L = TINY_CLIP_CONFIG.vision.num_layers
LR, WD = 1e-2, 1e-2
LOSS_RTOL = 1e-5
UPDATE_TOL = 1e-3
PROJ = ("visual_projection",)


def _data(seed: int):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=(4,))
    targets = rng.normal(size=(3, 16)).astype(np.float32)
    return images, labels, targets


def _jax_run(params, module, data, k, enable_projection, steps=2):
    import jax
    import jax.numpy as jnp

    from bayesvlm_tpu.train.backbone import make_backbone_train_step as jax_step_fn

    images, labels, targets = data

    def loss_fn(p, batch):
        embeds, _ = module.apply({"params": p}, batch["images"])
        e = embeds / jnp.linalg.norm(embeds, axis=-1, keepdims=True)
        t = targets / jnp.linalg.norm(targets, axis=-1, keepdims=True)
        logp = jax.nn.log_softmax(e @ t.T * 10.0, -1)
        return -jnp.take_along_axis(logp, batch["labels"][:, None], -1).mean()

    init_state, step = jax_step_fn(module, loss_fn, num_layers=L, k_last_layers=k,
                                   projection_names=PROJ, learning_rate=LR,
                                   weight_decay=WD, enable_projection=enable_projection)
    opt_state = init_state(params)
    batch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return params, losses


def port_loss(targets):
    t = torch.from_numpy(targets)
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True)

    def loss_fn(module, batch):
        embeds, _ = module(batch["images"])
        e = embeds / torch.linalg.norm(embeds, dim=-1, keepdim=True)
        logp = torch.log_softmax(e @ t.T * 10.0, dim=-1)
        return -logp.gather(-1, batch["labels"][:, None]).mean()

    return loss_fn


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """The JAX package's seed-0 tiny-clip towers, and the port's weights dir
    holding the same weights."""
    import jax
    import jax.numpy as jnp

    import bayesvlm_tpu.models as jax_models

    j_img, j_txt, _ = jax_models.load_model("tiny-clip", dtype=jnp.float32, seed=0)
    wd = save_weights(tmp_path_factory.mktemp("w"),
                      jax.tree_util.tree_map(np.asarray, j_img.params),
                      jax.tree_util.tree_map(np.asarray, j_txt.params))
    return j_img, wd


def _port_tower(wd, remat=False):
    img = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32, device="cpu",
                     remat=remat)[0]
    return img.module


def _port_run(module, data, k, enable_projection, steps=2):
    images, labels, targets = data
    init_state, step = make_backbone_train_step(
        module, port_loss(targets), num_layers=L, k_last_layers=k,
        projection_names=PROJ, learning_rate=LR, weight_decay=WD,
        enable_projection=enable_projection)
    init_state()
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    return [float(step(batch)) for _ in range(steps)]


@pytest.mark.parametrize("k,enable_projection", [(1, True), (0, True), (1, False),
                                                 (2, True)])
def test_backbone_step_matches_jax(bridged, k, enable_projection):
    import jax

    j_img, wd = bridged
    data = _data(k + 10 * enable_projection)
    j_params, j_losses = _jax_run(j_img.params, j_img.module, data, k, enable_projection)
    module = _port_tower(wd)
    w0 = {n: p.detach().clone() for n, p in module.named_parameters()}
    losses = _port_run(module, data, k, enable_projection)
    np.testing.assert_allclose(losses, j_losses, rtol=LOSS_RTOL)
    assert losses[1] < losses[0]

    trained = trainable_parameters(module, L, k, PROJ, enable_projection)
    want = {f"encoder.layers.{i}." for i in range(L - k, L)}
    assert {n for n in trained if not n.startswith("visual_projection")} == {
        n for n in w0 if n[:17] in want}
    assert ("visual_projection.weight" in trained) == enable_projection
    jax_new = vision_state_dict(jax.tree_util.tree_map(np.asarray, j_params))
    for name, p in module.named_parameters():
        got = p.detach()
        if name in trained and name.endswith("k_proj.bias"):
            # zero in exact arithmetic (a softmax row does not move when one
            # term is added to all its scores): both packages run Adam on
            # rounding noise, which no bound between them holds; checked
            # instead: the port's gradient is rounding-sized
            q_bias = dict(module.named_parameters())[name.replace("k_proj", "q_proj")]
            assert float(p.grad.norm()) <= 1e-6 * float(q_bias.grad.norm()), name
        elif name in trained:
            d_port, d_jax = got - w0[name], jax_new[name] - w0[name]
            assert float(torch.linalg.norm(d_jax)) > 0, name
            rel = float(torch.linalg.norm(d_port - d_jax) / torch.linalg.norm(d_jax))
            assert rel <= UPDATE_TOL, (name, rel)
        else:
            # frozen: bit-identical, in both packages
            assert torch.equal(got, w0[name]), name
            assert torch.equal(jax_new[name], w0[name]), name
        assert not p.requires_grad or name in trained


def test_remat_gives_equal_gradients(bridged):
    _, wd = bridged
    images, labels, targets = _data(7)
    batch = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels)}
    grads = []
    for remat in (False, True):
        module = _port_tower(wd, remat=remat)
        assert module.encoder.remat == remat
        init_state, step = make_backbone_train_step(
            module, port_loss(targets), num_layers=L, k_last_layers=2,
            projection_names=PROJ, learning_rate=LR, weight_decay=WD)
        init_state()
        step(batch)
        grads.append({n: p.grad.clone() for n, p in module.named_parameters()
                      if p.grad is not None})
    assert set(grads[0]) == set(grads[1]) and len(grads[0]) > 10
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_remat_changes_nothing_without_a_gradient(bridged):
    _, wd = bridged
    images = torch.from_numpy(_data(3)[0])
    outs = []
    for remat in (False, True):
        module = _port_tower(wd, remat=remat)
        with torch.no_grad():
            outs.append(module(images)[0])
    assert torch.equal(outs[0], outs[1])


def test_rebuild_keeps_or_sets_remat(bridged):
    _, wd = bridged
    img = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32, device="cpu",
                     remat=True)[0]
    assert rebuild_image_encoder(img).module.encoder.remat
    assert not rebuild_image_encoder(img, remat=False).module.encoder.remat
    assert load_model("tiny-clip", dtype=torch.float32, device="cpu")[1].module.encoder.remat \
        is False


@pytest.mark.parametrize("lane", [dict(mlp_int8=True), dict(attn_int8=True),
                                  dict(attn_pallas_block=True)])
def test_kernel_lanes_are_refused_before_a_step(bridged, lane):
    _, wd = bridged
    img = load_model("tiny-clip", weights_dir=wd, dtype=torch.float32, device="cpu")[0]
    module = rebuild_image_encoder(img, **lane).module
    before = {n: p.clone() for n, p in module.named_parameters()}
    with pytest.raises(ValueError, match="no backward"):
        make_backbone_train_step(module, port_loss(_data(0)[2]), num_layers=L,
                                 k_last_layers=1, projection_names=PROJ)
    assert all(torch.equal(p, before[n]) for n, p in module.named_parameters())


def test_step_before_init_state_is_refused(bridged):
    _, wd = bridged
    module = _port_tower(wd)
    _, step = make_backbone_train_step(module, port_loss(_data(0)[2]), num_layers=L,
                                       k_last_layers=1, projection_names=PROJ)
    with pytest.raises(RuntimeError, match="init_state"):
        step({})


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, True),
                                   (False, False, True)])
def test_attention_backward_gradcheck(monkeypatch, needs):
    """The kernel's autograd.Function on the CPU, its launch stubbed by the
    plain forward: its backward (the plain version's gradients, recomputed)
    passes gradcheck in float64, for any subset of q, k, v requiring grad."""
    launches = []

    def stub(q, k, v, num_heads, schedule):
        launches.append(schedule)
        return attention.fused_attention_reference(q, k, v, num_heads)

    monkeypatch.setattr(attention, "_launch", stub)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 5, 6, generator=gen, dtype=torch.float64).requires_grad_(n)
               for n in needs)
    fn = lambda q, k, v: attention._AttentionWithGrad.apply(q, k, v, 2,
                                                            attention.ONE_BLOCK)
    assert torch.autograd.gradcheck(fn, (q, k, v))
    assert launches and set(launches) == {attention.ONE_BLOCK}


def test_attention_function_matches_plain_gradients(monkeypatch):
    """fp32: the Function's gradients are the plain version's, bit for bit
    (the backward recomputes it on the saved q, k, v)."""
    monkeypatch.setattr(attention, "_launch", lambda q, k, v, h, s:
                        attention.fused_attention_reference(q, k, v, h))
    gen = torch.Generator().manual_seed(1)
    qkv = [torch.randn(3, 7, 32, generator=gen).requires_grad_() for _ in range(3)]
    g = torch.randn(3, 7, 32, generator=gen)
    out = attention._AttentionWithGrad.apply(*qkv, 2, attention.ONE_BLOCK)
    got = torch.autograd.grad(out, qkv, g)
    want = torch.autograd.grad(attention.fused_attention_reference(*qkv, 2), qkv, g)
    assert out.grad_fn is not None
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_records_grad_follows_grad_mode():
    x = torch.ones(2, requires_grad=True)
    y = torch.ones(2)
    assert kernels.records_grad(x, None) and not kernels.records_grad(y, None)
    with pytest.raises(RuntimeError, match="has no backward"):
        kernels.refuse_grad("k", y, x)
    with torch.no_grad():
        assert not kernels.records_grad(x)
        kernels.refuse_grad("k", x)
    with torch.inference_mode():
        assert not kernels.records_grad(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_records_a_gradient_on_card(cuda, dtype):
    """On the card a recorded fused_attention launches the kernel once
    (counted as before) and carries the plain version's gradient; under
    no_grad and inference_mode the same launch gives the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = [torch.randn(4, 257, 1024, generator=gen, device=cuda).to(dtype)
           for _ in range(3)]
    attention.fused_attention.launches = 0
    with torch.no_grad():
        plain_bits = attention.fused_attention(*qkv, 16)
    with torch.inference_mode():
        inf_bits = attention.fused_attention(*qkv, 16)
    leaves = [t.clone().requires_grad_() for t in qkv]
    out = attention.fused_attention(*leaves, 16)
    assert attention.fused_attention.launches == 3
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), plain_bits) and torch.equal(inf_bits, plain_bits)
    g = torch.randn(out.shape, generator=gen, device=cuda).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    ref = [t.clone().requires_grad_() for t in qkv]
    want = torch.autograd.grad(attention.fused_attention_reference(*ref, 16), ref, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_gradless_kernels_refuse_a_recorded_call_on_card(cuda):
    from bayesvlm_tpu_torch.models.linear_int8 import linear_int8
    from bayesvlm_tpu_torch.models.mlp_int8 import mlp_int8

    x = torch.randn(2, 50, 64, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    w = [torch.randn(64, 64, device=cuda, dtype=torch.bfloat16) * 0.1 for _ in range(4)]
    b = [torch.zeros(64, device=cuda, dtype=torch.bfloat16) for _ in range(4)]
    ln = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    block = lambda x: attention.fused_attention_block(
        x, *ln, w[0], b[0], w[1], b[1], w[2], b[2], w[3], b[3], num_heads=4)
    w1 = torch.randn(128, 64, device=cuda, dtype=torch.bfloat16)
    w2 = torch.randn(64, 128, device=cuda, dtype=torch.bfloat16)
    b1, b2 = torch.zeros(128, device=cuda), torch.zeros(64, device=cuda)
    mlp = lambda x: mlp_int8(x, w1, b1, w2, b2)
    lin = lambda x: linear_int8(x, w[0], b[0])
    for fn in (block, mlp, lin):
        with pytest.raises(RuntimeError, match="has no backward"):
            fn(x)
        with torch.no_grad():
            assert fn(x).shape == x.shape
