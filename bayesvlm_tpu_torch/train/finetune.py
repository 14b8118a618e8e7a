"""Projection-layer fine-tuning on cached features
(ref:scripts/activelearning.py:33-225), counterpart of
`bayesvlm_tpu.train.finetune`.

Everything runs on precomputed activations and residuals, with no
encoder in the loop. A train step is the cross-entropy of the
deterministic logits between the updated image embeddings and the fixed
text embeddings (ref:activelearning.py:195-205), its gradient by
autograd on the image projection's weight (and bias), and one
`torch.optim.AdamW` step with optax's `adamw` hyperparameters (b1 0.9,
b2 0.999, eps 1e-8, decay on every parameter). Evaluation is the
unfused probabilistic (Smith) forward and reports accuracy, weighted
accuracy, ECE and the mean CE loss (ref:activelearning.py:33-73). The
best checkpoint is the lowest val loss, taken on `<=`.

The data order is the JAX package's own: `np.random.default_rng(seed)`
permutes each epoch and the ragged tail is padded by wrap-around, so
both packages train on the same batches. Products run at full fp32
(`_highest_fp32_matmul`); the global TF32 setting is left alone.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bayesvlm_tpu_torch.inference.metrics import expected_calibration_error
from bayesvlm_tpu_torch.ops import to_numpy as _host
from bayesvlm_tpu_torch.probforward.smith import ProbabilisticHead, probabilistic_logits
from bayesvlm_tpu_torch.types import EncoderResult, _highest_fp32_matmul


def _project(proj: Dict, activations: torch.Tensor,
             residuals: torch.Tensor) -> torch.Tensor:
    with _highest_fp32_matmul():
        e = activations @ proj["kernel"]
    if proj.get("bias") is not None:
        e = e + proj["bias"]
    return e + residuals


def evaluate_projection(proj: Dict, head: ProbabilisticHead, features: EncoderResult,
                        labels, text_features: EncoderResult, num_classes: int,
                        batch_size: int = 4096) -> dict:
    """ref:scripts/activelearning.py:33-73: accuracy, weighted accuracy
    (the mean of per-class recalls, weighted by support), 15-bin ECE of
    softmax(mean) and the mean CE loss of the probabilistic mean."""
    N = len(features)
    labels_np = _host(labels).reshape(-1)
    device = features.activations.device
    means, loss = [], 0.0
    with torch.no_grad():
        for s in range(0, N, batch_size):
            sl = slice(s, min(s + batch_size, N))
            source = EncoderResult(
                _project(proj, features.activations[sl], features.residuals[sl]),
                features.activations[sl], features.residuals[sl])
            mean = probabilistic_logits(head, source, text_features).mean
            lbl = torch.as_tensor(labels_np[sl], device=device, dtype=torch.long)
            logp = torch.log_softmax(mean, dim=-1)
            loss += float(-logp.gather(-1, lbl[:, None]).sum())
            means.append(mean.cpu().numpy())
    mean_all = np.concatenate(means, axis=0)

    pred = mean_all.argmax(-1)
    acc = float((pred == labels_np).mean())
    accs = []
    for c in range(num_classes):
        mask = labels_np == c
        if mask.any():
            accs.append(float((pred[mask] == c).mean()) * mask.sum())
    acc_weighted = float(np.sum(accs) / len(labels_np)) if accs else 0.0

    probs = torch.softmax(torch.from_numpy(mean_all), dim=-1)
    ece = float(expected_calibration_error(probs, torch.from_numpy(labels_np), n_bins=15))
    return dict(accuracy=acc, accuracy_weighted=acc_weighted, ece=ece, loss=loss / N)


def finetune_projection(
    img_proj: Dict,
    txt_proj: Dict,
    head: ProbabilisticHead,
    train_features: EncoderResult,
    labels_train,
    val_features: EncoderResult,
    labels_val,
    test_features: EncoderResult,
    labels_test,
    text_features: EncoderResult,
    lr: float,
    wd: float,
    epochs: int,
    batch_size: int,
    num_classes: int,
    logger=None,
    seed: int = 0,
    early_stopping_patience: Optional[int] = None,
    stats: Optional[dict] = None,
) -> Tuple[Dict, dict]:
    """AdamW fine-tune of the image projection ({"kernel": [P, D],
    "bias"?}, projection_tree's layout) on the features' device; returns
    (best projection, best test metrics), ref:scripts/activelearning.py:76-225.
    `early_stopping_patience` stops after that many epochs without a
    strict val-loss improvement (ref:scripts/activelearning_kmeans.py:367).
    `stats`, when given, receives the "epochs" run and the train "steps"
    taken."""
    device = train_features.activations.device
    txt = _project(txt_proj, text_features.activations,
                   torch.zeros_like(text_features.embeds))
    t = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
    params = {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
              for k, v in img_proj.items() if v is not None}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=wd)
    scale = torch.exp(head.logit_scale)
    logit_bias = head.logit_bias

    def train_step(a, r, y) -> None:
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad(), _highest_fp32_matmul():
            embeds = _project(params, a, r)
            e = embeds / torch.linalg.norm(embeds, dim=-1, keepdim=True)
            logits = e @ t.T * scale + logit_bias
            loss = -torch.log_softmax(logits, dim=-1).gather(-1, y[:, None]).mean()
            loss.backward()
        opt.step()

    def snapshot() -> Dict:
        return {k: v.detach().clone() for k, v in params.items()}

    N = len(train_features)
    rng = np.random.default_rng(seed)
    acts, res = train_features.activations, train_features.residuals
    lbls = torch.as_tensor(_host(labels_train).reshape(-1), device=device,
                           dtype=torch.long)

    def eval_all(p):
        return tuple(evaluate_projection(p, head, f, y, text_features, num_classes)
                     for f, y in ((train_features, labels_train),
                                  (val_features, labels_val),
                                  (test_features, labels_test)))

    def log(step, **groups):
        if logger:
            for prefix, m in groups.items():
                logger.log({f"{prefix}_{k}": v for k, v in m.items()}, step=step)

    train_m, val_m, test_m = eval_all(params)
    log(0, train=train_m, val=val_m, test=test_m)

    best_val_loss = float("inf")
    best_proj, best_test_m, best_val_m = snapshot(), test_m, val_m
    epochs_without_improvement = 0
    steps = epochs_run = 0
    for epoch in range(epochs):
        order = rng.permutation(N)
        # fixed-size batches: the ragged tail padded by wrap-around
        for s in range(0, N, batch_size):
            idx = order[s:s + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            sel = torch.as_tensor(idx, device=device)
            train_step(acts[sel], res[sel], lbls[sel])
            steps += 1
        epochs_run += 1

        train_m, val_m, test_m = eval_all(params)
        # the checkpoint is taken on <= (ties keep the later epoch,
        # ref:scripts/activelearning.py:211), but patience resets only on a
        # strict improvement (ref:scripts/activelearning_kmeans.py:416), so
        # a plateau of equal val losses still stops early
        improved_strictly = val_m["loss"] < best_val_loss
        if val_m["loss"] <= best_val_loss:
            best_val_loss = val_m["loss"]
            best_proj, best_test_m, best_val_m = snapshot(), test_m, val_m
        epochs_without_improvement = 0 if improved_strictly else epochs_without_improvement + 1
        log(epoch + 1, train=train_m, val=val_m, test=test_m, best_test=best_test_m,
            best_val=best_val_m)
        if (early_stopping_patience is not None
                and epochs_without_improvement >= early_stopping_patience):
            print(f"Early stopping at epoch {epoch + 1}")
            break
    if stats is not None:
        stats.update(epochs=epochs_run, steps=steps)
    return best_proj, best_test_m
