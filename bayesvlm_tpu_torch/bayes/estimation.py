"""K-FAC GGN estimation driver (ref:scripts/hessian_estimation.py:26-109),
the port's counterpart of `bayesvlm_tpu.bayes.estimation`.

The dataset is split into class batches of `num_classes` pairs; within
each class batch the B factor accumulates the GGN of every source sample
against that class batch's targets, and the A factor the activation Gram
(with the ones column of SigLIP's biased projection). Both are summed in
float64, in class-batch order, and divided by sqrt(n) at the end.

The reference's inner loop of 5-sample batches only bounds its [B, D, D]
intermediates; the Gram reformulation (bayes/hessians.py) has none, so
the inner block is thousands of rows, sized for the [block, C] logits
buffers.

Each class batch goes through dist/hessian_allreduce.py: with a mesh
(dist/mesh.py) its source rows are split over the ranks and the [C] /
[D, D] partials `all_reduce`d, so every rank holds the same factors;
with none (None) the functions are one device's, with the bits of
bayes/hessians.py's dense ones.

Step checkpoints: with a `checkpoint_dir`, the running float64 sums are
written every `checkpoint_every` completed class batches as one atomic
`step_{k:08d}.pt` (`torch.save` to a temporary name, then `os.replace`;
k = the class batches done), the latest two kept. A killed run resumes
from the newest step and gives the uninterrupted run's factors bit for
bit (the same sums in the same order); the directory is removed on
success. A step from another run configuration, or a directory that
holds no readable step (the JAX package's orbax steps), is discarded
with a RuntimeWarning and the sums restart at class batch 0.
"""

from __future__ import annotations

import os
import shutil
import warnings
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from bayesvlm_tpu_torch.dist.hessian_allreduce import (
    sharded_activation_gram,
    sharded_hessian_infonce,
    sharded_hessian_siglip,
)

_LIKELIHOOD_IDS = {"info_nce": 0, "siglip": 1}
_KEEP_STEPS = 2


def _steps(ckpt_dir: Path):
    """(class batches done, path) of the step files, oldest first."""
    found = []
    for p in ckpt_dir.glob("step_*.pt"):
        try:
            found.append((int(p.stem.split("_", 1)[1]), p))
        except ValueError:
            continue
    return sorted(found)


def _save_step(ckpt_dir: Path, done: int, state: dict) -> None:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".step_{done:08d}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, ckpt_dir / f"step_{done:08d}.pt")
    for _, old in _steps(ckpt_dir)[:-_KEEP_STEPS]:
        old.unlink()


def _restart(ckpt_dir: Path, why: str):
    warnings.warn(f"GGN step checkpoint {why}; restarting the accumulation "
                  f"from class batch 0", RuntimeWarning, stacklevel=3)
    shutil.rmtree(ckpt_dir)
    return None, None, 0


def _restore_ggn_state(ckpt_dir: Path, num_classes: int, n_sources: int,
                       likelihood: str, device):
    """(A, B, class batches done) of the newest compatible step, or
    (None, None, 0) when there is none."""
    if not ckpt_dir.exists() or not any(ckpt_dir.iterdir()):
        return None, None, 0
    steps = _steps(ckpt_dir)
    if not steps:
        return _restart(ckpt_dir, f"directory {ckpt_dir} holds no step this "
                                  f"package wrote")
    done, path = steps[-1]
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # a step this package cannot read
        return _restart(ckpt_dir, f"{path} is unreadable ({e})")
    ok = (int(state["num_classes"]) == num_classes
          and int(state["n_sources"]) == n_sources
          and int(state["likelihood"]) == _LIKELIHOOD_IDS[likelihood])
    if not ok:
        return _restart(ckpt_dir, "is from a different run configuration "
                                  "(num_classes/n_sources/likelihood changed)")
    return state["A"].to(device), state["B"].to(device), done


def kfac_ggn(
    logit_scale,
    logit_bias,
    num_classes: int,
    source_embeds,
    source_activations,
    target_embeds,
    likelihood: str,
    block_size: int = 2048,
    chunk_size_j: Optional[int] = None,
    precision: str = "highest",
    mesh=None,
    progress: bool = False,
    checkpoint_dir: Optional[Union[str, Path]] = None,
    checkpoint_every: int = 1,
    device: Union[str, torch.device, None] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (A, B) as fp32 tensors on `device`, both already divided by
    sqrt(n) (ref:hessian_estimation.py:106-109).

    `block_size` chunks the source axis (the CLI's --la_batch_size),
    `chunk_size_j` the SigLIP target axis (--siglip_chunk_size); results
    are invariant to both. `precision`: "highest" (fp32, the default) or
    "high" (3xTF32). `mesh`: shards each class batch's source rows over
    the mesh's ranks (None or a mesh of one rank: one device).
    `checkpoint_dir` / `checkpoint_every`: the step checkpoints (module
    docstring). `device`: where the sums run; by default the device of
    `source_embeds` when it is a tensor, else the card.
    """
    if likelihood not in _LIKELIHOOD_IDS:
        raise ValueError(f"Invalid likelihood: {likelihood}, must be one of "
                         f"{sorted(_LIKELIHOOD_IDS)}.")
    if device is None:
        device = source_embeds.device if torch.is_tensor(source_embeds) else "cuda"
    device = torch.device(device)

    def fp32(x):
        return torch.as_tensor(x).to(device, torch.float32)

    source_embeds, source_activations, target_embeds = (
        fp32(source_embeds), fp32(source_activations), fp32(target_embeds))
    scale, bias = fp32(logit_scale), fp32(logit_bias)

    num_class_batches = len(target_embeds) // num_classes
    if num_class_batches == 0:
        raise ValueError(
            f"Too few datapoints for K-FAC approximation. Need at least "
            f"{num_classes} datapoints."
        )

    if mesh is not None and mesh.size() == 1:
        mesh = None  # one device: no collective
    n_sources = len(source_embeds)
    A = B = None
    start_batch = 0
    ckpt_dir = Path(checkpoint_dir) if checkpoint_dir is not None else None
    if ckpt_dir is not None:
        A, B, start_batch = _restore_ggn_state(ckpt_dir, num_classes, n_sources,
                                               likelihood, device)
        if start_batch and progress:
            print(f"K-FAC resume from class batch {start_batch}/"
                  f"{num_class_batches}", flush=True)

    for i in range(start_batch, num_class_batches):
        if progress:
            print(f"K-FAC class batch {i + 1}/{num_class_batches}", flush=True)
        start, end = i * num_classes, (i + 1) * num_classes
        tgt = target_embeds[start:end]
        src = source_embeds[start:end]
        act = source_activations[start:end]
        if likelihood == "info_nce":
            H = sharded_hessian_infonce(src, tgt, scale, mesh, block_size=block_size,
                                        precision=precision)
            G = sharded_activation_gram(act, mesh)
        else:
            indices = torch.arange(len(src), device=device)
            H = sharded_hessian_siglip(src, indices, tgt, scale, bias, mesh,
                                       block_size=block_size, chunk_j=chunk_size_j,
                                       precision=precision)
            G = sharded_activation_gram(act, mesh, append_bias_column=True)
        # fp32 -> fp64 is exact; the adds are IEEE fp64, as numpy's
        H, G = H.double(), G.double()
        B = H if B is None else B + H
        A = G if A is None else A + G

        if ckpt_dir is not None and (i + 1) % max(1, checkpoint_every) == 0 \
                and (i + 1) < num_class_batches:
            # step = the class batches completed, so a restore resumes at i+1
            _save_step(ckpt_dir, i + 1, {
                "A": A.cpu(), "B": B.cpu(), "num_classes": num_classes,
                "n_sources": n_sources, "likelihood": _LIKELIHOOD_IDS[likelihood],
            })

    n = num_class_batches * num_classes
    A = A / np.sqrt(n)
    B = B / np.sqrt(n)
    if ckpt_dir is not None and ckpt_dir.exists():
        shutil.rmtree(ckpt_dir)
    return A.float(), B.float()
