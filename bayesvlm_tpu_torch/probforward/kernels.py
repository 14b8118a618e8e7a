"""The fused probit zero-shot head: the CUDA kernel and its plain PyTorch
version.

`fused_probit_probs` is the port of `bayesvlm_tpu.probforward.kernels.
smith_pallas.fused_probit_probs` (`_smith_kernel`): from the image
embeddings and their per-sample diagonal covariances (sigma from
`smith.activation_diag_covariance`) and the class embeddings and theirs,
the probit-softmax probabilities [B, C] in fp32, without the [B, C] mean
and variance of the Smith forward ever reaching device memory:

    mean  = (e_s / sqrt(E_s)) . (e_t / sqrt(E_t))^T
    var   = (n_s / E_s) . (sigma_t / E_t)^T + (sigma_s / E_s) . (e_t^2 / E_t)^T
    probs = softmax(mean e^s / sqrt(1 + pi/8 var e^{2s}))

with n = e^2 + sigma and E = sum(n) per row. The row-scaling prelude, the
three products, the probit and the row softmax are the kernel's
(csrc/smith_head.cu: a prepass splits the class side into TF32 parts,
then the fused kernel runs the products on the tensor cores in three
TF32 passes); the wrapper checks, pads the image side for the TMA where
its rows need it, and allocates.

- CUDA tensors launch the kernel or raise; nothing falls back to the
  plain version on the card.
- CPU tensors run `smith_probit_probs_reference`, the unfused chain in
  plain PyTorch. The tests and chip_smoke.py hold the kernel against it.

Neither the pipeline nor the zero-shot CLI calls it, as in the JAX
package: they materialise the mean and variance (`make_predictions`
caches them as `logits_mean.pt` / `logits_var.pt`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.probforward.smith import _highest_fp32_matmul

_PI8 = math.pi / 8.0


def smith_probit_probs_reference(source_embeds, source_diag_cov, target_embeds,
                                 target_diag_cov, logit_scale) -> torch.Tensor:
    """The unfused chain (smith_pallas.py:202-217), fp32 products at
    "highest" precision. Returns [B, C] fp32."""
    se, sc = source_embeds.float(), source_diag_cov.float()
    te, tc = target_embeds.float(), target_diag_cov.float()
    n_s = se**2 + sc
    E_s = n_s.sum(-1, keepdim=True)
    n_t = te**2 + tc
    E_t = n_t.sum(-1, keepdim=True)
    with _highest_fp32_matmul():
        mean = (se / torch.sqrt(E_s)) @ (te / torch.sqrt(E_t)).T
        var = (n_s @ tc.T + sc @ (te**2).T) / (E_s * E_t.T)
    scale = torch.exp(torch.as_tensor(logit_scale, dtype=torch.float32,
                                      device=se.device))
    mean = mean * scale
    var = var * scale**2
    return torch.softmax(mean / torch.sqrt(1.0 + _PI8 * var), dim=-1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("smith_head")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_smith_head.argtypes = [p, p, i, p, p, p, p, p, p, i, i, i, p]
    lib.bvt_smith_head.restype = i
    lib.bvt_smith_head_max_classes.argtypes = []
    lib.bvt_smith_head_max_classes.restype = i
    lib.bvt_smith_head_resources.argtypes = [i, i, i, p]
    lib.bvt_smith_head_resources.restype = i
    return lib


def max_classes() -> int:
    """The largest class count the kernel takes on the current card (it
    refuses larger C): past one column tile of 128, each CTA of a cluster
    of 8 keeps the logits of its tiles, 64 rows each, in shared memory
    beside a ring of two stages."""
    n = _library().bvt_smith_head_max_classes()
    if n < 0:
        raise RuntimeError(f"smith_head kernel: no device limits (cudaError {-n})")
    return n


RESOURCE_KEYS = ("nt", "tiles", "cluster", "stages", "smem_bytes", "registers",
                 "local_bytes", "max_active_clusters", "k_stages")


def kernel_resources(B: int, C: int, D: int) -> dict:
    """The plan of a call at B, C, D (column tile NT, column tiles, cluster
    width, ring stages, k stages of 16) and its kernel's resources (dynamic
    shared memory, registers and local memory a thread, clusters the card
    holds at once)."""
    lib = _library()
    out = (ctypes.c_int * len(RESOURCE_KEYS))()
    kernels.check(lib, lib.bvt_smith_head_resources(B, C, D, out), "smith_head resources")
    return dict(zip(RESOURCE_KEYS, out))


def _tma_rows(se: torch.Tensor, sc: torch.Tensor):
    """se, sc [B, D] fp32 as the TMA reads them: rows a multiple of 16 bytes
    apart from 16-byte aligned bases. Where D % 4 != 0 or a base is
    misaligned, zero-padded copies [B, D rounded up to 4] (zero columns
    change neither the products nor E). Returns (se, sc, row stride)."""
    D = se.shape[1]
    if D % 4 == 0 and se.data_ptr() % 16 == 0 and sc.data_ptr() % 16 == 0:
        return se, sc, D
    lds = -(-D // 4) * 4
    return F.pad(se, (0, lds - D)), F.pad(sc, (0, lds - D)), lds


def fused_probit_probs(source_embeds: torch.Tensor, source_diag_cov: torch.Tensor,
                       target_embeds: torch.Tensor, target_diag_cov: torch.Tensor,
                       logit_scale) -> torch.Tensor:
    """Probit-softmax zero-shot probabilities [B, C] fp32 from the image
    embeddings and diagonal covariances [B, D] and the class ones [C, D];
    `logit_scale` s (the probabilities use e^s) a float or a 0-d tensor
    (one on the card is read there, without a host sync).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted in `fused_probit_probs.launches`, or raise (a C past
    `max_classes()`, among others)."""
    operands = (source_embeds, source_diag_cov, target_embeds, target_diag_cov)
    if any(t.dim() != 2 for t in operands):
        raise ValueError("embeddings and covariances must be 2-d")
    (B, D), (C, Dt) = source_embeds.shape, target_embeds.shape
    if source_diag_cov.shape != (B, D) or target_diag_cov.shape != (C, Dt) or D != Dt:
        raise ValueError(f"shapes {[tuple(t.shape) for t in operands]}: want "
                         f"[B, D], [B, D], [C, D], [C, D]")
    if C == 0 or D == 0:
        raise ValueError("fused_probit_probs needs C >= 1 classes and D >= 1")
    device = source_embeds.device
    if any(t.device != device for t in operands):
        raise ValueError("embeddings and covariances must be on one device")
    if device.type == "cpu":
        return smith_probit_probs_reference(*operands, logit_scale)
    if device.type != "cuda":
        raise ValueError(f"no smith_head kernel for device {device}")

    lib = _library()
    with torch.cuda.device(device):
        limit = max_classes()
        if C > limit:
            raise ValueError(f"smith_head kernel: C={C} classes do not fit the shared "
                             f"memory of a block beside its ring (C <= {limit})")
        se, sc, te, tc = (t.float().contiguous() for t in operands)
        se, sc, lds = _tma_rows(se, sc)
        if isinstance(logit_scale, torch.Tensor):
            log_scale = logit_scale.to(device, torch.float32).reshape(1).contiguous()
        else:
            log_scale = torch.full((1,), float(logit_scale), dtype=torch.float32,
                                   device=device)
        cp, dp = -(-C // 8) * 8, -(-D // 4) * 4
        cls = torch.empty(6, cp, dp, dtype=torch.float32, device=device)
        scales = torch.empty(2, cp, dtype=torch.float32, device=device)
        out = torch.empty(B, C, dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bvt_smith_head(se.data_ptr(), sc.data_ptr(), lds, te.data_ptr(),
                                 tc.data_ptr(), log_scale.data_ptr(), cls.data_ptr(),
                                 scales.data_ptr(), out.data_ptr(), B, C, D, stream)
    kernels.check(lib, err, "smith_head kernel")
    fused_probit_probs.launches += 1
    return out


fused_probit_probs.launches = 0
