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
(csrc/smith_head.cu: a pre-pass writes the scaled operands k-major, then
the fused kernel); the wrapper only checks and allocates.

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
    lib.bvt_smith_head.argtypes = [
        *[ctypes.c_void_p] * 9,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.bvt_smith_head.restype = ctypes.c_int
    lib.bvt_smith_head_smem_bytes.argtypes = [ctypes.c_int]
    lib.bvt_smith_head_smem_bytes.restype = ctypes.c_long
    lib.bvt_smith_head_smem_limit.argtypes = []
    lib.bvt_smith_head_smem_limit.restype = ctypes.c_int
    return lib


def max_classes() -> int:
    """The largest class count whose [16, C] logits tile fits the current
    card's shared memory per block (the kernel refuses larger C)."""
    lib = _library()
    base, per_class = lib.bvt_smith_head_smem_bytes(0), 16 * 4
    return (lib.bvt_smith_head_smem_limit() - base) // per_class


def fused_probit_probs(source_embeds: torch.Tensor, source_diag_cov: torch.Tensor,
                       target_embeds: torch.Tensor, target_diag_cov: torch.Tensor,
                       logit_scale) -> torch.Tensor:
    """Probit-softmax zero-shot probabilities [B, C] fp32 from the image
    embeddings and diagonal covariances [B, D] and the class ones [C, D];
    `logit_scale` s (the probabilities use e^s) a float or a 0-d tensor
    (one on the card is read there, without a host sync).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    counted in `fused_probit_probs.launches`, or raise (a C past the
    card's shared memory, `max_classes()`, among others)."""
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
        need, limit = lib.bvt_smith_head_smem_bytes(C), lib.bvt_smith_head_smem_limit()
        if need > limit:
            raise ValueError(f"smith_head kernel: C={C} classes need {need} bytes of "
                             f"shared memory a block, the device allows {limit} "
                             f"(C <= {max_classes()})")
        se, sc, te, tc = (t.float().contiguous() for t in operands)
        if isinstance(logit_scale, torch.Tensor):
            log_scale = logit_scale.to(device, torch.float32).reshape(1).contiguous()
        else:
            log_scale = torch.full((1,), float(logit_scale), dtype=torch.float32,
                                   device=device)
        ldb, ldc = -(-B // 4) * 4, -(-C // 4) * 4
        src = torch.empty(3, D, ldb, dtype=torch.float32, device=device)
        tgt = torch.empty(3, D, ldc, dtype=torch.float32, device=device)
        energy = torch.empty(B + C, dtype=torch.float32, device=device)
        out = torch.empty(B, C, dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bvt_smith_head(se.data_ptr(), sc.data_ptr(), te.data_ptr(),
                                 tc.data_ptr(), log_scale.data_ptr(), src.data_ptr(),
                                 tgt.data_ptr(), energy.data_ptr(), out.data_ptr(),
                                 B, C, D, ldb, ldc, stream)
    kernels.check(lib, err, "smith_head kernel")
    fused_probit_probs.launches += 1
    return out


fused_probit_probs.launches = 0
