"""Fused non-causal multi-head attention: the CUDA kernel and its plain
PyTorch version.

`fused_attention` is the port of `bayesvlm_tpu.models.attention_pallas.
fused_attention` (default schedule, `_mha_kernel`). On packed-head
`q, k, v: [B, T, H*Dh]` it computes, per head, fp32 scores scaled AFTER
the dot, an exact fp32 softmax, `p` rounded to the input dtype, and
`p @ v` accumulated in fp32 (csrc/attention.cu says how).

- CUDA tensors launch the hand-written kernel or raise; nothing falls
  back to the plain version on the card.
- CPU tensors run `fused_attention_reference`, the same math in plain
  PyTorch. The tests and chip_smoke.py hold the kernel against it.

The kernel is compiled with nvcc for sm_90a on first use, from
`csrc/attention.cu` (`bayesvlm_tpu_torch/kernels.py` builds and loads
it).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bayesvlm_tpu_torch import kernels

# head dims the kernel is instantiated for (csrc/attention.cu launch_dtype)
KERNEL_HEAD_DIMS = (16, 64, 80)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math, same rounding points:
    fp32 scores (inputs widened, so bf16 products are exact) times the
    scale, fp32 softmax written as exp(s - max) / sum, p rounded to the
    input dtype, p @ v accumulated in fp32 and rounded to the input
    dtype. Materialises the [B, H, T, T] scores."""
    B, T, D = q.shape
    Dh = D // num_heads

    def heads(x):
        return x.reshape(B, T, num_heads, Dh).transpose(1, 2).float()

    s = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(Dh))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    o = p.float() @ heads(v)
    return o.transpose(1, 2).reshape(B, T, D).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("attention")
    lib.bvt_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.bvt_attention.restype = ctypes.c_int
    lib.bvt_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bvt_attention_smem_bytes.restype = ctypes.c_long
    lib.bvt_attention_smem_limit.argtypes = []
    lib.bvt_attention_smem_limit.restype = ctypes.c_int
    return lib


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Non-causal self-attention on packed heads [B, T, H*Dh] -> same.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in `fused_attention.launches`) or raise."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one [B, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, D = q.shape
    if D % num_heads:
        raise ValueError(f"hidden size {D} is not a multiple of {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")

    Dh = D // num_heads
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention kernel takes float32 or bfloat16, not {q.dtype}")
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel has no head dim {Dh} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel needs contiguous q, k, v")
    if B > 65535 or num_heads > 65535:
        raise ValueError("attention kernel grid takes at most 65535 batch rows "
                         "and heads")
    lib = _library()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        smem = lib.bvt_attention_smem_bytes(T, Dh)
        budget = lib.bvt_attention_smem_limit()
        if smem > budget:
            raise ValueError(f"T={T} needs {smem} bytes of shared memory for "
                             f"its scores; the card allows {budget} per block")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bvt_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), B, T, num_heads, Dh,
                                _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(Dh),
                                stream)
    kernels.check(lib, err, "attention kernel")
    fused_attention.launches += 1
    return o


fused_attention.launches = 0
