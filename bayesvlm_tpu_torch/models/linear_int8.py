"""W8A8 int8 linear layer: the CUDA kernel and its plain PyTorch version.

`linear_int8` is the port of `bayesvlm_tpu.models.linear_int8.
linear_int8` (`_linear_int8_kernel`), used for the vision towers'
attention projections (`attn_int8`): per-row absmax int8 activations,
per-output-channel absmax int8 weights (quantized per call, as in the
JAX package), exact int32 products, fp32 dequant + bias, one cast to x's
dtype. The same quantization recipe as models/mlp_int8.py.

- CUDA tensors launch the hand-written kernel (csrc/linear_int8.cu: the
  int8 product on the wgmma body of csrc/wgmma_gemm.cuh, dequant and
  bias in its epilogue) or raise; nothing falls back to the plain version
  on the card. `kernel_resources` reads its shared memory, blocks an SM
  and registers, and whether an output goes out by the TMA.
- CPU tensors run `linear_int8_reference`, the same math in plain
  PyTorch.

`chunks > 1` returns the output split along its last axis into that
many contiguous tensors: the kernel writes them so, and the fused QKV
projection hands contiguous q, k, v to the attention kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.models.mlp_int8 import (
    _int_product,
    _quant_rows,
    quantize_weight,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def linear_int8_reference(x: torch.Tensor, w: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (the JAX package's
    `linear_int8_reference`): x [..., K], w [N, K] -> [..., N]."""
    shape = x.shape
    xm = x.reshape(-1, shape[-1]).float()
    wq, s = quantize_weight(w)
    xq, xs = _quant_rows(xm)
    o = _int_product(xq, wq) * xs * s
    if b is not None:
        o = o + b.float()
    return o.to(x.dtype).reshape(*shape[:-1], w.shape[0])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("linear_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_linear_int8.argtypes = [p, i, i, i, i, p, p, p, i, p, p, p, p]
    lib.bvt_linear_int8.restype = ctypes.c_int
    lib.bvt_linear_int8_resources.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_int)]
    lib.bvt_linear_int8_resources.restype = ctypes.c_int
    return lib


def kernel_resources(dtype=torch.bfloat16, N: int = 3072, chunks: int = 3,
                     device=None) -> dict:
    """What the kernel's GEMM takes on the card for an x of `dtype`
    (csrc/wgmma_gemm.cuh, ping-pong 128 x 128 tiles, 5 stages): dynamic
    shared memory a block, blocks an SM, registers a thread at launch (the
    warpgroups then move to 40 / 232 with setmaxnreg), and whether N
    outputs in `chunks` chunks go out by TMA stores (each chunk a whole
    number of 128-byte epilogue boxes, or one chunk) or by plain stores."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"linear_int8 kernel takes float32 or bfloat16, not {dtype}")
    if chunks < 1 or N % chunks:
        raise ValueError(f"linear_int8: N={N} does not split into {chunks} chunks")
    lib = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.bvt_linear_int8_resources(_DTYPE_CODES[dtype], N, N // chunks, out)
    kernels.check(lib, err, "linear_int8 resources query")
    return {"body": "wgmma", "smem_bytes": out[0], "blocks_per_sm": out[1],
            "registers": out[2], "tma_store": bool(out[3])}


def linear_int8(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, chunks: int = 1
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """W8A8 linear: x [..., K] . w[N, K]^T + b [N] -> [..., N] in x's
    dtype (b=None: a zero bias, as the TPU kernel adds). With chunks > 1,
    a tuple of `chunks` contiguous [..., N / chunks] tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in `linear_int8.launches`) or raise."""
    shape = x.shape
    K = shape[-1]
    N = w.shape[0]
    if w.dim() != 2 or w.shape[1] != K:
        raise ValueError(f"linear_int8: w {tuple(w.shape)} does not fit K={K}")
    if chunks < 1 or N % chunks:
        raise ValueError(f"linear_int8: N={N} does not split into {chunks} chunks")
    if x.device.type == "cpu":
        out = linear_int8_reference(x, w, b)
        if chunks == 1:
            return out
        return tuple(t.contiguous() for t in out.chunk(chunks, dim=-1))
    if x.device.type != "cuda":
        raise ValueError(f"no linear_int8 kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"linear_int8 kernel takes float32 or bfloat16, not {x.dtype}")
    if K % 16:
        raise ValueError(f"linear_int8 kernel needs K a multiple of 16, got {K}")
    dev = x.device
    xm = x.reshape(-1, K).contiguous()
    M = xm.shape[0]
    wq, s = quantize_weight(w)
    bias = (torch.zeros(N, device=dev) if b is None
            else b.to(device=dev, dtype=torch.float32).contiguous())
    if wq.device != dev:
        raise ValueError("linear_int8: w and x must be on one device")
    xq = torch.empty(M, K, device=dev, dtype=torch.int8)
    xs = torch.empty(M, device=dev, dtype=torch.float32)
    width = N // chunks
    out = torch.empty(chunks, M, width, device=dev, dtype=x.dtype)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bvt_linear_int8(
            xm.data_ptr(), _DTYPE_CODES[x.dtype], M, K, N, wq.data_ptr(),
            s.data_ptr(), bias.data_ptr(), width, xq.data_ptr(),
            xs.data_ptr(), out.data_ptr(), stream)
    kernels.check(lib, err, "linear_int8 kernel")
    linear_int8.launches += 1
    if chunks == 1:
        return out.reshape(*shape[:-1], N)
    return tuple(t.reshape(*shape[:-1], width) for t in out.unbind(0))


linear_int8.launches = 0
