"""W8A8 int8 MLP sublayer: the CUDA kernel and its plain PyTorch version.

`mlp_int8` is the port of `bayesvlm_tpu.models.mlp_int8.mlp_int8`
(`_mlp_int8_kernel`): per-row absmax int8 activations, per-output-channel
absmax int8 weights, exact int32 products, fp32 dequant + bias +
tanh-GELU (or quick-GELU), a per-row requantize, the second product, and
with the fused variant the fp32 LayerNorm before and the fp32 residual
after (`x + fc2(act(fc1(LN(x))))`). The rounding points are the JAX
package's (csrc/int8_gemm.cuh lists them).

- CUDA tensors launch the hand-written kernel (csrc/mlp_int8.cu: both
  int8 products on the wgmma body of csrc/wgmma_gemm.cuh, the dequant,
  bias and residual in its epilogue; the activation and requantize in one
  row pass between them) or raise; nothing falls back to the plain
  version on the card.
  `kernel_resources` reads the GEMMs' shared memory, blocks an SM and
  registers.
- CPU tensors run `mlp_int8_reference`, the same math in plain PyTorch.

Weights keep torch's `nn.Linear` layout: w1 [F, D], w2 [D, F], so the
per-output-channel absmax runs over dim 1 (the JAX package's [in, out]
kernels take it over axis 0), and [N, K] with K contiguous is what the
kernel's tensor-core B operand wants.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from bayesvlm_tpu_torch import kernels

EPS = 1e-12
ACTIVATIONS = {"gelu_tanh": 1, "quick_gelu": 2}  # csrc/int8_gemm.cuh Activation
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_QMAX = {8: 127.0, 4: 7.0}
# The int8 lane's tolerance against its plain version, the JAX package's
# flip tolerance (tests/test_mlp_int8.py): an ulp of difference before a
# rounding (the LayerNorm's summation order, tanhf, rsqrt) can flip one
# int8 step of one element; flips are sparse, a systematic fault moves
# every element. max |d| <= FLIP_TOL_MAX max|ref|, mean |d| <=
# FLIP_TOL_MEAN max|ref|.
FLIP_TOL_MAX, FLIP_TOL_MEAN = 0.02, 0.002


def quantize_weight(w: torch.Tensor, bits: int = 8):
    """Per-output-channel symmetric absmax quantization: w [N, K] ->
    (int8 [N, K], fp32 scale [N]) with w ~= wq * scale[:, None]. bits=8
    is the W8A8 lane (+-127); bits=4 (+-7, held in int8) the W4A8 lane.
    Both divisions are true elementwise divisions, as in the JAX package
    (PyTorch on the card turns a division by a Python scalar into a
    multiplication by its reciprocal, which rounds differently)."""
    if bits not in _QMAX:
        raise ValueError(f"quantize_weight: bits must be 8 or 4, got {bits}")
    w = w.float()
    amax = w.abs().amax(dim=1).clamp_min(EPS)
    s = amax / torch.full_like(amax, _QMAX[bits])
    wq = torch.round(w / s[:, None]).to(torch.int8)  # |w/s| <= qmax
    return wq, s


def _quant_rows(x: torch.Tensor):
    """Per-row symmetric absmax int8: fp32 [M, K] -> (int8 [M, K], fp32
    row scale [M, 1]); 127 / r is rounded before the product, as in the
    JAX package."""
    r = x.abs().amax(dim=1, keepdim=True).clamp_min(EPS)
    scale = r * (1.0 / 127.0)
    q = torch.round(x * torch.div(torch.full_like(r, 127.0), r)).to(torch.int8)
    return q, scale


def _ln_rows(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, two-pass variance. Zero rows
    are safe: mean = var = 0 -> the output is `bias`."""
    mu = x.mean(dim=1, keepdim=True)
    var = (x - mu).square().mean(dim=1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def _int_product(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """q [M, K] int8 . wq [N, K]^T, rounded to fp32 as the int32 sum
    would be: float64 holds every product and sum exactly (|sum| <
    K * 127^2 < 2^53), and works on the CPU and the card alike."""
    return (q.double() @ wq.double().T).float()


def _tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    c = 0.7978845608028654  # sqrt(2 / pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


_ACT_FNS = {"gelu_tanh": _tanh_gelu, "quick_gelu": _quick_gelu}


def _act_name(name: str) -> str:
    # the JAX package swaps erf-GELU for tanh-GELU inside this kernel,
    # for fp32 towers too (mlp_int8.py:172-173)
    name = "gelu_tanh" if name == "gelu" else name
    if name not in ACTIVATIONS:
        raise ValueError(f"mlp_int8: unsupported activation {name!r}")
    return name


def quantize_mlp_weights(w1: torch.Tensor, w2: torch.Tensor,
                         weight_bits: int = 8) -> dict:
    """The quantized weight cache of one MLP sublayer; pass it as
    `mlp_int8(..., quant=...)` to skip the per-call weight quantization."""
    w1q, s1 = quantize_weight(w1, weight_bits)
    w2q, s2 = quantize_weight(w2, weight_bits)
    return {"w1q": w1q, "s1": s1, "w2q": w2q, "s2": s2}


def mlp_int8_reference(x, w1, b1, w2, b2, act_name="gelu_tanh", quant=None,
                       ln_weight=None, ln_bias=None, ln_eps=None,
                       weight_bits=8) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math (the JAX package's
    `mlp_int8_reference`): same quantization, same fp32 dequant chain,
    same fused-LN/residual variant."""
    act = _ACT_FNS[_act_name(act_name)]
    if quant is None:
        quant = quantize_mlp_weights(w1, w2, weight_bits)
    shape = x.shape
    xm = x.reshape(-1, shape[-1]).float()
    if ln_eps is not None:
        xq, xs = _quant_rows(_ln_rows(xm, ln_weight.float(), ln_bias.float(),
                                      ln_eps))
    else:
        xq, xs = _quant_rows(xm)
    h = _int_product(xq, quant["w1q"]) * xs * quant["s1"] + b1.float()
    aq, as_ = _quant_rows(act(h))
    o = _int_product(aq, quant["w2q"]) * as_ * quant["s2"] + b2.float()
    if ln_eps is not None:
        o = o + xm
    return o.to(x.dtype).reshape(shape)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("mlp_int8")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bvt_mlp_int8.argtypes = [p, i, i, i, i, p, p, f, p, p, p, p, p, p, i,
                                 p, p, p, p, p, p, p]
    lib.bvt_mlp_int8.restype = ctypes.c_int
    lib.bvt_mlp_int8_resources.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.bvt_mlp_int8_resources.restype = ctypes.c_int
    return lib


def kernel_resources(dtype=torch.bfloat16, device=None) -> dict:
    """What the kernel's two GEMMs take on the card (csrc/wgmma_gemm.cuh,
    ping-pong 128 x 128 tiles, 5 stages): dynamic shared memory a block,
    blocks an SM (the occupancy calculator) and registers a thread at
    launch, GEMM1's (fp32 out) and GEMM2's (x's dtype out, the larger of
    its plain and fused variants); the warpgroups then move to 40 / 232
    with setmaxnreg."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"mlp_int8 kernel takes float32 or bfloat16, not {dtype}")
    lib = _library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.bvt_mlp_int8_resources(_DTYPE_CODES[dtype], out)
    kernels.check(lib, err, "mlp_int8 resources query")
    return {"body": "wgmma", "smem_bytes": out[0], "blocks_per_sm": out[1],
            "registers": max(out[2], out[3]), "registers_gemm": [out[2], out[3]]}


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def mlp_int8(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, act_name: str = "gelu_tanh",
             quant: Optional[dict] = None,
             ln_weight: Optional[torch.Tensor] = None,
             ln_bias: Optional[torch.Tensor] = None,
             ln_eps: Optional[float] = None,
             weight_bits: int = 8) -> torch.Tensor:
    """W8A8 MLP sublayer: x [..., D] -> fc2(act(fc1(x))) [..., D], or with
    ln_weight/ln_bias/ln_eps the whole pre-LN sublayer
    x + fc2(act(fc1(LN(x)))). w1 [F, D], b1 [F], w2 [D, F], b2 [D]
    (quantized here, or taken from `quant`, see quantize_mlp_weights);
    the output has x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in `mlp_int8.launches`) or raise. The kernel
    has no backward (nor in JAX): where autograd would record it on the
    card, it raises."""
    act_name = _act_name(act_name)
    if (ln_weight is None) != (ln_eps is None) or (ln_bias is None) != (ln_eps is None):
        raise ValueError("mlp_int8: pass ln_weight, ln_bias and ln_eps together")
    if x.device.type == "cpu":
        return mlp_int8_reference(x, w1, b1, w2, b2, act_name, quant,
                                  ln_weight, ln_bias, ln_eps, weight_bits)
    if x.device.type != "cuda":
        raise ValueError(f"no mlp_int8 kernel for device {x.device}")
    kernels.refuse_grad("mlp_int8", x, w1, b1, w2, b2, ln_weight, ln_bias)
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"mlp_int8 kernel takes float32 or bfloat16, not {x.dtype}")
    shape = x.shape
    D = shape[-1]
    F = w1.shape[0]
    if tuple(w1.shape) != (F, D) or tuple(w2.shape) != (D, F):
        raise ValueError(f"mlp_int8: w1 {tuple(w1.shape)} and w2 "
                         f"{tuple(w2.shape)} do not fit D={D}")
    if D % 16 or F % 16:
        raise ValueError(f"mlp_int8 kernel needs D and F multiples of 16, "
                         f"got D={D}, F={F}")
    if quant is None:
        quant = quantize_mlp_weights(w1, w2, weight_bits)
    xm = x.reshape(-1, D).contiguous()
    M = xm.shape[0]
    dev = x.device
    f32 = dict(device=dev, dtype=torch.float32)
    i8 = dict(device=dev, dtype=torch.int8)
    ln_w = ln_b = None
    if ln_eps is not None:
        ln_w = ln_weight.to(**f32).contiguous()
        ln_b = ln_bias.to(**f32).contiguous()
    consts = [quant["w1q"], quant["s1"], b1.to(**f32), quant["w2q"],
              quant["s2"], b2.to(**f32)]
    consts = [c.contiguous() for c in consts]
    if any(c.device != dev for c in consts):
        raise ValueError("mlp_int8: weights and x must be on one device")
    scratch = [torch.empty(M, D, **i8), torch.empty(M, **f32),
               torch.empty(M, F, **f32), torch.empty(M, F, **i8),
               torch.empty(M, **f32)]
    out = torch.empty_like(xm)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bvt_mlp_int8(
            xm.data_ptr(), _DTYPE_CODES[x.dtype], M, D, F, _ptr(ln_w),
            _ptr(ln_b), 0.0 if ln_eps is None else float(ln_eps),
            *(c.data_ptr() for c in consts), ACTIVATIONS[act_name],
            *(s.data_ptr() for s in scratch), out.data_ptr(), stream)
    kernels.check(lib, err, "mlp_int8 kernel")
    mlp_int8.launches += 1
    return out.reshape(shape)


mlp_int8.launches = 0
