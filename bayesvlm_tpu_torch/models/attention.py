"""Fused non-causal multi-head attention and the whole pre-LN attention
sublayer: the CUDA kernels and their plain PyTorch versions.

`fused_attention` is the port of `bayesvlm_tpu.models.attention_pallas.
fused_attention` with its three schedules: one-block (`_mha_kernel`),
split-key (`_mha_split_kernel`) and packed-pair (`_mha_packed_kernel`).
On packed-head `q, k, v: [B, T, H*Dh]` each computes, per head, fp32
scores scaled AFTER the dot, an exact fp32 softmax, `p` rounded to the
input dtype, and `p @ v` accumulated in fp32 (csrc/attention.cuh says
how each schedule walks the keys and heads).

`fused_attention_block` is the port of `fused_attention_block`
(`_mha_block_kernel`): `x + out_proj(MHA(LN(x)))` with the LN in fp32
and each projection rounded once (csrc/attention_block.cu).

- CUDA tensors launch the hand-written kernels or raise; nothing falls
  back to the plain version on the card. bf16 runs all three schedules
  on the tensor-core body (`csrc/attention_mma.cuh`; the packed pair as
  one block of two heads side by side, equal to one-block bit for bit);
  fp32 the CUDA-core body (`csrc/attention.cuh`). `kernel_resources`
  reports what a launch takes. The sublayer's bf16 projections run the
  wgmma/TMA GEMM body (`csrc/wgmma_gemm.cuh`, bias and residual in its
  epilogue); `block_gemm_resources` reports what they take.
- CPU tensors run `fused_attention_reference` /
  `fused_attention_block_reference`, the same math in plain PyTorch. The
  tests and chip_smoke.py hold the kernels against them.

The kernels are compiled with nvcc for sm_90a on first use, from
`csrc/attention.cu` and `csrc/attention_block.cu`
(`bayesvlm_tpu_torch/kernels.py` builds and loads them).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bayesvlm_tpu_torch import kernels

# head dims the kernels are instantiated for (csrc/attention.cuh
# launch_head_dim)
KERNEL_HEAD_DIMS = (16, 64, 80)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/attention.cuh Schedule
ONE_BLOCK, SPLIT_KEY, PACKED_PAIR = 0, 1, 2
# split-key: the main block of keys is a multiple of this (the TPU's lane
# tile, kept so that the two packages split at the same key)
SPLIT_TILE = 128


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernels' math, for all three
    schedules (they compute one function with the same rounding points;
    the split-key remainder's -inf filler and the packed pair's segment
    mask contribute exp() = 0 on the TPU). fp32 scores (inputs widened,
    so bf16 products are exact) times the scale, fp32 softmax written as
    exp(s - max) / sum, p rounded to the input dtype, p @ v accumulated
    in fp32 and rounded to the input dtype. Materialises the
    [B, H, T, T] scores. Differentiable; float64 inputs are computed in
    float64 (the backward's gradcheck)."""
    B, T, D = q.shape
    Dh = D // num_heads
    acc = torch.promote_types(q.dtype, torch.float32)

    def heads(x):
        return x.reshape(B, T, num_heads, Dh).transpose(1, 2).to(acc)

    s = heads(q) @ heads(k).transpose(-1, -2) * (1.0 / math.sqrt(Dh))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    o = p.to(acc) @ heads(v)
    return o.transpose(1, 2).reshape(B, T, D).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("attention")
    lib.bvt_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bvt_attention.restype = ctypes.c_int
    i, ip = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.bvt_attention_smem_bytes.argtypes = [i, i, i, i]
    lib.bvt_attention_smem_bytes.restype = ctypes.c_long
    lib.bvt_attention_smem_limit.argtypes = []
    lib.bvt_attention_smem_limit.restype = i
    lib.bvt_attention_uses_mma.argtypes = [i, i]
    lib.bvt_attention_uses_mma.restype = i
    lib.bvt_attention_occupancy.argtypes = [i, i, i, i, ip, ip]
    lib.bvt_attention_occupancy.restype = i
    return lib


def _check_kernel_operands(tensors, dtype, head_dim: int, what: str) -> None:
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{what} takes float32 or bfloat16, not {dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} has no head dim {head_dim} "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous operands")


@functools.lru_cache(maxsize=256)
def _tensor_core_body(device_index: int, T: int, head_dim: int, dtype,
                      schedule: int) -> bool:
    """Whether (dtype, schedule) launches the tensor-core body. Raises when
    the body it launches cannot take T on the card: the CUDA-core body
    keeps all T scores in shared memory, the tensor-core body a fixed
    amount whatever T. Cached, so that a launch at a shape seen before
    makes no query."""
    lib, code = _library(), _DTYPE_CODES[dtype]
    with torch.cuda.device(device_index):
        budget = lib.bvt_attention_smem_limit()
    smem = lib.bvt_attention_smem_bytes(T, head_dim, code, schedule)
    if smem > budget:
        raise ValueError(f"T={T} needs {smem} bytes of shared memory for "
                         f"its scores; the card allows {budget} per block")
    return lib.bvt_attention_uses_mma(code, schedule) == 1


def kernel_resources(T: int, head_dim: int, dtype, schedule: int = ONE_BLOCK,
                     device=None) -> dict:
    """What a launch of the attention kernel at (T, head_dim, dtype,
    schedule) takes on the card: its body ("mma": the tensor-core body of
    csrc/attention_mma.cuh, "simt": the CUDA-core body of attention.cuh),
    dynamic shared memory a block, registers a thread and blocks an SM
    (the occupancy calculator)."""
    lib, code = _library(), _DTYPE_CODES[dtype]
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = lib.bvt_attention_occupancy(T, head_dim, code, schedule,
                                          ctypes.byref(regs), ctypes.byref(blocks))
    kernels.check(lib, err, "attention occupancy query")
    return {"body": "mma" if lib.bvt_attention_uses_mma(code, schedule) == 1 else "simt",
            "smem_bytes": lib.bvt_attention_smem_bytes(T, head_dim, code, schedule),
            "registers": regs.value, "blocks_per_sm": blocks.value}


def schedule_for(T: int, split_key: bool = False, packed_heads: bool = False) -> int:
    """The schedule `fused_attention` launches for T keys: split-key only
    when T has a remainder past a nonzero multiple of 128, as in JAX."""
    t_main = T // SPLIT_TILE * SPLIT_TILE
    if packed_heads:
        return PACKED_PAIR
    return SPLIT_KEY if split_key and 0 < t_main < T else ONE_BLOCK


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
            schedule: int) -> torch.Tensor:
    """One launch of the kernel at `schedule` on CUDA q, k, v (checked by
    `fused_attention`), counted in its schedule's count."""
    B, T, D = q.shape
    Dh = D // num_heads
    count = {ONE_BLOCK: "launches", SPLIT_KEY: "launches_split",
             PACKED_PAIR: "launches_packed"}[schedule]
    # the tensor-core body copies rows in 16-byte pieces (cp.async); o is a
    # fresh allocation
    if (_tensor_core_body(q.device.index, T, Dh, q.dtype, schedule)
            and any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("attention kernel needs 16-byte aligned operands")
    lib = _library()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bvt_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), B, T, num_heads, Dh,
                                _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(Dh),
                                schedule, stream)
    kernels.check(lib, err, "attention kernel")
    setattr(fused_attention, count, getattr(fused_attention, count) + 1)
    return o


class _AttentionWithGrad(torch.autograd.Function):
    """The kernel's forward with a gradient: the forward is one launch of
    the kernel (the same launch and count as without a gradient) and saves
    q, k, v; the backward recomputes the plain version on them with
    autograd and returns its gradients. The JAX package has no backward
    kernel either (its towers are differentiated through the einsum
    path)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, schedule: int):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return _launch(q, k, v, num_heads, schedule)

    @staticmethod
    def backward(ctx, grad_o):
        saved = ctx.saved_tensors
        needed = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(n) for t, n in zip(saved, needed))
            o = fused_attention_reference(q, k, v, ctx.num_heads)
            inputs = [t for t, n in zip((q, k, v), needed) if n]
            grads = iter(torch.autograd.grad(o, inputs, grad_o))
        return (*(next(grads) if n else None for n in needed), None, None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, split_key: bool = False,
                    packed_heads: bool = False) -> torch.Tensor:
    """Non-causal self-attention on packed heads [B, T, H*Dh] -> same.

    `packed_heads` (even head counts only) takes the packed-pair
    schedule; else `split_key` takes the split-key schedule when T has a
    remainder past a multiple of 128 (otherwise the one-block schedule,
    as in JAX). CPU tensors take the plain version; CUDA tensors launch
    the kernel, counting the launch in `fused_attention.launches` (one
    block), `.launches_split` or `.launches_packed`, or raise. In bf16
    every schedule runs on the tensor cores and needs 16-byte aligned
    operands.

    Where autograd records the call (grad mode on, q, k or v requiring
    grad), the launch goes through `_AttentionWithGrad`, whose backward
    is the plain version's; elsewhere (`no_grad`, `inference_mode`, the
    serving programs' capture) it is the bare launch."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        # the kernels tile q, k and v from q's length: cross-attention with
        # Tq != Tk (the SigLIP probe) takes the caller's plain path
        raise ValueError(f"q, k, v must share one [B, T, D] shape (self-attention, "
                         f"Tq == Tk), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, D = q.shape
    if D % num_heads:
        raise ValueError(f"hidden size {D} is not a multiple of {num_heads} heads")
    if packed_heads and num_heads % 2:
        raise ValueError("packed_heads requires an even head count")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")

    Dh = D // num_heads
    _check_kernel_operands((q, k, v), q.dtype, Dh, "attention kernel")
    if B > 65535 or num_heads > 65535:
        raise ValueError("attention kernel grid takes at most 65535 batch rows "
                         "and heads")
    schedule = schedule_for(T, split_key, packed_heads)
    if kernels.records_grad(q, k, v):
        return _AttentionWithGrad.apply(q, k, v, num_heads, schedule)
    return _launch(q, k, v, num_heads, schedule)


fused_attention.launches = 0
fused_attention.launches_split = 0
fused_attention.launches_packed = 0


# -- the whole sublayer ------------------------------------------------------


def _layer_norm_fp32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """`_mha_block_kernel`'s LayerNorm: fp32, two-pass, rounded once."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x . w^T accumulated in fp32 (bf16 products are exact in fp32), plus
    the bias in fp32, rounded once to x's dtype."""
    return (x.float() @ w.float().T + b.float()).to(x.dtype)


def fused_attention_block_reference(x, ln_weight, ln_bias, wq, bq, wk, bk, wv,
                                    bv, wo, bo, num_heads: int,
                                    ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the sublayer kernel, op for op
    (attention_pallas.py:241-287): fp32 two-pass LN rounded once; q, k, v
    each accumulated in fp32 with the bias added in fp32 and rounded
    once; the attention core; the out-projection the same way; then
    x + out in the compute dtype (two values, summed, rounded once)."""
    h = _layer_norm_fp32(x, ln_weight, ln_bias, ln_eps)
    q, k, v = _proj(h, wq, bq), _proj(h, wk, bk), _proj(h, wv, bv)
    a = fused_attention_reference(q, k, v, num_heads)
    return x + _proj(a, wo, bo)


@functools.cache
def _block_library() -> ctypes.CDLL:
    lib = kernels.load("attention_block")
    lib.bvt_attention_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
        *[ctypes.c_void_p] * 8,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, *[ctypes.c_void_p] * 5,
    ]
    lib.bvt_attention_block.restype = ctypes.c_int
    lib.bvt_attention_block_gemm.argtypes = [
        *[ctypes.c_void_p] * 7, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        *[ctypes.c_int] * 4, ctypes.c_void_p]
    lib.bvt_attention_block_gemm.restype = ctypes.c_int
    lib.bvt_attention_block_gemm_resources.argtypes = [ctypes.c_int,
                                                       ctypes.POINTER(ctypes.c_int)]
    lib.bvt_attention_block_gemm_resources.restype = ctypes.c_int
    return lib


def _block_projection(a, ws, bs, residual, out) -> None:
    """One projection of the sublayer alone, on CUDA tensors, through its C
    entry (the tests and chip_smoke.py time and check it; the sublayer
    itself launches it from `bvt_attention_block`): out[p] = a . ws[p]^T +
    bs[p] for each of the 1-3 parts, each rounded once, or with the
    residual [M, N] (one part) residual + that. a [M, K]; ws[p] [N, K],
    bs[p] [N]; out [parts, M, N]; one dtype, contiguous."""
    lib = _block_library()
    (M, K), N, parts = a.shape, ws[0].shape[0], len(ws)
    w3, b3 = [*ws, *ws[:1] * (3 - parts)], [*bs, *bs[:1] * (3 - parts)]
    err = lib.bvt_attention_block_gemm(
        a.data_ptr(), *(t.data_ptr() for t in w3), *(t.data_ptr() for t in b3), parts,
        None if residual is None else residual.data_ptr(), out.data_ptr(), M, N, K,
        _DTYPE_CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    kernels.check(lib, err, "attention block GEMM")


def block_gemm_resources(device=None) -> dict:
    """The bf16 sublayer's two GEMM instantiations on the wgmma body
    (csrc/bf16_gemm.cuh): "qkv" (bias) and "out_proj" (bias and residual),
    each {"smem_bytes", "blocks_per_sm", "registers" (a thread at launch),
    "local_bytes" (spills, a thread), "producer_registers",
    "consumer_registers" (after setmaxnreg)}."""
    lib = _block_library()
    keys = ("smem_bytes", "blocks_per_sm", "registers", "local_bytes",
            "producer_registers", "consumer_registers")
    out = {}
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        for name, residual in (("qkv", 0), ("out_proj", 1)):
            vals = (ctypes.c_int * len(keys))()
            kernels.check(lib, lib.bvt_attention_block_gemm_resources(residual, vals),
                          "attention block GEMM resource query")
            out[name] = dict(zip(keys, vals))
    return out


def fused_attention_block(x: torch.Tensor, ln_weight, ln_bias, wq, bq, wk, bk,
                          wv, bv, wo, bo, num_heads: int,
                          ln_eps: float = 1e-5) -> torch.Tensor:
    """Non-causal pre-LN attention sublayer with the residual:
    x [B, T, D] (pre-LN, compute dtype) -> x + out_proj(MHA(LN(x))).

    Weights [D, D] in torch's [out, in] layout (the product is x @ W.T)
    and biases [D] in x's dtype; LN parameters [D] (used in fp32). CPU
    tensors take the plain version; CUDA tensors launch the kernel chain
    of csrc/attention_block.cu (counted once per call in
    `fused_attention_block.launches`) or raise: x and the weights must
    start 16-byte aligned (the bf16 GEMMs read the weights by the TMA).
    The chain has no backward (nor in JAX): where autograd would record
    it on the card, it raises."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    B, T, D = x.shape
    weights, biases = (wq, wk, wv, wo), (bq, bk, bv, bo)
    if any(tuple(w.shape) != (D, D) for w in weights):
        raise ValueError(f"projection weights must be [{D}, {D}]")
    if any(tuple(t.shape) != (D,) for t in (*biases, ln_weight, ln_bias)):
        raise ValueError(f"biases and LN parameters must be [{D}]")
    if D % num_heads:
        raise ValueError(f"hidden size {D} is not a multiple of {num_heads} heads")
    if any(t.device != x.device for t in (*weights, *biases, ln_weight, ln_bias)):
        raise ValueError("x and the sublayer's parameters must be on one device")
    if x.device.type == "cpu":
        return fused_attention_block_reference(x, ln_weight, ln_bias, wq, bq, wk,
                                               bk, wv, bv, wo, bo, num_heads,
                                               ln_eps)

    Dh = D // num_heads
    params = (*weights, *biases)
    _check_kernel_operands((x, *params), x.dtype, Dh, "attention block kernel")
    if any(t.dtype != x.dtype for t in params):
        raise ValueError("projection weights and biases must be in x's dtype")
    # the TMA's rules: rows a multiple of 16 bytes apart, 16-byte aligned
    # bases (the weights; x is the out-projection's residual, read in pairs)
    if D % 8:
        raise ValueError(f"attention block kernel needs D a multiple of 8, not {D}")
    for name, t in (("x", x), ("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        if t.data_ptr() % 16:
            raise ValueError(f"attention block kernel: {name}'s base address "
                             f"{t.data_ptr():#x} is not 16-byte aligned")
    if B > 65535:
        raise ValueError("attention block kernel takes at most 65535 batch rows")
    if x.device.type != "cuda":
        raise ValueError(f"no attention block kernel for device {x.device}")
    kernels.refuse_grad("fused_attention_block", x, ln_weight, ln_bias, *params)
    _tensor_core_body(x.device.index, T, Dh, x.dtype, ONE_BLOCK)  # the core takes T
    ln_w, ln_b = ln_weight.float().contiguous(), ln_bias.float().contiguous()
    M = B * T
    h = torch.empty(M, D, device=x.device, dtype=x.dtype)
    qkv = torch.empty(3, M, D, device=x.device, dtype=x.dtype)
    attn = torch.empty(M, D, device=x.device, dtype=x.dtype)
    out = torch.empty_like(x)
    lib = _block_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bvt_attention_block(
            x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), ln_eps,
            *(t.data_ptr() for t in (wq, bq, wk, bk, wv, bv, wo, bo)),
            B, T, D, num_heads, _DTYPE_CODES[x.dtype], 1.0 / math.sqrt(Dh),
            h.data_ptr(), qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), stream)
    kernels.check(lib, err, "attention block kernel")
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0
