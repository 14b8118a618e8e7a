"""The attention-schedule probes' kernels (csrc/attention_variants.cu) and
their plain PyTorch versions.

Each kernel changes one thing of the one-block attention kernel (#1,
`models.attention.fused_attention`) on packed-head `q, k, v: [B, T,
H*Dh]`, fp32 or bf16, head dims 16, 64 and 80:

- `attention_v2` ports `_kernel_v2` (scripts/dev/bench_attn_variants.py):
  the scale folded into q (rounded to the input dtype), the softmax left
  unnormalised (`p = round(e)`), and the p . v output divided by the
  fp32 row sums of the unrounded e. `subtract_max=False` is the script's
  v3, which also drops the max (an unsafe-numerics cost probe: keep the
  scores small, as the probe's N(0, 1) inputs do). In bf16 both run
  #1's tensor-core body with that function (v2 two sweeps over the keys,
  the first for the max alone; v3 one sweep), in fp32 a CUDA-core body
  with #1's score tile.
- `attention_v4` ports `_kernel_v4` (bench_attn_variants2.py): the
  scaled scores rounded to bf16 (whatever the input dtype), then #1's
  fp32 softmax from them. It runs #1's own bodies with that rounding
  added: in bf16 the tensor-core body (no score tile, any T), in fp32
  the CUDA-core body (an fp32 tile of the rounded scores).
- `attention_group_heads` ports `_kernel_v5` (bench_attn_variants2.py):
  H / GROUPS heads a block; `attention_group_rows` ports `_kernel_v6`
  (bench_attn_variants3.py): ROWS batch rows a block. Both compute #1's
  function, so their plain version is `fused_attention_reference`. In
  bf16 they run #1's tensor-core body, a block walking its (head, batch
  row) groups in turn, and equal bf16 #1 bit for bit; in fp32 a
  CUDA-core group kernel equal to fp32 #1 bit for bit (`block_resources`
  reports the body a launch takes).

Every bf16 kernel runs the tensor-core body, which keeps no score tile
(any T; 16-byte aligned operands). Every fp32 kernel runs a CUDA-core
body: those keep all T scores of a block in shared memory, and a T past
the card's shared memory raises. CUDA tensors launch the kernel or
raise; CPU tensors run the plain version; nothing falls back. Each
launch is counted on its wrapper (`.launches`; v3 in
`attention_v2.launches_v3`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.models.attention import (
    _DTYPE_CODES,
    _check_kernel_operands,
    fused_attention_reference,
)

# csrc/attention_variants.cu Variant
V2, V3, V4, GROUP = 0, 1, 2, 3
# v5: the heads split into GROUPS blocks (bench_attn_variants2.py GROUPS)
GROUPS = 2
# v6: batch rows a block (bench_attn_variants3.py ROWS)
ROWS = 2
# heads a block the group kernel is built for (v5 takes H / GROUPS)
GROUP_HEADS = (1, 2, 4, 6, 8)
# kernels whose scores round to bf16 whatever the input dtype: an fp32
# sum taken in another order can flip one score's rounding, so their max
# |d| is held to the bf16 tolerance in fp32 too
BF16_SCORES = ("attention_v4",)
# mean |kernel - plain| limits, which pin the rounding the max cannot: a
# flipped rounding is sparse (one value in thousands, moving one (row,
# head) output vector), while leaving the rounding out moves every
# output, by a mean |d| some thousand times that of the flips. The limit
# lies between (tests/test_torch_attn_variants.py shows that #1's
# function fails v4's, and v2 without its rounding of q * scale, which
# is exact at Dh = 16 and 64 and not at Dh = 80, fails v2's;
# chip_smoke.py prints the means on the card).
MEAN_TOL = {"attention_v2": 1e-5, "attention_v3": 1e-5, "attention_v4": 1e-5}


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    B, H, T, Dh = o.shape
    return o.transpose(1, 2).reshape(B, T, H * Dh)


def attention_v2_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int, subtract_max: bool = True) -> torch.Tensor:
    """`_kernel_v2` in plain PyTorch: qs = round(fp32(q) * scale); fp32
    scores qs . k with no scale after the dot; e = exp(s - max) (or
    exp(s)); the row sums of the unrounded e; p = round(e); o =
    round(fp32(p . v) / sums)."""
    Dh = q.shape[-1] // num_heads
    qs = (q.float() * (1.0 / math.sqrt(Dh))).to(q.dtype)
    s = _heads(qs, num_heads).float() @ _heads(k, num_heads).float().transpose(-1, -2)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True) if subtract_max else s)
    denom = e.sum(dim=-1, keepdim=True)
    o = e.to(q.dtype).float() @ _heads(v, num_heads).float()
    return _merge(o / denom).to(q.dtype)


def attention_v4_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """`_kernel_v4` in plain PyTorch: s = round_bf16(fp32(q . k) * scale),
    p = round(exp(s - max) / sum) in fp32, o = round(fp32 p . v)."""
    Dh = q.shape[-1] // num_heads
    s = _heads(q, num_heads).float() @ _heads(k, num_heads).float().transpose(-1, -2)
    s = (s * (1.0 / math.sqrt(Dh))).to(torch.bfloat16).float()
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    return _merge(p.float() @ _heads(v, num_heads).float()).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("attention_variants")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_attn_variant.argtypes = [p, p, p, p, i, i, i, i, i, ctypes.c_float,
                                     i, i, i, p]
    lib.bvt_attn_variant.restype = ctypes.c_int
    lib.bvt_attn_variant_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.bvt_attn_variant_smem_bytes.restype = ctypes.c_long
    lib.bvt_attn_variant_uses_mma.argtypes = [i, i, i, i, i]
    lib.bvt_attn_variant_uses_mma.restype = i
    ip = ctypes.POINTER(i)
    lib.bvt_attn_variant_occupancy.argtypes = [i, i, i, i, i, i, ip, ip]
    lib.bvt_attn_variant_occupancy.restype = i
    lib.bvt_attn_variant_smem_limit.argtypes = []
    lib.bvt_attn_variant_smem_limit.restype = ctypes.c_int
    return lib


# each probe kernel's variant in csrc/attention_variants.cu
VARIANTS = {"attention_v2": V2, "attention_v3": V3, "attention_v4": V4,
            "attention_group_heads": GROUP, "attention_group_rows": GROUP}


def _block_shape(name: str, num_heads: int, batch: int):
    """(heads, batch rows) one block of the kernel `name` holds; raises on
    a shape the kernel cannot take (the TPU grids `B // ROWS` and
    `H // GROUPS` would leave the rest unwritten)."""
    if name == "attention_group_rows":
        if batch % ROWS:
            raise ValueError(f"attention_group_rows takes an even batch ({ROWS} rows "
                             f"a block), not {batch}")
        return 1, ROWS
    if name == "attention_group_heads":
        if num_heads % GROUPS:
            raise ValueError(f"attention_group_heads takes an even head count "
                             f"({GROUPS} groups), not {num_heads}")
        nh = num_heads // GROUPS
        if nh not in GROUP_HEADS:
            raise ValueError(f"attention_group_heads has no block of {nh} heads "
                             f"(built for {GROUP_HEADS})")
        return nh, 1
    return 1, 1


def _run(name: str, q, k, v, num_heads: int, plain):
    """Validate, then the plain version on the CPU or the kernel `name` on
    the card; returns (out, launched)."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, T, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, D = q.shape
    if D % num_heads:
        raise ValueError(f"hidden size {D} is not a multiple of {num_heads} heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: q, k, v must share one dtype")
    nh, nr = _block_shape(name, num_heads, B)
    if q.device.type == "cpu":
        return plain(q, k, v, num_heads), False
    if q.device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {q.device}")
    Dh = D // num_heads
    _check_kernel_operands((q, k, v), q.dtype, Dh, f"{name} kernel")
    if num_heads // nh > 65535 or B // nr > 65535:
        raise ValueError(f"{name}: the grid takes at most 65535 head blocks and "
                         f"batch blocks")
    lib = _library()
    args = (VARIANTS[name], T, Dh, _DTYPE_CODES[q.dtype], nh, nr)
    if lib.bvt_attn_variant_uses_mma(args[0], Dh, args[3], nh, nr) == 1:
        # the tensor-core body copies rows in 16-byte pieces (cp.async); o
        # is a fresh allocation
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError(f"{name} kernel needs 16-byte aligned operands")
    else:
        # a CUDA-core body keeps the block's T scores in shared memory
        smem = lib.bvt_attn_variant_smem_bytes(*args)
        with torch.cuda.device(q.device):
            budget = lib.bvt_attn_variant_smem_limit()
        if smem > budget:
            raise ValueError(f"{name}: T={T} needs {smem} bytes of shared memory "
                             f"for its scores; the card allows {budget} per block")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.bvt_attn_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o.data_ptr(), B, T, num_heads, Dh, args[3],
                                   1.0 / math.sqrt(Dh), args[0], nh, nr, stream)
    kernels.check(lib, err, f"{name} kernel")
    return o, True


def attention_v2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int, subtract_max: bool = True) -> torch.Tensor:
    """`_kernel_v2` (v3 with `subtract_max=False`) on packed heads [B, T,
    H*Dh] -> same. Counts in `attention_v2.launches` (v3:
    `.launches_v3`)."""
    o, launched = _run("attention_v2" if subtract_max else "attention_v3", q, k, v,
                       num_heads, functools.partial(attention_v2_reference,
                                                    subtract_max=subtract_max))
    if launched and subtract_max:
        attention_v2.launches += 1
    elif launched:
        attention_v2.launches_v3 += 1
    return o


def attention_v4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """`_kernel_v4`: bf16 scores, fp32 softmax. Counts in
    `attention_v4.launches`."""
    o, launched = _run("attention_v4", q, k, v, num_heads, attention_v4_reference)
    attention_v4.launches += launched
    return o


def attention_group_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int) -> torch.Tensor:
    """`_kernel_v5`: #1's function with H / GROUPS heads a block (H even,
    H / 2 in GROUP_HEADS). Counts in `attention_group_heads.launches`."""
    o, launched = _run("attention_group_heads", q, k, v, num_heads,
                       fused_attention_reference)
    attention_group_heads.launches += launched
    return o


def attention_group_rows(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int) -> torch.Tensor:
    """`_kernel_v6`: #1's function with ROWS batch rows a block (B even).
    Counts in `attention_group_rows.launches`."""
    o, launched = _run("attention_group_rows", q, k, v, num_heads,
                       fused_attention_reference)
    attention_group_rows.launches += launched
    return o


attention_v2.launches = 0
attention_v2.launches_v3 = 0
attention_v4.launches = 0
attention_group_heads.launches = 0
attention_group_rows.launches = 0

# each probe kernel's wrapper and its plain version
KERNELS = {
    "attention_v2": (attention_v2, attention_v2_reference),
    "attention_v3": (functools.partial(attention_v2, subtract_max=False),
                     functools.partial(attention_v2_reference, subtract_max=False)),
    "attention_v4": (attention_v4, attention_v4_reference),
    "attention_group_heads": (attention_group_heads, fused_attention_reference),
    "attention_group_rows": (attention_group_rows, fused_attention_reference),
}


def block_resources(name: str, batch: int, seq: int, num_heads: int,
                    head_dim: int, dtype: torch.dtype) -> dict:
    """What a launch of the kernel `name` (a key of KERNELS) at this shape
    takes on the card: its body ("mma" or "simt", as the kernel library
    reports it), dynamic shared memory a block, registers a thread and
    blocks an SM (the occupancy calculator)."""
    nh, nr = _block_shape(name, num_heads, batch)
    lib = _library()
    args = (VARIANTS[name], seq, head_dim, _DTYPE_CODES[dtype], nh, nr)
    regs, blocks = ctypes.c_int(), ctypes.c_int()
    err = lib.bvt_attn_variant_occupancy(*args, ctypes.byref(regs), ctypes.byref(blocks))
    kernels.check(lib, err, f"{name} occupancy query")
    mma = lib.bvt_attn_variant_uses_mma(args[0], head_dim, args[3], nh, nr)
    return {"body": "mma" if mma == 1 else "simt",
            "smem_bytes": lib.bvt_attn_variant_smem_bytes(*args),
            "registers": regs.value, "blocks_per_sm": blocks.value}
