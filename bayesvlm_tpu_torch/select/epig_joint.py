"""Fused EPIG joint-entropy row sums: the CUDA kernel and its plain
PyTorch version.

`joint_xlogy_rowsums` is the port of `bayesvlm_tpu.select.epig_pallas.
joint_xlogy_rowsums` (`_xlogy_rowsum_kernel`, and `_xlogy_rowsum_kernel_
int8` with `use_int8=True`):

    r[m] = sum_n xlogy((pool_flat @ targ_flat^T)[m, n] / K)

with bf16-rounded operands and fp32 products, sums and xlogy. At the
reference operating point (pool 4000, targets 2000, C = 65, K = 100) the
joint is [260000, 130000], 135 GB in fp32; the kernel never writes it.

- CUDA tensors launch the hand-written kernel (csrc/xlogy_rowsum.cu: wgmma
  fed by TMA, consumer warpgroups whose logs run beside each other's
  products) or raise; nothing falls back to the plain version on the
  card. `kernel_resources` reads what it takes on the card.
- CPU tensors run `joint_xlogy_rowsums_reference`, the same math in
  plain PyTorch, in pool-row chunks of about 1 GB of fp32 joint.

`use_int8` is internal, as in the JAX package: per-row absmax int8
operands and exact int32 sums. The JAX package measured it slower and
ranking-destroying on the TPU (EPIG is a small difference of large
entropies), so no active-learning script or CLI exposes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.models.mlp_int8 import _quant_rows as _quant_rows_i8
from bayesvlm_tpu_torch.probforward.smith import _highest_fp32_matmul

# fp32 elements of one joint chunk of the plain version (1 GiB)
_CHUNK_ELEMS = 1 << 28
_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's row sums against the plain version, row by row: both take
# the same fp32 s (bf16 products are exact, int8 sums exact in both), so
# they differ by the fp32 summation order of N terms of one sign (a
# thread adds N / 4 of them as N / 64 tile sums of 16: at worst (16 + N /
# 64) 2^-24 of the sum, 1.2e-4 at N = 130,000, typically about the square
# root of that count times 2^-24, 3e-6) and by lg2.approx (<= 3e-7 s a
# term).
ROWSUM_RTOL = 1e-4
# K is zero-padded to whole wgmma k-steps of 32 bytes: 16 bf16, 32 int8
# values (a zero column adds zero)
_K_STEP = {False: 16, True: 32}
# the most bytes of K a resident block holds as A fragments in registers
# (csrc/xlogy_rowsum.cu kRegBytes: K <= 128 bf16 / 256 int8); longer rows
# take the streamed instantiation
RESIDENT_K_BYTES = 256


def _check_operands(pool_flat: torch.Tensor, targ_flat: torch.Tensor) -> None:
    if pool_flat.dim() != 2 or targ_flat.dim() != 2:
        raise ValueError(f"joint_xlogy_rowsums takes [M, K] and [N, K], got "
                         f"{tuple(pool_flat.shape)} and {tuple(targ_flat.shape)}")
    if pool_flat.shape[1] != targ_flat.shape[1]:
        raise ValueError(f"joint_xlogy_rowsums: K differs ({pool_flat.shape[1]} "
                         f"vs {targ_flat.shape[1]})")
    if pool_flat.device != targ_flat.device:
        raise ValueError("joint_xlogy_rowsums: operands on two devices")


def joint_xlogy_rowsums_reference(pool_flat: torch.Tensor,
                                  targ_flat: torch.Tensor, num_samples: int,
                                  use_int8: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel's math: [M, K], [N, K] -> [M]
    fp32. Operands rounded to bf16 (then, with `use_int8`, quantized per
    row); an fp32 matmul of bf16 values is exact per product, so this is
    the bf16 / fp32 contract up to summation order, and int8 sums of
    K * 127^2 < 2^24 are exact in fp32."""
    _check_operands(pool_flat, targ_flat)
    a = pool_flat.to(torch.bfloat16).float()
    b = targ_flat.to(torch.bfloat16).float()
    if use_int8:
        aq, a_scale = _quant_rows_i8(a)
        bq, b_scale = _quant_rows_i8(b)
        a, b, b_scale = aq.float(), bq.float(), b_scale.T
    M, N = a.shape[0], b.shape[0]
    inv_k = torch.tensor(1.0 / num_samples, dtype=torch.float32, device=a.device)
    rows = max(1, _CHUNK_ELEMS // max(N, 1))
    out = torch.empty(M, dtype=torch.float32, device=a.device)
    with _highest_fp32_matmul():
        for i in range(0, M, rows):
            s = a[i:i + rows] @ b.T
            if use_int8:
                # ((s32 * b_scale) * a_scale) * (1/K), as the JAX kernel
                s = s * b_scale * a_scale[i:i + rows] * inv_k
            else:
                s = s * inv_k
            s = s.clamp_min_(0.0)  # xlogy(s) = 0 where s <= 0
            out[i:i + rows] = torch.xlogy(s, s).sum(dim=1)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("xlogy_rowsum")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bvt_xlogy_rowsum_bf16.argtypes = [p, p, p, i, i, i, f, i, p]
    lib.bvt_xlogy_rowsum_bf16.restype = ctypes.c_int
    lib.bvt_xlogy_rowsum_int8.argtypes = [p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.bvt_xlogy_rowsum_int8.restype = ctypes.c_int
    lib.bvt_xlogy_rowsum_resources.argtypes = [i, i, i, p]
    lib.bvt_xlogy_rowsum_resources.restype = ctypes.c_int
    return lib


def _plan(M: int, N: int, K: int, use_int8: bool,
          streamed: Optional[bool] = None) -> dict:
    """What a launch on [M, K] x [N, K] takes: K padded to whole k-steps
    (`k_pad`), the instantiation (`streamed`: the resident one holds at
    most RESIDENT_K_BYTES of K a row; `streamed` forces one, for timing
    them against each other) and the int8 scratch ({name: (shape,
    dtype)}: the quantized operands and their row scales)."""
    step = _K_STEP[use_int8]
    k_pad = -(-K // step) * step
    k_bytes = k_pad if use_int8 else 2 * k_pad
    if streamed is None:
        streamed = k_bytes > RESIDENT_K_BYTES
    elif not streamed and k_bytes > RESIDENT_K_BYTES:
        raise ValueError(f"the resident xlogy_rowsum kernel holds at most "
                         f"{RESIDENT_K_BYTES} bytes of K a row, not {k_bytes} "
                         f"(K = {K}); take the streamed one")
    scratch = {}
    if use_int8:
        scratch = {"aq": ((M, k_pad), torch.int8), "a_scale": ((M,), torch.float32),
                   "bq": ((N, k_pad), torch.int8), "b_scale": ((N,), torch.float32)}
    return {"k_pad": k_pad, "streamed": bool(streamed), "scratch": scratch}


def kernel_resources(use_int8: bool = False, K: int = 100,
                     streamed: Optional[bool] = None, device=None) -> dict:
    """What the instantiation a launch at this K takes on the card: its
    dynamic shared memory a block (and the device's opt-in limit), blocks
    an SM (the occupancy calculator), threads a block, registers a thread
    at launch (the streamed one's warpgroups then move to 40 / 232 with
    setmaxnreg) and local memory a thread (spills)."""
    plan = _plan(1, 1, K, use_int8, streamed)
    lib = _library()
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.bvt_xlogy_rowsum_resources(int(use_int8), int(plan["streamed"]),
                                             plan["k_pad"], out)
    kernels.check(lib, err, "xlogy_rowsum resources query")
    return {"body": "wgmma", "streamed": plan["streamed"], "k_pad": plan["k_pad"],
            "smem_bytes": out[0], "smem_limit": out[4], "blocks_per_sm": out[1],
            "threads": out[5], "registers": out[2], "local_bytes": out[3]}


def _padded_bf16(x: torch.Tensor, k_pad: int) -> torch.Tensor:
    """x [R, K] -> contiguous bf16 [R, k_pad], zero columns appended."""
    out = torch.zeros(x.shape[0], k_pad, dtype=torch.bfloat16, device=x.device)
    out[:, :x.shape[1]] = x
    return out


def joint_xlogy_rowsums(pool_flat: torch.Tensor, targ_flat: torch.Tensor,
                        num_samples: int, use_int8: bool = False) -> torch.Tensor:
    """sum_n xlogy(pool_flat @ targ_flat^T / num_samples)[m, n] -> [M] fp32.

    pool_flat [M, K], targ_flat [N, K]: class probabilities, classes
    flattened into the rows and the K MC samples along the columns. The
    caller turns this into the joint entropy via
    `-(rowsums.reshape(N_p, C).sum(1)) / N_t`.

    CPU tensors take the plain version; CUDA tensors (float32 or
    bfloat16, any strides) launch the kernel or raise, for any K: rows
    longer than the resident block holds in registers take the kernel's
    streamed instantiation (K > 128 bf16 / 256 int8). Each
    launch is counted: the bf16 kernel's in
    `joint_xlogy_rowsums.launches`, the int8 kernel's in
    `joint_xlogy_rowsums.launches_int8`."""
    _check_operands(pool_flat, targ_flat)
    if pool_flat.device.type == "cpu":
        return joint_xlogy_rowsums_reference(pool_flat, targ_flat, num_samples,
                                             use_int8)
    if pool_flat.device.type != "cuda":
        raise ValueError(f"no xlogy_rowsum kernel for device {pool_flat.device}")
    for x in (pool_flat, targ_flat):
        if x.dtype not in _DTYPES:
            raise ValueError(f"xlogy_rowsum kernel takes float32 or bfloat16, "
                             f"not {x.dtype}")
    return _launch(pool_flat, targ_flat, num_samples, use_int8)


def _launch(pool_flat: torch.Tensor, targ_flat: torch.Tensor, num_samples: int,
            use_int8: bool, streamed: Optional[bool] = None) -> torch.Tensor:
    """The kernel on CUDA operands, on the current stream (`streamed` as
    `_plan` takes it)."""
    dev = pool_flat.device
    with torch.cuda.device(dev):
        out = _call(_library(), pool_flat, targ_flat, num_samples, use_int8, streamed,
                    torch.cuda.current_stream(dev).cuda_stream)
    if use_int8:
        joint_xlogy_rowsums.launches_int8 += 1
    else:
        joint_xlogy_rowsums.launches += 1
    return out


def _call(lib, pool_flat: torch.Tensor, targ_flat: torch.Tensor, num_samples: int,
          use_int8: bool, streamed: Optional[bool], stream: int) -> torch.Tensor:
    """One call of the library's entry point: bf16 operands zero-padded to
    `_plan`'s K (fresh, so 16-byte aligned with rows a multiple of 16
    bytes apart, as the kernel's TMA needs), the int8 scratch, the row
    sums [M]; raises when the library refuses."""
    (M, K), N = pool_flat.shape, targ_flat.shape[0]
    plan = _plan(M, N, K, use_int8, streamed)
    k_pad, dev = plan["k_pad"], pool_flat.device
    a, b = _padded_bf16(pool_flat, k_pad), _padded_bf16(targ_flat, k_pad)
    out = torch.empty(M, dtype=torch.float32, device=dev)
    inv_k = 1.0 / num_samples
    if use_int8:
        scratch = {name: torch.empty(shape, dtype=dtype, device=dev)
                   for name, (shape, dtype) in plan["scratch"].items()}
        err = lib.bvt_xlogy_rowsum_int8(
            a.data_ptr(), b.data_ptr(), *(scratch[n].data_ptr() for n in (
                "aq", "a_scale", "bq", "b_scale")), out.data_ptr(), M, N, k_pad, inv_k,
            int(plan["streamed"]), stream)
    else:
        err = lib.bvt_xlogy_rowsum_bf16(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
                                        k_pad, inv_k, int(plan["streamed"]), stream)
    kernels.check(lib, err, "xlogy_rowsum kernel")
    return out


joint_xlogy_rowsums.launches = 0
joint_xlogy_rowsums.launches_int8 = 0


def _flatten(probs: torch.Tensor) -> torch.Tensor:
    """[N, K, C] -> fp32 [N * C, K] (classes into the rows)."""
    N, K, C = probs.shape
    return probs.transpose(1, 2).reshape(N * C, K).float()


def _marginal_entropy_flat(flat: torch.Tensor, n: int, c: int) -> torch.Tensor:
    """H[mean_K p] from the [N * C, K] fp32 layout -> [N]."""
    pm = flat.mean(dim=1)
    xlogy = torch.where(pm > 0, pm * torch.log(pm), torch.zeros_like(pm))
    return -xlogy.reshape(n, c).sum(dim=1)


def scores_from_rowsums(pool_flat: torch.Tensor, targ_flat: torch.Tensor,
                        rowsums: torch.Tensor, n_pool: int, n_targ: int,
                        n_classes: int) -> torch.Tensor:
    """EPIG = H[pool] + E[H[targ]] - E[H[joint]] from the flattened
    operands and the joint row sums -> [N_p]."""
    entropy_pool = _marginal_entropy_flat(pool_flat, n_pool, n_classes)
    entropy_targ = _marginal_entropy_flat(targ_flat, n_targ, n_classes).mean()
    entropy_joint = -rowsums.reshape(n_pool, n_classes).sum(dim=1) / n_targ
    return entropy_pool + entropy_targ - entropy_joint


def epig_from_probs_fused(probs_pool: torch.Tensor, probs_targ: torch.Tensor,
                          use_int8: bool = False) -> torch.Tensor:
    """EPIG scores [N_p] from probs_pool [N_p, K, C] and probs_targ
    [N_t, K, C] through the joint row sums (the counterpart of the JAX
    package's `epig_from_probs_pallas`; `use_int8` is internal)."""
    N_p, K, C = probs_pool.shape
    pool_flat, targ_flat = _flatten(probs_pool), _flatten(probs_targ)
    rowsums = joint_xlogy_rowsums(pool_flat, targ_flat, K, use_int8=use_int8)
    return scores_from_rowsums(pool_flat, targ_flat, rowsums, N_p,
                               probs_targ.shape[0], C)
