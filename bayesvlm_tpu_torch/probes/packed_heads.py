"""The packed-head probe's kernels (csrc/packed_heads.cu) and their plain
PyTorch versions: the two halves of attention alone, per head or for a
pair of heads packed into one 128-wide product against a block-diagonal
operand, as scripts/dev/probe_packed_heads.py computes them.

- `qk_scores(q, k, num_heads)` ports `_qk_perhead_kernel` (:46): q, k
  bf16 [B, T, H*64] -> fp32 scores [B, H, T, T], (q_h . k_h^T) * SCALE
  with the scale on the fp32 sum. `packed=True` ports `_qk_packed_kernel`
  (:58): [B, H/2, T, 2T], the pair's 128 columns of q against the
  block-diagonal Kp [2T, 128] (head 2p in columns 0:T, 2p+1 in T:2T).
- `pv(p, v, num_heads)` ports `_pv_perhead_kernel` (:86): p fp32 [B, H,
  T, T], v bf16 [B, T, H*64] -> bf16 [B, T, H*64], the product in fp32.
  `packed=True` ports `_pv_packed_kernel` (:97): p' [B, H/2, T, 2T]
  (`pack_pairs`) times the block-diagonal V' [2T, 128].

CUDA tensors launch the kernel or raise; CPU tensors run the plain
version; nothing falls back. q, k and v reach the kernels through tensor
maps, so on the card they must start 16-byte aligned (the TMA's rule;
the wrapper raises otherwise); p may start at any 4-byte boundary. Each
launch is counted on its wrapper (`.launches`, and `.launches_packed` for
the packed instantiation). `kernel_resources` reads what a kernel takes on
the card, `qk_plan` how the scores kernel's staging holds a strip.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bayesvlm_tpu_torch import kernels

HEAD_DIM = 64
SCALE = 1.0 / math.sqrt(HEAD_DIM)
ALIGN = 16  # bytes: the TMA's rule for the bf16 operands' base
# csrc/packed_heads.cu Kernel
QK, PV = 0, 1
# pv kernel vs plain: both take the fp32 product (the kernel's three bf16
# parts of p sum to p exactly, and each part times a bf16 v is exact in
# fp32), so they differ by the fp32 summation order, which can move a
# value across the output's bf16 rounding boundary: one bf16 ulp, at most
# 2^-7 of the value. Flips are sparse; a single bf16 rounding of p moves
# every output by about 2^-9 |p| |v| sqrt(T). The mean |d| limit, relative
# to the mean |plain|, lies between the two (tests/test_torch_packed_heads.py
# shows a bf16-rounded p fails it; chip_smoke.py prints both means).
PV_TOL = 2.0 ** -7
PV_MEAN_RTOL = 1e-4


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*Dh] -> [B, H, T, Dh]"""
    B, T, D = x.shape
    return x.reshape(B, T, num_heads, D // num_heads).transpose(1, 2)


def _pairs(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*Dh] -> [B, H/2, T, 2*Dh]: each pair's columns side by side"""
    B, T, D = x.shape
    return x.reshape(B, T, num_heads // 2, 2 * D // num_heads).transpose(1, 2)


def _block_diagonal(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*Dh] -> [B, H/2, 2T, 2*Dh]: rows 0:T hold head 2p in
    columns 0:Dh, rows T:2T head 2p+1 in columns Dh:2Dh, zeros elsewhere
    (the TPU bodies' Kp and V')."""
    B, T, D = x.shape
    dh = D // num_heads
    h = _heads(x, num_heads)
    out = x.new_zeros(B, num_heads // 2, 2 * T, 2 * dh)
    out[:, :, :T, :dh] = h[:, 0::2]
    out[:, :, T:, dh:] = h[:, 1::2]
    return out


def pack_pairs(p: torch.Tensor) -> torch.Tensor:
    """[B, H, T, T] -> [B, H/2, T, 2T]: each pair's probability blocks side
    by side, as the script lays p' out (probe_packed_heads.py:227-230)."""
    return torch.cat([p[:, 0::2], p[:, 1::2]], dim=-1)


def qk_scores_reference(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                        packed: bool = False) -> torch.Tensor:
    """fp32 (q . k^T) * SCALE per head [B, H, T, T], or per pair against
    the block-diagonal keys [B, H/2, T, 2T]."""
    if packed:
        s = _pairs(q, num_heads).float() @ _block_diagonal(k, num_heads).float().transpose(-1, -2)
    else:
        s = _heads(q, num_heads).float() @ _heads(k, num_heads).float().transpose(-1, -2)
    return s * SCALE


def pv_reference(p: torch.Tensor, v: torch.Tensor, num_heads: int,
                 packed: bool = False) -> torch.Tensor:
    """bf16(fp32 p . v) per head, or p' times the block-diagonal V' per
    pair; [B, T, H*Dh]."""
    B, T, D = v.shape
    if packed:
        o = p.float() @ _block_diagonal(v, num_heads).float()
    else:
        o = p.float() @ _heads(v, num_heads).float()
    return o.transpose(1, 2).reshape(B, T, D).to(torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("packed_heads")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_qk_scores.argtypes = [p, p, p, i, i, i, ctypes.c_float, i, p]
    lib.bvt_qk_scores.restype = ctypes.c_int
    lib.bvt_pv.argtypes = [p, p, p, i, i, i, i, p]
    lib.bvt_pv.restype = ctypes.c_int
    lib.bvt_packed_heads_resources.argtypes = [i, i, p]
    lib.bvt_packed_heads_resources.restype = ctypes.c_int
    lib.bvt_qk_plan.argtypes = [i, i, p]
    lib.bvt_qk_plan.restype = ctypes.c_int
    return lib


def _check_heads(x: torch.Tensor, num_heads: int, packed: bool, what: str) -> None:
    if x.dim() != 3 or x.shape[-1] % num_heads:
        raise ValueError(f"{what}: expected [B, T, H*Dh] with H = {num_heads}, got "
                         f"{tuple(x.shape)}")
    if x.shape[-1] // num_heads != HEAD_DIM:
        raise ValueError(f"{what} is built for head dim {HEAD_DIM}, not "
                         f"{x.shape[-1] // num_heads}")
    if packed and num_heads % 2:
        raise ValueError(f"{what} packs heads in pairs: an even head count, not "
                         f"{num_heads}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what} takes bfloat16 q, k, v, not {x.dtype}")


def _device(tensors, what: str, mapped=()) -> str:
    """The operands' one device type; off the CPU, the `mapped` ones (the
    bf16 operands the kernel reaches by tensor maps) must start ALIGN-byte
    aligned."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what}: operands must be on one device")
    if device.type != "cpu":
        for name, t in mapped:
            if t.data_ptr() % ALIGN:
                raise ValueError(f"{what}: {name}'s base address {t.data_ptr():#x} is not "
                                 f"{ALIGN}-byte aligned (the TMA's rule)")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {device}")
    if device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel needs contiguous operands")
    return device.type


def qk_scores(q: torch.Tensor, k: torch.Tensor, num_heads: int,
              packed: bool = False) -> torch.Tensor:
    """`_qk_perhead_kernel` (or `_qk_packed_kernel`): fp32 scores [B, H, T,
    T] (or [B, H/2, T, 2T]). Counts in `qk_scores.launches`
    (`.launches_packed`)."""
    _check_heads(q, num_heads, packed, "qk_scores")
    if k.shape != q.shape or k.dtype != q.dtype:
        raise ValueError(f"qk_scores: q and k must share one shape and dtype, got "
                         f"{tuple(q.shape)} {q.dtype}, {tuple(k.shape)} {k.dtype}")
    if _device((q, k), "qk_scores", (("q", q), ("k", k))) == "cpu":
        return qk_scores_reference(q, k, num_heads, packed)
    B, T, _ = q.shape
    shape = (B, num_heads // 2, T, 2 * T) if packed else (B, num_heads, T, T)
    s = torch.empty(shape, dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.bvt_qk_scores(q.data_ptr(), k.data_ptr(), s.data_ptr(), B, T, num_heads,
                                SCALE, int(packed),
                                torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(lib, err, "qk_scores kernel")
    if packed:
        qk_scores.launches_packed += 1
    else:
        qk_scores.launches += 1
    return s


def pv(p: torch.Tensor, v: torch.Tensor, num_heads: int,
       packed: bool = False) -> torch.Tensor:
    """`_pv_perhead_kernel` (or `_pv_packed_kernel`): bf16 [B, T, H*64].
    Counts in `pv.launches` (`.launches_packed`)."""
    _check_heads(v, num_heads, packed, "pv")
    B, T, _ = v.shape
    shape = (B, num_heads // 2, T, 2 * T) if packed else (B, num_heads, T, T)
    if tuple(p.shape) != shape or p.dtype != torch.float32:
        raise ValueError(f"pv takes float32 p of shape {shape}, got {tuple(p.shape)} "
                         f"{p.dtype}")
    if _device((p, v), "pv", (("v", v),)) == "cpu":
        return pv_reference(p, v, num_heads, packed)
    o = torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(v.device):
        err = lib.bvt_pv(p.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, num_heads,
                         int(packed), torch.cuda.current_stream(v.device).cuda_stream)
    kernels.check(lib, err, "pv kernel")
    if packed:
        pv.launches_packed += 1
    else:
        pv.launches += 1
    return o


qk_scores.launches = 0
qk_scores.launches_packed = 0
pv.launches = 0
pv.launches_packed = 0

# each kernel: its wrapper and plain version (called as fn(x, y, num_heads)),
# its count (owner, attribute), and the TPU body it replaces
KERNELS = {
    "qk_scores": (qk_scores, qk_scores_reference, (qk_scores, "launches"),
                  "scripts/dev/probe_packed_heads.py:46"),
    "qk_scores_packed": (functools.partial(qk_scores, packed=True),
                         functools.partial(qk_scores_reference, packed=True),
                         (qk_scores, "launches_packed"),
                         "scripts/dev/probe_packed_heads.py:58"),
    "pv": (pv, pv_reference, (pv, "launches"), "scripts/dev/probe_packed_heads.py:86"),
    "pv_packed": (functools.partial(pv, packed=True),
                  functools.partial(pv_reference, packed=True), (pv, "launches_packed"),
                  "scripts/dev/probe_packed_heads.py:97"),
}


def kernel_resources(name: str, device=None) -> dict:
    """What the kernel `name` (a key of KERNELS) takes on the card: its
    dynamic shared memory a block, blocks an SM (the occupancy calculator),
    registers a thread, local memory a thread (spills) and threads a
    block."""
    lib = _library()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = lib.bvt_packed_heads_resources(QK if name.startswith("qk") else PV,
                                             int(name.endswith("packed")), out)
    kernels.check(lib, err, f"{name} resources query")
    return {"body": "wgmma", "smem_bytes": out[0], "blocks_per_sm": out[1],
            "registers": out[2], "local_bytes": out[3], "threads": out[4]}


def qk_plan(T: int, packed: bool = False) -> dict:
    """How the scores kernel stages a strip at this T: rows a strip (64, or
    fewer where a strip would not fit), strips in flight (staging buffers)
    and a buffer's bytes. Raises where one row does not fit."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    kernels.check(lib, lib.bvt_qk_plan(T, int(packed), out), f"qk plan at T = {T}")
    return {"rows": out[0], "buffers": out[1], "pitch": out[2]}


def pv_check(out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The pv kernel against its plain version: max |d| within PV_TOL (abs
    + rel) and mean |d| within PV_MEAN_RTOL of the mean |plain|; raises
    if not."""
    d = (out.float() - ref.float()).abs()
    worst = float((d / (PV_TOL + PV_TOL * ref.float().abs())).max())
    mean, mean_ref = float(d.mean()), float(ref.float().abs().mean())
    r = {"max_abs_err": float(d.max()), "worst": worst, "mean_abs_err": mean,
         "mean_tol": PV_MEAN_RTOL * mean_ref}
    if worst > 1.0:
        raise RuntimeError(f"pv disagrees with its plain version: max |d| "
                           f"{r['max_abs_err']:.3e} (tol {PV_TOL:.3e} abs + rel)")
    if mean > r["mean_tol"]:
        raise RuntimeError(f"pv strays from its plain version: mean |d| {mean:.3e} "
                           f"(tol {r['mean_tol']:.3e})")
    return r
