"""The GEMM probes' kernel (csrc/tile_gemm.cu) and its plain PyTorch
version: C[M, N] = A[M, K] . B[K, N] with the raw accumulator as output,
B row-major [K, N] as scripts/dev/bench_int8_mxu.py, bench_int8_sweep.py
and bench_int4_mxu.py lay it out (their shared `make_matmul` body).

- `matmul(a, b, tile)`: bf16 x bf16 -> fp32, or int8 x int8 -> int32.
- `matmul_s4(a, b_packed)`: s4 x s4 -> int32 (a packed, uint8) or
  s8 x s4 -> int32 (a int8, the weight-only int4 case). s4 values are
  packed two a byte along K, the lower k in the low nibble, two's
  complement (`pack_s4`, `unpack_s4`): A as [M, K/2], B as [K/2, N]. No
  torch int4 dtype is used.
- `unpack_prepass(a, b_packed)`: the s4 kinds' unpacking prepass alone.

Every kind runs the warp-specialised wgmma GEMM fed by TMA
(csrc/wgmma_gemm.cuh): bf16 and int8 at any of its 8 configurations,
`TILES` (the sweep's), the s4 kinds at `DEFAULT_TILE`. The library lays
int8's B out as B^T [N, K] first, with a transpose kernel in the same
call (wgmma reads 8-bit operands K-major only). Hopper's wgmma has no
int4 form, so for the s4 kinds one prepass kernel in the same call
unpacks B's nibbles to s8 B^T [N, K] (and s4 x s4's A's to s8 [M, K]),
and the s8 GEMM runs on those. Every kind hands the library B [K, N]
(packed for the s4 kinds). Every operand must start 16-byte aligned with
rows a multiple of 16 bytes apart (the TMA's rule; the wrapper raises by
name, it does not copy).
CUDA tensors launch the kernel or raise; CPU tensors run the plain
version; nothing falls back. Each launch is counted on its wrapper:
`matmul.launches` (bf16), `matmul.launches_s8`, `matmul_s4.launches` (s4
x s4), `matmul_s4.launches_s8s4`.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import torch

from bayesvlm_tpu_torch import kernels
from bayesvlm_tpu_torch.probes import card

# csrc/tile_gemm.cu Kind
BF16, S8, S4, S8S4 = 0, 1, 2, 3
KIND_NAMES = {BF16: "bf16", S8: "s8", S4: "s4", S8S4: "s8s4"}
# K must be a multiple of one wgmma step's depth (the s4 kinds run the s8
# product after their prepass)
DEPTH = {BF16: 16, S8: 32, S4: 32, S8S4: 32}
# the probes' shape (the scripts' M, K, N), and a tiny one for the CPU
M, K, N = 16384, 1024, 4096
CPU_SHAPE = (64, 256, 128)
# timing: best of REPS CUDA-event runs of N_ITER launches (PLAIN_ITER for
# the plain versions)
N_ITER, REPS, PLAIN_ITER = 20, 3, 2
# bf16 kernel vs plain: both sum fp32 products of the same bf16 values, in
# another order: a few fp32 ulps of the largest partial sums
BF16_TOL = 1e-5
# the product each kind runs (csrc/tile_gemm.cu) and its body: "wgmma"
# (csrc/wgmma_gemm.cuh) for all four
MMA = {BF16: "wgmma m64nNk16 bf16 (TMA ring)", S8: "wgmma m64nNk32 s8 (TMA ring)",
       S4: "wgmma m64nNk32 s8 (TMA ring) after the unpack_s4 prepass (A and B to s8)",
       S8S4: "wgmma m64nNk32 s8 (TMA ring) after the unpack_s4 prepass (B to s8)"}
BODY = {BF16: "wgmma", S8: "wgmma", S4: "wgmma", S8S4: "wgmma"}
# the TMA's rule for every operand: base and row stride in 16-byte units
ALIGN = 16


class Tile(NamedTuple):
    """A block tile of the wgmma kernel: BM x BN outputs, `warps` warps
    (12: a producer and two consumer warpgroups), a `stages`-deep TMA ring
    of 128-byte K rows, and a schedule: the consumers share each tile
    ("coop") or take whole tiles in turn ("pingpong"); csrc/tile_gemm.cu
    BVT_TILES, in the same order."""

    bm: int
    bn: int
    warps: int
    stages: int
    schedule: str = ""

    def __str__(self) -> str:
        tail = f"/{self.schedule}" if self.schedule else ""
        return f"{self.bm}x{self.bn}/{self.warps}w/{self.stages}st{tail}"


# the library's code of each schedule (describe's out[5])
SCHEDULES = {"coop": 0, "pingpong": 1}
TILES = (Tile(128, 128, 12, 6, "pingpong"), Tile(128, 128, 12, 5, "pingpong"),
         Tile(128, 128, 12, 4, "pingpong"), Tile(64, 256, 12, 4, "pingpong"),
         Tile(128, 256, 12, 4, "coop"), Tile(128, 256, 12, 3, "coop"),
         Tile(256, 128, 12, 4, "coop"), Tile(128, 256, 12, 2, "coop"))
DEFAULT_TILE = TILES[0]  # and the s4 kinds' only one


def pack_s4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """int values in [-8, 7] -> uint8 with two a byte along `dim` (of even
    length): element 2i in the low nibble, 2i+1 in the high one."""
    if x.shape[dim] % 2:
        raise ValueError(f"pack_s4: dim {dim} has odd length {x.shape[dim]}")
    if x.numel() and (int(x.min()) < -8 or int(x.max()) > 7):
        raise ValueError("pack_s4 takes values in [-8, 7]")
    x = x.to(torch.int16).movedim(dim, -1)
    lo, hi = x[..., 0::2] & 0xF, x[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8).movedim(-1, dim).contiguous()


def unpack_s4(p: torch.Tensor, dim: int) -> torch.Tensor:
    """`pack_s4`'s inverse: uint8 -> int8 values in [-8, 7], twice as long
    along `dim`."""
    x = p.to(torch.int16).movedim(dim, -1)
    nib = torch.stack([x & 0xF, x >> 4], dim=-1).flatten(-2)
    return (nib - ((nib & 8) << 1)).to(torch.int8).movedim(-1, dim).contiguous()


def matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain product: bf16 -> fp32 (a fp32 product of the bf16 values);
    integers -> the exact int32 sum (int64 on the CPU; on the card the
    float64 product, exact while K 127^2 < 2^53, since torch has no CUDA
    integer matmul and float32 is exact only while K 127^2 < 2^24)."""
    if a.dtype == torch.bfloat16:
        return a.float() @ b.float()
    if a.device.type == "cpu":
        return (a.long() @ b.long()).to(torch.int32)
    return (a.double() @ b.double()).to(torch.int32)


def matmul_s4_reference(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """The plain product of the widened values: a unpacked along K when it
    is packed (uint8), b unpacked along K."""
    if a.dtype == torch.uint8:
        a = unpack_s4(a, 1)
    return matmul_reference(a, unpack_s4(b_packed, 0))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = kernels.load("tile_gemm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_tile_gemm.argtypes = [i, i, p, p, p, i, i, i, p]
    lib.bvt_tile_gemm.restype = ctypes.c_int
    lib.bvt_tile_gemm_describe.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
    lib.bvt_tile_gemm_describe.restype = ctypes.c_int
    lib.bvt_tile_gemm_blocks_per_sm.argtypes = [i, i]
    lib.bvt_tile_gemm_blocks_per_sm.restype = ctypes.c_int
    lib.bvt_tile_gemm_registers.argtypes = [i, i]
    lib.bvt_tile_gemm_registers.restype = ctypes.c_int
    lib.bvt_tile_gemm_unpack_s4.argtypes = [p, p, p, p, i, i, i, p]
    lib.bvt_tile_gemm_unpack_s4.restype = ctypes.c_int
    return lib


def _tile_index(tile: Tile, kind: int) -> int:
    """The tile's index in the library's table of this kind: TILES for bf16
    and s8, DEFAULT_TILE (index 0) alone for the s4 kinds."""
    if kind in (S4, S8S4):
        if tile != DEFAULT_TILE:
            raise ValueError(f"the {KIND_NAMES[kind]} kernel is built for {DEFAULT_TILE} "
                             f"only")
        return 0
    if tile not in TILES:
        raise ValueError(f"no tile {tile}: the kernel is built for {TILES}")
    return TILES.index(tile)


def _check_operand(name: str, t: torch.Tensor) -> None:
    """The kernels read and write whole 16-byte pieces (TMA boxes, cp.async
    chunks): a contiguous operand whose base and row stride are multiples
    of 16 bytes. Raises naming the operand; nothing is copied."""
    if not t.is_contiguous():
        raise ValueError(f"GEMM operand {name}: the kernel needs contiguous operands")
    if t.data_ptr() % ALIGN:
        raise ValueError(f"GEMM operand {name}: base address {t.data_ptr():#x} is not "
                         f"{ALIGN}-byte aligned (the TMA's rule)")
    row = t.stride(0) * t.element_size()
    if row % ALIGN:
        raise ValueError(f"GEMM operand {name}: rows are {row} bytes apart, not a "
                         f"multiple of {ALIGN} (the TMA's rule)")


def _check_launch(kind: int, a: torch.Tensor, b: torch.Tensor, Kr: int, Nr: int) -> None:
    """What the library takes, checked before it is loaded: the TMA's rules
    for both operands, K and N, one CUDA device."""
    _check_operand("a", a)
    _check_operand("b", b)
    if Kr % DEPTH[kind]:
        raise ValueError(f"{KIND_NAMES[kind]} GEMM: K = {Kr} is not a multiple of "
                         f"{DEPTH[kind]} (one wgmma step)")
    if Nr % 16:
        raise ValueError(f"GEMM: N = {Nr} is not a multiple of 16 (16-byte B rows)")
    if a.device != b.device:
        raise ValueError("GEMM: a and b must be on one device")
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")


def _launch(kind: int, tile: Tile, a: torch.Tensor, b: torch.Tensor, Mr: int, Nr: int,
            Kr: int, out_dtype: torch.dtype) -> torch.Tensor:
    index = _tile_index(tile, kind)
    _check_launch(kind, a, b, Kr, Nr)
    c = torch.empty(Mr, Nr, dtype=out_dtype, device=a.device)
    if Mr == 0:
        return c  # nothing to launch, nothing counted
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.bvt_tile_gemm(kind, index, a.data_ptr(), b.data_ptr(), c.data_ptr(), Mr,
                                Nr, Kr, stream)
    kernels.check(lib, err, f"{KIND_NAMES[kind]} GEMM kernel")
    owner, attr = COUNTS[kind]
    setattr(owner, attr, getattr(owner, attr) + 1)
    return c


def _shapes(a: torch.Tensor, b: torch.Tensor, ka: int, kb: int, what: str):
    if a.dim() != 2 or b.dim() != 2 or ka != kb:
        raise ValueError(f"{what}: a [M, K] and b [K, N] do not match: "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def matmul(a: torch.Tensor, b: torch.Tensor, tile: Tile = DEFAULT_TILE) -> torch.Tensor:
    """a [M, K] . b [K, N]: bf16 -> fp32, int8 -> int32. Counts in
    `matmul.launches` (bf16) and `matmul.launches_s8`."""
    _shapes(a, b, a.shape[-1], b.shape[0], "matmul")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"matmul takes bf16 x bf16 or int8 x int8, not {a.dtype} x "
                         f"{b.dtype}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_reference(a, b)
    kind = BF16 if a.dtype == torch.bfloat16 else S8
    return _launch(kind, tile, a, b, a.shape[0], b.shape[1], a.shape[1],
                   torch.float32 if kind == BF16 else torch.int32)


def matmul_s4(a: torch.Tensor, b_packed: torch.Tensor) -> torch.Tensor:
    """s4 x s4 (a packed uint8 [M, K/2]) or s8 x s4 (a int8 [M, K]) times
    b packed uint8 [K/2, N] -> int32 [M, N], at DEFAULT_TILE: the unpacking
    prepass, then the s8 GEMM, in one library call. Counts in
    `matmul_s4.launches` (s4 x s4) and `matmul_s4.launches_s8s4`."""
    if b_packed.dtype != torch.uint8 or a.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"matmul_s4 takes a packed s4 (uint8) or int8 a and a packed "
                         f"s4 (uint8) b, not {a.dtype} x {b_packed.dtype}")
    kind = S4 if a.dtype == torch.uint8 else S8S4
    Kr = a.shape[-1] * (2 if kind == S4 else 1)
    _shapes(a, b_packed, Kr, 2 * b_packed.shape[0], "matmul_s4")
    if a.device.type == "cpu" and b_packed.device.type == "cpu":
        return matmul_s4_reference(a, b_packed)
    return _launch(kind, DEFAULT_TILE, a, b_packed, a.shape[0], b_packed.shape[1], Kr,
                   torch.int32)


def unpack_prepass(a: Optional[torch.Tensor], b_packed: torch.Tensor):
    """The s4 kinds' prepass alone (`matmul_s4` launches it inside its
    library call; the tests and chip_smoke.py check it apart): (a8, bt),
    bt int8 [N, K] = B^T unpacked from b packed uint8 [K/2, N], a8 int8 [M,
    K] unpacked from a packed uint8 [M, K/2], or None without a. CPU tensors
    get the plain version (`unpack_s4`); nothing is counted."""
    Kr, Nr = 2 * b_packed.shape[0], b_packed.shape[1]
    if (b_packed.dtype != torch.uint8 or b_packed.dim() != 2
            or (a is not None and (a.dtype != torch.uint8 or a.dim() != 2
                                   or 2 * a.shape[1] != Kr))):
        raise ValueError("unpack_prepass takes packed s4 (uint8) a [M, K/2] or None and b "
                         "[K/2, N]")
    if b_packed.device.type == "cpu" and (a is None or a.device.type == "cpu"):
        return (None if a is None else unpack_s4(a, 1)), unpack_s4(b_packed, 0).t().contiguous()
    _check_launch(S4, b_packed if a is None else a, b_packed, Kr, Nr)
    dev = b_packed.device
    bt = torch.empty(Nr, Kr, dtype=torch.int8, device=dev)
    a8 = None if a is None else torch.empty(a.shape[0], Kr, dtype=torch.int8, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bvt_tile_gemm_unpack_s4(
            None if a is None else a.data_ptr(), b_packed.data_ptr(),
            None if a8 is None else a8.data_ptr(), bt.data_ptr(),
            0 if a is None else a.shape[0], Nr, Kr, torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, err, "s4 unpacking prepass")
    return a8, bt


matmul.launches = 0
matmul.launches_s8 = 0
matmul_s4.launches = 0
matmul_s4.launches_s8s4 = 0
# each kind's launch count (owner, attribute), added to where it launches
COUNTS = {BF16: (matmul, "launches"), S8: (matmul, "launches_s8"),
          S4: (matmul_s4, "launches"), S8S4: (matmul_s4, "launches_s8s4")}

# each kernel kind's name, its count (owner, attribute) and the TPU body
# it replaces (the pallas_call of `make_matmul`)
KERNELS = {
    "tile_gemm_bf16": (BF16, COUNTS[BF16], "scripts/dev/bench_int8_mxu.py:64"),
    "tile_gemm_s8": (S8, COUNTS[S8], "scripts/dev/bench_int8_mxu.py:64"),
    "tile_gemm_s4": (S4, COUNTS[S4], "scripts/dev/bench_int4_mxu.py:49"),
    "tile_gemm_s8s4": (S8S4, COUNTS[S8S4], "scripts/dev/bench_int4_mxu.py:49"),
}


def gemm_bound(Mr: int, Kr: int, Nr: int, kind: str) -> dict:
    """The least time the card could take for C = A . B of this kind
    ("bf16", "s8", "s4", "s8s4"): A and B read once (s4 at half a byte),
    C (4 bytes) written once, against 2 M K N operations at the bf16 or
    int8 rate (int4 held to the int8 rate: no published H100 int4 rate)."""
    a_bytes = {"bf16": 2, "s8": 1, "s4": 0.5, "s8s4": 1}[kind]
    b_bytes = {"bf16": 2, "s8": 1, "s4": 0.5, "s8s4": 0.5}[kind]
    nbytes = Mr * Kr * a_bytes + Kr * Nr * b_bytes + Mr * Nr * 4
    ops = 2 * Mr * Kr * Nr
    return {**card.bound(nbytes, ops, "bf16" if kind == "bf16" else "int8"),
            "bytes": nbytes, "ops": ops}


def tile_resources(kind: int, tile: Tile):
    """(shared-memory bytes, blocks an SM, registers a thread at launch) of
    the GEMM kernel at this tile (the s4 kinds: the s8 wgmma kernel their
    prepass feeds), from the library's own table (which must match TILES),
    the card's occupancy calculator and cudaFuncGetAttributes."""
    lib = _library()
    index = _tile_index(tile, kind)
    out = (ctypes.c_int * 6)()
    if lib.bvt_tile_gemm_describe(kind, index, out) != 0:
        raise ValueError(f"the {KIND_NAMES[kind]} kernel has no tile {tile}")
    bm, bn, threads, stages, smem, schedule = out
    if (bm, bn, threads // 32, stages, schedule) != (*tile[:4], SCHEDULES[tile.schedule]):
        raise RuntimeError(f"the {KIND_NAMES[kind]} kernel's tile {index} is {tile} here but "
                           f"{bm}x{bn}/{threads // 32}w/{stages}st, schedule {schedule} in "
                           f"the library")
    blocks = lib.bvt_tile_gemm_blocks_per_sm(kind, index)
    if blocks < 0:
        kernels.check(lib, -blocks, "GEMM occupancy")
    registers = lib.bvt_tile_gemm_registers(kind, index)
    if registers < 0:
        kernels.check(lib, -registers, "GEMM registers")
    return smem, blocks, registers


# -- what the three GEMM probes share ------------------------------------------


def parse_args(argv, description: str) -> argparse.Namespace:
    """--device: cuda (the default) runs at the scripts' shape, cpu at
    CPU_SHAPE (`probe_shape`)."""
    p = argparse.ArgumentParser(description=description.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def probe_shape(device: str):
    """(M, K, N): the scripts' on the card, CPU_SHAPE on the CPU."""
    return CPU_SHAPE if device == "cpu" else (M, K, N)


def library_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> fp32 in one PyTorch call, the bf16 kernel's library
    yardstick (timed only; the port never calls it): cuBLAS through
    `torch.mm(a, b, out_dtype=torch.float32)`, the same function. PyTorch
    has no CPU version of it; there the fp32 product of the same values
    stands in."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    return torch.mm(a, b, out_dtype=torch.float32)


def draw(rng, low: int, high: int, shape, device) -> torch.Tensor:
    """rng.integers(low, high, shape) as int8 on `device`, as the scripts
    draw their operands."""
    return torch.from_numpy(rng.integers(low, high, size=shape).astype("int8")).to(device)


def check_exact(name: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """An integer kernel must equal its plain version; raises if not."""
    if not torch.equal(out, ref):
        bad = int((out != ref).sum())
        raise RuntimeError(f"{name} differs from its plain version in {bad} of "
                           f"{ref.numel()} sums")
    return {"max_abs_err": 0.0}


def check_bf16(name: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """The bf16 kernel within BF16_TOL of max |plain|; raises if not."""
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    if err > BF16_TOL * scale:
        raise RuntimeError(f"{name} disagrees with its plain version: max |d| {err:.3e} "
                           f"(tol {BF16_TOL} x max |ref| = {BF16_TOL * scale:.3e})")
    return {"max_abs_err": err, "max_abs_ref": scale}


def measure(fn: Callable, plain: Callable, library: Optional[Callable], device,
            shape, kind: str, kind_code: int, tile: Tile,
            reference: Optional[Callable] = None) -> dict:
    """A kernel's times beside its plain version's, the library call's
    (one PyTorch call of the same function, or None), a reference
    product's (another function, timed for reference only; None if not
    given), its bound, its rate, its tile, its mma and body, and its
    tile's shared memory, blocks an SM and registers (None off the
    card)."""
    r = {"ms": card.device_ms(fn, device, N_ITER, REPS),
         "plain_ms": card.device_ms(plain, device, PLAIN_ITER, REPS),
         "library_ms": (None if library is None
                        else card.device_ms(library, device, N_ITER, REPS)),
         "tile": str(tile), "mma": MMA[kind_code], "body": BODY[kind_code],
         **gemm_bound(*shape, kind)}
    if reference is not None:
        r["reference_ms"] = card.device_ms(reference, device, N_ITER, REPS)
    r["tops"] = None if r["ms"] is None else r["ops"] / r["ms"] / 1e9
    r["smem_bytes"], r["blocks_per_sm"], r["registers"] = (
        tile_resources(kind_code, tile) if device.type == "cuda" else (None, None, None))
    return r


def rate(r: dict) -> str:
    return "" if r["ms"] is None else f" = {r['tops']:.1f} TOP/s"


def block_note(r: dict) -> str:
    return ("" if r["smem_bytes"] is None else
            f"  [{r['smem_bytes']} B shared memory, {r['blocks_per_sm']} blocks/SM, "
            f"{r['registers']} registers]")
