"""The native decode lane, the port's counterpart of
`bayesvlm_tpu.data.native_io` (same names):

  - `tar_index(path)`: a one-pass tar member index (name, offset, size),
    and `read_member(path, offset, size)`: one member by pread, both from
    the port's own host library (csrc/host_io.cc, built with g++);
  - `decode_batch(jpegs, size, mean, std, ...)` / `decode_batch_u8(jpegs,
    size, ...)`: JPEG bytes -> [n, size, size, 3] crops (fp32 normalised /
    uint8) and [n] int32 statuses (0, or -1 for a failed decode, whose crop
    is all zeros), bilinear, either the shorter side resized and the centre
    cropped (CLIP) or a square resize (`square_resize`, SigLIP).

`device="cuda"` (the default, as every entry point of the port) decodes on
the card: nvJPEG to RGB in device memory, then `resize_crop`, the kernel of
csrc/jpeg_decode.cu, on the current stream; the crops are device tensors.
Without a card it raises: it never drops to the CPU. `device="cpu"` decodes
with libjpeg (csrc/jpeg_cpu.cc, built at first use; it needs `jpeglib.h`)
and crops with `resize_crop_reference`, the plain version: the JAX lane's
bits. The two decoders differ in their pixels (IDCT and chroma upsampling),
not in the resampling, which is bit for bit the same on both devices.

Bilinear is the opt-in fast lane, as in the JAX package: PIL bicubic stays
the default pipeline everywhere.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from bayesvlm_tpu_torch import kernels


class _TarEntry(ctypes.Structure):
    # 257 bytes: the longest ustar path (155 prefix + '/' + 100 name) and
    # its NUL, as csrc/host_io.cc
    _fields_ = [
        ("name", ctypes.c_char * 257),
        ("offset", ctypes.c_uint64),
        ("size", ctypes.c_uint64),
    ]


@functools.cache
def _host_io() -> ctypes.CDLL:
    lib = kernels.load_host("host_io")
    lib.bvt_tar_index.restype = ctypes.c_long
    lib.bvt_tar_index.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.POINTER(_TarEntry))]
    lib.bvt_free_index.argtypes = [ctypes.POINTER(_TarEntry)]
    lib.bvt_pread.restype = ctypes.c_int
    lib.bvt_pread.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                              ctypes.POINTER(ctypes.c_uint8)]
    return lib


@functools.cache
def _jpeg_cpu() -> ctypes.CDLL:
    lib = kernels.load_host("jpeg_cpu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_jpeg_decode_cpu.restype = i
    lib.bvt_jpeg_decode_cpu.argtypes = [p, p, i, p, p, p, p, i]
    lib.bvt_jpeg_planes_cpu.restype = i
    lib.bvt_jpeg_planes_cpu.argtypes = [p, p, i, p, p, p, i]
    lib.bvt_jpeg_free.argtypes = [p]
    return lib


@functools.cache
def _jpeg_cuda() -> ctypes.CDLL:
    lib = kernels.load("jpeg_decode")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bvt_jpeg_info.restype = i
    lib.bvt_jpeg_info.argtypes = [p, p, i, p, p]
    lib.bvt_jpeg_decode.restype = i
    lib.bvt_jpeg_decode.argtypes = [p, p, i, p, p, p, p]
    lib.bvt_ycc_to_rgb.restype = i
    lib.bvt_ycc_to_rgb.argtypes = [p, i, ctypes.c_int64, p]
    lib.bvt_resize_crop.restype = i
    lib.bvt_resize_crop.argtypes = [p, i, i, i, p, p, p, p, p]
    return lib


def available() -> bool:
    """Whether the tar reader's library is built (the JAX package's test)."""
    return kernels.host_library_path("host_io").exists()


def prepare(device="cuda") -> None:
    """Build (where missing) and load the tar reader and the decoder of
    `device`: libjpeg's for the CPU, nvJPEG and the kernel for the card.
    Raises with the reason: no card, no `jpeglib.h`, a failed build."""
    _host_io()
    if resolve_device(device).type == "cpu":
        _jpeg_cpu()
    else:
        _jpeg_cuda()


def build(device="cpu") -> bool:
    """`prepare(device)`; returns success (the JAX package's `build`)."""
    try:
        prepare(device)
        return True
    except Exception:
        return False


def tar_index(path) -> List[Tuple[str, int, int]]:
    lib = _host_io()
    out = ctypes.POINTER(_TarEntry)()
    n = lib.bvt_tar_index(str(path).encode(), ctypes.byref(out))
    if n < 0:
        raise IOError(f"cannot index tar {path}")
    try:
        return [(out[i].name.decode(), int(out[i].offset), int(out[i].size))
                for i in range(n)]
    finally:
        lib.bvt_free_index(out)


def read_member(path, offset: int, size: int) -> bytes:
    buf = (ctypes.c_uint8 * size)()
    rc = _host_io().bvt_pread(str(path).encode(), offset, size, buf)
    if rc != 0:
        raise IOError(f"pread failed ({rc}) on {path}")
    return bytes(buf)


def _bitstreams(jpegs: Sequence[bytes]):
    """ctypes arrays of the JPEGs' addresses and lengths (no copy: each
    points into its bytes object, which the caller keeps alive)."""
    jpegs = [j if isinstance(j, bytes) else bytes(j) for j in jpegs]
    n = len(jpegs)
    return jpegs, (ctypes.c_char_p * n)(*jpegs), (ctypes.c_uint64 * n)(*map(len, jpegs))


def resolve_device(device) -> torch.device:
    """The lane's device: "cpu", or a card (its index filled in); raises
    where there is no card, or for another device type."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the card's decode lane (nvJPEG and "
                               "resize_crop) needs one; pass device='cpu' for the "
                               "CPU lane")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"no native decode lane for device {device}")
    return device


class Planes(NamedTuple):
    """One decoded JPEG before its colour stage: luma [h, w] and, for a
    colour image, chroma [ch, cw] at its stored resolution with its
    subsampling factors (hf, vf); cb = cr = None and hf = vf = 0 for grey."""

    y: torch.Tensor
    cb: Optional[torch.Tensor]
    cr: Optional[torch.Tensor]
    hf: int
    vf: int


def _planes_of(flat: torch.Tensor, dims: np.ndarray, offsets, status) -> List[Optional[Planes]]:
    out: List[Optional[Planes]] = []
    for i, (w, h, cw, ch, hf, vf) in enumerate(dims.tolist()):
        if status[i] != 0:
            out.append(None)
            continue
        buf = flat[int(offsets[i]):int(offsets[i + 1])]
        y = buf[:w * h].view(h, w)
        if hf == 0:
            out.append(Planes(y, None, None, 0, 0))
            continue
        cb = buf[w * h:w * h + cw * ch].view(ch, cw)
        cr = buf[w * h + cw * ch:w * h + 2 * cw * ch].view(ch, cw)
        out.append(Planes(y, cb, cr, hf, vf))
    return out


def decode_planes(jpegs: Sequence[bytes], device="cuda", num_threads: int = 8):
    """Decode JPEG bytes to their planes, before any colour stage ->
    ([Planes on `device`, None where the decode failed], [n] int32
    statuses). The card: nvJPEG (NVJPEG_OUTPUT_UNCHANGED) on the current
    stream into one buffer; the CPU: libjpeg's raw data over `num_threads`
    threads."""
    device = resolve_device(device)
    jpegs, datas, lens = _bitstreams(jpegs)
    n = len(jpegs)
    status = np.zeros(n, np.int32)
    dims = np.zeros((n, 6), np.int32)
    ptr = lambda a: a.ctypes.data  # noqa: E731
    if device.type == "cpu":
        lib = _jpeg_cpu()
        bufs = (ctypes.c_void_p * n)()
        lib.bvt_jpeg_planes_cpu(datas, lens, n, bufs, ptr(dims), ptr(status), num_threads)
        sizes = [int(w * h + 2 * cw * ch) if status[i] == 0 else 0
                 for i, (w, h, cw, ch, _, _) in enumerate(dims.tolist())]
        flat = np.empty(sum(sizes), np.uint8)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        for i in range(n):
            if status[i] == 0:
                flat[offsets[i]:offsets[i + 1]] = np.frombuffer(
                    (ctypes.c_uint8 * sizes[i]).from_address(bufs[i]), np.uint8)
                lib.bvt_jpeg_free(bufs[i])
        return _planes_of(torch.from_numpy(flat), dims, offsets, status), status

    lib = _jpeg_cuda()
    with torch.cuda.device(device):
        kernels.check(lib, lib.bvt_jpeg_info(datas, lens, n, ptr(dims), ptr(status)),
                      "nvJPEG image info")
        d = dims.astype(np.int64)
        sizes = d[:, 0] * d[:, 1] + 2 * d[:, 2] * d[:, 3]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        flat = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
        outs = (ctypes.c_void_p * n)(*[flat.data_ptr() + int(o) for o in offsets[:-1]])
        stream = torch.cuda.current_stream(device).cuda_stream
        kernels.check(lib, lib.bvt_jpeg_decode(datas, lens, n, outs, ptr(dims), ptr(status),
                                               stream), "nvJPEG decode")
    return _planes_of(flat, dims, offsets, status), status


def decode_rgb(jpegs: Sequence[bytes], device="cuda", num_threads: int = 8):
    """Decode JPEG bytes -> ([h, w, 3] uint8 RGB tensors on `device`, None
    where the decode failed; [n] int32 statuses). The card: nvJPEG's planes
    (`decode_planes`), then `ycc_to_rgb`'s kernel, libjpeg's colour stage,
    into one buffer (the images are views of it); the CPU: libjpeg over
    `num_threads` threads, JCS_RGB (the JAX lane's decode)."""
    device = resolve_device(device)
    if device.type == "cuda":
        planes, status = decode_planes(jpegs, device, num_threads)
        return ycc_to_rgb(planes), status
    jpegs, datas, lens = _bitstreams(jpegs)
    n = len(jpegs)
    status = np.zeros(n, np.int32)
    w = np.zeros(n, np.int32)
    h = np.zeros(n, np.int32)
    ptr = lambda a: a.ctypes.data  # noqa: E731
    lib = _jpeg_cpu()
    rgbs = (ctypes.c_void_p * n)()
    lib.bvt_jpeg_decode_cpu(datas, lens, n, rgbs, ptr(w), ptr(h), ptr(status), num_threads)
    out: List[Optional[torch.Tensor]] = []
    for i in range(n):
        if status[i] != 0:
            out.append(None)
            continue
        buf = (ctypes.c_uint8 * int(w[i] * h[i] * 3)).from_address(rgbs[i])
        out.append(torch.from_numpy(np.frombuffer(buf, np.uint8).reshape(
            int(h[i]), int(w[i]), 3).copy()))
        lib.bvt_jpeg_free(rgbs[i])
    return out, status


def _fix16(x: float) -> int:
    """libjpeg's FIX(x): x in 16-bit fixed point, rounded."""
    return int(x * 65536.0 + 0.5)


def _upsample_reference(c: torch.Tensor, h: int, w: int, hf: int, vf: int) -> torch.Tensor:
    """[ch, cw] chroma -> [h, w] int64 as libjpeg-turbo's jdsample.c with
    fancy upsampling (the edges repeat the edge sample)."""
    ch, cw = c.shape
    c = c.to(torch.int64)
    ys = torch.arange(h, device=c.device)
    xs = torch.arange(w, device=c.device)
    odd_y, odd_x = (ys & 1).view(h, 1), (xs & 1).view(1, w)
    j = ys >> 1
    nb = torch.where(ys & 1 == 1, torch.clamp(j + 1, max=ch - 1), torch.clamp(j - 1, min=0))
    i = xs >> 1
    k = torch.where(xs & 1 == 1, torch.clamp(i + 1, max=cw - 1), torch.clamp(i - 1, min=0))
    if hf == 2 and vf == 2 and cw > 2:  # h2v2_fancy_upsample
        colsum = 3 * c[j] + c[nb]  # [h, cw]
        return (3 * colsum[:, i] + colsum[:, k] + 8 - odd_x) >> 4
    if hf == 2 and vf == 1 and cw > 2:  # h2v1_fancy_upsample
        return (3 * c[:h][:, i] + c[:h][:, k] + 1 + odd_x) >> 2
    if hf == 1 and vf == 2:  # h1v2_fancy_upsample
        return (3 * c[j][:, :w] + c[nb][:, :w] + 1 + odd_y) >> 2
    rows = torch.clamp(ys // vf, max=ch - 1)
    cols = torch.clamp(xs // hf, max=cw - 1)
    return c[rows][:, cols]  # replication


def ycc_to_rgb_reference(planes) -> List[Optional[torch.Tensor]]:
    """The plain version of `ycc_to_rgb`: each image's planes (None: a
    failed decode) -> [h, w, 3] uint8 RGB, libjpeg-turbo 2.1's colour stage
    in int64: chroma upsampled as jdsample.c (fancy), then jdcolor.c's
    ycc_rgb_convert with its fixed-point tables, clamped to [0, 255]; grey
    gives R = G = B = Y."""
    out: List[Optional[torch.Tensor]] = []
    for pl in planes:
        if pl is None:
            out.append(None)
            continue
        h, w = pl.y.shape
        if pl.hf == 0:
            out.append(pl.y.unsqueeze(-1).expand(h, w, 3).contiguous())
            continue
        luma = pl.y.to(torch.int64)
        cb = _upsample_reference(pl.cb, h, w, pl.hf, pl.vf) - 128
        cr = _upsample_reference(pl.cr, h, w, pl.hf, pl.vf) - 128
        r = luma + ((_fix16(1.40200) * cr + 32768) >> 16)
        g = luma + ((-_fix16(0.34414) * cb + 32768 - _fix16(0.71414) * cr) >> 16)
        b = luma + ((_fix16(1.77200) * cb + 32768) >> 16)
        out.append(torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8))
    return out


def ycc_to_rgb(planes) -> List[Optional[torch.Tensor]]:
    """Each image's planes (None: failed) -> [h, w, 3] uint8 RGB, as
    `ycc_to_rgb_reference`. CPU planes take the plain version; planes on
    the card launch ycc_rgb_kernel (csrc/jpeg_decode.cu) on the current
    stream into one buffer (the images are views of it), counted in
    `ycc_to_rgb.launches`, or raise."""
    present = [p for p in planes if p is not None]
    devices = {p.y.device for p in present}
    if len(devices) > 1:
        raise ValueError(f"planes on several devices: {sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    if device.type == "cpu":
        return ycc_to_rgb_reference(planes)
    if device.type != "cuda":
        raise ValueError(f"no ycc_to_rgb kernel for device {device}")
    launch, rgbs = ycc_to_rgb_launcher(planes, device)
    launch()
    if present:
        ycc_to_rgb.launches += 1
    return rgbs


ycc_to_rgb.launches = 0


def ycc_to_rgb_launcher(planes, device: torch.device):
    """(launch, rgbs) for planes on the card: `launch()` runs ycc_rgb_kernel
    on the current stream into `rgbs` and nothing else (no allocation, no
    copy, no count), so it can be captured in a CUDA graph and timed alone."""
    for p in planes:
        if p is not None and not all(t is None or (t.dtype == torch.uint8
                                                   and t.is_contiguous())
                                     for t in (p.y, p.cb, p.cr)):
            raise ValueError("ycc_to_rgb: planes must be contiguous uint8")
    lib = _jpeg_cuda()
    n = len(planes)
    pixels = np.asarray([p.y.numel() if p is not None else 0 for p in planes], np.int64)
    offsets = np.concatenate([[0], np.cumsum(pixels * 3)])
    with torch.cuda.device(device):
        flat = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
        # each image's planes, output, sizes and factors: one pinned [10, n]
        # block, one asynchronous copy
        meta = torch.zeros(10, n, dtype=torch.int64, pin_memory=True)
        m = meta.numpy()
        for i, p in enumerate(planes):
            if p is None:
                continue
            colour = p.hf > 0
            m[:, i] = [p.y.data_ptr(), p.cb.data_ptr() if colour else 0,
                       p.cr.data_ptr() if colour else 0, flat.data_ptr() + int(offsets[i]),
                       p.y.shape[1], p.y.shape[0], p.cb.shape[1] if colour else 0,
                       p.cb.shape[0] if colour else 0, p.hf, p.vf]
        meta = meta.to(device, non_blocking=True)
    rgbs = [flat[int(offsets[i]):int(offsets[i + 1])].view(*p.y.shape, 3)
            if p is not None else None for i, p in enumerate(planes)]
    max_pixels = int(pixels.max()) if n else 0

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.bvt_ycc_to_rgb(meta.data_ptr(), n, max_pixels, stream)
        kernels.check(lib, err, "ycc_to_rgb kernel")

    return launch, rgbs


def _full(value: float, shape, device) -> torch.Tensor:
    # a divisor as a tensor, never a Python scalar: PyTorch's CUDA division
    # by a scalar multiplies by its reciprocal, which rounds differently
    return torch.full(shape, value, dtype=torch.float32, device=device)


def _sample_axis(S: int, length: int, square: bool, scale, offset, device):
    """Source coordinates of the S output positions on one axis, clamped as
    bilinear() clamps them: (index0, index1, fraction), float32 op for op
    as native/bvt_io.cc:196-258."""
    idx = torch.arange(S, dtype=torch.float32, device=device)
    if square:  # (xx + 0.5f) * w / S - 0.5f
        s = (idx + 0.5) * float(length) / _full(float(S), (S,), device) - 0.5
    else:  # (xx + ox + 0.5f) * scale - 0.5f
        s = ((idx + offset) + 0.5) * scale - 0.5
    lim = _full(float(length), (1,), device) - _full(1.001, (1,), device)
    s = torch.where(lim < s, lim, s)  # std::min(x, lim)
    s = torch.where(0.0 < s, s, torch.zeros_like(s))  # std::max(0.0f, x)
    i0 = s.to(torch.int64)  # truncation (s >= 0)
    return i0, torch.clamp(i0 + 1, max=length - 1), s - i0.to(torch.float32)


def sample_grid(h: int, w: int, size: int, square_resize: bool = False,
                device="cpu"):
    """Where each output pixel of one [h, w] source samples it: ((y0, y1,
    fy), (x0, x1, fx)), each [size], as process_one places the crop
    (shorter side to `size` and the centre, or a square resize) and
    bilinear() clamps it; the plain version's and the kernel's grid."""
    S = size
    scale = ox = oy = None
    if not square_resize:  # shorter side to S, centre crop
        fS = _full(float(S), (1,), device)
        scale = _full(float(w if w <= h else h), (1,), device) / fS
        ox = (_full(float(w), (1,), device) / scale - fS) * 0.5
        oy = (_full(float(h), (1,), device) / scale - fS) * 0.5
    return (_sample_axis(S, h, square_resize, scale, oy, device),
            _sample_axis(S, w, square_resize, scale, ox, device))


def resize_crop_reference(rgb_list, size: int, square_resize: bool = False,
                          mean: Sequence[float] = (0.0, 0.0, 0.0),
                          std: Sequence[float] = (1.0, 1.0, 1.0),
                          out_uint8: bool = False) -> torch.Tensor:
    """The plain version of `resize_crop`: [h, w, 3] uint8 RGB images (None:
    a failed decode, zeros) -> [n, size, size, 3] uint8 (+0.5, clamp,
    truncate) or fp32 ((px / 255 - mean) / std) crops, in float32
    throughout, scalars included, each operation rounded on its own as in
    process_one and bilinear() (native/bvt_io.cc:173-258)."""
    S = size
    present = [r for r in rgb_list if r is not None]
    device = present[0].device if present else torch.device("cpu")
    dtype = torch.uint8 if out_uint8 else torch.float32
    out = torch.zeros(len(rgb_list), S, S, 3, dtype=dtype, device=device)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device).view(1, 1, 3)
    std_t = torch.tensor(std, dtype=torch.float32, device=device).view(1, 1, 3)
    for i, rgb in enumerate(rgb_list):
        if rgb is None:
            continue
        (y0, y1, fy), (x0, x1, fx) = sample_grid(int(rgb.shape[0]), int(rgb.shape[1]),
                                                 S, square_resize, device)
        src = rgb.to(torch.float32)
        r0, r1 = src[y0], src[y1]  # [S, w, 3]
        p00, p01, p10, p11 = r0[:, x0], r0[:, x1], r1[:, x0], r1[:, x1]
        fx, fy = fx.view(1, S, 1), fy.view(S, 1, 1)
        a = p00 + (p01 - p00) * fx
        b = p10 + (p11 - p10) * fx
        px = a + (b - a) * fy
        if out_uint8:
            v = px + 0.5
            v = torch.where(v < 0.0, torch.zeros_like(v),
                            torch.where(v > 255.0, torch.full_like(v, 255.0), v))
            out[i] = v.trunc().to(torch.uint8)
        else:
            out[i] = (px / _full(255.0, (1, 1, 1), device) - mean_t) / std_t
    return out


def resize_crop(rgb_list, size: int, square_resize: bool = False,
                mean: Sequence[float] = (0.0, 0.0, 0.0),
                std: Sequence[float] = (1.0, 1.0, 1.0),
                out_uint8: bool = False) -> torch.Tensor:
    """[h, w, 3] uint8 RGB images (None: failed, zeros) -> [n, size, size, 3]
    crops, as `resize_crop_reference`. CPU images take the plain version;
    images on the card launch resize_crop_kernel (csrc/jpeg_decode.cu) on
    the current stream, counted in `resize_crop.launches`, or raise."""
    present = [r for r in rgb_list if r is not None]
    for r in present:
        if r.dtype != torch.uint8 or r.dim() != 3 or r.shape[2] != 3:
            raise ValueError(f"images must be [h, w, 3] uint8, not {r.dtype} "
                             f"{tuple(r.shape)}")
    if not all(r.is_contiguous() for r in present):
        raise ValueError("resize_crop: images must be contiguous")
    devices = {r.device for r in present}
    if len(devices) > 1:
        raise ValueError(f"images on several devices: {sorted(map(str, devices))}")
    device = devices.pop() if devices else torch.device("cpu")
    if device.type == "cpu":
        return resize_crop_reference(rgb_list, size, square_resize, mean, std, out_uint8)
    if device.type != "cuda":
        raise ValueError(f"no resize_crop kernel for device {device}")

    launch, out = resize_crop_launcher(rgb_list, size, square_resize, mean, std,
                                       out_uint8, device)
    launch()
    if len(rgb_list):
        resize_crop.launches += 1
    return out


def resize_crop_launcher(rgb_list, size: int, square_resize: bool, mean, std,
                         out_uint8: bool, device: torch.device):
    """(launch, out) for card images: `launch()` runs resize_crop_kernel on
    the current stream into `out` and nothing else (no allocation, no copy,
    no count), so it can be captured in a CUDA graph and timed alone."""
    lib = _jpeg_cuda()
    n = len(rgb_list)
    with torch.cuda.device(device):
        # each source's address, width and height: one pinned [3, n] block,
        # one asynchronous copy
        meta = torch.empty(3, n, dtype=torch.int64, pin_memory=True)
        meta.numpy()[:] = [[r.data_ptr() if r is not None else 0 for r in rgb_list],
                           [r.shape[1] if r is not None else 0 for r in rgb_list],
                           [r.shape[0] if r is not None else 0 for r in rgb_list]]
        meta = meta.to(device, non_blocking=True)
        out = torch.empty(n, size, size, 3, device=device,
                          dtype=torch.uint8 if out_uint8 else torch.float32)
    norm = np.asarray([*mean, *std], np.float32)  # read on the host
    f32 = None if out_uint8 else out.data_ptr()
    u8 = out.data_ptr() if out_uint8 else None

    def launch():
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.bvt_resize_crop(meta.data_ptr(), n, size, int(square_resize),
                                      norm.ctypes.data, norm.ctypes.data + 12, f32, u8,
                                      stream)
        kernels.check(lib, err, "resize_crop kernel")

    return launch, out


resize_crop.launches = 0


def decode_batch(jpegs: Sequence[bytes], size: int, mean: Sequence[float],
                 std: Sequence[float], square_resize: bool = False,
                 num_threads: int = 8, device="cuda") -> Tuple[torch.Tensor, np.ndarray]:
    """JPEG bytes -> ([n, size, size, 3] fp32 normalised NHWC on `device`,
    [n] int32 statuses; nonzero = decode failure, its crop zeros).
    `num_threads`: the CPU lane's decode threads (the card decodes in the
    calling thread)."""
    rgbs, status = decode_rgb(jpegs, device, num_threads)
    return resize_crop(rgbs, size, square_resize, mean, std, out_uint8=False), status


def decode_batch_u8(jpegs: Sequence[bytes], size: int, square_resize: bool = False,
                    num_threads: int = 8, device="cuda") -> Tuple[torch.Tensor, np.ndarray]:
    """The uint8 lane: decode, resize and crop without normalising ->
    ([n, size, size, 3] uint8 NHWC on `device`, [n] int32 statuses); the
    image encoder normalises on the device."""
    rgbs, status = decode_rgb(jpegs, device, num_threads)
    return resize_crop(rgbs, size, square_resize, out_uint8=True), status
