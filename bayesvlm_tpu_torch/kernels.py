"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Every source in `csrc/` is compiled by nvcc for sm_90a into a shared
library with a plain C interface, under `build/` beside this package,
and loaded with ctypes. The first use of any kernel builds every source
that has no library yet: one nvcc per source, all started together.

A library's file name carries a hash of its source and of the shared
headers (`csrc/*.cuh`), so an edited source is rebuilt and a stale
library is never loaded. Each library is written under a temporary name
and renamed, so a process that loads while another builds never sees a
half-written file.

A source whose first line is `// link: <flags>` names libraries to link
(`jpeg_decode.cu`: nvJPEG, found in the toolkit's `lib64`, with an rpath
there so that it loads without LD_LIBRARY_PATH).

Each C entry point returns a `cudaError_t` (0 = launched): the
`cudaGetLastError()` after its launches. `check` raises on anything else.

The host sources (`csrc/*.cc`: the tar reader, the CPU JPEG decoder) are
built the same way by g++, one at its first use (`load_host`), into the
same directory, named by the hash of their own source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Tuple

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")


def sources() -> Dict[str, Path]:
    """Kernel name -> its source, one per `csrc/*.cu`."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libbvt_{name}_{digest.hexdigest()[:16]}.so"


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cc").read_bytes())
    return BUILD_DIR / f"libbvt_{name}_{digest.hexdigest()[:16]}.so"


def link_flags(src: Path) -> Tuple[str, ...]:
    """The flags named by the source's first line, `// link: <flags>`."""
    first = src.read_text().split("\n", 1)[0]
    return tuple(first.split(":", 1)[1].split()) if first.startswith("// link:") else ()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def _nvcc_command(src: Path, out: str) -> list:
    nvcc = _nvcc()
    libs = link_flags(src)
    if libs:  # the toolkit's own libraries: its lib64, and an rpath there
        lib64 = Path(nvcc).resolve().parent.parent / "lib64"
        libs = (f"-L{lib64}", "-Xlinker", f"-rpath,{lib64}", *libs)
    return [nvcc, *NVCC_FLAGS, "-o", out, str(src), *libs]


def _host_command(src: Path, out: str) -> list:
    return ["g++", *HOST_FLAGS, "-o", out, str(src), *link_flags(src)]


def _compile(src: Path, lib: Path, command=_nvcc_command) -> float:
    """Build `src` into `lib` under a temporary name, then rename."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        argv = command(src, tmp)
        proc = subprocess.run(argv, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{argv[0]} failed on {src.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def build_all() -> Dict[str, Optional[float]]:
    """Compile every kernel whose library is missing, in parallel; return
    kernel name -> seconds its nvcc took (None: already built)."""
    todo = {name: (src, library_path(name)) for name, src in sources().items()}
    todo = {name: job for name, job in todo.items() if not job[1].exists()}
    seconds: Dict[str, Optional[float]] = dict.fromkeys(sources())
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            futures = {name: pool.submit(_compile, *job) for name, job in todo.items()}
            seconds.update({name: f.result() for name, f in futures.items()})
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The kernel library `name` (building every missing one first)."""
    build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    lib.bvt_error_string.argtypes = [ctypes.c_int]
    lib.bvt_error_string.restype = ctypes.c_char_p
    return lib


def build_host(name: str) -> Optional[float]:
    """Compile `csrc/{name}.cc` with g++ if its library is missing; the
    seconds it took (None: already built). Raises, with the compiler's
    words, when it cannot be built (the CPU decoder needs libjpeg's
    `jpeglib.h`)."""
    lib = host_library_path(name)
    if lib.exists():
        return None
    if shutil.which("g++") is None:
        raise RuntimeError(f"g++ not found: csrc/{name}.cc is built with g++")
    try:
        return _compile(CSRC / f"{name}.cc", lib, _host_command)
    except RuntimeError as e:
        if "jpeglib.h: No such file" in str(e):
            raise RuntimeError(f"csrc/{name}.cc needs libjpeg's headers (jpeglib.h), "
                               "which this machine lacks") from e
        raise


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The host library `name` (building it first if it is missing)."""
    build_host(name)
    return ctypes.CDLL(str(host_library_path(name)))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.bvt_error_string(err).decode())


def records_grad(*tensors) -> bool:
    """Whether autograd records an operation on `tensors` here: grad mode
    on (not `no_grad`, not `inference_mode`) and one of them requires a
    gradient. None entries are skipped."""
    import torch

    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a kernel that has no backward: a
    ctypes launch writes a tensor autograd knows nothing of, so a gradient
    would stop there without a word."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{what} has no backward (nor in the JAX package): run it under "
            "torch.no_grad() / torch.inference_mode(), or with no input "
            "requiring grad")
