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

Each C entry point returns a `cudaError_t` (0 = launched): the
`cudaGetLastError()` after its launches. `check` raises on anything else.
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
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def sources() -> Dict[str, Path]:
    """Kernel name -> its source, one per `csrc/*.cu`."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libbvt_{name}_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the kernels are built with the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def _compile(src: Path, lib: Path) -> float:
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n"
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
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.bvt_error_string(err).decode())
