"""Build the port's CUDA kernels with a bare ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file exposes ``extern "C"`` host functions that take raw
pointers, ints and a ``cudaStream_t`` and return ``cudaGetLastError()``. One
``nvcc`` command compiles all of them into one shared library; no source
includes PyTorch's headers, so the build takes seconds (PyTorch's own
extension builder needs ninja and minutes per file, and is not used).

The library is built at first use into ``ops/_build/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, and reused while
they are unchanged.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# -fmad=false: no implicit multiply-add contraction, so the kernels round each
# operation as the plain PyTorch versions do (explicit __fmaf_rn still works)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# argtypes of every extern "C" entry point; all return a cudaError_t as int
SIGNATURES = {
    "mft_corr_lookup": [_P, _P, _P, _P, _P, _P] + [_I] * 9 + [_L, _I, _I, _P],
    "mft_corr_lookup_conv": [_P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 9
                            + [_L, _I, _I, _I, _P],
    "mft_chain_select": [_P] * 10 + [_F, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build (or load) that made the library


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmft_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile all kernel sources into one shared library (if not yet built)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
            build_seconds = time.perf_counter() - t0
        return _lib


def check(err: int, name: str):
    """Raise if a kernel's host entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
