"""Build the port's CUDA kernels with a bare ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` file exposes ``extern "C"`` host functions that take raw
pointers, ints and a ``cudaStream_t`` and return ``cudaGetLastError()``. One
bare ``nvcc -c`` per source, all started together, compiles them; one more
``nvcc`` links the objects into one shared library. No source includes
PyTorch's headers, so the build takes seconds (``torch.utils.cpp_extension``
needs ninja and minutes per file, and is not used).

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
# operation as the plain PyTorch versions do (explicit __fmaf_rn still works;
# tensor-core instructions are not touched);
# -Xptxas=-v: registers, shared memory and spills of each kernel, kept in
# ``build_log``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float
# argtypes of every extern "C" entry point; all return a cudaError_t as int
SIGNATURES = {
    "mft_corr_lookup": [_P, _P, _P, _P, _P, _P] + [_I] * 9 + [_L, _I, _I, _P],
    "mft_corr_lookup_bwd": [_P] * 6 + [_I] * 9 + [_L, _I, _I, _P],
    "mft_corr_lookup_conv": [_P] * 8 + [_I] * 9 + [_L, _I, _I, _P],
    "mft_corr_lookup_conv_tc": [_P] * 8 + [_I] * 9 + [_L, _I, _I, _P],
    "mft_chain_select": [_P] * 10 + [_F, _I, _I, _I, _I, _P],
    "mft_corr_alt": [_P] * 7 + [_I] * 14 + [_F, _I, _P],
    "mft_corr_win": [_P] * 7 + [_I] * 14 + [_F, _I, _P, _P],
    "mft_corr_lookup_q": [_P] * 7 + [_I] * 12 + [_P],
    "mft_corr_lookup_packed": [_P] * 3 + [_I] * 15 + [_P],
    "mft_corr_lookup_packed_i8": [_P] * 4 + [_I] * 14 + [_P],
    "mft_corr_lookup_t": [_P] * 6 + [_I] * 13 + [_P],
    "mft_corr_lookup_t_counts": [_P, _I],
    "mft_corr_lookup_folded": [_P] * 6 + [_I] * 17 + [_P],
    "mft_corr_lookup_mixed": [_P] * 6 + [_I] * 13 + [_P],
    "mft_corr_build_folded": [_P] * 9 + [_I] * 8 + [_F, _P],
    "mft_corr_build_folded_tc": [_P] * 9 + [_I] * 9 + [_F, _P],
    "mft_conv": [_P] * 4 + [_L] * 4 + [_I] * 11 + [_P],
    "mft_conv_tc": [_P] * 4 + [_L] * 4 + [_I] * 13 + [_P],
    "mft_warp": [_P] * 4 + [_I] * 4 + [_L] * 6 + [_I] * 3 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build (or load) that made the library
build_log = ""        # nvcc's messages of the build that made the library


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
    """The library's path, keyed by the flags and every source and header."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmft_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands at once; raise with the output of the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile all kernel sources into one shared library (if not yet built)."""
    global build_log
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        build_log = log_path.read_text() if log_path.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = out.with_suffix(f".{tag}")
    nvcc = find_nvcc()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                        for src, obj in zip(sources(), objs)])
        log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        log_path.write_text(log)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log = log
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
