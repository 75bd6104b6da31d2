"""Build and load the CUDA kernels of `csrc/`.

The kernels are compiled on first use with `nvcc` into a shared library with
a plain C interface (`-gencode arch=compute_90a,code=sm_90a -shared
-Xcompiler -fPIC`), placed in ``build/`` at the repository root and loaded
with `ctypes`.  The library name carries a hash of the source and flags, so
an edited source is rebuilt and a stale library is never loaded.  Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "nvcc_path", "build", "load"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "stencil3d.cu"
BUILD_DIR = _PKG.parent / "build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    # name: argtypes (restype is int: a cudaError_t)
    "wlt_conv_diff": [_P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
    "wlt_bdim": [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P,
                 _I64, _I64, _I64, _P],
    "wlt_mult": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "wlt_gs_incr": [_P, _P, _P, _P, _P, _P, _P, _P,
                    ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                    ctypes.c_float, _I64, _I64, _I64, _P],
}

_loaded: dict[str, ctypes.CDLL] = {}
build_info: dict[str, object] = {}   # path, seconds and ptxas log of the build


def nvcc_path() -> str:
    """The `nvcc` on PATH, else the one under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libstencil3d-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile `csrc/stencil3d.cu` unless the library for this source is
    already built; returns its path.  Records the time and the compiler's
    register report in `build_info`."""
    out = _lib_path()
    if out.exists():
        build_info.setdefault("path", str(out))
        build_info.setdefault("seconds", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc_path(), *_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    path = str(build())
    lib = _loaded.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.wlt_error_string.argtypes = [ctypes.c_int]
        lib.wlt_error_string.restype = ctypes.c_char_p
        _loaded[path] = lib
    return lib
