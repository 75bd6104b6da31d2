"""Build and load the CUDA kernels of `csrc/`.

The kernels are compiled on first use with `nvcc`, one process per source,
all started together (`-gencode arch=compute_90a,code=sm_90a -Xcompiler
-fPIC -c`), then linked into one shared library with a plain C interface,
placed in ``build/`` at the repository root and loaded with `ctypes`.  The
library name carries a hash of every source, the shared headers and the
flags, so a process started after a source was edited rebuilds it and never
loads a stale library.  The compiler's resource report (`-Xptxas -v`) is kept
beside the library and parsed by `ptxas_report`.  Nothing is built or loaded
at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "nvcc_path", "build", "load", "ptxas_report"]

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "stencil3d.cu", _PKG / "csrc" / "fused3d.cu",
           _PKG / "csrc" / "probe.cu", _PKG / "csrc" / "convdiff_jvp.cu")
_HEADERS = (_PKG / "csrc" / "stencil_common.cuh",
            _PKG / "csrc" / "convdiff_tile.cuh",
            _PKG / "csrc" / "rb_cascade.cuh")
BUILD_DIR = _PKG.parent / "build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
# every `extern "C"` entry of `csrc/*.cu`: name -> (restype, argtypes).  The
# argtypes must be declared: without them ctypes passes a Python int as a
# 32-bit int and cuts a pointer (`tests/test_torch_binding.py` holds this
# table against the sources)
_SIGNATURES = {
    "wlt_error_string": (ctypes.c_char_p, [_I]),
    "wlt_conv_diff": (_I, [_P, _P, _P, _I64, _I64, _I64, _I, _I, _P]),
    "wlt_conv_diff_jvp": (_I, [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P]),
    "wlt_bdim": (_I, [_P, _P, _P, _P, _P, _P, _F, _P, _I64, _I64, _I64, _P]),
    "wlt_mult": (_I, [_P, _P, _P, _P, _I64, _I64, _I64, _P]),
    "wlt_bdim_band": (_I, [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _P,
                           _I64, _I64, _I64, _P]),
    "wlt_gs_incr_route": (_I, [_I64, _I64, _I64, _I, _I]),
    "wlt_gs_incr": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _F, _I,
                         _I64, _I64, _I64, _P]),
    "wlt_gauss_sweeps_route": (_I, [_I64, _I64, _I64, _I, _I]),
    "wlt_gauss_sweeps": (_I, [_P, _P, _P, _P, _P, _IP, _I, _IP, _I, _I,
                              _I64, _I64, _I64, _P]),
    "wlt_incr_gs_route": (_I, [_I64, _I64, _I64, _I, _I]),
    "wlt_incr_gs_partials": (_I64, [_I64, _I64, _I64, _I, _I, _I]),
    "wlt_conv_diff_bdim": (_I, [_P, _P, _P, _F, _F, _F, _I, _I, _P, _P,
                                _I64, _I64, _I64, _I, _P]),
    "wlt_bc_div": (_I, [_P, _F, _F, _F, _P, _P, _I64, _I64, _I64, _P]),
    "wlt_projbc": (_I, [_P, _P, _P, _F, _F, _F, _I, _P, _P, _I64, _I64, _I64,
                        _P]),
    "wlt_bc": (_I, [_P, _F, _F, _F, _I, _P, _I64, _I64, _I64, _P]),
    "wlt_div": (_I, [_P, _P, _I64, _I64, _I64, _P]),
    "wlt_incr_gs": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _P, _IP, _I, _F, _P,
                         _P, _I, _I64, _I64, _I64, _P]),
    "wlt_copy_scale": (_I, [_P, _P, _I64, _I, _P]),
    "wlt_copy_scale6": (_I, [_PP, _PP, _I64, _I, _P]),
    "wlt_copy_scale_loop": (_I, [_P, _P, _I64, _I, _I, _P]),
}
# the mixed-precision instantiations take the arguments of the float32 ones
_SIGNATURES["wlt_gs_incr_mp"] = _SIGNATURES["wlt_gs_incr"]
_SIGNATURES["wlt_incr_gs_mp"] = _SIGNATURES["wlt_incr_gs"]

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
    h = hashlib.sha1(b"".join(p.read_bytes() for p in (*SOURCES, *_HEADERS))
                     + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libwlt-{h.hexdigest()[:12]}.so"


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> Path:
    """Compile the sources of `csrc/` (one `nvcc` each, in parallel) and
    link them into one library, unless the library for these sources is
    already built; returns its path.  Records the time and the compiler's
    register report in `build_info`."""
    out = _lib_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        build_info.setdefault("path", str(out))
        build_info.setdefault("seconds", 0.0)
        if log_path.exists():
            build_info.setdefault("log", log_path.read_text())
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / (src.stem + ".o")) for src in SOURCES]
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(
                _run, [[nvcc, *_FLAGS, "-c", "-o", o, str(src)]
                       for src, o in zip(SOURCES, objs)]))
        lib = str(Path(tmp) / "lib.so")
        logs.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", lib, *objs]))
        log_path.write_text("".join(logs))
        os.replace(lib, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      log="".join(logs))
    return out


_PTXAS_FN = re.compile(r"Function properties for (\S+)\s*\n\s*(\d+) bytes stack "
                       r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
                       r"\s*\n.*?Used (\d+) registers", re.S)


def ptxas_report(log: str) -> list[dict[str, object]]:
    """The entries of a `-Xptxas -v` log: the mangled name, stack frame and
    spill bytes and registers of each compiled function."""
    return [dict(name=m[1], stack=int(m[2]), spill_stores=int(m[3]),
                 spill_loads=int(m[4]), registers=int(m[5]))
            for m in _PTXAS_FN.finditer(log)]


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library, once per process: every
    wrapper call goes through here, and hashing the sources from disk on
    each call would cost the host more than a launch."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
