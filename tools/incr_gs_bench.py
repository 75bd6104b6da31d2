#!/usr/bin/env python3
"""Build the CUDA kernels, report what the compiler gave K7's tiled cascade,
and time K7 (`fused3d.incr_gs_k`) against its plain version.

    PYTHONPATH=. python3 tools/incr_gs_bench.py [--quick] [--sass] [nx ny nz ...]

Prints the card, the registers / stack frame / spills of every
`incr_gs_tile_kernel` instantiation from the `-Xptxas -v` log, then per
shape (default 258^3 and the drag grid 322 x 130 x 130) and colour list the
maximum error of x', r' and both norms relative to max|plain| and the median
time per call (CUDA events, 20 back-to-back calls, 5 runs).  ``--quick``
does not time the plain versions.  ``--sass`` also disassembles the library
with ``cuobjdump`` and counts, per instantiation, the machine instructions,
barriers and shared and global loads and stores.  The package and
``chip_smoke`` are imported from the working directory, so run from the
root of another checkout (with this file's path) it times that checkout's
kernel: two versions can be compared in turns on one card.  Needs a CUDA
device; imports no JAX.
"""
from __future__ import annotations

import sys

# (label, colours, norms): the main path's 4 colours first
CASES = [("4 colours 1010, norms", [1, 0, 1, 0], True),
         ("3 colours 010", [0, 1, 0], False),
         ("4 colours 0101, norms", [0, 1, 0, 1], True),
         ("2 colours 10, norms", [1, 0], True),
         ("4 colours 0101", [0, 1, 0, 1], False),
         ("K6, norms", [], True)]


def sass_report(lib_path: str, nvcc: str) -> None:
    import collections
    import pathlib
    import re
    import subprocess

    cuobjdump = str(pathlib.Path(nvcc).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        name = fn.split("\n", 1)[0]
        if "incr_gs_tile_kernel" not in name:
            continue
        ops = [m[1] for m in re.finditer(
            r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", fn)]
        hist = collections.Counter(ops)
        keys = ("BAR", "LDS", "STS", "LDG", "STG", "LDGSTS", "FFMA", "FMUL",
                "FADD", "IMAD")
        print(f"sass {name[-40:]}: {len(ops)} instructions, "
              + ", ".join(f"{k} {hist[k]}" for k in keys), flush=True)


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("incr_gs_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from waterlily_tpu_torch.ops import _build
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops.bc import bc_vector

    quick = "--quick" in argv
    dims = [int(a) for a in argv if not a.startswith("--")]
    shapes = ([tuple(dims[k:k + 3]) for k in range(0, len(dims), 3)]
              or [(258, 258, 258), cs.DRAG_GRID])
    print(cs.card_line(), flush=True)
    _build.load()
    for e in _build.ptxas_report(_build.build_info.get("log", "")):
        if "incr_gs" in e["name"]:
            print(f"ptxas {e['name'][-40:]}: {e['registers']} registers, stack "
                  f"{e['stack']} B, spills {e['spill_stores']}/{e['spill_loads']} B",
                  flush=True)
    if "--sass" in argv:
        sass_report(str(_build.build_info["path"]), _build.nvcc_path())
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    worst = 0.0
    for shape in shapes:
        f32 = torch.float32

        def g(scale=1.0):
            a = torch.as_tensor(scale * rng.standard_normal(shape), dtype=f32,
                                device=dev)
            out = torch.zeros_like(a)
            out[1:-1, 1:-1, 1:-1] = a[1:-1, 1:-1, 1:-1]
            return out
        lev = ps.make_level(bc_vector(torch.as_tensor(
            0.2 + rng.random((3,) + shape), dtype=f32, device=dev), (0.0,) * 3))
        x = torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
        r, eps = g(), g(0.3)
        for label, cols, nrm in CASES:
            args = (x, r, eps, lev.L, lev.D, lev.iD, cols, 0.9, nrm)
            got, want = fz.incr_gs_k(*args), fz.incr_gs_plain(*args)
            torch.cuda.synchronize()
            got = [*got[:2], *got[2]] if nrm else list(got)
            want = [*want[:2], *want[2]] if nrm else list(want)
            rel = max(((a - b).abs().max() / b.abs().max()).item()
                      for a, b in zip(got, want))
            worst = max(worst, rel)
            del got, want
            ms = cs.median_ms(torch, lambda: fz.incr_gs_k(*args), 20)
            pms = (float("nan") if quick else
                   cs.median_ms(torch, lambda: fz.incr_gs_plain(*args), 3))
            print(f"{str(shape):16s} {label:24s} rel {rel:.3e}  kernel {ms:.4f} ms"
                  f"  plain {pms:.4f} ms", flush=True)
        del x, r, eps, lev
        torch.cuda.empty_cache()
    print(f"worst relative error {worst:.3e} (limit 1e-5)", flush=True)
    return 0 if worst <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
