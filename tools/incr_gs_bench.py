#!/usr/bin/env python3
"""Build the CUDA kernels, report what the compiler gave K7's tiled cascade,
and time K7 (`fused3d.incr_gs_k`) against its plain version.

    PYTHONPATH=. python3 tools/incr_gs_bench.py [--quick] [--sass] [--mp] [nx ny nz ...]

Prints the card, the registers / stack frame / spills of every
`incr_gs_tile_kernel` instantiation from the `-Xptxas -v` log, then per
shape (default 258^3 and the drag grid 322 x 130 x 130; with ``--mp`` also
130^3 and 66^3) and colour list the maximum error of x', r' and both norms
relative to max|plain| and the median time per call (CUDA events, 20
back-to-back calls, 5 runs) and the device time alone (the calls queued
behind a spin of the card, `smoother_bench.device_ms`), of the wrapper (the
route it picks) and, where the package has the forced-route entry, of each
route forced.  ``--mp`` times the bf16 form (``mp=True`` on the level's
bf16 coefficients; errors: x and the norms relative to max|plain|, r
relative to 2^-8, both met bit for bit) instead of float32.  ``--quick``
does not time the plain versions.  ``--sass`` also disassembles the library
with ``cuobjdump`` and counts, per instantiation of the cascade (K7, K15,
K13), the machine instructions, barriers and shared and global loads and
stores.  The package and
``chip_smoke`` are imported from the working directory, so run from the
root of another checkout (with this file's path) it times that checkout's
kernel: two versions can be compared in turns on one card.  Needs a CUDA
device; imports no JAX.
"""
from __future__ import annotations

import os
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
        if "_tile_kernel" not in name or "conv_diff" in name:
            continue
        ops = [m[1] for m in re.finditer(
            r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)", fn)]
        hist = collections.Counter(ops)
        keys = ("BAR", "LDS", "STS", "LDG", "STG", "LDGSTS", "FFMA", "FMUL",
                "FADD", "IMAD", "HFMA2", "HMUL2", "HADD2", "F2FP", "PRMT", "BRA")
        print(f"sass {name[-60:]}: {len(ops)} instructions, "
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

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from smoother_bench import device_ms

    quick = "--quick" in argv
    mp = "--mp" in argv
    dims = [int(a) for a in argv if not a.startswith("--")]
    shapes = ([tuple(dims[k:k + 3]) for k in range(0, len(dims), 3)]
              or [(258, 258, 258), cs.DRAG_GRID]
              + ([(130, 130, 130), (66, 66, 66)] if mp else []))
    routed = hasattr(fz, "_incr_gs_launch")          # both routes to force
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
        coef = ps.with_bf16(lev).bf if mp else (lev.L, lev.D, lev.iD)
        x = torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
        r, eps = g(), g(0.3)
        ncol = len(CASES[0][1])
        route = (fz._lib().wlt_incr_gs_route(*shape, ncol, int(mp))
                 if routed else None)
        print(f"{str(shape):16s} {'bf16' if mp else 'float32'}: {ncol} colours "
              f"take the {['per-colour route', 'cascade', '?'][route if routed else 2]}",
              flush=True)
        for label, cols, nrm in CASES:
            if mp and not cols:
                continue                             # K6 has no bf16 form
            args = (x, r, eps, *coef, cols, 0.9, nrm)
            want = fz.incr_gs_plain(*args, mp=mp)
            want = [*want[:2], *want[2]] if nrm else list(want)
            runs = {"auto": lambda args=args: fz.incr_gs_k(*args, mp=mp)}
            if routed and cols:
                runs |= {name: lambda args=args, rt=rt: fz._incr_gs_launch(
                             *args, mp=mp, route=rt)
                         for name, rt in (("cascade", 1), ("per-colour", 0))
                         if rt == 0 or len(cols) <= 4}
            line = [f"{str(shape):16s} {label:24s}"]
            for name, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                got = [*got[:2], *got[2]] if nrm else list(got)
                errs = [((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(got, want)]
                if mp:                   # r to one flipped bf16 rounding
                    errs[1] *= 1e-5 / 2.0 ** -8
                rel = max(errs)
                worst = max(worst, rel)
                del got
                ms = cs.median_ms(torch, fn, 20)
                line.append(f"{name} {ms:.4f} ms, device "
                            f"{device_ms(torch, fn):.4f} (rel {rel:.1e})")
            del want
            pms = (float("nan") if quick else cs.median_ms(
                torch, lambda args=args: fz.incr_gs_plain(*args, mp=mp), 3))
            line.append(f"plain {pms:.4f} ms")
            print("  ".join(line), flush=True)
        del x, r, eps, lev, coef
        torch.cuda.empty_cache()
    print(f"worst relative error {worst:.3e} (limit 1e-5; bf16 r scaled to "
          "2^-8)", flush=True)
    return 0 if worst <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
