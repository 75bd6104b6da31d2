#!/usr/bin/env python3
"""Build the CUDA kernels, report what the compiler gave the conv-diff
instantiations, and time K12, K1 and K12's tangent kernel against their
plain versions.

    PYTHONPATH=. python3 tools/convdiff_bench.py [--quick] [--sass] [nx ny nz ...]

Prints the card (name, power limit, SM clock now and at most), the
registers / stack frame / spills of every conv-diff kernel from the
`-Xptxas -v` log, then per shape (default 258^3 and the drag grid 322 x 130
x 130) and case (every scheme, walled, xyz- and z-periodic; K12's tangent
`conv_diff_jvp_k` against `conv_diff_jvp_plain`) the maximum error
relative to max|plain| and the median time per call (CUDA events, 20
back-to-back calls, 5 runs).  ``--quick`` checks one small and one full
shape without timing the plain versions.  ``--sass`` also disassembles the
library with ``cuobjdump`` and prints, for the walled K12, K1 and tangent
kernels and the fully periodic ones of each scheme, the number of machine
instructions, how many of them lie in the x-march loop (the longest backward branch: a thread runs it once
per cell it owns, so it is the kernel's instructions per cell), the loop's
most frequent opcodes, and the issue-rate bound at 258^3: cells x loop
instructions / 32 lanes over 4 warp schedulers x 132 SMs at the card's
highest SM clock.  The package and ``chip_smoke`` are imported from the
working directory, so run from the root of another checkout (with this
file's path) it times that checkout's kernels: two versions can be compared
in turns on one card.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import sys

SMS, SCHEDULERS, LANES = 132, 4, 32      # H100 SXM: SMs, warp schedulers an SM
TANGENT = ("conv_diff_jvp_tile_kernel", "conv_diff_jvp_kernel")


def sm_clocks() -> tuple[float, float]:
    """The SM clock now and at most, MHz (`nvidia-smi`)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    now, top = out.strip().splitlines()[0].split(",")
    return float(now), float(top)


def sass_report(lib_path: str, nvcc: str, mhz: float) -> None:
    import collections
    import pathlib
    import re
    import subprocess

    cuobjdump = str(pathlib.Path(nvcc).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    cells = 258 ** 3
    for fn in re.split(r"\n\s*Function : ", out)[1:]:
        name = fn.split("\n", 1)[0]
        tile = "conv_diff_tile_kernel" in name and re.search(
            r"ILi\dELi[07]ENS_8StoreRhs|ILi\dELi0ENS_12BdimEpilogue", name)
        # K12's tangent: the tile, or the one-thread kernel of a checkout
        # before it (no loop: its instructions are per (cell, component))
        tangent = any(k in name for k in TANGENT) and re.search(
            r"ILi\d(ELi[07])?EE", name)
        if not (tile or tangent):
            continue
        ins = [(int(m[1], 16), m[2]) for m in re.finditer(
            r"/\*([0-9a-f]{4,5})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);", fn)]
        jumps = [(int(m[1], 16), int(m[2], 16)) for m in re.finditer(
            r"/\*([0-9a-f]{4,5})\*/\s+(?:@!?U?P\d+\s+)?BRA(?:\.\w+)* (?:\w+, )?0x([0-9a-f]+)",
            fn)]
        back = max(((a - t, t, a) for a, t in jumps if t < a), default=(0, 0, 0))
        loop = [op for a, op in ins if back[1] <= a <= back[2]]
        hist = collections.Counter(op.split(".")[0] for op in loop)
        # the one-thread tangent kernel runs its whole body once per (cell,
        # component); the tiles run their loop once per cell
        per_cell = 3 * len(ins) if TANGENT[1] in name else len(loop)
        bound = cells * per_cell / LANES / (SCHEDULERS * SMS * mhz * 1e6) * 1e3
        print(f"sass {name[-62:]}: {len(ins)} instructions, {len(loop)} in the "
              f"loop: {dict(hist.most_common(12))}; ~{per_cell} a cell, issue "
              f"bound at 258^3 {bound:.3f} ms at {mhz:.0f} MHz", flush=True)


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("convdiff_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from waterlily_tpu_torch.ops import _build
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import stencil3d as st

    quick = "--quick" in argv
    dims = [int(a) for a in argv if not a.startswith("--")]
    shapes = [tuple(dims[k:k + 3]) for k in range(0, len(dims), 3)] or (
        [(12, 10, 7), (258, 258, 258)] if quick
        else [(258, 258, 258), (322, 130, 130)])
    now, top = sm_clocks()
    print(f"{cs.card_line()}; SM clock {now:.0f} MHz now, {top:.0f} MHz at most",
          flush=True)
    _build.load()
    for e in _build.ptxas_report(_build.build_info.get("log", "")):
        if "conv_diff" in e["name"]:
            print(f"ptxas {e['name'][-60:]}: {e['registers']} registers, stack "
                  f"{e['stack']} B, spills {e['spill_stores']}/{e['spill_loads']} B",
                  flush=True)
    if "--sass" in argv:
        sass_report(str(_build.build_info["path"]), _build.nvcc_path(), top)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    nu, dnu = torch.tensor(0.03, device=dev), torch.tensor(-0.4, device=dev)
    worst = 0.0
    for shape in shapes:
        u, u0 = (torch.as_tensor(rng.standard_normal((3,) + shape),
                                 dtype=torch.float32, device=dev) for _ in range(2))
        lo, hi = shape[0] // 3, 2 * shape[0] // 3
        cases = []
        for sid, sch in enumerate(st.SCHEMES):
            for per in ((), (0, 1, 2), (2,)):
                cases.append((f"K12' {sch.__name__} per={''.join(map(str, per)) or '-'}",
                              lambda sid=sid, per=per: st.conv_diff_jvp_k(
                                  u, u0, nu, dnu, sid, per),
                              lambda sch=sch, per=per: st.conv_diff_jvp_plain(
                                  u, u0, nu, dnu, sch, per)))
            for per in ((), (0, 1, 2), (2,)):
                cases.append((f"K12 {sch.__name__} per={''.join(map(str, per)) or '-'}",
                              lambda sid=sid, per=per: st.conv_diff_k(u, nu, sid, per),
                              lambda sch=sch, per=per: st.conv_diff_plain(u, nu, sch, per)))
            for rows in ((lo, hi), None):
                def k1(sid=sid, rows=rows):
                    un, f = fz.conv_diff_bdim_k(u, u0, nu, 0.3, 1.0, 0.5, sid, rows)
                    return un, f[:, slice(*(rows or (0, None)))]

                def p1(sch=sch, rows=rows):
                    un, f = fz.conv_diff_bdim_plain(u, u0, nu, 0.3, 1.0, 0.5, sch)
                    return un, f[:, slice(*(rows or (0, None)))]
                cases.append((f"K1 {sch.__name__} f_rows={rows}", k1, p1))
        for label, kern, plain in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
            worst = max(worst, rel)
            del got, want
            ms = cs.median_ms(torch, kern, 20)
            pms = float("nan") if quick else cs.median_ms(torch, plain, 3)
            print(f"{str(shape):16s} {label:34s} rel {rel:.3e}  kernel {ms:.4f} ms  "
                  f"plain {pms:.4f} ms", flush=True)
        del u, u0
        torch.cuda.empty_cache()
    print(f"worst relative error {worst:.3e} (limit 2e-5)", flush=True)
    return 0 if worst <= 2e-5 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
