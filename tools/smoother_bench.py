#!/usr/bin/env python3
"""Time the red-black smoothers K15 (`stencil3d.gs_incr_k`) and K13
(`stencil3d.gauss_sweeps_k`, periodic in x, y and z and in z alone) with 4
colours (``--it N``: the first N of 1, 0, 1, 0) on both routes, level by
level, against their plain versions.

    PYTHONPATH=. python3 tools/smoother_bench.py [--quick] [--mp] [--it N] [nx ny nz ...]
    PYTHONPATH=. python3 tools/smoother_bench.py --smoke [--mp]

Prints the card, the registers / stack frame / spills of every cascade
instantiation of K15 and K13 from the `-Xptxas -v` log, then per shape
(default: the levels of the 258^3 sphere, 258^3 down to 18^3, and of the
N = 128 drag sphere, 322 x 130 x 130 down to 82 x 34 x 34) and case the
route the launcher picks, the maximum error of each route relative to
max|plain| over every cell, the median time per call of the wrapper (the
route it picks), of each route forced, and of the plain version (CUDA
events, 20 back-to-back calls, 5 runs; for the kernels also the device time
alone, the calls queued behind a spin of the card), and the cascade's
march: blocks,
steps per chunk and chunks per resident block slot.  ``--quick`` does not
time the plain versions.  The package and ``chip_smoke`` are imported from
the working directory, so run from the root of another checkout (with this
file's path) it times that checkout's kernels (the wrapper alone where that
checkout has one route): two versions can be compared in turns on one card.
Exits non-zero if an error exceeds 1e-5.  ``--mp`` times the bf16 K5
(``gs_incr_k(mp=True)`` on the level's bf16 coefficients; K13 has no bf16
form) instead, its r error taken relative to 2^-8 (one flipped bf16
rounding; met bit for bit).  ``--smoke`` times instead the K15 and K13
cases (``--mp``: the bf16 K5 and K7 cases) of that checkout's
``chip_smoke.py`` phase 3 at 258^3, 130^3 and the drag grid, on the route
each takes there (its `BEFORE_MS` keys).  Needs a CUDA device; imports no
JAX.
"""
from __future__ import annotations

import math
import sys

COLORS = [1, 0, 1, 0]        # the callers' 4 colours (poisson.gauss_seidel_rb)
SHAPES = [(258,) * 3, (130,) * 3, (66,) * 3, (34,) * 3, (18,) * 3,
          (322, 130, 130), (162, 66, 66), (82, 34, 34)]
TILE_Y, TILE_Z = 16, 32      # the cascade's tile (RB_TY, RB_TZ)


def march(shape, it: int, slots: int) -> tuple[int, int, int]:
    """The cascade's grid as `rb_cascade_grid` picks it: (blocks, steps a
    chunk takes, chunks per resident block slot)."""
    cols = math.ceil((shape[2] - 2) / TILE_Z) * math.ceil((shape[1] - 2) / TILE_Y)
    ni = max(1, shape[0] - 2)
    best = None
    for n in range(1, ni + 1):
        c = math.ceil(ni / n)
        if math.ceil(ni / c) != n:
            continue
        waves = math.ceil(cols * n / slots)
        if best is None or waves * (c + 2 * it + 3) < best[0]:
            best = (waves * (c + 2 * it + 3), c, waves, n)
    _, c, waves, n = best
    return cols * n, c + 2 * it + 3, waves


def device_ms(torch, fn, launches: int = 20, runs: int = 5) -> float:
    """Median over ``runs`` of the device time per call of ``launches``
    back-to-back calls, queued behind a spin of the card (~10 ms) so that
    the host's time to enqueue them is hidden: on a small level the
    back-to-back time of `chip_smoke.median_ms` is the host's."""
    import statistics

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def smoke_times(torch, np, cs, st, dev, names) -> None:
    """The cases of the kernels ``names`` of ``chip_smoke.kernel_cases``,
    timed as its phase 3 times them."""
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import poisson as ps

    rng = np.random.default_rng(cs.SEED)
    for shape in ((258,) * 3, (130,) * 3, cs.DRAG_GRID):
        band = (shape[0] // 3, 2 * shape[0] // 3)
        for name, label, kern, _ in cs.kernel_cases(torch, st, fz, ps, shape,
                                                    rng, dev, band):
            if (name in names
                    and not label.endswith(("cascade", "per-colour"))):
                ms = cs.median_ms(torch, kern, 20)
                print(f"smoke ({shape}, {name!r}, {label!r}): {ms:.4f},",
                      flush=True)
        torch.cuda.empty_cache()


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("smoother_bench: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as cs
    from waterlily_tpu_torch.ops import _build
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops import stencil3d as st
    from waterlily_tpu_torch.ops.bc import bc_vector, per_bc

    quick = "--quick" in argv
    mp = "--mp" in argv
    colors = COLORS
    if "--it" in argv:
        k = argv.index("--it")
        colors = COLORS[:int(argv.pop(k + 1))]
        argv.pop(k)
    it = len(colors)
    dims = [int(a) for a in argv if not a.startswith("--")]
    shapes = [tuple(dims[k:k + 3]) for k in range(0, len(dims), 3)] or SHAPES
    print(cs.card_line(), flush=True)
    _build.load()
    for e in _build.ptxas_report(_build.build_info.get("log", "")):
        if "gs_incr_tile" in e["name"] or "gauss_sweeps_tile" in e["name"]:
            print(f"ptxas {e['name'][-48:]}: {e['registers']} registers, stack "
                  f"{e['stack']} B, spills {e['spill_stores']}/{e['spill_loads']} B",
                  flush=True)
    routed = hasattr(st, "_gs_incr_launch")          # both routes to force
    dev = torch.device("cuda")
    if "--smoke" in argv:
        smoke_times(torch, np, cs, st, dev,
                    ("gs_incr_mp_k", "incr_gs_mp_k") if mp
                    else ("gs_incr_k", "gauss_sweeps_k"))
        return 0
    slots = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    worst = 0.0
    f32 = torch.float32
    for shape in shapes:
        x = torch.as_tensor(rng.standard_normal(shape), dtype=f32, device=dev)
        r = torch.zeros_like(x)
        r[1:-1, 1:-1, 1:-1] = x.flip(0)[1:-1, 1:-1, 1:-1]
        L_raw = torch.as_tensor(0.2 + rng.random((3,) + shape), dtype=f32,
                                device=dev)
        cases = []
        lev = ps.make_level(bc_vector(L_raw, (0.0,) * 3))
        coef = ps.with_bf16(lev).bf if mp else (lev.L, lev.D, lev.iD)
        gs = (x, r, *coef, colors, 0.9)
        tag = "".join(map(str, colors))
        cases.append(("K5 bf16" if mp else "K15", f"gs_incr_k {tag}",
                      lambda: st.gs_incr_k(*gs, mp=mp),
                      lambda: st.gs_incr_plain(*gs, mp=mp),
                      (lambda route: st._gs_incr_launch(*gs, mp, route))
                      if routed else None,
                      st._lib().wlt_gs_incr_route(*shape, it, int(mp))
                      if routed else 0))
        for per in (() if mp else ((0, 1, 2), (2,))):
            Lp = bc_vector(L_raw, (0.0,) * 3, perdir=per)
            sw = (per_bc(x, per), r, Lp, ps.make_level(Lp).iD, colors, per)
            mask = sum(1 << j for j in per)
            cases.append(("K13", f"gauss_sweeps_k {tag} per={''.join(map(str, per))}",
                          lambda sw=sw: st.gauss_sweeps_k(*sw),
                          lambda sw=sw: st.gauss_sweeps_plain(*sw),
                          (lambda route, sw=sw: st._gauss_sweeps_launch(*sw, route))
                          if routed else None,
                          st._lib().wlt_gauss_sweeps_route(*shape, it, mask)
                          if routed else 0))
        blocks, steps, waves = march(shape, it, slots)
        for kernel, label, auto, plain, forced, route in cases:
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            runs = {"auto": auto}
            if forced is not None:
                runs |= {"cascade": lambda f=forced: f(st.CASCADE),
                         "per-colour": lambda f=forced: f(st.PER_COLOUR)}
            line = [f"{kernel} {str(shape):16s} {label:24s} picks "
                    f"{'cascade' if route == 1 else 'per-colour'}"]
            for name, fn in runs.items():
                try:
                    got = fn()
                except RuntimeError:        # a checkout without this route
                    line.append(f"{name} refused")
                    continue
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                errs = [((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(got, want)]
                if mp:                   # r to one flipped bf16 rounding
                    errs[1] *= 1e-5 / 2.0 ** -8
                rel = max(errs)
                worst = max(worst, rel)
                del got
                ms = cs.median_ms(torch, fn, 20)
                line.append(f"{name} {ms:.4f} ms, device {device_ms(torch, fn):.4f} "
                            f"(rel {rel:.1e})")
            del want
            pms = float("nan") if quick else cs.median_ms(torch, plain, 3)
            line.append(f"plain {pms:.4f} ms; march {blocks} blocks, {steps} "
                        f"steps, {waves} chunks a slot")
            print("  ".join(line), flush=True)
        del x, r, L_raw, lev, coef, cases
        torch.cuda.empty_cache()
    print(f"worst relative error {worst:.3e} (limit 1e-5)", flush=True)
    return 0 if worst <= 1e-5 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
