#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the CUDA kernels of ``waterlily_tpu_torch/csrc`` with ``nvcc``; the
   compiler's report (``-Xptxas -v``) must show all 27 conv–diff
   instantiations (K12: 3 schemes × 8 periodic masks, K1: 3 schemes), the 8
   of K7's tiled cascade (1–4 colours, with and without norms) and the 4
   each of K15's and K13's (1–4 colours) with no stack frame and no spills;
3. each kernel (and each mode: K12 periodic, K9 keeping the exit plane, K2
   with its band in the middle, at row 1, at row Nx−1, empty and periodic,
   the bf16 smoothers with 0, 2 and 4 colours and with and without norms,
   K7 with 4, 2 and 3 colours and K6, K15 and K13 with 4 colours on each
   of their routes, the tiled cascade and the per-colour launches, where
   the shape allows it)
   against its plain PyTorch version in float32 on random inputs at the
   shapes the main paths give it (258³ fine level, 130³, 66³ and 18³ MG
   levels, a non-cubic (50, 34, 34) and an odd-interior (51, 34, 35)), and
   the median time of each case at 258³ beside its plain version's; K12,
   K1, K7, K15 and K13 are also timed at the drag grid (322, 130, 130), K15
   and K13 at 130³ too, and each of their times is printed beside the
   kernels they replaced (``BEFORE_MS``: K12 and K1 one thread per (cell,
   component), K7, K15 and K13 a launch per colour);
4. the main paths at full width, each built with ``Simulation`` and stepped
   10 times with ``sim_step(remeasure=False)``, first with ``engine="flat"``
   (the fused engine, what ``"auto"`` picks on CUDA), then with
   ``engine="3d"``, each run with its own launch counts (set to 0 just
   before it, read just after):
   a. the 256³ static sphere of ``bench.py`` (radius N/8, ν = radius/1e3);
   b. ``examples/tgv3d.py``'s Taylor–Green vortex at 256³ (Re = 1600,
      periodic in x, y and z, a callable ``u0``): KE and enstrophy per step;
   c. ``examples/sphere_drag.py``'s sphere at N = 128 (grid 320×128×128,
      R = 16, Re = 1e3, the convective outlet): C_d after steps 1, 5 and 10
      from the ported force metrics;
   d. ``les``: the sphere of ``examples/les_sharded.py`` at 256³ on one card
      (R = N/8 at the centre, ν = R/1e4, ``udf=sgs(smagorinsky(0.17))``);
   e. ``ramp``: the sphere of (a) with a callable ``ubc(i, x, t)`` (a free
      stream that ramps smoothly from 0 to 1 over tU/L = 1) and a constant
      transverse body force ``g``;
   f. ``sphere-mp``: the sphere of (a) with ``smooth_it=2, mp_smooth=True``
      (bf16 smoothing) and, as ``sphere-s2``, with ``smooth_it=2`` alone,
      flat engine: ms/step, ``pois_n`` and peak memory side by side;
   g. ``probe``: ``tools/bandwidth_probe.py``'s copy and launch-cost probes;
5. at small size, 5 steps compared after each (every step's figures are
   printed; held after step 5 to 1e-4·max|u|, 1e-3·max|p| and iteration
   counts within one unless said otherwise): the flat engine with the
   kernels (built with ``engine="auto"``) against the flat engine with
   ``plain_ops()``, and against the 3d engine with the kernels, on a 64³
   sphere, a 64³ Taylor–Green vortex, ``examples/sphere_drag.py``'s sphere
   at N = 64 (160×64×64, R = 8) and the 64³ ``les`` and ``ramp`` spheres.
   At N = 32 (R = 4) the drag flow moves u by up to 2e-4·max|u| between two
   float32 rounding orders; at N = 64 by less than 2e-5.  The ``ramp`` is
   held to 1e-4·max|u| after step 1 and to 5e-4 after step 5: from rest its
   second step takes the CFL limit dt = 10, forty times the first, and the
   rounding difference of the momentum RHS enters u times dt (2.2e-4·max|u|
   measured at 64³, 3.6e-4 at 128³, in u and not in p, on both engines).
   ``sphere-mp`` at 64³, the flat engine with the bf16 kernels:
   a. against the same run with the bf16 smoothers alone routed to their
      plain versions (``plain_ops(only=...)``; every float32 kernel stays):
      u, p to 1e-6 of max and equal iteration counts over all 5 steps
      (measured: equal bit for bit), which holds the bf16 kernels end to end;
   b. against ``plain_ops()`` after step 1: 5e-4·max|u|, 1e-3·max|p|
      (measured 1.8e-4 and 1.8e-4, where bf16 and float32 smoothing differ
      by 4.5e-3 and 1.6e-2).  Later steps are for the record: bf16 smoothing
      amplifies the float32 kernels' rounding differences (a flipped bf16
      rounding of the residual moves a correction by 2⁻⁸ of itself) to
      4.8e-3·max|u| by step 5, with no bf16 kernel involved, as (a) shows;
   c. against float32 smoothing (``sphere-s2``), for the record.

Before its last line it prints one JSON object with each kernel's launches
(summed over the phase-4 runs), error, times and bound, and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Needs
no JAX and no network.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

SEED = 0
FINE = 256
STEPS = 10
UBC = (1.0, 0.25, -0.5)      # all three components non-zero for BC! corners
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
_STENCIL = "waterlily_tpu_torch/csrc/stencil3d.cu"
_FUSED = "waterlily_tpu_torch/csrc/fused3d.cu"
_PROBE = "waterlily_tpu_torch/csrc/probe.cu"
# the bf16 smoothers round where their plain versions round and use no fused
# multiply-add: x to 1e-5, r to one flipped bf16 rounding, the norms to 1e-5
_MP_TOL = (1e-5, 2.0 ** -8, 1e-5, 1e-5)
# name: (tolerance relative to max|plain|, one for all outputs or one each,
#        CUDA source, TPU kernel replaced, bytes per cell the timed case must
#        move (each input read once, each output written once; None: depends
#        on the case, see `bound_ms`), float32 operations per cell it needs)
KERNELS = {
    "conv_diff_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:274", 24, 200),
    "bdim_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:372", 108, 60),
    "mult_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:504", 24, 13),
    # 4 colours: e0 = r iD, four sweeps of 13 operations on half the cells,
    # A e and the two updates
    "gs_incr_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:416", 36, 44),
    "gauss_sweeps_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:312", 28, 28),
    "conv_diff_bdim_k": (2e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:376",
                         None, 215),
    "incr_gs_k": (1e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:896", 40, 60),
    "bc_div_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1143", 28, 6),
    "projbc_k": (1e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1201", 40, 9),
    "bc_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1076", 24, 0),
    "div_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1279", 16, 6),
    "bdim_band_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas_flat.py:665",
                    None, 60),
    # x, r in and out (16 B) and five bf16 coefficients (10 B)
    "gs_incr_mp_k": (_MP_TOL, _STENCIL, "waterlily_tpu/ops/pallas_flat.py:759",
                     26, 17),
    # x, r, eps in, x, r out (20 B) and five bf16 coefficients (10 B)
    "incr_gs_mp_k": (_MP_TOL, _FUSED, "waterlily_tpu/ops/pallas_flat.py:896",
                     30, 60),
    "copy_scale_k": (0.0, _PROBE, "benchmarks/leanprobe.py:99", 8, 1),
    "copy_scale6_k": (0.0, _PROBE, "benchmarks/bwprobe.py:128", 48, 6),
}
DRAG_GRID = (322, 130, 130)      # `drag_sim(128)` with its ghost cells
# the redesigned kernels: timed at the drag grid too, beside `BEFORE_MS`
REDESIGNED = ("conv_diff_k", "conv_diff_bdim_k", "incr_gs_k", "gs_incr_k",
              "gauss_sweeps_k")
# the shapes at which a redesigned kernel is timed besides 258^3: the
# smoothers whose routes change with the level also at 130^3
TIMED_AT = {DRAG_GRID: REDESIGNED, (130,) * 3: ("gs_incr_k", "gauss_sweeps_k")}
# ms per call of the kernels that the redesigns replaced, on an NVIDIA H100
# 80GB HBM3 at 700 W.  K12 and K1 (one thread per (cell, component), every
# flux evaluated twice, cached global reads): at 258^3 from this script's
# phase 3 on the commit before the tiles, at the drag grid from
# `tools/convdiff_bench.py` run in that commit's checkout in one call with
# the tiled kernels.  K7 (a head pass, a launch per colour, a tail pass):
# from `tools/incr_gs_bench.py` run in the parent commit's checkout in one
# call with the cascade.  K15 and K13 (a launch per colour, and per colour
# and periodic direction): from `tools/smoother_bench.py --smoke` run in the
# parent commit's checkout (Jacobi, K15 with no colours, is unchanged)
BEFORE_MS = {
    ((258,) * 3, "conv_diff_k", "quick"): 2.524,
    ((258,) * 3, "conv_diff_k", "vanleer"): 2.594,
    ((258,) * 3, "conv_diff_k", "cds"): 1.347,
    ((258,) * 3, "conv_diff_k", "quick per=012"): 2.383,
    ((258,) * 3, "conv_diff_k", "vanleer per=012"): 2.444,
    ((258,) * 3, "conv_diff_k", "cds per=012"): 3.611,
    ((258,) * 3, "conv_diff_k", "quick per=2"): 2.381,
    ((258,) * 3, "conv_diff_bdim_k", "kb=0,s=1"): 2.611,
    ((258,) * 3, "conv_diff_bdim_k", "kb=1,s=0.5"): 2.622,
    (DRAG_GRID, "conv_diff_k", "quick"): 0.880,
    (DRAG_GRID, "conv_diff_k", "vanleer"): 0.910,
    (DRAG_GRID, "conv_diff_k", "cds"): 0.480,
    (DRAG_GRID, "conv_diff_k", "quick per=012"): 0.839,
    (DRAG_GRID, "conv_diff_k", "vanleer per=012"): 0.855,
    (DRAG_GRID, "conv_diff_k", "cds per=012"): 1.207,
    (DRAG_GRID, "conv_diff_k", "quick per=2"): 0.838,
    (DRAG_GRID, "conv_diff_bdim_k", "kb=1,s=0.5"): 0.904,
    ((258,) * 3, "incr_gs_k", "[0, 1, 0, 1] norms=True"): 1.2501,
    ((258,) * 3, "incr_gs_k", "[1, 0] norms=True"): 0.8662,
    ((258,) * 3, "incr_gs_k", "[] norms=True"): 0.2271,
    ((258,) * 3, "incr_gs_k", "[0, 1, 0] norms=False"): 1.0379,
    (DRAG_GRID, "incr_gs_k", "[0, 1, 0, 1] norms=True"): 0.4040,
    (DRAG_GRID, "incr_gs_k", "[1, 0] norms=True"): 0.2857,
    (DRAG_GRID, "incr_gs_k", "[] norms=True"): 0.0827,
    (DRAG_GRID, "incr_gs_k", "[0, 1, 0] norms=False"): 0.3337,
    ((258,) * 3, "gs_incr_k", "[0, 1, 0, 1]"): 1.0690,
    ((258,) * 3, "gs_incr_k", "[1, 0]"): 0.6877,
    ((258,) * 3, "gs_incr_k", "[]"): 0.2352,
    ((258,) * 3, "gauss_sweeps_k", "[0, 1, 0, 1] per=012"): 0.8776,
    ((258,) * 3, "gauss_sweeps_k", "[1, 0] per=012"): 0.4684,
    ((258,) * 3, "gauss_sweeps_k", "[0, 1, 0, 1] per=2"): 0.8528,
    ((258,) * 3, "gauss_sweeps_k", "[1, 0] per=2"): 0.4572,
    ((130,) * 3, "gs_incr_k", "[0, 1, 0, 1]"): 0.1473,
    ((130,) * 3, "gs_incr_k", "[1, 0]"): 0.0961,
    ((130,) * 3, "gs_incr_k", "[]"): 0.0382,
    ((130,) * 3, "gauss_sweeps_k", "[0, 1, 0, 1] per=012"): 0.1482,
    ((130,) * 3, "gauss_sweeps_k", "[1, 0] per=012"): 0.0765,
    ((130,) * 3, "gauss_sweeps_k", "[0, 1, 0, 1] per=2"): 0.1282,
    ((130,) * 3, "gauss_sweeps_k", "[1, 0] per=2"): 0.0695,
    (DRAG_GRID, "gs_incr_k", "[0, 1, 0, 1]"): 0.3455,
    (DRAG_GRID, "gs_incr_k", "[1, 0]"): 0.2304,
    (DRAG_GRID, "gs_incr_k", "[]"): 0.0809,
    (DRAG_GRID, "gauss_sweeps_k", "[0, 1, 0, 1] per=012"): 0.3059,
    (DRAG_GRID, "gauss_sweeps_k", "[1, 0] per=012"): 0.1619,
    (DRAG_GRID, "gauss_sweeps_k", "[0, 1, 0, 1] per=2"): 0.2768,
    (DRAG_GRID, "gauss_sweeps_k", "[1, 0] per=2"): 0.1512,
}
# the kernels each main path launches (engine x configuration)
PATH_KERNELS = {
    # a body band is set: the flat engine runs K1 and no K12
    ("sphere", "flat"): {"conv_diff_bdim_k", "bdim_k", "mult_k", "gs_incr_k",
                         "incr_gs_k", "bc_div_k", "projbc_k"},
    ("sphere", "3d"): {"conv_diff_k", "bdim_k", "mult_k", "gs_incr_k"},
    # periodic: no K1, K8, K9 or fused tail; K13 smooths, K6 increments
    ("tgv", "flat"): {"conv_diff_k", "bdim_k", "mult_k", "incr_gs_k",
                      "gauss_sweeps_k", "div_k"},
    ("tgv", "3d"): {"conv_diff_k", "bdim_k", "mult_k", "gauss_sweeps_k"},
    # convective outlet: K10 + K11 in place of K8, K9 keeps the exit plane
    ("drag", "flat"): {"conv_diff_bdim_k", "bdim_k", "mult_k", "gs_incr_k",
                       "incr_gs_k", "projbc_k", "bc_k", "div_k"},
    ("drag", "3d"): {"conv_diff_k", "bdim_k", "mult_k", "gs_incr_k"},
    # a udf: K12 + K2 on the band in place of K1; the fused BC kernels stay
    ("les", "flat"): {"conv_diff_k", "bdim_band_k", "mult_k", "gs_incr_k",
                      "incr_gs_k", "bc_div_k", "projbc_k"},
    ("les", "3d"): {"conv_diff_k", "bdim_k", "mult_k", "gs_incr_k"},
    # a callable ubc: no K8, K9 or K10; plain BC at t, K11
    ("ramp", "flat"): {"conv_diff_k", "bdim_band_k", "mult_k", "gs_incr_k",
                       "incr_gs_k", "div_k"},
    ("ramp", "3d"): {"conv_diff_k", "bdim_k", "mult_k", "gs_incr_k"},
    # bf16 smoothing on the levels 258³, 130³, 66³; float32 below (K15, K6)
    ("sphere-mp", "flat"): {"conv_diff_bdim_k", "bdim_k", "mult_k", "gs_incr_k",
                            "incr_gs_k", "bc_div_k", "projbc_k", "gs_incr_mp_k",
                            "incr_gs_mp_k"},
    ("sphere-s2", "flat"): {"conv_diff_bdim_k", "bdim_k", "mult_k", "gs_incr_k",
                            "incr_gs_k", "bc_div_k", "projbc_k"},
    ("probe", "tool"): {"copy_scale_k", "copy_scale6_k"},
}
# (configuration, engine) in the order phase 4 runs them
MAIN_RUNS = [(c, e) for c in ("sphere", "tgv", "drag", "les", "ramp")
             for e in ("flat", "3d")] + [("sphere-mp", "flat"), ("sphere-s2", "flat")]


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


# ------------------------------------------------------------ phase 2
# the tiled kernels held to no stack frame and no spills: the kernel's name
# in the compiler's report and the number of its instantiations
TILED = {"conv-diff": ("conv_diff_tile_kernel", 27),
         "K7 cascade": ("incr_gs_tile_kernel", 8),
         "K15 cascade": ("gs_incr_tile_kernel", 4),
         "K13 cascade": ("gauss_sweeps_tile_kernel", 4)}


def check_build(_build) -> None:
    """Every instantiation of the tiled kernels in the compiler's report,
    each without a stack frame and without spills."""
    log = _build.build_info.get("log")
    check(bool(log), "phase2: no compiler report beside the kernel library")
    report = _build.ptxas_report(log)
    for label, (kernel, count) in TILED.items():
        entries = [e for e in report if kernel in e["name"]]
        check(len(entries) == count, f"phase2: {len(entries)} {label} "
              f"instantiations in the compiler's report, expected {count}")
        bad = [e for e in entries
               if e["stack"] or e["spill_stores"] or e["spill_loads"]]
        regs = sorted(e["registers"] for e in entries)
        print(f"phase2 {label}: {count} instantiations, registers "
              f"{regs[0]}-{regs[-1]}, {len(bad)} with a stack frame or spills",
              flush=True)
        check(not bad, f"phase2: {label} instantiations with a stack frame or "
              "spills: " + "; ".join(f"{e['name'][-48:]} stack {e['stack']} B "
                                     f"spills {e['spill_stores']}/"
                                     f"{e['spill_loads']} B" for e in bad))


# ------------------------------------------------------------ phase 3
def kernel_cases(torch, st, fz, ps, shape, rng, dev, band):
    """(kernel name, case label, kernel thunk, plain thunk) at one shape.
    A thunk returns a tensor or a tuple of tensors to compare.  The first
    case of each kernel is the one the JSON line times; ``band`` is the x
    band of K2's first case."""
    from waterlily_tpu_torch.ops import probe
    from waterlily_tpu_torch.ops.bc import bc_vector, per_bc

    f32 = torch.float32

    def g(*s):
        return torch.as_tensor(rng.standard_normal(s + shape), dtype=f32, device=dev)

    def zero_ghost(a):
        out = torch.zeros(shape, dtype=f32, device=dev)
        out[1:-1, 1:-1, 1:-1] = a[1:-1, 1:-1, 1:-1]
        return out

    u, u0, f, V = g(3), g(3), g(3), 0.1 * g(3)
    mu0, mu1 = g(3).abs(), 0.3 * g(3, 3)
    L_raw = torch.as_tensor(0.2 + rng.random((3,) + shape), dtype=f32, device=dev)
    lev = ps.make_level(bc_vector(L_raw, (0.0,) * 3))
    x = g()
    r, eps = zero_ghost(g()), zero_ghost(0.3 * g())
    nu = torch.tensor(0.03, dtype=f32, device=dev)
    cases = []
    for sid, scheme in enumerate(st.SCHEMES):
        cases.append(("conv_diff_k", scheme.__name__,
                      lambda sid=sid: st.conv_diff_k(u, nu, sid),
                      lambda scheme=scheme: st.conv_diff_plain(u, nu, scheme)))
    # K12's periodic mode (phiuP in the periodic directions)
    for sid, per in ((0, (0, 1, 2)), (1, (0, 1, 2)), (2, (0, 1, 2)), (0, (2,))):
        scheme = st.SCHEMES[sid]
        cases.append(("conv_diff_k", f"{scheme.__name__} per={''.join(map(str, per))}",
                      lambda sid=sid, per=per: st.conv_diff_k(u, nu, sid, per),
                      lambda scheme=scheme, per=per: st.conv_diff_plain(u, nu, scheme, per)))
    cases.append(("bdim_k", "", lambda: st.bdim_k(u, u0, f, V, mu0, mu1, 0.3),
                  lambda: st.bdim_plain(u, u0, f, V, mu0, mu1, 0.3)))
    cases.append(("mult_k", "", lambda: st.mult_k(x, lev.L, lev.D),
                  lambda: st.mult_plain(x, lev.L, lev.D)))
    # K15: the route the level takes, then 4 colours on each route
    gs = (x, r, lev.L, lev.D, lev.iD)
    for cols in ([0, 1, 0, 1], [1, 0], []):
        cases.append(("gs_incr_k", str(cols),
                      lambda cols=cols: st.gs_incr_k(*gs, cols, 0.9),
                      lambda cols=cols: st.gs_incr_plain(*gs, cols, 0.9)))
    for route, rname in ((st.CASCADE, "cascade"), (st.PER_COLOUR, "per-colour")):
        cases.append(("gs_incr_k", f"[0, 1, 0, 1] {rname}",
                      lambda route=route: st._gs_incr_launch(*gs, [0, 1, 0, 1],
                                                             0.9, False, route),
                      lambda: st.gs_incr_plain(*gs, [0, 1, 0, 1], 0.9)))
    # K13 on a periodic level, from a periodic-synced eps: the route the
    # level takes, then 4 colours on each route the shape allows (the
    # cascade needs even periodic extents)
    for per in ((0, 1, 2), (2,)):
        Lp = bc_vector(L_raw, (0.0,) * 3, perdir=per)
        sw = (per_bc(eps, per), r, Lp, ps.make_level(Lp).iD)
        tag = f"per={''.join(map(str, per))}"
        for cols in ([0, 1, 0, 1], [1, 0]):
            cases.append(("gauss_sweeps_k", f"{cols} {tag}",
                          lambda cols=cols, per=per, sw=sw:
                              st.gauss_sweeps_k(*sw, cols, per),
                          lambda cols=cols, per=per, sw=sw:
                              st.gauss_sweeps_plain(*sw, cols, per)))
        even = all((shape[j] - 2) % 2 == 0 for j in per)
        for route, rname in ((st.CASCADE, "cascade"), (st.PER_COLOUR, "per-colour")):
            if route == st.CASCADE and not even:
                continue
            cases.append(("gauss_sweeps_k", f"[0, 1, 0, 1] {tag} {rname}",
                          lambda route=route, per=per, sw=sw:
                              st._gauss_sweeps_launch(*sw, [0, 1, 0, 1], per, route),
                          lambda per=per, sw=sw:
                              st.gauss_sweeps_plain(*sw, [0, 1, 0, 1], per)))
    # K1 with a body slab in the middle third of x: u_new everywhere, f on
    # the slab only (its other rows are never written)
    lo, hi = shape[0] // 3, 2 * shape[0] // 3
    for kb, sc in ((0.0, 1.0), (1.0, 0.5)):
        def k1(kb=kb, sc=sc):
            un, fk = fz.conv_diff_bdim_k(u, u0, nu, 0.3, kb, sc, 0, (lo, hi))
            return un, fk[:, lo:hi]

        def p1(kb=kb, sc=sc):
            un, fp = fz.conv_diff_bdim_plain(u, u0, nu, 0.3, kb, sc, st.quick)
            return un, fp[:, lo:hi]
        cases.append(("conv_diff_bdim_k", f"kb={kb:g},s={sc:g}", k1, p1))
    # K7 (K6 with no colours), each norm compared on its own scale: the
    # tiled cascade with 4 and 2 colours with norms and 3 without, K6
    for cols, nrm in (([0, 1, 0, 1], True), ([1, 0], True), ([], True),
                      ([0, 1, 0], False)):
        def k7(cols=cols, nrm=nrm):
            out = fz.incr_gs_k(x, r, eps, lev.L, lev.D, lev.iD, cols, 0.9, nrm)
            return (*out[:2], out[2][0:1], out[2][1:2]) if nrm else out

        def p7(cols=cols, nrm=nrm):
            out = fz.incr_gs_plain(x, r, eps, lev.L, lev.D, lev.iD, cols, 0.9, nrm)
            return (*out[:2], out[2][0:1], out[2][1:2]) if nrm else out
        cases.append(("incr_gs_k", f"{cols} norms={nrm}", k7, p7))
    cases.append(("bc_div_k", "", lambda: fz.bc_div_k(u, UBC),
                  lambda: fz.bc_div_plain(u, UBC)))
    for se in (False, True):
        for cfl in (False, True):
            cases.append(("projbc_k", f"cfl={cfl} exit={se}",
                          lambda cfl=cfl, se=se: fz.projbc_k(u, x, lev.L, UBC, cfl, se),
                          lambda cfl=cfl, se=se: fz.projbc_plain(u, x, lev.L, UBC, cfl, se)))
    for se in (False, True):
        cases.append(("bc_k", f"exit={se}", lambda se=se: fz.bc_k(u, UBC, se),
                      lambda se=se: fz.bc_plain(u, UBC, se)))
    cases.append(("div_k", "", lambda: fz.div_k(u), lambda: fz.div_plain(u)))
    # K2: the band of the main path first, then at row 1, at row Nx-1, over
    # every row, empty, and with periodic directions
    nx = shape[0]
    for label, b, per in (("band", band, ()), ("row1", (1, nx // 2), ()),
                          ("top", (nx // 2, nx - 1), ()), ("full", (1, nx - 1), ()),
                          ("empty", (1, 1), ()), ("band per=2", band, (2,)),
                          ("band per=012", band, (0, 1, 2))):
        cases.append(("bdim_band_k", f"{label} {b}",
                      lambda b=b, per=per: st.bdim_band_k(u, u0, f, V, mu0, mu1, 0.3, b, per),
                      lambda b=b, per=per: st.bdim_band_plain(u, u0, f, V, mu0, mu1, 0.3,
                                                            b, per)))
    # the bf16 instantiations of K15 and K7 on the level's bf16 coefficients
    bf = ps.with_bf16(lev).bf
    for cols in ([], [0, 1, 0, 1], [1, 0]):
        cases.append(("gs_incr_mp_k", str(cols),
                      lambda cols=cols: st.gs_incr_k(x, r, *bf, cols, 0.9, mp=True),
                      lambda cols=cols: st.gs_incr_plain(x, r, *bf, cols, 0.9, mp=True)))
    for cols, nrm in (([0, 1, 0, 1], True), ([1, 0], True), ([0, 1, 0, 1], False)):
        def k7m(cols=cols, nrm=nrm):
            out = fz.incr_gs_k(x, r, eps, *bf, cols, 0.9, nrm, mp=True)
            return (*out[:2], out[2][0:1], out[2][1:2]) if nrm else out

        def p7m(cols=cols, nrm=nrm):
            out = fz.incr_gs_plain(x, r, eps, *bf, cols, 0.9, nrm, mp=True)
            return (*out[:2], out[2][0:1], out[2][1:2]) if nrm else out
        cases.append(("incr_gs_mp_k", f"{cols} norms={nrm}", k7m, p7m))
    # the copy probes, at both block sizes
    six = [x, r, eps] + [c.clone() for c in u]      # clones: 16-byte aligned
    for block in (256, 1024):
        cases.append(("copy_scale_k", f"block={block}",
                      lambda block=block: tuple(probe.copy_scale_k([x], block)),
                      lambda: tuple(probe.copy_scale_plain([x]))))
        cases.append(("copy_scale6_k", f"block={block}",
                      lambda block=block: tuple(probe.copy_scale_k(six, block)),
                      lambda: tuple(probe.copy_scale_plain(six))))
    return cases


def median_ms(torch, fn, launches: int, runs: int = 5) -> float:
    """Median over ``runs`` of the mean time per call of ``launches``
    back-to-back calls between two CUDA events."""
    fn()                                   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def bound_ms(name: str, shape, band) -> tuple[float, str]:
    """The least time the card could take for the timed case of ``name`` at
    ``shape``: the larger of its bytes over the HBM rate and its float32
    operations over the float32 peak (H100 SXM data sheet, 700 W)."""
    _, _, _, bpc, fpc = KERNELS[name]
    cells = math.prod(shape)
    if name == "conv_diff_bdim_k":
        # K1: u, u0 in and u_new out on every cell, f out on the slab third
        slab = (2 * shape[0] // 3 - shape[0] // 3) / shape[0]
        bpc = 36 + 12 * slab
    elif name == "bdim_band_k":
        # K2: u, u0, f in and out on every row (48 B), K14's nine fields per
        # component on the rows of the band (108 B)
        share = (band[1] - band[0]) / shape[0]
        bpc = 48 * (1 - share) + 108 * share
    t_bytes = bpc * cells / HBM_BYTES_PER_S * 1e3
    t_ops = fpc * cells / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_mul_ms(torch, fields) -> float:
    """One PyTorch call per field computing the copy probe's function,
    ``torch.mul(a, 1.0000001, out=b)``."""
    from waterlily_tpu_torch.ops import probe

    outs = [torch.empty_like(a) for a in fields]

    def lib():
        for a, b in zip(fields, outs):
            torch.mul(a, probe.SCALE, out=b)
    return median_ms(torch, lib, 20)


def library_div_ms(torch, u) -> float:
    """One PyTorch call computing the divergence: a 3-D convolution with a
    fixed 2×2×2 kernel over the three components (its output is the
    divergence at every cell but the last of each direction, without the
    ghost zeroing); cuDNN in full float32 (TF32 off)."""
    w = torch.zeros((1, 3, 2, 2, 2), dtype=u.dtype, device=u.device)
    w[0, 0, 0, 0, 0] = w[0, 1, 0, 0, 0] = w[0, 2, 0, 0, 0] = -1.0
    w[0, 0, 1, 0, 0] = w[0, 1, 0, 1, 0] = w[0, 2, 0, 0, 1] = 1.0
    conv = torch.nn.functional.conv3d
    out = conv(u[None], w)[0, 0]
    ref = (u[0, 1:, :-1, :-1] - u[0, :-1, :-1, :-1]) \
        + (u[1, :-1, 1:, :-1] - u[1, :-1, :-1, :-1]) \
        + (u[2, :-1, :-1, 1:] - u[2, :-1, :-1, :-1])
    check(bool(torch.allclose(out, ref, atol=1e-5)),
          "library conv3d does not compute the divergence")
    return median_ms(torch, lambda: conv(u[None], w), 20)


def phase_kernels(torch, np, wt, dev):
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops import stencil3d as st

    rng = np.random.default_rng(SEED)
    fine = (FINE + 2,) * 3
    # the x band the 256³ sphere of the main path really has
    fine_band = sphere_sim(torch, wt, FINE, dev).flow.cfg.band_x
    torch.cuda.empty_cache()
    print(f"phase3 band_x of the {FINE}^3 sphere: {fine_band} "
          f"({fine_band[1] - fine_band[0]} of {fine[0]} rows)", flush=True)
    shapes = [fine, (130,) * 3, (66,) * 3, (18,) * 3, (50, 34, 34), (51, 34, 35),
              DRAG_GRID]
    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                 "library_ms": None} for k in KERNELS}
    seen = set()
    for shape in shapes:
        band = fine_band if shape == fine else (shape[0] // 3, 2 * shape[0] // 3)
        for name, label, kern, plain in kernel_cases(torch, st, fz, ps, shape,
                                                     rng, dev, band):
            seen.add(name)
            tols = KERNELS[name][0]
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            check(len(got) == len(want), f"{name} {label}: output count differs")
            for k, (a, b) in enumerate(zip(got, want)):
                tol = tols[k] if isinstance(tols, tuple) else tols
                check(bool(torch.isfinite(a).all()), f"{name} {label} {shape}: non-finite")
                err = (a - b).abs().max().item()
                scale = max(b.abs().max().item(), 1e-30)
                rel = err / scale
                print(f"phase3 {name:16s} {label:24s} {str(shape):16s} out{k} "
                      f"max|d|={err:.3e} rel={rel:.3e} tol={tol:.1e}", flush=True)
                check(rel <= tol, f"{name} {label} at {shape} output {k}: "
                      f"relative error {rel:.3e} > {tol:.0e}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            del got, want
            if shape == fine or name in TIMED_AT.get(shape, ()):
                ms, pms = median_ms(torch, kern, 20), median_ms(torch, plain, 4)
                before = BEFORE_MS.get((shape, name, label))
                print(f"phase3 time {name:16s} {label:24s} at {shape}: kernel "
                      f"{ms:.4f} ms, plain {pms:.4f} ms per call"
                      + ("" if name not in REDESIGNED else
                         f", before the redesign {before:.3f} ms" if before else
                         ", before the redesign not measured"), flush=True)
                if shape == fine and stats[name]["ms"] is None:
                    # the JSON keeps the first case of each kernel (conv_diff:
                    # quick, walls; gs_incr: 4 colours; K13: 4 colours, xyz
                    # periodic; K1: predictor; K7: 4 colours, norms; K9: no CFL, no
                    # exit; K10: no exit; K2: the sphere's band; the bf16
                    # K15: Jacobi; the bf16 K7: 4 colours with norms; the
                    # probes: 256 threads per block)
                    stats[name]["ms"], stats[name]["plain_ms"] = ms, pms
                    stats[name]["bound_ms"], stats[name]["bound_by"] = bound_ms(
                        name, shape, band)
        if shape == fine:
            u = torch.as_tensor(rng.standard_normal((3,) + fine), dtype=torch.float32,
                                device=dev)
            lib = library_div_ms(torch, u)
            stats["div_k"]["library_ms"] = lib
            print(f"phase3 time div_k library conv3d at {fine}: {lib:.4f} ms per call",
                  flush=True)
            for name, fields in (("copy_scale_k", [u[0]]),
                                 ("copy_scale6_k", [u[0], u[1], u[2]] * 2)):
                lib = library_mul_ms(torch, fields)
                stats[name]["library_ms"] = lib
                print(f"phase3 time {name} library torch.mul at {fine}: {lib:.4f} "
                      f"ms per call", flush=True)
            del u
        torch.cuda.empty_cache()
    check(seen == set(KERNELS), f"phase3: kernels without a case: {set(KERNELS) - seen}")
    return stats


# ------------------------------------------------------------ configurations
def sphere_sim(torch, wt, n: int, dev, **kw):
    """The static sphere of `bench.py`: n³, radius n/8 at (n/3, n/2, n/2),
    ν = radius/1e3."""
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e3,
                         body=body, dtype=torch.float32, device=dev, **kw)


def tgv_sim(torch, wt, n: int, dev, **kw):
    """`examples/tgv3d.py`: the Taylor–Green vortex on an n³ periodic box,
    Re = 1600, the initial velocity a callable written in torch."""
    kappa = 2 * math.pi / n

    def u0(i, x):
        a, b, c = x[0] * kappa, x[1] * kappa, x[2] * kappa
        if i == 0:
            return torch.cos(a) * torch.sin(b) * torch.sin(c)
        if i == 1:
            return -torch.sin(a) * torch.cos(b) * torch.sin(c) / 2
        return -torch.sin(a) * torch.sin(b) * torch.cos(c) / 2
    return wt.Simulation((n, n, n), (0.0, 0.0, 0.0), n, U=1, nu=1 / (kappa * 1600),
                         u0=u0, perdir=(0, 1, 2), dtype=torch.float32, device=dev,
                         **kw)


def drag_sim(torch, wt, n: int, dev, **kw):
    """`examples/sphere_drag.py`: a (2.5n, n, n) channel, a sphere of radius
    n/8 at (n/3, n/2, n/2), Re = 1e3, the convective outlet."""
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((int(2.5 * n), n, n), (1.0, 0.0, 0.0), radius,
                         nu=radius / 1e3, body=body, exit_bc=True,
                         dtype=torch.float32, device=dev, **kw)


def les_sim(torch, wt, n: int, dev, **kw):
    """`examples/les_sharded.py` on one card: an n³ box, a sphere of radius
    n/8 at the centre, ν = radius/1e4; stepped with `les_udf()`."""
    radius = n // 8
    ctr = torch.tensor([n / 2, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e4,
                         body=body, dtype=torch.float32, device=dev, **kw)


def les_udf():
    from waterlily_tpu_torch.utils import les

    return les.sgs(les.smagorinsky(Cs=0.17))


def ramp_value(t: float, length: float) -> float:
    """The free stream of `ramp_sim` at time ``t``: 0 → 1 over tU/L = 1."""
    return 0.5 * (1.0 - math.cos(math.pi * min(t / length, 1.0)))


def ramp_sim(torch, wt, n: int, dev, **kw):
    """The sphere of `sphere_sim` in a free stream that ramps smoothly from
    0 to 1 over tU/L = 1 (a callable ``ubc(i, x, t)``, ``U = 1`` given) under
    a constant transverse body force ``g`` = 0.1 U²/L."""
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)

    def ubc(i, x, t):
        if i != 0:
            return 0.0
        return 0.5 * (1.0 - torch.cos(math.pi * torch.clamp(t / radius, max=1.0)))

    def g(i, x, t):
        return 0.1 / radius if i == 1 else 0.0
    return wt.Simulation((n, n, n), ubc, radius, U=1.0, nu=radius / 1e3, g=g,
                         body=body, dtype=torch.float32, device=dev, **kw)


def make_sim(torch, wt, config: str, n: int, dev, **kw):
    """The `Simulation` of a configuration at size ``n`` and the ``udf`` its
    steps take."""
    if config == "tgv":
        return tgv_sim(torch, wt, n, dev, **kw), None
    if config == "drag":
        return drag_sim(torch, wt, n, dev, **kw), None
    if config == "les":
        return les_sim(torch, wt, n, dev, **kw), les_udf()
    if config == "ramp":
        return ramp_sim(torch, wt, n, dev, **kw), None
    if config in ("sphere-mp", "sphere-s2"):
        kw = dict(kw, smooth_it=2, mp_smooth=config == "sphere-mp")
    return sphere_sim(torch, wt, n, dev, **kw), None


# ------------------------------------------------------------ phase 4
def tgv_energies(torch, mt, u):
    """(KE, enstrophy) of the interior, summed in float64, per cell."""
    n = math.prod(s - 2 for s in u.shape[1:])
    inner = (slice(1, -1),) * 3
    ke = mt.ke_field(u)[inner].double().sum().item() / n
    ens = (mt.omega_mag_field(u)[inner].double() ** 2).sum().item() / n
    return ke, ens


def drag_cd(sim, mt) -> float:
    """C_d = −2 (F_p + F_v)_x / (π R²) from the ported metrics."""
    st = sim.flow.state
    fp = mt.pressure_force(st.p, sim.body, sim.time)
    fv = mt.viscous_force(st.u, st.nu, sim.body, sim.time)
    return -2.0 * (fp[0] + fv[0]).item() / (math.pi * sim.L ** 2)


def phase_main(torch, wt, st, dev, config: str, engine: str):
    """One engine's run of one configuration at full width, with its own
    launch counts."""
    from waterlily_tpu_torch.utils import metrics as mt

    tag = f"phase4 {config} [{engine}]"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim, udf = make_sim(torch, wt, config, 128 if config == "drag" else FINE, dev,
                        engine=engine)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    check(sim.engine == engine, f"{tag}: Simulation runs engine {sim.engine}")
    shape = sim.flow.cfg.shape
    print(f"{tag} build {shape}: {build_s:.2f} s, levels "
          f"{[tuple(l.D.shape) for l in sim.levels]}, bf16 levels "
          f"{sum(l.bf is not None for l in sim.levels)}, band_x "
          f"{sim.flow.cfg.band_x}, peak during build "
          f"{build_peak / 2**30:.3f} GiB", flush=True)
    diags = []
    if config == "tgv":
        diags.append((0,) + tgv_energies(torch, mt, sim.flow.u))
    events = []
    st.reset_launch_counts()
    for k in range(1, STEPS + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.sim_step(remeasure=False, udf=udf)
        b.record()
        events.append((a, b))
        if config == "tgv" or (config == "drag" and k in (1, 5, STEPS)):
            # outside the timed window; the counts below include no metric
            counts_now = st.launch_counts()
            diags.append((k,) + (tgv_energies(torch, mt, sim.flow.u) if config == "tgv"
                                 else (drag_cd(sim, mt),)))
            check(st.launch_counts() == counts_now, f"{tag}: a metric launched a kernel")
    torch.cuda.synchronize()
    counts = st.launch_counts()
    step_ms = [a.elapsed_time(b) for a, b in events]
    ms_step = statistics.mean(step_ms[2:])
    peak = torch.cuda.max_memory_allocated()
    u, p = sim.flow.u, sim.flow.p
    itmx = sim.flow.cfg.itmx
    print(f"{tag} ms/step (steps 3-{STEPS}, mean) {ms_step:.3f}; per step "
          f"{[round(t, 3) for t in step_ms]}", flush=True)
    print(f"{tag} pois_n {sim.pois_n}; dt {[round(d, 5) for d in sim.flow.dt]}",
          flush=True)
    print(f"{tag} max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)", flush=True)
    print(f"{tag} launch counts {counts}; wrapper calls per step "
          f"{sum(counts.values()) / STEPS:.1f}", flush=True)
    check(tuple(u.shape) == (3,) + shape and tuple(p.shape) == shape,
          f"{tag}: wrong field shapes")
    check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(p).all()),
          f"{tag}: u or p not finite")
    check(all(0.0 < d <= 10.0 for d in sim.flow.dt), f"{tag}: dt out of (0, 10]")
    check(len(sim.pois_n) == 2 * STEPS and all(1 <= n <= itmx for n in sim.pois_n),
          f"{tag}: a pressure solve left [1, itmx={itmx}]: {sim.pois_n}")
    pmean = p[1:-1, 1:-1, 1:-1][sim.levels[0].iD[1:-1, 1:-1, 1:-1] != 0].mean().item()
    print(f"{tag} pressure mean over active cells {pmean:.3e}", flush=True)
    check(abs(pmean) < 1e-3 * max(p.abs().max().item(), 1.0),
          f"{tag}: pressure gauge not pinned")
    if config == "tgv":
        for k, ke, ens in diags:
            print(f"{tag} step {k:2d} KE {ke:.9f} enstrophy {ens:.9f}", flush=True)
        ke0, ke10 = diags[0][1], diags[-1][1]
        check(all(math.isfinite(v) for d in diags for v in d), f"{tag}: KE not finite")
        check(ke10 < ke0 and ke10 > 0.99 * ke0,
              f"{tag}: KE {ke0} -> {ke10} is not a decay of less than 1 %")
        for j in range(3):
            n = shape[j]
            for f in (u, p[None]):
                check(torch.equal(f.narrow(1 + j, 0, 1), f.narrow(1 + j, n - 2, 1))
                      and torch.equal(f.narrow(1 + j, n - 1, 1), f.narrow(1 + j, 1, 1)),
                      f"{tag}: a periodic ghost plane of direction {j} differs "
                      f"from its partner")
    if config == "drag":
        for k, cd in diags:
            print(f"{tag} step {k:2d} C_d {cd:.6f}", flush=True)
        check(all(math.isfinite(cd) for _, cd in diags), f"{tag}: C_d not finite")
        inflow = u[0, 1, 1:-1, 1:-1].double().mean().item()
        outflow = u[0, -1, 1:-1, 1:-1].double().mean().item()
        print(f"{tag} mean inflow {inflow:.9f}, mean outflow {outflow:.9f}",
              flush=True)
        check(abs(outflow - inflow) <= 1e-5 * abs(inflow),
              f"{tag}: outflow {outflow} differs from inflow {inflow}")
    if config == "ramp":
        want = ramp_value(sim.time, sim.L)
        inflow = u[0, 1, 1:-1, 1:-1].double()
        print(f"{tag} time {sim.time:.4f}, free stream {want:.6f}, inflow plane "
              f"[{inflow.min().item():.6f}, {inflow.max().item():.6f}], mean u_y "
              f"{u[1, 1:-1, 1:-1, 1:-1].double().mean().item():.3e}", flush=True)
        check(0.0 < want <= 1.0 and (inflow - want).abs().max().item() <= 1e-5,
              f"{tag}: the inflow plane is not ubc(t)")
    if config == "sphere-mp":
        check(sum(l.bf is not None for l in sim.levels) == 3,
              f"{tag}: bf16 copies are not on the levels 258^3, 130^3, 66^3")
    for k, n in counts.items():
        if k in PATH_KERNELS[(config, engine)]:
            check(n > 0, f"{tag}: kernel {k} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {k} of another path was launched")
    pois = list(sim.pois_n)
    del sim, u, p
    return dict(counts=counts, ms_step=ms_step, step_ms=step_ms, peak=peak,
                build_s=build_s, pois_n=pois)


def phase_probe(torch, st):
    """`tools/bandwidth_probe.py`, run through its own entry point with its
    own launch counts."""
    path = pathlib.Path(__file__).resolve().parent / "tools" / "bandwidth_probe.py"
    spec = importlib.util.spec_from_file_location("bandwidth_probe", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st.reset_launch_counts()
    rows = tool.run(FINE)
    torch.cuda.synchronize()
    counts = st.launch_counts()
    tool.report(rows)
    print(f"phase4 probe launch counts {counts}", flush=True)
    for r in rows:
        check(all(math.isfinite(v) and v > 0 for k, v in r.items()
                  if k.endswith(("ms", "per_launch", "per_s"))),
              f"phase4 probe: a time or rate of {r['name']} is not positive")
    for k, n in counts.items():
        check((n > 0) == (k in PATH_KERNELS[("probe", "tool")]),
              f"phase4 probe: launch count of {k} is {n}")
    torch.cuda.empty_cache()
    return dict(counts=counts, rows=rows)


# ------------------------------------------------------------ phase 5
SMALL = {"sphere": 64, "tgv": 64, "drag": 64, "les": 64, "ramp": 64,
         "sphere-mp": 64}
MP_KERNELS = ("gs_incr_mp_k", "incr_gs_mp_k")
# (configuration, run compared with): the comparisons held, each the step
# after which it is made, its limits relative to max|u| and max|p|, and by
# how much an iteration count may differ; a pair not listed takes
# `HELD_DEFAULT`, an empty tuple is for the record only
HELD_DEFAULT = ((5, 1e-4, 1e-3, 1),)
_RAMP = ((1, 1e-4, 1e-3, 1), (5, 5e-4, 1e-3, 1))
HELD = {
    ("ramp", "flat-plain"): _RAMP,
    ("ramp", "3d"): _RAMP,
    ("sphere-mp", "mp-plain"): ((5, 1e-6, 1e-6, 0),),
    ("sphere-mp", "flat-plain"): ((1, 5e-4, 1e-3, 1),),
    ("sphere-mp", "flat-f32"): (),
}


def phase_compare(torch, wt, st, dev, config: str, n: int):
    """Five steps at small size, compared after each: the flat engine with
    the kernels against the flat engine with the plain versions and against
    the 3d engine.  For ``sphere-mp`` against (``mp-plain``) the same run
    with the bf16 smoothers alone routed to their plain versions, which it
    must equal over all five steps; against the plain versions after the
    first step; and against float32 smoothing for the record.  Returns the
    comparisons that failed."""
    if config == "sphere-mp":
        others = {"mp-plain": (config, "flat", lambda: st.plain_ops(only=MP_KERNELS)),
                  "flat-plain": (config, "flat", st.plain_ops),
                  "flat-f32": ("sphere-s2", "flat", contextlib.nullcontext)}
    else:
        others = {"flat-plain": (config, "flat", st.plain_ops),
                  "3d": (config, "3d", contextlib.nullcontext)}
    k, udf = make_sim(torch, wt, config, n, dev)                 # engine="auto"
    check(k.engine == "flat", f"phase5: auto picked {k.engine} on CUDA")
    sims = {mode: make_sim(torch, wt, cfg_o, n, dev, engine=engine)[0]
            for mode, (cfg_o, engine, _) in others.items()}
    shape, failures = k.flow.cfg.shape, []
    for step in range(1, 6):
        k.sim_step(remeasure=False, udf=udf)
        for mode, o in sims.items():
            with others[mode][2]():
                o.sim_step(remeasure=False, udf=udf)
            du = (k.flow.u - o.flow.u).abs().max().item()
            dp = (k.flow.p - o.flow.p).abs().max().item()
            su, sp = o.flow.u.abs().max().item(), o.flow.p.abs().max().item()
            held = next((h for h in HELD.get((config, mode), HELD_DEFAULT)
                         if h[0] == step), None)
            print(f"phase5 {config} {shape} step {step}, flat vs {mode}: pois_n "
                  f"{k.pois_n[-2:]} vs {o.pois_n[-2:]}; max|du|/max|u|="
                  f"{du / su:.3e}, max|dp|/max|p|={dp / sp:.3e}"
                  + (f" (held to {held[1]:.0e}, {held[2]:.0e}, "
                     f"iterations within {held[3]})" if held else ""), flush=True)
            if held is None:
                continue
            if not (len(k.pois_n) == len(o.pois_n) and all(
                    abs(a - b) <= held[3] for a, b in zip(k.pois_n, o.pois_n))):
                failures.append(f"{config}: iteration counts of flat and {mode} "
                                f"differ by more than {held[3]}")
            if not du <= held[1] * su:
                failures.append(f"{config}: u of flat differs from {mode}")
            if not dp <= held[2] * sp:
                failures.append(f"{config}: p of flat differs from {mode}")
    torch.cuda.synchronize()
    return failures


def main() -> int:
    t_start = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on an NVIDIA GPU", file=sys.stderr)
        return 2
    import waterlily_tpu_torch as wt
    from waterlily_tpu_torch.ops import _build
    from waterlily_tpu_torch.ops import stencil3d as st

    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    print(f"phase1 python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc_version(_build.nvcc_path())}' "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load()
    print(f"phase2 nvcc build + load {time.perf_counter() - t0:.2f} s "
          f"({_build.build_info['path']})", flush=True)
    check_build(_build)

    stats = phase_kernels(torch, np, wt, dev)
    runs = {(c, e): phase_main(torch, wt, st, dev, c, e) for c, e in MAIN_RUNS}
    a, b = runs[("sphere-mp", "flat")], runs[("sphere-s2", "flat")]
    print(f"phase4 smooth_it=2, bf16 smoothing vs float32: ms/step "
          f"{a['ms_step']:.3f} vs {b['ms_step']:.3f}; pois_n {a['pois_n']} vs "
          f"{b['pois_n']}; peak {a['peak'] / 2**30:.3f} vs {b['peak'] / 2**30:.3f} GiB",
          flush=True)
    runs[("probe", "tool")] = phase_probe(torch, st)
    check(set(runs) == set(PATH_KERNELS), "phase4: a path was not run")
    launches = {k: sum(r["counts"][k] for r in runs.values()) for k in KERNELS}
    check(all(n > 0 for n in launches.values()),
          f"phase4: a kernel was launched by no path: {launches}")
    failures = [f for config in SMALL
                for f in phase_compare(torch, wt, st, dev, config, SMALL[config])]
    check(not failures, f"phase5: {'; '.join(failures)}")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
                "bound_ms": stats[k]["bound_ms"], "bound_by": stats[k]["bound_by"],
                "library_ms": stats[k]["library_ms"]}
               for k, (_, src, rep, _, _) in KERNELS.items()]
    check(set(st.launch_counts()) == set(KERNELS),
          "the kernels table and the launch counts name different kernels")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
