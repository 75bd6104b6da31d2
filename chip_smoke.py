#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the CUDA kernels of ``waterlily_tpu_torch/csrc`` with ``nvcc`` (one
   process a source, all started together); the
   compiler's report (``-Xptxas -v``) must show all 27 conv–diff
   instantiations (K12: 3 schemes × 8 periodic masks, K1: 3 schemes), the 24
   of K12's tangent tile (3 schemes × 8 masks), the 16
   of K7's tiled cascade (1–4 colours, with and without norms, float32 and
   bf16), the 8 of K15's (1–4 colours, float32 and bf16) and the 4 of K13's
   (1–4 colours) with no stack frame and no spills;
3. each kernel (and each mode: K12 periodic, K9 keeping the exit plane, K2
   with its band in the middle, at row 1, at row Nx−1, empty and periodic,
   the bf16 smoothers with 0, 2 and 4 colours and with and without norms,
   K7 with 4, 2 and 3 colours and K6, K15, K13 and the bf16 K5 and K7 with
   4 colours on each of their routes, the tiled cascade and the per-colour
   launches, where the shape allows it; K12's tangent kernel with every
   scheme on every periodic mask, against `torch.func.jvp` of the plain
   conv–diff)
   against its plain PyTorch version in float32 on random inputs at the
   shapes the main paths give it (258³ fine level, 130³, 66³ and 18³ MG
   levels, a non-cubic (50, 34, 34) and an odd-interior (51, 34, 35)), and
   the median time of each case at 258³ beside its plain version's; K12,
   K1, K7, K15, K13, the bf16 K5 and K7 and K12's tangent are also timed at
   the drag grid
   (322, 130, 130), K15, K13 and the bf16 K5 and K7 at 130³ too, and each
   of their times is printed beside the kernels they replaced
   (``BEFORE_MS``: K12, K1 and K12's tangent one thread per (cell,
   component), K7, K15, K13 and the bf16 K5 and K7 a launch per colour);
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
      flat engine: ms/step, ``pois_n`` and peak memory side by side, and
      the route each bf16 smoother call took on each level (the bf16 K7
      on 258³ and K5 on 130³ and 66³ must take their cascades);
   g. ``probe``: ``tools/bandwidth_probe.py``'s copy and launch-cost probes;
   h. ``launch``: ``tools/launch_cost.py``'s table, the host µs per call of
      every wrapper on an 18³ level (the copies on 8³ fields) beside
      ``torch.mul``'s on the same tensors, the pieces of a launch and the
      floor of a launch from a C loop;
   i. ``moving``: ``bench.py``'s oscillating sphere (radius N/8 at (N/3,
      N/2, N/2), ν = radius/1e3, the map x − (A sin ωt, 0, 0) with A =
      radius/2, ω = 1/radius) at 128³ and 192³ on the flat engine and at
      128³ on the 3d engine, 10 steps of ``sim_step(remeasure=True)`` and,
      on the flat engine, one ``sim_step_n(5, remeasure=True)``: the
      build, the measure's and the whole step's ms per step (CUDA events
      around each, steps 3–10), the measure box's cells against the
      grid's, the measure rounds (more than one: the body escaped its box),
      ``band_x`` after steps 1, 5 and 10, ``pois_n`` and peak memory;
5. at small size, 5 steps compared after each (every step's figures are
   printed; held after step 5 to 1e-4·max|u|, 1e-3·max|p| and iteration
   counts within one unless said otherwise): the flat engine with the
   kernels (built with ``engine="auto"``) against the flat engine with
   ``plain_ops()``, and against the 3d engine with the kernels, on a 64³
   sphere, a 64³ Taylor–Green vortex, ``examples/sphere_drag.py``'s sphere
   at N = 64 (160×64×64, R = 8) and the 64³ ``les`` and ``ramp`` spheres.
   The oscillating sphere (``moving``) is compared the same way at 64³,
   each step after a re-measure, its pressure difference at each cell
   weighted by the cell's largest face coefficient L (by at most which the
   pressure moves the flow): a cell that re-enters the fluid with a
   diagonal D near −2e-6 takes a pressure that the float32 rounding of its
   residual, times 1/D, sets (0.106·max|p| apart between the kernels and
   the plain versions after step 5, u within 4e-6·max|u|), and its faces'
   L near 2e-6 keep that out of the flow; the unweighted difference and
   its cell are printed too.  At 128³, 3 steps of it re-measured on the
   box (the flat engine's default) against 3 re-measured densely
   (``band_measure = False``): μ0, μ1, V and u after each step, printed as
   equal bit for bit or with the largest difference, held to
   1e-6·max|·|.
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

6. the 2-D path (no hand kernel runs: they take 3-D float32 fields; each
   run's launch counts must stay 0): ``examples/circle.py`` at its own size
   (R = 16, 384×256, Re = 250) in float64 on the card, 10 steps, against
   the same run on the CPU (u and p within 1e-9 of max, equal ``pois_n``);
   the circle at R = 64 (1,536×1,024) in float32 after ``perturb``, 20
   steps: ms/step, ``pois_n`` and C_d; ``examples/flapping_foil.py`` (L =
   32, 256×128, float32) re-measured every step, 5 steps, the measure and
   the step timed;
7. PCG: the 256³ sphere of 4a with ``psolver="pcg"`` (``engine="auto"``
   must pick the 3d engine), 5 steps with its launch counts (K12, K14 and
   K16 for every A·x of the conjugate gradient) and a solver log, then the
   same 5 steps under ``plain_ops()``, compared after each: iterations
   within one, after step 1 u within 1e-4·max|u| and p within 1e-3·max|p|;
   every solve stops at ``itmx`` (expected at 256³) and the stopped CG
   amplifies rounding from step to step, so after step 5 the kernels may
   also lie within 4 times the distance between the plain run and a plain
   run from an initial u changed by 1e-7 of itself (1.4e-4·max|u| on an H100,
   against a 1e-4 limit); its ms/step, the outer iterations of each solve
   and K16's launches;
8. the utilities on the PCG sphere's state: ``lambda2_field`` (timed, and
   the memory it takes) and ``MeanFlow.update`` with u⊗u (timed), an npz
   round trip of the state and the means that must come back bit for bit,
   a VTK write and read that must hold the state, phase 7's solver log read
   back by ``parse_log``, and ``update_particles`` on 100,000 tracers;
   matplotlib must not have been imported.  Files go to
   ``build/chip_smoke/`` in the checkout and are deleted;
9. forward-mode AD (`torch.func.jvp` through `mom_step_impl` on the 3d
   engine, float32, dt and t carried as 0-d tensors): the 256³ sphere of
   4a, d(F_x)/d(Re) after 5 steps (Re = U R/ν, F the pressure + viscous
   force), its primal run and its jvp timed (ms per step, peak memory), the
   jvp's launch counts (K12 and its tangent kernel ``conv_diff_jvp_k``,
   K14, K15, K16; no other kernel, none plain), then the same jvp under
   ``plain_ops()``: the derivatives within ``AD_SPHERE_TOL`` and every
   primal and tangent solve's iterations within one, and the tangent
   kernel's ms on the sphere's state beside the jvp step's; and the 64³
   Taylor–Green vortex (periodic: K13), dKE/dRe against the kernels'
   central difference (h = 1 % of Re) within 10 %, and its
   `torch.func.jacfwd` (every rule once per batch entry) against its jvp
   within 1e-6, with equal iteration counts, on the kernels;
10. domain decomposition (`parallel.DistSimulation`, one worker thread a
   shard, four shards on ``cuda:0``): (a) the 64³ sphere in float64 on a
   (4,) mesh with the flat engine and on (2, 2) with the 3d engine, 5 steps
   each against the same engine's single-device run on the card, u and p
   within 1e-10 of max and equal ``pois_n`` (no kernel runs in float64:
   this holds the exchange itself); (b) the 64³ float32 flat-engine sphere
   on (4,) with the kernels against the same run under ``plain_ops()``,
   after each of 5 steps, held to the phase-5 limits after step 5 (the
   plain run launches nothing); (c) the 256³ sphere of 4a, 10 steps on (4,)
   with the flat engine and on (2, 2) with the 3d engine, each beside the
   same engine's single-device run in this process: ms/step (steps 3-10 by
   CUDA events), peak memory, collectives and halo bytes per step, the
   launches per step of K14, K11, K16 and K6 (``incr_gs_k`` without
   colours, told from K7 by a tally of its calls) against
   ``PATH_KERNELS[("sphere-dist", engine)]``, with K1, K7, K8 and K9 at 0;
   u after step 10 within 1e-3·max|u| of the single-device run, iterations
   within one per solve; then one more flat step in which the arguments of
   the last fine-level call of K14, K11, K16 and K6 by an inner shard
   (both x ghosts from the ring) are kept, and each kernel is held against
   its plain version on them at its phase-3 tolerance; (d) ``torch.cuda.device_count()``, and (c)'s flat
   case on distinct cards when there are at least two (else a line that it
   was skipped); (e) the 256³ PCG sphere of phase 7 on (4,) (3d engine:
   K16 for every A·x of each shard's conjugate gradient, nothing else), 3
   steps, after each against the same steps under ``plain_ops()`` and
   against phase 7's single-device steps, held as phase 7 holds its run
   (iterations within one, u and p within 1e-4 and 1e-3 of max after step
   1, after step 3 within those or 4 times phase 7's twin distance), K16
   launched once per CG iteration and shard; (f) the 256³ LES sphere of
   4d on (4,) with the flat engine, 3 steps (K14, K11, K16 and K6 on every
   shard, K7 never) against the same steps under ``plain_ops()`` at (b)'s
   limits, and the 64³ float64 sphere with the LES against one device
   (1e-10, equal ``pois_n``); (g) `torch.func.jvp` in ν of one 3d step on
   (4,), each shard's through `shard_jvp`: float64 64³ against the
   single-device jvp (1e-10 of max, a non-zero tangent, equal iterations
   of every primal and tangent solve), then the 256³ float32 sphere's jvp
   step timed beside its decomposed primal step (K16 on the replicated
   coarsest level of both solves) and held against the same jvp step under
   ``plain_ops()``, against the single device's jvp step after the same
   primal steps of its own, with its kernels and under ``plain_ops()``,
   and, from the single device's state, against its jvp step (u and p
   within 1e-4 and 1e-3 of max, the tangents and d(dt)/dν within
   ``AD_SPHERE_TOL``, iterations within one); (h) the 64³
   oscillating sphere of 4i in float64 on (4,) with the flat engine,
   re-measured every step (its surface crosses the shard bound x = 16), 5
   steps against one device (1e-10, p weighted by each cell's largest face
   L as in phase 5, equal ``pois_n``), and the single device on the CPU
   against the card to the same limits (its unweighted p printed: a
   near-singular cell's p moves with the order of the sums).  Each of (e)-(g) prints its ms/step,
   collectives and launches per step.

Before its last line it prints one JSON object with each kernel's launches
(summed over the phase-4 runs a-g and i and the phase-6, 7, 9 and 10 (c, e-g) runs), error,
times, bound, host µs per call, the launches of the 4h table
(``tool_launches``, kept out of ``launches``), of the PCG run
(``pcg_launches``), of the AD runs (``ad_launches``) and of the 256³
distributed runs of 10c and 10e-g (``dist_launches``, all three in
``launches``), and the
card's name and power limit;
the last line is ``{"ok": true, "device": {...}}``.  Needs no JAX and no
network.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib.util
import json
import math
import pathlib
import statistics
import subprocess
import sys
import threading
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
_JVP = "waterlily_tpu_torch/csrc/convdiff_jvp.cu"
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
    # 4 colours: x, r in and out (16 B) and five bf16 coefficients (10 B);
    # the operations of `gs_incr_k`
    "gs_incr_mp_k": (_MP_TOL, _STENCIL, "waterlily_tpu/ops/pallas_flat.py:759",
                     26, 44),
    # x, r, eps in, x, r out (20 B) and five bf16 coefficients (10 B)
    "incr_gs_mp_k": (_MP_TOL, _FUSED, "waterlily_tpu/ops/pallas_flat.py:896",
                     30, 60),
    "copy_scale_k": (0.0, _PROBE, "benchmarks/leanprobe.py:99", 8, 1),
    "copy_scale6_k": (0.0, _PROBE, "benchmarks/bwprobe.py:128", 48, 6),
    # K12's tangent: u, du in, dr out (36 B); 9 tangent face fluxes of ~40
    # operations and their sums a cell; the JAX package takes the jvp of
    # the conv-diff of the TPU kernel it replaces
    "conv_diff_jvp_k": (2e-5, _JVP, "waterlily_tpu/ops/pallas3d.py:274", 36, 400),
}
DRAG_GRID = (322, 130, 130)      # `drag_sim(128)` with its ghost cells
# every periodic mask of K12 and its tangent, walled first
PER_MASKS = [tuple(j for j in range(3) if m >> j & 1) for m in range(8)]
# the tangent kernel's cases that phase 3 times (its plain version, a
# `torch.func.jvp`, takes 55-190 ms a call at 258^3 on an NVIDIA H100 80GB
# HBM3 at 700 W)
JVP_TIMED = ("quick", "vanleer", "cds", "quick per=012")
# the redesigned kernels: timed at the drag grid too, beside `BEFORE_MS`
REDESIGNED = ("conv_diff_k", "conv_diff_bdim_k", "incr_gs_k", "gs_incr_k",
              "gauss_sweeps_k", "gs_incr_mp_k", "incr_gs_mp_k", "conv_diff_jvp_k")
# the shapes at which a redesigned kernel is timed besides 258^3: the
# smoothers whose routes change with the level also at 130^3
TIMED_AT = {DRAG_GRID: REDESIGNED,
            (130,) * 3: ("gs_incr_k", "gauss_sweeps_k", "gs_incr_mp_k",
                         "incr_gs_mp_k")}
# ms per call of the kernels that the redesigns replaced, on an NVIDIA H100
# 80GB HBM3 at 700 W.  K12 and K1 (one thread per (cell, component), every
# flux evaluated twice, cached global reads): at 258^3 from this script's
# phase 3 on the commit before the tiles, at the drag grid from
# `tools/convdiff_bench.py` run in that commit's checkout in one call with
# the tiled kernels.  K7 (a head pass, a launch per colour, a tail pass):
# from `tools/incr_gs_bench.py` run in the parent commit's checkout in one
# call with the cascade.  K15 and K13 (a launch per colour, and per colour
# and periodic direction): from `tools/smoother_bench.py --smoke` run in the
# parent commit's checkout (Jacobi, K15 with no colours, is unchanged).  The
# bf16 K5 and K7 (a launch per colour): from `tools/smoother_bench.py
# --smoke --mp` run in the parent commit's checkout.  K12's tangent (one
# thread per (cell, component), every dual flux evaluated twice, cached
# global reads): this script's phase 3 on the commit before its tile
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
    ((258,) * 3, "gs_incr_mp_k", "[]"): 0.2076,
    ((258,) * 3, "gs_incr_mp_k", "[0, 1, 0, 1]"): 0.8286,
    ((258,) * 3, "gs_incr_mp_k", "[1, 0]"): 0.5529,
    ((258,) * 3, "incr_gs_mp_k", "[0, 1, 0, 1] norms=True"): 0.9565,
    ((258,) * 3, "incr_gs_mp_k", "[1, 0] norms=True"): 0.6860,
    ((258,) * 3, "incr_gs_mp_k", "[0, 1, 0, 1] norms=False"): 0.9436,
    ((130,) * 3, "gs_incr_mp_k", "[]"): 0.0590,
    ((130,) * 3, "gs_incr_mp_k", "[0, 1, 0, 1]"): 0.1095,
    ((130,) * 3, "gs_incr_mp_k", "[1, 0]"): 0.0764,
    ((130,) * 3, "incr_gs_mp_k", "[0, 1, 0, 1] norms=True"): 0.1356,
    ((130,) * 3, "incr_gs_mp_k", "[1, 0] norms=True"): 0.1098,
    ((130,) * 3, "incr_gs_mp_k", "[0, 1, 0, 1] norms=False"): 0.1294,
    (DRAG_GRID, "gs_incr_mp_k", "[]"): 0.0754,
    (DRAG_GRID, "gs_incr_mp_k", "[0, 1, 0, 1]"): 0.2721,
    (DRAG_GRID, "gs_incr_mp_k", "[1, 0]"): 0.1895,
    (DRAG_GRID, "incr_gs_mp_k", "[0, 1, 0, 1] norms=True"): 0.3239,
    (DRAG_GRID, "incr_gs_mp_k", "[1, 0] norms=True"): 0.2410,
    (DRAG_GRID, "incr_gs_mp_k", "[0, 1, 0, 1] norms=False"): 0.3067,
    ((258,) * 3, "conv_diff_jvp_k", "quick"): 3.293,
    ((258,) * 3, "conv_diff_jvp_k", "vanleer"): 2.874,
    ((258,) * 3, "conv_diff_jvp_k", "cds"): 1.798,
    ((258,) * 3, "conv_diff_jvp_k", "quick per=012"): 3.291,
    (DRAG_GRID, "conv_diff_jvp_k", "quick"): 1.155,
    (DRAG_GRID, "conv_diff_jvp_k", "vanleer"): 0.995,
    (DRAG_GRID, "conv_diff_jvp_k", "cds"): 0.627,
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
    # the oscillating sphere re-measured every step: the kernels of the
    # static sphere (the measure itself runs plain PyTorch)
    ("moving", "flat"): {"conv_diff_bdim_k", "bdim_k", "mult_k", "gs_incr_k",
                         "incr_gs_k", "bc_div_k", "projbc_k"},
    ("moving", "3d"): {"conv_diff_k", "bdim_k", "mult_k", "gs_incr_k"},
    # 2-D: no hand kernel (they take 3-D float32 fields)
    ("circle", "3d"): set(),
    ("circle-64", "3d"): set(),
    ("foil", "3d"): set(),
    # PCG on the 3d engine: K12, K14, and K16 for every A·x of the CG
    ("pcg", "3d"): {"conv_diff_k", "bdim_k", "mult_k"},
    ("probe", "tool"): {"copy_scale_k", "copy_scale6_k"},
    # phase 9, forward-mode AD on the 3d engine: K12 and its tangent kernel,
    # K14 (primal and tangent launches), the solver's kernels on the primal
    # and tangent solves (K15 walled; K13 and K16 periodic)
    ("ad-sphere", "3d"): {"conv_diff_k", "conv_diff_jvp_k", "bdim_k", "mult_k",
                          "gs_incr_k"},
    ("ad-tgv", "3d"): {"conv_diff_k", "conv_diff_jvp_k", "bdim_k", "mult_k",
                       "gauss_sweeps_k"},
    # phase 10, the 256³ sphere on four shards of the card: on the flat
    # engine K14 on the whole shard, K11, K16 (the residuals and the
    # replicated coarsest level's increment) and K6 (``incr_gs_k`` with no
    # colours; K7 is told apart by `incr_gs_tally`); the 3d engine is plain
    # under decomposition but for K16 on the replicated coarsest level
    ("sphere-dist", "flat"): {"bdim_k", "div_k", "mult_k", "incr_gs_k"},
    ("sphere-dist", "3d"): {"mult_k"},
    # phase 10e-g: PCG on the 3d engine, K16 for every A·x of each shard's
    # conjugate gradient; the LES on the flat engine, the four kernels of
    # the flat dist path; the jvp of a 3d step, K16 on the replicated
    # coarsest level of the primal and tangent solves
    ("pcg-dist", "3d"): {"mult_k"},
    ("les-dist", "flat"): {"bdim_k", "div_k", "mult_k", "incr_gs_k"},
    ("ad-dist", "3d"): {"mult_k"},
    # `tools/launch_cost.py` calls every wrapper
    ("launch", "tool"): set(KERNELS),
}
# the row of `tools/launch_cost.py` whose host µs per call each kernel's
# JSON entry carries: the mode phase 3 times first where the tool has it
HOST_ROW = {"conv_diff_k": "conv_diff_k", "conv_diff_bdim_k": "conv_diff_bdim_k",
            "bdim_k": "bdim_k", "bdim_band_k": "bdim_band_k", "mult_k": "mult_k",
            "gs_incr_k": "gs_incr_k 4 colours",
            "gauss_sweeps_k": "gauss_sweeps_k 4 colours xyz",
            "incr_gs_k": "incr_gs_k 4 colours norms", "bc_div_k": "bc_div_k",
            "projbc_k": "projbc_k cfl", "bc_k": "bc_k", "div_k": "div_k",
            "gs_incr_mp_k": "gs_incr_k mp 4 colours",
            "incr_gs_mp_k": "incr_gs_k mp 4 colours norms",
            "copy_scale_k": "copy_scale_k", "copy_scale6_k": "copy_scale6_k",
            "conv_diff_jvp_k": "conv_diff_jvp_k"}
# the paths of phases 6 and 7
LATER_PATHS = {("circle", "3d"), ("circle-64", "3d"), ("foil", "3d"), ("pcg", "3d"),
               ("ad-sphere", "3d"), ("ad-tgv", "3d"), ("sphere-dist", "flat"),
               ("sphere-dist", "3d"), ("pcg-dist", "3d"), ("les-dist", "flat"),
               ("ad-dist", "3d")}
# (configuration, engine) in the order phase 4 runs them
MAIN_RUNS = [(c, e) for c in ("sphere", "tgv", "drag", "les", "ramp")
             for e in ("flat", "3d")] + [("sphere-mp", "flat"), ("sphere-s2", "flat"),
                                         ("moving", "flat"), ("moving", "3d")]
# the grids of the moving runs, per engine
MOVING_SIZES = {"flat": (128, 192), "3d": (128,)}


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
         "conv-diff tangent": ("conv_diff_jvp_tile_kernel", 24),
         "K7 cascade": ("incr_gs_tile_kernel", 16),
         "K15 cascade": ("gs_incr_tile_kernel", 8),
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
    # K12's tangent kernel, every scheme and periodic mask, against the plain
    # version's derivative (`torch.func.jvp` of `conv_diff_plain`)
    dnu = torch.tensor(-0.4, dtype=f32, device=dev)
    for per in PER_MASKS:
        for sid, scheme in enumerate(st.SCHEMES):
            tag = f"{scheme.__name__}" + (f" per={''.join(map(str, per))}" if per else "")
            cases.append(("conv_diff_jvp_k", tag,
                          lambda sid=sid, per=per: st.conv_diff_jvp_k(u, u0, nu, dnu,
                                                                      sid, per),
                          lambda scheme=scheme, per=per: st.conv_diff_jvp_plain(
                              u, u0, nu, dnu, scheme, per)))
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
    # the bf16 instantiations of K15 and K7 on the level's bf16 coefficients:
    # the route the level takes, then 4 colours on each route
    bf = ps.with_bf16(lev).bf
    for cols in ([0, 1, 0, 1], [1, 0], []):
        cases.append(("gs_incr_mp_k", str(cols),
                      lambda cols=cols: st.gs_incr_k(x, r, *bf, cols, 0.9, mp=True),
                      lambda cols=cols: st.gs_incr_plain(x, r, *bf, cols, 0.9, mp=True)))
    for route, rname in ((st.CASCADE, "cascade"), (st.PER_COLOUR, "per-colour")):
        cases.append(("gs_incr_mp_k", f"[0, 1, 0, 1] {rname}",
                      lambda route=route: st._gs_incr_launch(
                          x, r, *bf, [0, 1, 0, 1], 0.9, True, route),
                      lambda: st.gs_incr_plain(x, r, *bf, [0, 1, 0, 1], 0.9,
                                               mp=True)))
    for cols, nrm, route in (([0, 1, 0, 1], True, None), ([1, 0], True, None),
                             ([0, 1, 0, 1], False, None),
                             ([0, 1, 0, 1], True, st.CASCADE),
                             ([0, 1, 0, 1], True, st.PER_COLOUR)):
        def k7m(cols=cols, nrm=nrm, route=route):
            out = (fz.incr_gs_k(x, r, eps, *bf, cols, 0.9, nrm, mp=True)
                   if route is None else
                   fz._incr_gs_launch(x, r, eps, *bf, cols, 0.9, nrm, mp=True,
                                      route=route))
            return (*out[:2], out[2][0:1], out[2][1:2]) if nrm else out

        def p7m(cols=cols, nrm=nrm):
            out = fz.incr_gs_plain(x, r, eps, *bf, cols, 0.9, nrm, mp=True)
            return (*out[:2], out[2][0:1], out[2][1:2]) if nrm else out
        rname = {None: "", st.CASCADE: " cascade", st.PER_COLOUR: " per-colour"}
        cases.append(("incr_gs_mp_k", f"{cols} norms={nrm}{rname[route]}", k7m,
                      p7m))
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
            if ((shape == fine or name in TIMED_AT.get(shape, ()))
                    and (name != "conv_diff_jvp_k" or label in JVP_TIMED)):
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
                    # K5: 4 colours; the bf16 K7: 4 colours with norms; the
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
                      f"ms per call; the kernel at 256 threads {stats[name]['ms']:.4f}"
                      f" ms ({stats[name]['ms'] / lib:.3f} of torch.mul's)", flush=True)
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


def moving_sim(torch, wt, n: int, dev, dtype=None, **kw):
    """`bench.py`'s moving rung: the sphere of `sphere_sim` oscillating in x
    under the map x − (A sin ωt, 0, 0), A = radius/2, ω = 1/radius (float32
    unless ``dtype`` is given)."""
    radius = n // 8
    dtype = dtype or torch.float32
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=dtype, device=dev)
    amp, om = radius / 2.0, 1.0 / radius

    def sdf(x, t):
        return torch.sqrt(torch.sum((x - ctr) ** 2)) - radius

    def map_fn(x, t):
        return x - torch.stack([amp * torch.sin(om * t), 0 * t, 0 * t])
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e3,
                         body=wt.AutoBody(sdf, map_fn), dtype=dtype, device=dev, **kw)


def circle_sim(torch, wt, radius: int, dev, **kw):
    """`examples/circle.py`: a (24R, 16R) channel, a circle of radius R at
    (2R, 2R), Re = 250 (the README's 2-D example)."""
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 2 * radius) ** 2)) - radius)
    return wt.Simulation((24 * radius, 16 * radius), (1.0, 0.0), radius,
                         nu=radius / 250, body=body, device=dev, **kw)


def foil_sim(torch, wt, L: int, dev, **kw):
    """`examples/flapping_foil.py`: a (8L, 4L) channel, a segment of chord
    L and thickness 4 heaving by A = L/2 and pitching by 0.3 rad about its
    leading edge at Strouhal number 0.3, Re = 250; re-measured every step."""
    amp = 0.5 * L
    f = 0.3 / (2 * amp)

    def map_fn(x, t):
        h = amp * torch.sin(2 * math.pi * f * t)
        th = 0.3 * torch.cos(2 * math.pi * f * t)
        c, s = torch.cos(th), torch.sin(th)
        y = x - torch.stack([2.0 * L + 0 * h, 2.0 * L + h])
        return torch.stack([c * y[0] + s * y[1], -s * y[0] + c * y[1]])

    def sdf(x, t):
        cl = torch.clamp(x[0], 0.0, L)
        return torch.sqrt((x[0] - cl) ** 2 + x[1] ** 2) - 2.0
    return wt.Simulation((8 * L, 4 * L), (1.0, 0.0), L, nu=L / 250,
                         body=wt.AutoBody(sdf, map_fn), device=dev, **kw)


def make_sim(torch, wt, config: str, n: int, dev, **kw):
    """The `Simulation` of a configuration at size ``n`` (for ``circle`` the
    radius, float32 unless ``dtype`` is given) and the ``udf`` its steps
    take."""
    if config == "circle":
        return circle_sim(torch, wt, n, dev, **kw), None
    if config == "pcg":
        kw = dict(kw, psolver="pcg")
    if config == "tgv":
        return tgv_sim(torch, wt, n, dev, **kw), None
    if config == "drag":
        return drag_sim(torch, wt, n, dev, **kw), None
    if config == "les":
        return les_sim(torch, wt, n, dev, **kw), les_udf()
    if config == "ramp":
        return ramp_sim(torch, wt, n, dev, **kw), None
    if config == "moving":
        return moving_sim(torch, wt, n, dev, **kw), None
    if config in ("sphere-mp", "sphere-s2"):
        kw = dict(kw, smooth_it=2, mp_smooth=config == "sphere-mp")
    return sphere_sim(torch, wt, n, dev, **kw), None


# ------------------------------------------------------------ phase 4
@contextlib.contextmanager
def bf16_routes(st, fz, tally):
    """Count each call of the bf16 smoothers by (kernel, level shape,
    colours, route taken) while it runs: K4 (no colours) and K5 share the
    wrapper `gs_incr_mp_k`, and the route follows the level."""
    lib = st._lib()
    gs, ig = st._gs_incr_launch, fz._incr_gs_launch

    def gs_tally(x, r, L, D, iD, colors, omega, mp, route=None):
        if mp:
            rt = (lib.wlt_gs_incr_route(*x.shape, len(colors), 1)
                  if route is None else route)
            tally[("gs_incr_mp_k", tuple(x.shape), len(colors), rt)] += 1
        return gs(x, r, L, D, iD, colors, omega, mp, route)

    def ig_tally(x, r, eps, L, D, iD, colors, omega, want_norms=False,
                 mp=False, route=None):
        if mp:
            rt = (lib.wlt_incr_gs_route(*x.shape, len(colors), 1)
                  if route is None else route)
            tally[("incr_gs_mp_k", tuple(x.shape), len(colors), rt)] += 1
        return ig(x, r, eps, L, D, iD, colors, omega, want_norms, mp, route)

    st._gs_incr_launch, fz._incr_gs_launch = gs_tally, ig_tally
    try:
        yield tally
    finally:
        st._gs_incr_launch, fz._incr_gs_launch = gs, ig


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
    from waterlily_tpu_torch.ops import fused3d as fz
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
    routes = collections.Counter()
    st.reset_launch_counts()
    for k in range(1, STEPS + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        with (bf16_routes(st, fz, routes) if config == "sphere-mp"
              else contextlib.nullcontext()):
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
        for (name, lev, ncol, rt), calls in sorted(routes.items()):
            print(f"{tag} {name} on {lev} with {ncol} colours: {calls} calls "
                  f"on the {'cascade' if rt == st.CASCADE else 'per-colour route'}",
                  flush=True)
        # the redesigned bf16 smoothers took their cascades: K7 on 258^3,
        # K5 (2 colours) on 130^3 and 66^3
        want = {("incr_gs_mp_k", (FINE + 2,) * 3), ("gs_incr_mp_k", (130,) * 3),
                ("gs_incr_mp_k", (66,) * 3)}
        got = {(name, lev) for (name, lev, ncol, rt) in routes
               if ncol > 0 and rt == st.CASCADE}
        check(want <= got, f"{tag}: a bf16 smoother missed its cascade: "
              f"{sorted(want - got)}")
    for k, n in counts.items():
        if k in PATH_KERNELS[(config, engine)]:
            check(n > 0, f"{tag}: kernel {k} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {k} of another path was launched")
    pois = list(sim.pois_n)
    del sim, u, p
    return dict(counts=counts, ms_step=ms_step, step_ms=step_ms, peak=peak,
                build_s=build_s, pois_n=pois)


def time_measure(torch, sim, events: list) -> None:
    """Record CUDA events around every ``sim.measure()`` from now on, with
    the rounds it took, into ``events`` (an instance attribute in front of
    the method, which `step_once` calls)."""
    measure = sim.measure

    def timed(t=None):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        measure(t)
        b.record()
        events.append((a, b, sim.measure_rounds))
    sim.measure = timed


def box_cells(cfg) -> tuple[int, int]:
    """Cells of the measure box ``cfg.band_box`` (the grid's interior when
    there is none) and of the grid's interior."""
    grid = math.prod(n - 2 for n in cfg.shape)
    if cfg.band_box is None:
        return grid, grid
    return math.prod(hi - lo for lo, hi in cfg.band_box), grid


def phase_moving(torch, st, wt, dev, engine: str):
    """The oscillating sphere at each size of ``MOVING_SIZES[engine]``:
    ``STEPS`` re-measured steps (and on the flat engine one
    ``sim_step_n(5, remeasure=True)``), the measure and the step timed
    apart; the launch counts of all its steps."""
    total = collections.Counter()
    out = {}
    for n in MOVING_SIZES[engine]:
        tag = f"phase4 moving [{engine}] {n}^3"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sim, _ = make_sim(torch, wt, "moving", n, dev, engine=engine)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        check(sim.engine == engine, f"{tag}: Simulation runs engine {sim.engine}")
        cfg = sim.flow.cfg
        cells, grid = box_cells(cfg)
        print(f"{tag} build {cfg.shape}: {build_s:.2f} s, band_x {cfg.band_x}, "
              f"band_box {cfg.band_box}, box cells {cells} of {grid}", flush=True)
        meas, steps, bands, boxes = [], [], {}, []
        time_measure(torch, sim, meas)
        st.reset_launch_counts()
        for k in range(1, STEPS + 1):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            sim.sim_step(remeasure=True)
            b.record()
            steps.append((a, b))
            boxes.append(box_cells(sim.flow.cfg)[0])
            if k in (1, 5, STEPS):
                bands[k] = sim.flow.cfg.band_x
        n_loop = len(sim.pois_n)
        if engine == "flat":
            sim.sim_step_n(5, remeasure=True)
        torch.cuda.synchronize()
        counts = st.launch_counts()
        total.update(counts)
        peak = torch.cuda.max_memory_allocated()
        meas_ms = [a.elapsed_time(b) for a, b, _ in meas]
        step_ms = [a.elapsed_time(b) for a, b in steps]
        rounds = [r for _, _, r in meas]
        m_mean, s_mean = statistics.mean(meas_ms[2:STEPS]), statistics.mean(step_ms[2:])
        u, p = sim.flow.u, sim.flow.p
        print(f"{tag} measure ms/step (steps 3-{STEPS}, mean) {m_mean:.3f}, step "
              f"ms/step (measure included) {s_mean:.3f}, measure share "
              f"{m_mean / s_mean:.3f}; per step measure "
              f"{[round(t, 3) for t in meas_ms[:STEPS]]}, step "
              f"{[round(t, 3) for t in step_ms]}", flush=True)
        print(f"{tag} box cells per step {boxes} of {grid}; "
              f"measure rounds per call {rounds}; band_x after steps "
              f"{bands}; after sim_step_n {sim.flow.cfg.band_x}", flush=True)
        print(f"{tag} pois_n {sim.pois_n}; dt {[round(d, 5) for d in sim.flow.dt]}; "
              f"max|V_x| {sim.flow.state.V[0].abs().max().item():.5f}; "
              f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)", flush=True)
        print(f"{tag} launch counts {counts}", flush=True)
        itmx = sim.flow.cfg.itmx
        check(tuple(u.shape) == (3,) + cfg.shape and tuple(p.shape) == cfg.shape,
              f"{tag}: wrong field shapes")
        check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(p).all()),
              f"{tag}: u or p not finite")
        check(all(0.0 < d <= 10.0 for d in sim.flow.dt), f"{tag}: dt out of (0, 10]")
        check(n_loop == 2 * STEPS and len(sim.pois_n) == n_loop
              + (10 if engine == "flat" else 0)
              and all(1 <= i <= itmx for i in sim.pois_n),
              f"{tag}: a pressure solve left [1, itmx={itmx}]: {sim.pois_n}")
        check(len(meas) == STEPS + (5 if engine == "flat" else 0)
              and all(1 <= r <= 8 for r in rounds), f"{tag}: measure calls {rounds}")
        # the body's velocity is A·ω·cos(ωt) ≤ 0.5 in x and nothing else
        vmax = sim.flow.state.V.abs().amax(dim=(1, 2, 3)).tolist()
        check(0.0 < vmax[0] <= 0.5 * (1 + 1e-5) and max(vmax[1:]) <= 1e-6 * vmax[0],
              f"{tag}: body velocity {vmax}")
        if engine == "flat":
            check(sim.flow.cfg.band_x is not None and all(
                1 <= lo < hi <= m - 1 for (lo, hi), m in zip(sim.flow.cfg.band_box,
                                                               cfg.shape)),
                  f"{tag}: band {sim.flow.cfg.band_box}")
        for key, c in counts.items():
            if key in PATH_KERNELS[("moving", engine)]:
                check(c > 0, f"{tag}: kernel {key} was not launched")
            else:
                check(c == 0, f"{tag}: kernel {key} of another path was launched")
        out[n] = dict(measure_ms=m_mean, step_ms=s_mean, peak=peak, build_s=build_s,
                      rounds=rounds, pois_n=list(sim.pois_n))
        del sim, u, p
    return dict(counts=total, sizes=out)


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


def phase_launch(torch, st):
    """`tools/launch_cost.py`, run through its own entry point with its own
    launch counts."""
    path = pathlib.Path(__file__).resolve().parent / "tools" / "launch_cost.py"
    spec = importlib.util.spec_from_file_location("launch_cost", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st.reset_launch_counts()
    res = tool.run()
    torch.cuda.synchronize()
    counts = st.launch_counts()
    tool.report(res)
    print(f"phase4 launch launch counts {counts}", flush=True)
    rows = {r["name"]: r for r in res["rows"]}
    check(set(HOST_ROW.values()) <= set(rows), "phase4 launch: a row is missing")
    check(all(math.isfinite(v) and v > 0 for r in rows.values()
              for k, v in r.items() if k.endswith("_us"))
          and res["c_loop_us"] is not None and res["c_loop_us"] > 0,
          "phase4 launch: a time is not positive")
    for k, n in counts.items():
        check((n > 0) == (k in PATH_KERNELS[("launch", "tool")]),
              f"phase4 launch: launch count of {k} is {n}")
    torch.cuda.empty_cache()
    return dict(counts=counts, rows=rows, c_loop_us=res["c_loop_us"])


# ------------------------------------------------------------ phase 5
SMALL = {"sphere": 64, "tgv": 64, "drag": 64, "les": 64, "ramp": 64,
         "sphere-mp": 64, "moving": 64}
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


def face_weight(L):
    """The largest coefficient L of each cell's faces: a pressure difference
    at a cell moves the flow only through L·∇p, by at most this factor."""
    w = L.amax(dim=0)
    for d in range(L.shape[0]):
        w = w.maximum(L[d].roll(-1, d))
    return w


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
    remeasure = config == "moving"
    for step in range(1, 6):
        k.sim_step(remeasure=remeasure, udf=udf)
        for mode, o in sims.items():
            with others[mode][2]():
                o.sim_step(remeasure=remeasure, udf=udf)
            du = (k.flow.u - o.flow.u).abs().max().item()
            dp = (k.flow.p - o.flow.p).abs().max().item()
            su, sp = o.flow.u.abs().max().item(), o.flow.p.abs().max().item()
            if remeasure:
                dp_all, diff = dp, (k.flow.p - o.flow.p).abs()
                dp = (diff * face_weight(o.levels[0].L)).max().item()
                at = tuple(int(i) for i in torch.unravel_index(diff.argmax(), diff.shape))
                where = (f"; the unweighted largest at {at}: p {k.flow.p[at].item():.6g} "
                         f"vs {o.flow.p[at].item():.6g}, iD {o.levels[0].iD[at].item():.6g}, "
                         f"largest face L {face_weight(o.levels[0].L)[at].item():.3g}")
            held = next((h for h in HELD.get((config, mode), HELD_DEFAULT)
                         if h[0] == step), None)
            print(f"phase5 {config} {shape} step {step}, flat vs {mode}: pois_n "
                  f"{k.pois_n[-2:]} vs {o.pois_n[-2:]}; max|du|/max|u|="
                  f"{du / su:.3e}, max|dp|/max|p|={dp / sp:.3e}"
                  + (f" (weighted by the cell's largest face L; unweighted "
                     f"{dp_all / sp:.3e}{where})" if remeasure else "")
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


def phase_band_check(torch, wt, dev, n: int = 128, steps: int = 3):
    """The oscillating sphere at n³ re-measured on its box against the same
    run re-measured densely: μ0, μ1, V and u after each step, equal bit for
    bit or within 1e-6 of max|·|.  Returns the comparisons that failed."""
    box, _ = make_sim(torch, wt, "moving", n, dev, engine="flat")
    dense, _ = make_sim(torch, wt, "moving", n, dev, engine="flat")
    dense.band_measure = False
    failures = []
    for step in range(1, steps + 1):
        box.sim_step(remeasure=True)
        dense.sim_step(remeasure=True)
        parts = []
        for name in ("mu0", "mu1", "V", "u"):
            a, b = getattr(box.flow.state, name), getattr(dense.flow.state, name)
            diff = (a - b).abs().max().item()
            scale = b.abs().max().item()
            parts.append(f"{name} " + ("equal bit for bit" if torch.equal(a, b) else
                                       f"max|diff| {diff:.3e} = {diff / scale:.3e} of max"))
            if not diff <= 1e-6 * scale:
                failures.append(f"moving box vs dense measure: {name} at step {step}")
        print(f"phase5 moving {box.flow.cfg.shape} step {step}, box vs dense measure: "
              + "; ".join(parts) + f"; pois_n {box.pois_n[-2:]} vs {dense.pois_n[-2:]}; "
              f"band_x {box.flow.cfg.band_x} vs {dense.flow.cfg.band_x}; box cells "
              "{} of {}".format(*box_cells(box.flow.cfg)), flush=True)
    torch.cuda.synchronize()
    return failures


# ------------------------------------------------------------ phases 6-8
CIRCLE_RADII = (16, 64)      # `examples/circle.py`'s own size, and 4x
FOIL_L = 32                  # `examples/flapping_foil.py`'s own size
PCG_STEPS = 5
# how many times the float32 rounding sensitivity of the PCG run (phase 7)
# the kernels may part from the plain versions after the last step
PCG_SENSITIVITY = 4.0
SMOKE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"


def step_events(torch, step, n: int) -> list[float]:
    """``n`` calls of ``step``, each between two CUDA events: ms each."""
    events = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def check_no_kernels(counts, tag: str) -> None:
    """A 2-D path launches no hand kernel (they take 3-D float32 only)."""
    check(not any(counts.values()), f"{tag}: a kernel was launched: {counts}")


def circle_cd(sim, mt) -> float:
    """`examples/circle.py`'s C_d = −(F_p + F_v)_x / R (diameter 2R)."""
    st = sim.flow.state
    fp = mt.pressure_force(st.p, sim.body, sim.time)
    fv = mt.viscous_force(st.u, st.nu, sim.body, sim.time)
    return -2.0 * (fp[0] + fv[0]).item() / (2 * sim.L)


def phase_2d(torch, wt, st, dev):
    """Phase 6: the 2-D path.  (a) `examples/circle.py` at its own size in
    float64 on the card, 10 steps, against the same run on the CPU: u and p
    within 1e-9 of max, equal `pois_n`; (b) the circle at R = 64 in float32
    after `perturb`, 20 steps: ms/step, `pois_n`, C_d; (c) the flapping
    foil re-measured every step, 5 steps.  Each with its launch counts (no
    hand kernel: 2-D)."""
    from waterlily_tpu_torch.utils import metrics as mt

    runs = {}
    r16 = CIRCLE_RADII[0]
    tag = f"phase6 circle R={r16} float64"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = make_sim(torch, wt, "circle", r16, dev, dtype=torch.float64)[0]
    host = make_sim(torch, wt, "circle", r16, "cpu", dtype=torch.float64)[0]
    check(card.engine == "3d", f"{tag}: engine {card.engine}")
    st.reset_launch_counts()
    ms = step_events(torch, lambda: card.sim_step(remeasure=False), STEPS)
    counts = st.launch_counts()
    t0 = time.perf_counter()
    host.sim_step_n(STEPS)
    host_s = time.perf_counter() - t0
    du = (card.flow.u.cpu() - host.flow.u).abs().max().item() / host.flow.u.abs().max().item()
    dp = (card.flow.p.cpu() - host.flow.p).abs().max().item() / host.flow.p.abs().max().item()
    print(f"{tag} {card.flow.cfg.shape}: card ms/step (steps 3-{STEPS}, mean) "
          f"{statistics.mean(ms[2:]):.3f}, per step {[round(t, 3) for t in ms]}; "
          f"CPU {host_s / STEPS * 1e3:.1f} ms/step; pois_n card {card.pois_n} CPU "
          f"{host.pois_n}; card vs CPU max|du|/max|u| {du:.3e}, max|dp|/max|p| "
          f"{dp:.3e} (held to 1e-9); launch counts {counts}", flush=True)
    check(card.pois_n == host.pois_n, f"{tag}: pois_n differ from the CPU run")
    check(du <= 1e-9 and dp <= 1e-9, f"{tag}: u or p differ from the CPU run")
    check_no_kernels(counts, tag)
    runs[("circle", "3d")] = dict(counts=counts, ms_step=statistics.mean(ms[2:]),
                                  pois_n=list(card.pois_n))
    del card, host

    r64 = CIRCLE_RADII[1]
    tag = f"phase6 circle R={r64} float32"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = make_sim(torch, wt, "circle", r64, dev)[0]
    sim.perturb(0.1, seed=SEED)
    st.reset_launch_counts()
    ms = step_events(torch, lambda: sim.sim_step(remeasure=False), 2 * STEPS)
    counts = st.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cd = circle_cd(sim, mt)
    u, p = sim.flow.u, sim.flow.p
    print(f"{tag} {sim.flow.cfg.shape}: ms/step (steps 3-{2 * STEPS}, mean) "
          f"{statistics.mean(ms[2:]):.3f}, per step {[round(t, 3) for t in ms]}; "
          f"pois_n {sim.pois_n}; C_d after step {2 * STEPS} {cd:.6f} at tU/L "
          f"{sim.sim_time:.4f}; peak {peak / 2**30:.3f} GiB; launch counts {counts}",
          flush=True)
    check(math.isfinite(cd) and bool(torch.isfinite(u).all()) and bool(torch.isfinite(p).all()),
          f"{tag}: C_d, u or p not finite")
    check(all(1 <= n <= sim.flow.cfg.itmx for n in sim.pois_n), f"{tag}: pois_n {sim.pois_n}")
    check_no_kernels(counts, tag)
    runs[("circle-64", "3d")] = dict(counts=counts, ms_step=statistics.mean(ms[2:]),
                                     pois_n=list(sim.pois_n), peak=peak, cd=cd)
    del sim, u, p

    tag = f"phase6 foil L={FOIL_L} float32"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = foil_sim(torch, wt, FOIL_L, dev)
    meas = []
    time_measure(torch, sim, meas)
    st.reset_launch_counts()
    ms = step_events(torch, lambda: sim.sim_step(remeasure=True), 5)
    counts = st.launch_counts()
    meas_ms = [a.elapsed_time(b) for a, b, _ in meas]
    print(f"{tag} {sim.flow.cfg.shape}: step ms (measure included) "
          f"{[round(t, 3) for t in ms]}, measure ms {[round(t, 3) for t in meas_ms]}; "
          f"pois_n {sim.pois_n}; max|V| {sim.flow.state.V.abs().max().item():.5f}; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launch counts "
          f"{counts}", flush=True)
    check(bool(torch.isfinite(sim.flow.u).all()) and len(meas) == 5,
          f"{tag}: u not finite or a measure missing")
    check(sim.flow.state.V.abs().max().item() > 0, f"{tag}: the foil does not move")
    check_no_kernels(counts, tag)
    runs[("foil", "3d")] = dict(counts=counts, ms_step=statistics.mean(ms[2:]),
                                measure_ms=statistics.mean(meas_ms[2:]),
                                pois_n=list(sim.pois_n))
    del sim
    return runs


def phase_pcg(torch, wt, st, dev):
    """Phase 7: the 256³ sphere with ``psolver="pcg"`` (``engine="auto"``
    must pick the 3d engine), ``PCG_STEPS`` steps with its launch counts and
    a solver log; then the same steps under ``plain_ops()``, and, to
    measure how far float32 rounding alone moves this run, under
    ``plain_ops()`` from an initial u changed by 1e-7 of itself (``twin``).
    Every solve stops at ``itmx``, and a CG stopped short carries a rounding
    difference forward, amplified at each step.  Held: iterations within
    one at every step; after step 1 u within 1e-4·max|u| and p within
    1e-3·max|p| of the plain run (the phase-5 limits); after step
    ``PCG_STEPS`` within those limits or within ``PCG_SENSITIVITY`` times the
    twin's distance from the plain run.  Returns the run (its sim is the
    utilities' state; ``ref``: u and p after each of the first
    ``DIST_PCG_STEPS`` steps, and ``sens``: the twin's distance after each
    step, for phase 10e)."""
    from waterlily_tpu_torch.utils import log

    tag = f"phase7 pcg {FINE}^3"
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sim = make_sim(torch, wt, "pcg", FINE, dev)[0]
    check(sim.engine == "3d" and sim.masks == () and len(sim.levels) == 1,
          f"{tag}: engine {sim.engine}, {len(sim.levels)} levels")
    logger = log.SolverLogger(str(SMOKE_DIR / "pcg"))
    st.reset_launch_counts()
    ms, states = [], []
    for _ in range(PCG_STEPS):
        ms += step_events(torch, lambda: sim.sim_step(remeasure=False), 1)
        logger.log_step(sim)
        states.append((sim.flow.u.clone(), sim.flow.p.clone()))
    counts = st.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    itmx = sim.flow.cfg.itmx
    print(f"{tag}: ms/step {statistics.mean(ms[1:]):.3f} (steps 2-{PCG_STEPS}), per step "
          f"{[round(t, 3) for t in ms]}; outer iterations a solve {sim.pois_n} "
          f"(reached itmx={itmx}: {sum(n == itmx for n in sim.pois_n)} of "
          f"{len(sim.pois_n)}); K16 mult_k launches {counts['mult_k']} "
          f"({counts['mult_k'] / PCG_STEPS:.1f} a step); peak {peak / 2**30:.3f} GiB; "
          f"launch counts {counts}", flush=True)
    for k, n in counts.items():
        check((n > 0) == (k in PATH_KERNELS[("pcg", "3d")]),
              f"{tag}: launch count of {k} is {n}")
    plain = make_sim(torch, wt, "pcg", FINE, dev)[0]
    twin = make_sim(torch, wt, "pcg", FINE, dev)[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u = twin.flow.state.u
    twin.flow.state.u = u * (1 + 1e-7 * torch.randn(u.shape, generator=gen, device=dev))

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()
    failures, sens = [], []
    for step, (u, p) in enumerate(states, 1):
        with st.plain_ops():
            plain.sim_step(remeasure=False)
            twin.sim_step(remeasure=False)
        du, dp = rel(u, plain.flow.u), rel(p, plain.flow.p)
        su, sp = rel(twin.flow.u, plain.flow.u), rel(twin.flow.p, plain.flow.p)
        sens.append((su, sp))
        n_ok = all(abs(a - b) <= 1 for a, b in zip(sim.pois_n[:2 * step], plain.pois_n))
        print(f"{tag} step {step}, kernels vs plain_ops(): pois_n {sim.pois_n[2 * step - 2:2 * step]}"
              f" vs {plain.pois_n[-2:]}; max|du|/max|u| {du:.3e}, max|dp|/max|p| {dp:.3e}; "
              f"twin (u changed by 1e-7) vs plain: {su:.3e}, {sp:.3e}", flush=True)
        if not n_ok:
            failures.append(f"iteration counts at step {step}")
        if step == 1 and not (du <= 1e-4 and dp <= 1e-3):
            failures.append("u or p after step 1")
        if step == PCG_STEPS and not (du <= max(1e-4, PCG_SENSITIVITY * su)
                                      and dp <= max(1e-3, PCG_SENSITIVITY * sp)):
            failures.append(f"u or p after step {step}")
    check(sum(st.launch_counts().values()) == sum(counts.values()),
          f"{tag}: plain_ops() launched a kernel")
    check(not failures, f"{tag}: kernels and plain versions differ: {failures}")
    check(bool(torch.isfinite(sim.flow.u).all()) and bool(torch.isfinite(sim.flow.p).all()),
          f"{tag}: u or p not finite")
    ref = states[:DIST_PCG_STEPS]
    del plain, twin, states
    torch.cuda.empty_cache()
    return dict(counts=counts, ms_step=statistics.mean(ms[1:]), pois_n=list(sim.pois_n),
                peak=peak, sim=sim, log=logger.fname, ref=ref, sens=sens)


def phase_utils(torch, wt, dev, run):
    """Phase 8: the utilities on the 256³ PCG sphere's state: `lambda2_field`
    and `MeanFlow.update` timed, an npz round trip (bit for bit), a VTK
    write and read, the solver log of phase 7 read back, and
    `update_particles` on 100,000 tracers.  No matplotlib."""
    import numpy as np

    from waterlily_tpu_torch.utils import io, log, metrics as mt, pathlines as pl

    sim = run["sim"]
    tag = f"phase8 utilities {FINE}^3"
    u = sim.flow.u

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    lam2, lam_ms = timed(lambda: mt.lambda2_field(u))
    lam_peak = torch.cuda.max_memory_allocated() - base
    _, lam_ms2 = timed(lambda: mt.lambda2_field(u))
    check(tuple(lam2.shape) == tuple(u.shape[1:]) and bool(torch.isfinite(lam2).all()),
          f"{tag}: lambda2 not finite")
    print(f"{tag}: lambda2_field {lam_ms:.1f} ms, again {lam_ms2:.1f} ms ({mt.LAMBDA2_CHUNK} "
          f"cells an eigvalsh call), peak above the state {lam_peak / 2**30:.3f} GiB; "
          f"min {lam2.min().item():.4e}, cells with lambda2 < 0: "
          f"{int((lam2 < 0).sum().item())}", flush=True)
    del lam2
    mf = mt.MeanFlow(flow=sim.flow, uu_stats=True)
    _, mf_ms1 = timed(lambda: mf.update(sim.flow))
    sim.sim_step(remeasure=False)
    _, mf_ms2 = timed(lambda: mf.update(sim.flow))
    print(f"{tag}: MeanFlow.update with u⊗u {mf_ms1:.3f} ms (first), {mf_ms2:.3f} ms",
          flush=True)

    f = SMOKE_DIR / "state.npz"
    old_u, old_p, old_dt, old_uu = sim.flow.u, sim.flow.p, list(sim.flow.dt), mf.UU
    t0 = time.perf_counter()
    io.save(str(f), sim, meanflow=mf)
    t1 = time.perf_counter()
    io.load(str(f), sim, meanflow=mf)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = (torch.equal(sim.flow.u, old_u) and torch.equal(sim.flow.p, old_p)
            and torch.equal(sim.flow.state.u0, old_u) and sim.flow.dt == old_dt
            and torch.equal(mf.UU, old_uu))
    print(f"{tag}: npz {f.stat().st_size / 2**20:.1f} MiB, save {t1 - t0:.2f} s, load "
          f"{t2 - t1:.2f} s, bit for bit {same}", flush=True)
    check(same, f"{tag}: the npz round trip changed the state")
    f.unlink()

    t0 = time.perf_counter()
    w = io.VTKWriter(str(SMOKE_DIR / "smoke"), dirname=str(SMOKE_DIR / "vtk"))
    w.write(sim)
    t1 = time.perf_counter()
    back = io._read_vti(w.entries[-1][1])
    t2 = time.perf_counter()
    vtk_ok = (np.array_equal(back["Velocity"], sim.flow.u.cpu().numpy())
              and np.array_equal(back["Pressure"], sim.flow.p.cpu().numpy()))
    print(f"{tag}: VTK write {t1 - t0:.2f} s ({pathlib.Path(w.entries[-1][1]).stat().st_size / 2**20:.1f} "
          f"MiB), read {t2 - t1:.2f} s, equal {vtk_ok}", flush=True)
    check(vtk_ok, f"{tag}: the VTK file does not hold the state")
    del back

    counts, _, _ = log.parse_log(run["log"])
    print(f"{tag}: solver log {run['log']}: {len(counts)} solves, counts {counts}", flush=True)
    check(counts == run["pois_n"], f"{tag}: the solver log does not read back")

    p = pl.Particles.init(100_000, sim.flow.cfg.shape, life=255, seed=SEED, device=dev)
    (p2, old, v), ms1 = timed(lambda: pl.update_particles(p, sim))
    (p3, _, _), ms2 = timed(lambda: pl.update_particles(p2, sim))
    hi = torch.tensor([s - 2 for s in sim.flow.cfg.shape], device=dev)
    check(bool(torch.isfinite(p3.pos).all()) and bool(((p3.pos >= 0) & (p3.pos <= hi)).all()),
          f"{tag}: particles left the domain")
    print(f"{tag}: update_particles on 100,000 tracers {ms1:.3f} ms (first), {ms2:.3f} "
          f"ms; mean speed {torch.linalg.norm(v, dim=1).mean().item():.4f}", flush=True)
    check("matplotlib" not in sys.modules, f"{tag}: matplotlib was imported")
    for q in SMOKE_DIR.rglob("*"):
        if q.is_file():
            q.unlink()
    return dict(lambda2_ms=lam_ms, lambda2_peak=lam_peak, meanflow_ms=mf_ms2)


# ------------------------------------------------------------ phase 9
AD_STEPS = 5
AD_TGV_N = 64
AD_TGV_RE = 1600.0          # `examples/tgv3d.py`'s Re = U/(κν)
AD_FD_STEP = 0.01           # the central difference's step, relative to Re
AD_FD_TOL = 0.1             # AD against that difference (`tests/test_diff.py`)
# the kernels' d(F_x)/d(Re) against the plain versions' (`plain_ops()`),
# relative; float32 rounding of the two runs parts them (2.07e-5 measured on
# an NVIDIA H100 80GB HBM3 at 700 W, with every solve's iterations equal)
AD_SPHERE_TOL = 5e-2
# `torch.func.jacfwd` against `torch.func.jvp` of the same run, relative: the
# same kernels, the batched plain ops may sum in another order
AD_JACFWD_TOL = 1e-6


def ad_runner(torch, sim, nu, steps: int, events=None):
    """``steps`` steps of `mom_step_impl` from the state of ``sim`` with
    viscosity ``nu``, dt and t carried as 0-d tensors (the differentiable
    runner of `tests/test_diff.py`: dt's tangent flows through the CFL).
    ``events``: a list that gets a pair of CUDA events around each step.
    Returns ``(state, t)``."""
    from waterlily_tpu_torch.models import flow as fl

    cfg = sim.flow.cfg
    state = dataclasses.replace(sim.flow.state, nu=nu)
    dt = torch.tensor(sim.flow.dt[-1], dtype=cfg.dtype, device=state.u.device)
    t = torch.zeros((), dtype=cfg.dtype, device=state.u.device)
    for _ in range(steps):
        if events is not None:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
        state, dt_next, _, _ = fl.mom_step_impl(cfg, state, sim.levels, sim.masks, dt, t)
        if events is not None:
            b.record()
            events.append((a, b))
        t, dt = t + dt, dt_next
    return state, t


def check_counts(counts, path, tag: str) -> None:
    for k, n in counts.items():
        if k in PATH_KERNELS[path]:
            check(n > 0, f"{tag}: kernel {k} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {k} of another path was launched")


def phase_ad(torch, wt, st, dev):
    """Phase 9: forward-mode AD (`torch.func.jvp`) through `mom_step_impl`
    on the 3d engine in float32.  (a) The 256³ sphere of phase 4a:
    d(F_x)/d(Re) (Re = U R/ν, F the pressure + viscous force after
    ``AD_STEPS`` steps): the primal run timed, the jvp timed with its launch
    counts (K12 and its tangent kernel, K14, K15, K16: none plain), then the
    jvp under `plain_ops()`: the derivatives within ``AD_SPHERE_TOL``,
    every primal and tangent solve's iterations within one.  (b) The 64³
    Taylor–Green vortex (periodic: K13): dKE/dRe against the kernels'
    central difference within ``AD_FD_TOL``."""
    from waterlily_tpu_torch.ops import multigrid as mg
    from waterlily_tpu_torch.utils import metrics as mt

    runs = {}
    tag = f"phase9 ad-sphere {FINE}^3 [3d]"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sim = sphere_sim(torch, wt, FINE, dev, engine="3d")
    check(sim.engine == "3d", f"{tag}: Simulation runs engine {sim.engine}")
    re0 = torch.tensor(sim.L / sim.flow.nu, dtype=torch.float32, device=dev)
    one = torch.ones_like(re0)
    last = {}               # the primal run's final u, for the tangent kernel's time

    def force(re, events=None):
        state, t = ad_runner(torch, sim, sim.L / re, AD_STEPS, events)
        if not st.ad_active():
            last["u"] = state.u
        f = (mt.pressure_force(state.p, sim.body, t)
             + mt.viscous_force(state.u, state.nu, sim.body, t))
        return f[0]

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        events = []
        with mg.iteration_log() as log:
            out = fn(events)
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in events]
        return out, ms, torch.cuda.max_memory_allocated(), list(log)

    f0, primal_ms, primal_peak, plog = timed(lambda ev: force(re0, ev))
    st.reset_launch_counts()
    (fj, dj), jvp_ms, jvp_peak, jlog = timed(
        lambda ev: torch.func.jvp(lambda r: force(r, ev), (re0,), (one,)))
    counts = st.launch_counts()
    with st.plain_ops(), mg.iteration_log() as qlog:
        fq, dq = torch.func.jvp(force, (re0,), (one,))
    torch.cuda.synchronize()
    check(st.launch_counts() == counts, f"{tag}: plain_ops() launched a kernel")
    f0, fj, dj, fq, dq = (float(v) for v in (f0, fj, dj, fq, dq))
    rel_d, rel_f = abs(dj - dq) / abs(dq), abs(fj - fq) / abs(fq)
    pm, jm = statistics.mean(primal_ms[1:]), statistics.mean(jvp_ms[1:])
    print(f"{tag}: Re {float(re0):.1f}, F_x after {AD_STEPS} steps {fj:.9e} (primal run "
          f"{f0:.9e}); dF_x/dRe kernels {dj:.9e}, plain_ops() {dq:.9e}: rel {rel_d:.3e} "
          f"(tol {AD_SPHERE_TOL:g}); F_x rel {rel_f:.3e}", flush=True)
    print(f"{tag}: ms/step (steps 2-{AD_STEPS}, CUDA events) primal {pm:.3f}, jvp {jm:.3f} "
          f"({jm / pm:.2f}x); per step primal {[round(t, 3) for t in primal_ms]}, jvp "
          f"{[round(t, 3) for t in jvp_ms]}; peak {primal_peak / 2**30:.3f} GiB primal, "
          f"{jvp_peak / 2**30:.3f} GiB jvp ({jvp_peak / primal_peak:.2f}x)", flush=True)
    print(f"{tag}: solve iterations (primal, tangent per projection) kernels {jlog}, "
          f"plain_ops() {qlog}, primal run {plog}; launch counts {counts}", flush=True)
    check(all(math.isfinite(v) for v in (f0, fj, dj, fq, dq)), f"{tag}: not finite")
    check(fj == f0 and jlog[0::2] == plog, f"{tag}: the jvp's primal is not the primal run's")
    check(len(jlog) == len(qlog) == 4 * AD_STEPS
          and all(abs(a - b) <= 1 for a, b in zip(jlog, qlog)),
          f"{tag}: iteration counts differ by more than one")
    check(rel_d <= AD_SPHERE_TOL, f"{tag}: dF/dRe of the kernels and of the plain "
          f"versions differ by {rel_d:.3e} > {AD_SPHERE_TOL}")
    check_counts(counts, ("ad-sphere", "3d"), tag)
    # the tangent kernel on the primal run's final state (two launches a
    # step), timed after the run's counts were read
    u = last.pop("u")
    du = torch.randn(u.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
    nu = torch.tensor(sim.flow.nu, dtype=torch.float32, device=dev)
    tan_ms = median_ms(torch, lambda: st.conv_diff_jvp_k(u, du, nu, one, 0), 20)
    print(f"{tag}: tangent kernel conv_diff_jvp_k (quick, walls) on the run's final "
          f"state {tan_ms:.4f} ms a call, {2 * tan_ms:.3f} ms a step "
          f"({2 * tan_ms / jm:.1%} of the jvp step's {jm:.3f})", flush=True)
    runs[("ad-sphere", "3d")] = dict(counts=counts, primal_ms=pm, jvp_ms=jm,
                                     primal_peak=primal_peak, jvp_peak=jvp_peak,
                                     rel_d=rel_d, dF=dj, tangent_ms=tan_ms)
    del sim, u, du
    torch.cuda.empty_cache()

    tag = f"phase9 ad-tgv {AD_TGV_N}^3 [3d]"
    sim = tgv_sim(torch, wt, AD_TGV_N, dev, engine="3d")
    kappa = 2 * math.pi / AD_TGV_N
    inner = (slice(1, -1),) * 3
    re0 = torch.tensor(AD_TGV_RE, dtype=torch.float32, device=dev)

    def ke(re):
        state, _ = ad_runner(torch, sim, 1 / (kappa * re), AD_STEPS)
        return mt.ke_field(state.u)[inner].double().sum()

    st.reset_launch_counts()
    (k0, dk), tgv_ms, tgv_peak, tlog = timed(
        lambda ev: torch.func.jvp(ke, (re0,), (torch.ones_like(re0),)))
    counts = st.launch_counts()
    h = AD_FD_STEP * AD_TGV_RE
    fd = (float(ke(re0 + h)) - float(ke(re0 - h))) / (2 * h)
    rel = abs(float(dk) - fd) / abs(fd)
    print(f"{tag}: KE after {AD_STEPS} steps {float(k0):.9f}; dKE/dRe AD {float(dk):.9e}, "
          f"central difference (h = {h:g}) {fd:.9e}: rel {rel:.3e} (tol {AD_FD_TOL:g}); "
          f"solve iterations {tlog}; launch counts {counts}", flush=True)
    check(math.isfinite(float(dk)) and rel <= AD_FD_TOL,
          f"{tag}: AD and the central difference differ by {rel:.3e}")
    check_counts(counts, ("ad-tgv", "3d"), tag)
    # the same derivative by `torch.func.jacfwd`: every rule, tangent and
    # tangent solve once per batch entry (`stencil3d._loop_vmap`)
    st.reset_launch_counts()
    with mg.iteration_log() as flog:
        dkf = float(torch.func.jacfwd(ke)(re0))
    fcounts = st.launch_counts()
    rel_j = abs(dkf - float(dk)) / abs(float(dk))
    print(f"{tag}: jacfwd dKE/dRe {dkf:.9e} against the jvp's: rel {rel_j:.3e} "
          f"(tol {AD_JACFWD_TOL:g}); solve iterations {list(flog)}; launch counts "
          f"{fcounts}", flush=True)
    check(math.isfinite(dkf) and rel_j <= AD_JACFWD_TOL,
          f"{tag}: jacfwd and jvp differ by {rel_j:.3e}")
    check(list(flog) == tlog, f"{tag}: jacfwd's solve iterations {list(flog)} "
          f"are not the jvp's {tlog}")
    check_counts(fcounts, ("ad-tgv", "3d"), f"{tag} jacfwd")
    runs[("ad-tgv", "3d")] = dict(counts=counts, rel_fd=rel, rel_jacfwd=rel_j)
    del sim
    torch.cuda.empty_cache()
    return runs

# ------------------------------------------------------------ phase 10
DIST_SMALL = 64
DIST_STEPS = 5
# the mesh of each engine, four shards on one card
DIST_MESHES = {"flat": (4,), "3d": (2, 2)}
# the kernels that must not run on the distributed flat engine (K7 is
# `incr_gs_k` with colours: counted by `incr_gs_tally`)
DIST_ABSENT = ("conv_diff_bdim_k", "bc_div_k", "projbc_k")
# the shard of the (4,) mesh whose kernel calls 10c replays: an inner one,
# both of its x ghosts from the ring (`ShardPool` names its threads)
DIST_SHARD_THREAD = "waterlily-shard-1"


@contextlib.contextmanager
def incr_gs_tally(fz, tally):
    """Count the calls of K6 (``incr_gs_k`` with no colours) and K7 (with
    colours) apart while it runs, from every shard (one runs at a time):
    they share one launch counter."""
    launch = fz._incr_gs_launch

    def tallied(x, r, eps, L, D, iD, colors, omega, want_norms=False, mp=False,
                route=None):
        tally["K7" if len(colors) else "K6"] += 1
        return launch(x, r, eps, L, D, iD, colors, omega, want_norms, mp, route)

    fz._incr_gs_launch = tallied
    try:
        yield tally
    finally:
        fz._incr_gs_launch = launch


@contextlib.contextmanager
def shard_calls(st, fz, shape, calls):
    """While it runs, keep in ``calls`` a copy of the arguments of the last
    call that the shard of ``DIST_SHARD_THREAD`` makes of each kernel of the
    flat dist path on fields of its fine ``shape`` (of `incr_gs_k`, K6: no
    colours), beside the kernel's wrapper and its plain version."""
    wrappers = {"bdim_k": (st, st.bdim_plain), "div_k": (fz, fz.div_plain),
                "mult_k": (st, st.mult_plain), "incr_gs_k": (fz, fz.incr_gs_plain)}
    saved = {name: getattr(mod, name) for name, (mod, _) in wrappers.items()}

    def keeper(name, fn, plain):
        def kept(*args):
            if (threading.current_thread().name == DIST_SHARD_THREAD
                    and tuple(args[0].shape[-3:]) == shape
                    and (name != "incr_gs_k" or not len(args[6]))):
                calls[name] = (fn, plain, tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args))
            return fn(*args)
        return kept

    for name, (mod, plain) in wrappers.items():
        setattr(mod, name, keeper(name, saved[name], plain))
    try:
        yield calls
    finally:
        for name, (mod, _) in wrappers.items():
            setattr(mod, name, saved[name])


def dist_shard_check(torch, st, fz, d, stats) -> list:
    """10c's replay (module docstring): one more step of the flat `d`, then
    each kept kernel call against its plain version; the failures."""
    calls, failures = {}, []
    with shard_calls(st, fz, tuple(d.local_shape), calls):
        d.step_once(remeasure=False)
    for name in sorted(PATH_KERNELS[("sphere-dist", "flat")]):
        if name not in calls:
            failures.append(f"(c) flat: shard 1 made no fine-level {name} call")
            continue
        kern, plain, args = calls[name]
        got, want = kern(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        tols = KERNELS[name][0]
        for k, (a, b) in enumerate(zip(got, want)):
            tol = tols[k] if isinstance(tols, tuple) else tols
            err = (a - b).abs().max().item()
            rel = err / max(b.abs().max().item(), 1e-30)
            print(f"phase10c {name:10s} shard 1 of (4,) {tuple(args[0].shape)} out{k} "
                  f"max|d|={err:.3e} rel={rel:.3e} tol={tol:.1e}", flush=True)
            if not (bool(torch.isfinite(a).all()) and rel <= tol):
                failures.append(f"(c) flat: {name} on shard 1 output {k}: relative "
                                f"error {rel:.3e} > {tol:.0e} or non-finite")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
    return failures


def dist_sphere(torch, wt, n: int, dev, dtype, engine: str):
    """`sphere_sim` in ``dtype``."""
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=dtype, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e3,
                         body=body, dtype=dtype, device=dev, engine=engine)


def rel_diff(torch, a, b) -> float:
    """max|a − b| / max|b| of two fields (numpy or tensors)."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()


def dist_run(torch, wt, st, fz, sim, mesh, engine: str, steps: int):
    """``steps`` steps of a `DistSimulation` of ``sim`` with its own launch
    counts, K6/K7 tally, collectives and peak memory; ms per step by CUDA
    events."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    d = wt.DistSimulation(sim, mesh, engine=engine)
    check(d.engine == engine, f"phase10: DistSimulation runs engine {d.engine}")
    tally = collections.Counter()
    d.comm.reset_counts()
    st.reset_launch_counts()
    with incr_gs_tally(fz, tally):
        ms = step_events(torch, lambda: d.step_once(remeasure=False), steps)
    counts = st.launch_counts()
    return dict(d=d, ms=ms, counts=counts, tally=dict(tally),
                comm=dict(d.comm.counts), halo=d.comm.halo_bytes,
                peak=torch.cuda.max_memory_allocated())


def phase_dist(torch, wt, st, dev, stats):
    """Phase 10 (module docstring).  Returns the 256³ runs' counts as
    paths; the failures are collected and raised after every case
    printed.  The shard replay's errors join ``stats`` (phase 3's)."""
    import copy

    from waterlily_tpu_torch.ops import fused3d as fz

    ndev = torch.cuda.device_count()
    print(f"phase10 torch.cuda.device_count() {ndev}", flush=True)
    one_card = lambda shape: wt.make_mesh(shape, [dev] * math.prod(shape))
    failures = []
    # (a) the exchange itself, float64 (no kernel takes float64)
    for engine, shape in DIST_MESHES.items():
        ref = dist_sphere(torch, wt, DIST_SMALL, dev, torch.float64, engine)
        d = wt.DistSimulation(copy.deepcopy(ref), one_card(shape), engine=engine)
        st.reset_launch_counts()
        for k in range(1, DIST_STEPS + 1):
            ref.sim_step(remeasure=False)
            d.step_once(remeasure=False)
            du, dp = rel_diff(torch, d.u, ref.flow.u.cpu()), rel_diff(torch, d.p, ref.flow.p.cpu())
            print(f"phase10a f64 {engine} {shape} step {k}: max|du|/max|u|={du:.3e}, "
                  f"max|dp|/max|p|={dp:.3e}, pois_n {d.pois_n[-2:]} vs "
                  f"{ref.pois_n[-2:]}", flush=True)
        if not (du <= 1e-10 and dp <= 1e-10 and d.pois_n == ref.pois_n):
            failures.append(f"(a) float64 {engine} on {shape} differs from one device")
        if any(st.launch_counts().values()):
            failures.append(f"(a) float64 {engine} launched a kernel")
        d.close()
        del ref, d
    # (b) the kernels on every shard against their plain versions
    base = dist_sphere(torch, wt, DIST_SMALL, dev, torch.float32, "flat")
    k_run = wt.DistSimulation(copy.deepcopy(base), one_card((4,)), engine="flat")
    p_run = wt.DistSimulation(base, one_card((4,)), engine="flat")
    st.reset_launch_counts()
    for step in range(1, DIST_STEPS + 1):
        k_run.step_once(remeasure=False)
        counts = st.launch_counts()
        with st.plain_ops():
            p_run.step_once(remeasure=False)
        if st.launch_counts() != counts:
            failures.append("(b) the plain_ops() run launched a kernel")
        du = rel_diff(torch, k_run.u, p_run.u)
        dp = rel_diff(torch, k_run.p, p_run.p)
        print(f"phase10b f32 flat (4,) {DIST_SMALL}^3 step {step}, kernels vs "
              f"plain_ops(): max|du|/max|u|={du:.3e}, max|dp|/max|p|={dp:.3e}, "
              f"pois_n {k_run.pois_n[-2:]} vs {p_run.pois_n[-2:]}", flush=True)
    print(f"phase10b launch counts {st.launch_counts()}", flush=True)
    if not (du <= 1e-4 and dp <= 1e-3 and all(
            abs(a - b) <= 1 for a, b in zip(k_run.pois_n, p_run.pois_n))):
        failures.append("(b) the flat dist kernels differ from plain_ops() beyond "
                        "the phase-5 limits")
    if not all(st.launch_counts()[n] > 0 for n in PATH_KERNELS[("sphere-dist", "flat")]):
        failures.append("(b) a kernel of the flat dist path did not launch")
    k_run.close()
    p_run.close()
    del base, k_run, p_run
    # (c) full width, four shards on one card, beside one device
    runs = {}
    for engine, shape in DIST_MESHES.items():
        tag = f"phase10c sphere-dist {FINE}^3 [{engine}] on {shape}"
        sim = sphere_sim(torch, wt, FINE, dev, engine=engine)
        dsim = copy.deepcopy(sim)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        one_ms = step_events(torch, lambda: sim.sim_step(remeasure=False), STEPS)
        one_peak = torch.cuda.max_memory_allocated()
        u1, pois1 = sim.flow.u.cpu(), list(sim.pois_n)
        del sim
        r = dist_run(torch, wt, st, fz, dsim, one_card(shape), engine, STEPS)
        d = r.pop("d")
        ms, one = statistics.mean(r["ms"][2:]), statistics.mean(one_ms[2:])
        print(f"{tag} ms/step (steps 3-{STEPS}, mean) {ms:.3f} against one device "
              f"{one:.3f} ({ms / one:.2f}x); per step {[round(t, 3) for t in r['ms']]}",
              flush=True)
        print(f"{tag} max_memory_allocated {r['peak'] / 2**30:.3f} GiB against one "
              f"device {one_peak / 2**30:.3f} GiB", flush=True)
        ncoll = sum(r["comm"].values())
        print(f"{tag} collectives per step {ncoll / STEPS:.1f} ({r['comm']} in "
              f"{STEPS} steps), halo bytes per step {r['halo'] / STEPS:.0f} "
              f"({r['halo'] / STEPS / 2**20:.2f} MiB)", flush=True)
        per_step = {k: n / STEPS for k, n in r["counts"].items() if n}
        print(f"{tag} launches per step {per_step}; K6 {r['tally'].get('K6', 0) / STEPS:.1f}, "
              f"K7 {r['tally'].get('K7', 0) / STEPS:.1f}", flush=True)
        du = rel_diff(torch, d.u, u1)
        print(f"{tag} pois_n {d.pois_n} against one device {pois1}; u after step "
              f"{STEPS}: max|du|/max|u|={du:.3e}", flush=True)
        for k, n in r["counts"].items():
            if k in PATH_KERNELS[("sphere-dist", engine)]:
                if n == 0:
                    failures.append(f"(c) {engine}: kernel {k} was not launched")
            elif n:
                failures.append(f"(c) {engine}: kernel {k} of another path was launched")
        if engine == "flat" and (r["tally"].get("K7", 0) or not r["tally"].get("K6", 0)
                                 or any(r["counts"][k] for k in DIST_ABSENT)):
            failures.append("(c) flat: K1, K7, K8 or K9 ran, or K6 did not")
        if not (du <= 1e-3 and len(d.pois_n) == len(pois1) and all(
                abs(a - b) <= 1 for a, b in zip(d.pois_n, pois1))):
            failures.append(f"(c) {engine}: u or the iterations differ from one device")
        if engine == "flat":
            failures += dist_shard_check(torch, st, fz, d, stats)
        d.close()
        del d, dsim, u1
        runs[("sphere-dist", engine)] = dict(counts=r["counts"], ms_step=ms,
                                             one_ms_step=one, peak=r["peak"],
                                             collectives=ncoll / STEPS,
                                             halo=r["halo"] / STEPS)
    # (d) distinct cards
    if ndev >= 2:
        n = 4 if ndev >= 4 else 2
        mesh = wt.make_mesh((n,), [torch.device("cuda", i) for i in range(n)])
        r = dist_run(torch, wt, st, fz, sphere_sim(torch, wt, FINE, dev, engine="flat"),
                     mesh, "flat", STEPS)
        print(f"phase10d sphere-dist {FINE}^3 [flat] on {n} cards: ms/step "
              f"{statistics.mean(r['ms'][2:]):.3f}, launches {r['counts']}", flush=True)
        r.pop("d").close()
    else:
        print("phase10d skipped: the flat case on distinct cards needs at least 2 "
              f"cards, this machine has {ndev}", flush=True)
    check(not failures, f"phase10: {'; '.join(failures)}")
    return runs


# ------------------------------------------------------------ phase 10e-h
DIST_PCG_STEPS = 3
DIST_LES_STEPS = 3
DIST_MOVING_STEPS = 5
DIST_AD_STEPS = 2


def dist_jvp_step(torch, d, cfg, dt, t0):
    """`torch.func.jvp` in ν of one `mom_step_impl` of every shard of ``d``
    (3d engine), each shard's entered with `shard_jvp`: per shard ``((u, p,
    dt_next), (du, dp, ddt), iterations)``, the iterations of every solve,
    primal then tangent."""
    from waterlily_tpu_torch.models import flow as fl
    from waterlily_tpu_torch.ops import multigrid as mg
    from waterlily_tpu_torch.ops.dist import shard_jvp

    def one(rank):
        sh = d.shards[rank]

        def f(nu):
            st, dt_next, _, _ = fl.mom_step_impl(
                cfg, dataclasses.replace(sh.state, nu=nu), sh.levels, d.masks, dt, t0,
                ctx=sh.ctx, n_dist=d.n_dist)
            return st.u, st.p, dt_next
        with mg.iteration_log() as log:
            prim, tan = shard_jvp(sh.ctx, f, (sh.state.nu,),
                                  (torch.ones_like(sh.state.nu),))
        return prim, tan, list(log)
    return d.pool.run(one)


def one_jvp_step(torch, sim, dt, t0):
    """The single-device counterpart of `dist_jvp_step`."""
    from waterlily_tpu_torch.models import flow as fl
    from waterlily_tpu_torch.ops import multigrid as mg

    cfg, state = sim.flow.cfg, sim.flow.state

    def f(nu):
        st, dt_next, _, _ = fl.mom_step_impl(cfg, dataclasses.replace(state, nu=nu),
                                             sim.levels, sim.masks, dt, t0)
        return st.u, st.p, dt_next
    with mg.iteration_log() as log:
        prim, tan = torch.func.jvp(f, (state.nu,), (torch.ones_like(state.nu),))
    return prim, tan, list(log)


def dist_record(torch, tag, d, ms, counts, steps):
    """Print the ms per step, collectives and launches of a run; its dict."""
    ncoll = sum(d.comm.counts.values())
    per_step = {k: n / steps for k, n in counts.items() if n}
    mean = statistics.mean(ms[1:] or ms)
    print(f"{tag} ms/step {[round(t, 3) for t in ms]} (mean after the first "
          f"{mean:.3f}); collectives per step {ncoll / steps:.1f} "
          f"({dict(d.comm.counts)}); halo MiB per step "
          f"{d.comm.halo_bytes / steps / 2**20:.2f}; launches per step {per_step}",
          flush=True)
    return dict(counts=counts, ms_step=mean, collectives=ncoll / steps)


def phase_dist2(torch, wt, st, dev, pcg):
    """Phase 10e-h (module docstring): PCG, the LES udf and forward-mode AD
    on four shards of the card, and the flat engine with a moving body.
    ``pcg`` is phase 7's run (its states and sensitivities).  Returns the
    float32 runs' counts as paths; the failures are collected and raised
    after every case printed."""
    import copy

    from waterlily_tpu_torch.ops import fused3d as fz

    one_card = lambda shape: wt.make_mesh(shape, [dev] * math.prod(shape))
    failures, runs = [], {}

    def rel(a, b):
        return rel_diff(torch, a, b)

    # (e) PCG, 3d engine, (4,): kernels vs plain_ops() and vs one device
    tag = f"phase10e pcg-dist {FINE}^3 [3d] on (4,)"
    base = make_sim(torch, wt, "pcg", FINE, dev)[0]
    k_run = wt.DistSimulation(copy.deepcopy(base), one_card((4,)))
    p_run = wt.DistSimulation(base, one_card((4,)))
    check(k_run.engine == "3d" and [len(lv) for lv in k_run.levels] == [1] * 4,
          f"{tag}: engine {k_run.engine}, levels {[len(lv) for lv in k_run.levels]}")
    ms, cg = [], 0
    pois1 = pcg["pois_n"]
    for step in range(1, DIST_PCG_STEPS + 1):
        st.reset_launch_counts()
        k_run.comm.reset_counts()
        ms += step_events(torch, lambda: k_run.step_once(remeasure=False), 1)
        counts = st.launch_counts()
        if step == 1:
            first = dist_record(torch, f"{tag} step 1", k_run, ms, counts, 1)
            total = collections.Counter(counts)
        else:
            total.update(counts)
        with st.plain_ops():
            p_run.step_once(remeasure=False)
        if st.launch_counts() != counts:
            failures.append("(e) the plain_ops() run launched a kernel")
        cg += 6 * sum(k_run.pois_n[-2:])
        u1, p1 = pcg["ref"][step - 1]
        su, sp = pcg["sens"][step - 1]
        du, dp = rel(k_run.u, p_run.u), rel(k_run.p, p_run.p)
        du1, dp1 = rel(k_run.u, u1.cpu()), rel(k_run.p, p1.cpu())
        n_plain = all(abs(a - b) <= 1 for a, b in zip(k_run.pois_n, p_run.pois_n))
        n_one = all(abs(a - b) <= 1 for a, b in zip(k_run.pois_n, pois1))
        print(f"{tag} step {step}: pois_n {k_run.pois_n[-2:]}, plain_ops() "
              f"{p_run.pois_n[-2:]}, one device {pois1[2 * step - 2:2 * step]}; vs plain_ops() "
              f"max|du|/max|u| {du:.3e}, max|dp|/max|p| {dp:.3e}; vs one device {du1:.3e}, "
              f"{dp1:.3e}; phase 7's twin {su:.3e}, {sp:.3e}", flush=True)
        if not (n_plain and n_one):
            failures.append(f"(e) iteration counts at step {step}")
        lim_u = 1e-4 if step == 1 else max(1e-4, PCG_SENSITIVITY * su)
        lim_p = 1e-3 if step == 1 else max(1e-3, PCG_SENSITIVITY * sp)
        if not (du <= lim_u and dp <= lim_p and du1 <= lim_u and dp1 <= lim_p):
            failures.append(f"(e) u or p after step {step}")
    counts = dict(total)
    k16 = counts["mult_k"]
    print(f"{tag}: ms/step {[round(t, 3) for t in ms]} (steps 2-{DIST_PCG_STEPS} mean "
          f"{statistics.mean(ms[1:]):.3f}); K16 launches {k16} = {k16 / cg:.2f} per CG "
          f"iteration and shard ({k16 / (2 * DIST_PCG_STEPS):.1f} a solve on the four "
          f"shards); step 1's collectives {first['collectives']:.0f}", flush=True)
    if k16 != 4 * cg:
        failures.append(f"(e) K16 launched {k16} times for {cg} CG iterations a shard")
    for k, n in counts.items():
        if (n > 0) != (k in PATH_KERNELS[("pcg-dist", "3d")]):
            failures.append(f"(e) launch count of {k} is {n}")
    if not (bool(torch.isfinite(torch.as_tensor(k_run.u)).all())):
        failures.append("(e) u not finite")
    runs[("pcg-dist", "3d")] = dict(counts=counts, ms_step=statistics.mean(ms[1:]),
                                    collectives=first["collectives"])
    k_run.close()
    p_run.close()
    del base, k_run, p_run
    torch.cuda.empty_cache()

    # (f) LES, flat engine, (4,): kernels vs plain_ops(); 64³ f64 vs one device
    tag = f"phase10f les-dist {FINE}^3 [flat] on (4,)"
    base, udf = make_sim(torch, wt, "les", FINE, dev)
    k_run = wt.DistSimulation(copy.deepcopy(base), one_card((4,)), engine="flat")
    p_run = wt.DistSimulation(base, one_card((4,)), engine="flat")
    tally = collections.Counter()
    st.reset_launch_counts()
    k_run.comm.reset_counts()
    with incr_gs_tally(fz, tally):
        ms = step_events(torch, lambda: k_run.step_once(remeasure=False, udf=udf),
                         DIST_LES_STEPS)
    counts = st.launch_counts()
    runs[("les-dist", "flat")] = dist_record(torch, tag, k_run, ms, counts,
                                             DIST_LES_STEPS)
    with st.plain_ops():
        p_run.sim_step_n(DIST_LES_STEPS, udf=udf)
    if st.launch_counts() != counts:
        failures.append("(f) the plain_ops() run launched a kernel")
    du, dp = rel(k_run.u, p_run.u), rel(k_run.p, p_run.p)
    print(f"{tag} after step {DIST_LES_STEPS}, kernels vs plain_ops(): max|du|/max|u| "
          f"{du:.3e}, max|dp|/max|p| {dp:.3e}; pois_n {k_run.pois_n} vs {p_run.pois_n}; "
          f"K6 {tally['K6']}, K7 {tally['K7']}", flush=True)
    if not (du <= 1e-4 and dp <= 1e-3 and all(
            abs(a - b) <= 1 for a, b in zip(k_run.pois_n, p_run.pois_n))):
        failures.append("(f) the LES dist kernels differ from plain_ops() beyond the "
                        "phase-5 limits")
    for k, n in counts.items():
        if (n > 0) != (k in PATH_KERNELS[("les-dist", "flat")]):
            failures.append(f"(f) launch count of {k} is {n}")
    if tally["K7"] or not tally["K6"]:
        failures.append("(f) K7 ran or K6 did not")
    k_run.close()
    p_run.close()
    del base, k_run, p_run
    torch.cuda.empty_cache()
    ref = dist_sphere(torch, wt, DIST_SMALL, dev, torch.float64, "flat")
    d = wt.DistSimulation(copy.deepcopy(ref), one_card((4,)), engine="flat")
    st.reset_launch_counts()
    for _ in range(DIST_LES_STEPS):
        ref.sim_step(remeasure=False, udf=udf)
        d.step_once(remeasure=False, udf=udf)
    du, dp = rel(d.u, ref.flow.u.cpu()), rel(d.p, ref.flow.p.cpu())
    print(f"phase10f f64 les flat (4,) {DIST_SMALL}^3 after {DIST_LES_STEPS} steps vs one "
          f"device: max|du|/max|u| {du:.3e}, max|dp|/max|p| {dp:.3e}, pois_n {d.pois_n} "
          f"vs {ref.pois_n}", flush=True)
    if not (du <= 1e-10 and dp <= 1e-10 and d.pois_n == ref.pois_n):
        failures.append("(f) the float64 LES on (4,) differs from one device")
    if any(st.launch_counts().values()):
        failures.append("(f) float64 LES launched a kernel")
    d.close()
    del ref, d

    # (g) forward-mode AD of a decomposed 3d step
    sim = dist_sphere(torch, wt, DIST_SMALL, dev, torch.float64, "3d")
    sim.sim_step(remeasure=False)
    cfg = sim.flow.cfg
    dt = torch.tensor(sim.flow.dt[-1], dtype=cfg.dtype, device=dev)
    t0 = torch.tensor(sim.time, dtype=cfg.dtype, device=dev)
    prim1, tan1, log1 = one_jvp_step(torch, sim, dt, t0)
    d = wt.DistSimulation(copy.deepcopy(sim), one_card((4,)), engine="3d")
    res = dist_jvp_step(torch, d, cfg, dt, t0)
    errs = []
    for k, lead in ((0, 1), (1, 0)):
        for part, one in ((0, prim1), (1, tan1)):
            errs.append(rel(d._dense(lambda sh: res[sh.ctx.rank][part][k], lead),
                            one[k].cpu()))
    tmax = max(tan1[0].abs().max().item(), tan1[1].abs().max().item())
    ddt = [r[1][2].item() for r in res]
    print(f"phase10g f64 jvp in nu of a 3d step, (4,) {DIST_SMALL}^3 vs one device: "
          f"relative u, du, p, dp {[f'{e:.3e}' for e in errs]}; max|tangent| {tmax:.3e}; "
          f"d(dt)/d(nu) {ddt[0]:.9e} vs {tan1[2].item():.9e}; iterations "
          f"{[r[2] for r in res]} vs {log1}", flush=True)
    if not (max(errs) <= 1e-10 and tmax > 1e-3 and all(r[2] == log1 for r in res)
            and all(abs(x - tan1[2].item()) <= 1e-10 * abs(tan1[2].item()) for x in ddt)):
        failures.append("(g) the float64 decomposed jvp differs from one device, or "
                        "its tangent is zero")
    d.close()
    del sim, d, res
    tag = f"phase10g ad-dist {FINE}^3 [3d] on (4,)"
    sim = sphere_sim(torch, wt, FINE, dev, engine="3d")
    one = copy.deepcopy(sim)
    cfg = sim.flow.cfg
    d = wt.DistSimulation(sim, one_card((4,)), engine="3d")
    primal_ms = step_events(torch, lambda: d.step_once(remeasure=False), DIST_AD_STEPS)
    for _ in range(DIST_AD_STEPS):
        one.sim_step(remeasure=False)
    dt = torch.tensor(d.sim.flow.dt[-1], dtype=cfg.dtype, device=dev)
    t0 = torch.tensor(d.time, dtype=cfg.dtype, device=dev)
    st.reset_launch_counts()
    d.comm.reset_counts()
    res = []
    ms = step_events(torch, lambda: res.append(dist_jvp_step(torch, d, cfg, dt, t0)),
                     DIST_AD_STEPS)
    counts = st.launch_counts()
    runs[("ad-dist", "3d")] = dist_record(torch, f"{tag} jvp", d, ms, counts,
                                          DIST_AD_STEPS)
    last = res[-1]
    du = torch.as_tensor(d._dense(lambda sh: last[sh.ctx.rank][1][0], 1))
    print(f"{tag}: primal ms/step {[round(t, 3) for t in primal_ms]}, jvp ms/step "
          f"{[round(t, 3) for t in ms]}; max|du/dnu| {du.abs().max().item():.3e}, "
          f"iterations {last[0][2]}", flush=True)
    if not (bool(torch.isfinite(du).all()) and du.abs().max().item() > 0
            and all(r[2] == last[0][2] for r in last)):
        failures.append("(g) the float32 decomposed jvp is not finite, is zero, or its "
                        "shards took other iterations")
    for k, n in counts.items():
        if (n > 0) != (k in PATH_KERNELS[("ad-dist", "3d")]):
            failures.append(f"(g) launch count of {k} is {n}")
    # the same jvp step under plain_ops(), and the single device's jvp step
    # after the same primal steps (its own kernels): the primal to phase
    # 5's limits, the tangents and d(dt)/d(nu) to phase 9's, the
    # iterations within one
    with st.plain_ops():
        plain = dist_jvp_step(torch, d, cfg, dt, t0)
    if st.launch_counts() != counts:
        failures.append("(g) the plain_ops() jvp launched a kernel")
    dt1 = torch.tensor(one.flow.dt[-1], dtype=cfg.dtype, device=dev)
    t1 = torch.tensor(one.time, dtype=cfg.dtype, device=dev)
    single = one_jvp_step(torch, one, dt1, t1)
    before = st.launch_counts()
    with st.plain_ops():
        single_plain = one_jvp_step(torch, one, dt1, t1)
    if st.launch_counts() != before:
        failures.append("(g) the single device's plain_ops() jvp launched a kernel")

    def dense_of(r, sharded):
        """u, p, du/dν, dp/dν (dense, on the host), d(dt)/dν and each
        shard's iterations of a jvp step's result."""
        out = {}
        for k, lead, name in ((0, 1, "u"), (1, 0, "p")):
            for part, pre in ((0, ""), (1, "d")):
                out[pre + name] = torch.as_tensor(
                    d._dense(lambda sh: r[sh.ctx.rank][part][k], lead) if sharded
                    else r[part][k].cpu())
        out["d(dt)"] = (r[0] if sharded else r)[1][2].item()
        out["logs"] = [x[2] for x in r] if sharded else [r[2]] * len(last)
        return out

    def compare(a, b):
        errs = {k: rel(a[k], b[k]) for k in ("u", "du", "p", "dp")}
        errs["d(dt)"] = abs(a["d(dt)"] - b["d(dt)"]) / abs(b["d(dt)"])
        diff = (a["du"] - b["du"]).abs()
        at = tuple(int(i) for i in torch.unravel_index(diff.argmax(), diff.shape))
        it_ok = all(len(x) == len(y) and all(abs(i - j) <= 1 for i, j in zip(x, y))
                    for x, y in zip(a["logs"], b["logs"]))
        return errs, at, it_ok

    mine = dense_of(last, True)
    refs = {"plain_ops()": dense_of(plain, True),
            "one device, each after its own primal steps": dense_of(single, False),
            "one device under plain_ops(), each after its own primal steps":
                dense_of(single_plain, False)}
    for against, ref in refs.items():
        errs, at, it_ok = compare(mine, ref)
        print(f"{tag}: jvp vs {against}: relative "
              f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (du's largest at "
              f"{at}; the shards start at x = {[FINE // 4 * i + 1 for i in range(4)]}); d(dt)/d(nu) "
              f"{mine['d(dt)']:.9e} vs {ref['d(dt)']:.9e}; iterations {mine['logs'][0]} vs "
              f"{ref['logs'][0]}", flush=True)
        if not (errs["u"] <= 1e-4 and errs["p"] <= 1e-3 and it_ok
                and max(errs["du"], errs["dp"], errs["d(dt)"]) <= AD_SPHERE_TOL):
            failures.append(f"(g) the float32 decomposed jvp differs from {against} "
                            "beyond the phase-5 and phase-9 limits")
        runs[("ad-dist", "3d")][f"vs {against}"] = errs
    one_k, one_p = list(refs.values())[1:]
    errs, at, _ = compare(one_k, one_p)
    print(f"{tag}: one device's jvp, kernels vs plain_ops(): relative "
          f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (du's largest at {at})",
          flush=True)
    # the four shards' jvp step from the single device's own state: the
    # comparison with one device without the primal steps' divergence
    d.close()
    del d, res, last, plain, mine
    d = wt.DistSimulation(copy.deepcopy(one), one_card((4,)), engine="3d")
    errs, at, it_ok = compare(dense_of(dist_jvp_step(torch, d, cfg, dt1, t1), True), one_k)
    print(f"{tag}: jvp from the single device's state vs one device: relative "
          f"{', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (du's largest at {at})",
          flush=True)
    if not (errs["u"] <= 1e-4 and errs["p"] <= 1e-3 and it_ok
            and max(errs["du"], errs["dp"], errs["d(dt)"]) <= AD_SPHERE_TOL):
        failures.append("(g) the float32 decomposed jvp from the single device's state "
                        "differs from one device beyond the phase-5 and phase-9 limits")
    runs[("ad-dist", "3d")]["vs one device, same state"] = errs
    runs[("ad-dist", "3d")]["primal_ms_step"] = statistics.mean(primal_ms[1:])
    d.close()
    del sim, one, d, single, single_plain, refs, one_k, one_p
    torch.cuda.empty_cache()

    # (h) the flat engine with a moving body, float64, against one device
    ref = make_sim(torch, wt, "moving", DIST_SMALL, dev, dtype=torch.float64,
                   engine="flat")[0]
    d = wt.DistSimulation(copy.deepcopy(ref), one_card((4,)), engine="flat")
    # the single device on the CPU: the same run in another order of sums
    host = make_sim(torch, wt, "moving", DIST_SMALL, torch.device("cpu"),
                    dtype=torch.float64, engine="flat")[0]
    st.reset_launch_counts()
    for k in range(1, DIST_MOVING_STEPS + 1):
        ref.sim_step(remeasure=True)
        d.step_once(remeasure=True)
        host.sim_step(remeasure=True)
    # p weighted by each cell's largest face L, as phase 5 holds a moving
    # body: a cell that re-enters the fluid has a near-singular row, whose p
    # moves with the order of the sums (the CPU's single device, printed)
    w = face_weight(ref.levels[0].L).cpu()
    pmax = ref.flow.p.abs().max().item()

    def p_diff(p):
        diff = (torch.as_tensor(p) - ref.flow.p.cpu()).abs()
        at = tuple(int(i) for i in torch.unravel_index(diff.argmax(), diff.shape))
        return (diff * w).max().item() / pmax, diff.max().item() / pmax, at
    du, (dp, dp_all, at) = rel(d.u, ref.flow.u.cpu()), p_diff(d.p)
    hu, (hp, hp_all, h_at) = rel(host.flow.u, ref.flow.u.cpu()), p_diff(host.flow.p)
    print(f"phase10h f64 moving sphere, flat (4,) {DIST_SMALL}^3, re-measured every step, "
          f"after {DIST_MOVING_STEPS} steps vs one device: max|du|/max|u| {du:.3e}, "
          f"max|dp|/max|p| {dp:.3e} weighted by the cell's largest face L (unweighted "
          f"{dp_all:.3e}, largest at {at}, where L is {w[at].item():.3g}), pois_n "
          f"{d.pois_n} vs {ref.pois_n}; the single device on the CPU vs on the card: "
          f"max|du|/max|u| {hu:.3e}, max|dp|/max|p| weighted {hp:.3e}, unweighted "
          f"{hp_all:.3e} at {h_at} (L {w[h_at].item():.3g}), pois_n {host.pois_n}; "
          f"(4,) vs the CPU's single device: max|dp|/max|p| unweighted "
          f"{rel(d.p, host.flow.p):.3e}", flush=True)
    if not (du <= 1e-10 and dp <= 1e-10 and d.pois_n == ref.pois_n):
        failures.append("(h) the float64 moving flat run on (4,) differs from one device")
    if not (hu <= 1e-10 and hp <= 1e-10 and host.pois_n == ref.pois_n):
        failures.append("(h) the float64 moving flat run on the CPU differs from the card")
    if any(st.launch_counts().values()):
        failures.append("(h) float64 moving run launched a kernel")
    d.close()
    del ref, d, host
    check(not failures, f"phase10e-h: {'; '.join(failures)}")
    return runs


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
    runs = {(c, e): phase_moving(torch, st, wt, dev, e) if c == "moving"
            else phase_main(torch, wt, st, dev, c, e) for c, e in MAIN_RUNS}
    a, b = runs[("sphere-mp", "flat")], runs[("sphere-s2", "flat")]
    print(f"phase4 smooth_it=2, bf16 smoothing vs float32: ms/step "
          f"{a['ms_step']:.3f} vs {b['ms_step']:.3f}; pois_n {a['pois_n']} vs "
          f"{b['pois_n']}; peak {a['peak'] / 2**30:.3f} vs {b['peak'] / 2**30:.3f} GiB",
          flush=True)
    runs[("probe", "tool")] = phase_probe(torch, st)
    # the launch-cost table calls every wrapper as a microbenchmark: its
    # counts are checked by its own phase and kept out of `launches`
    cost = phase_launch(torch, st)
    host = cost["rows"]
    check(set(runs) | {("launch", "tool")} | LATER_PATHS == set(PATH_KERNELS),
          "phase4: a path was not run")
    failures = [f for config in SMALL
                for f in phase_compare(torch, wt, st, dev, config, SMALL[config])]
    failures += phase_band_check(torch, wt, dev)
    check(not failures, f"phase5: {'; '.join(failures)}")
    runs.update(phase_2d(torch, wt, st, dev))
    runs[("pcg", "3d")] = pcg = phase_pcg(torch, wt, st, dev)
    phase_utils(torch, wt, dev, pcg)
    del pcg["sim"]
    ad = phase_ad(torch, wt, st, dev)
    runs.update(ad)
    dist = phase_dist(torch, wt, st, dev, stats)
    dist.update(phase_dist2(torch, wt, st, dev, pcg))
    del pcg["ref"]
    runs.update(dist)
    check(set(runs) | {("launch", "tool")} == set(PATH_KERNELS),
          "phase6-10: a path was not run")
    launches = {k: sum(r["counts"][k] for r in runs.values()) for k in KERNELS}
    check(all(n > 0 for n in launches.values()),
          f"a kernel was launched by no path: {launches}")

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
                "bound_ms": stats[k]["bound_ms"], "bound_by": stats[k]["bound_by"],
                "library_ms": stats[k]["library_ms"],
                "host_us": host[HOST_ROW[k]]["host_us"],
                "mul_host_us": host[HOST_ROW[k]]["mul_host_us"],
                "tool_launches": cost["counts"][k],
                "pcg_launches": pcg["counts"][k],
                "ad_launches": sum(r["counts"][k] for r in ad.values()),
                "dist_launches": sum(r["counts"][k] for r in dist.values())}
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
