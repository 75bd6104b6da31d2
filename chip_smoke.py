#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the CUDA kernels of ``waterlily_tpu_torch/csrc`` with ``nvcc``;
3. each kernel (and each mode: K12 periodic, K9 keeping the exit plane)
   against its plain PyTorch version in float32 on random inputs at the
   shapes the main paths give it (258³ fine level, 130³ and 18³ MG levels,
   a non-cubic (50, 34, 34) and an odd-interior (51, 34, 35)), and the
   median time of each case at 258³ beside its plain version's;
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
5. at small size, 5 steps: the flat engine with the kernels (built with
   ``engine="auto"``) against the flat engine with ``plain_ops()``, and
   against the 3d engine with the kernels, on a 64³ sphere, a 64³
   Taylor–Green vortex and ``examples/sphere_drag.py``'s sphere at N = 64
   (160×64×64, R = 8).  At N = 32 (R = 4) that flow moves u by up to
   2e-4·max|u| between two float32 rounding orders, above the comparison's
   1e-4 limit; at N = 64 by less than 2e-5.

Before its last line it prints one JSON object with each kernel's launches
(summed over the phase-4 runs), error, times and bound, and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Needs
no JAX and no network.
"""
from __future__ import annotations

import json
import math
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
# name: (tolerance relative to max|plain|, CUDA source, TPU kernel replaced,
#        bytes per cell the timed case must move (each input read once, each
#        output written once), float32 operations per cell it needs)
KERNELS = {
    "conv_diff_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:274", 24, 200),
    "bdim_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:372", 108, 60),
    "mult_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:504", 24, 13),
    "gs_incr_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:416", 36, 17),
    "gauss_sweeps_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:312", 28, 28),
    "conv_diff_bdim_k": (2e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:376",
                         None, 215),
    "incr_gs_k": (1e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:896", 40, 60),
    "bc_div_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1143", 28, 6),
    "projbc_k": (1e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1201", 40, 9),
    "bc_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1076", 24, 0),
    "div_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1279", 16, 6),
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
}


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


# ------------------------------------------------------------ phase 3
def kernel_cases(torch, st, fz, ps, shape, rng, dev):
    """(kernel name, case label, kernel thunk, plain thunk) at one shape.
    A thunk returns a tensor or a tuple of tensors to compare.  The first
    case of each kernel is the one the JSON line times."""
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
    for cols in ([], [0, 1, 0, 1], [1, 0]):
        cases.append(("gs_incr_k", str(cols),
                      lambda cols=cols: st.gs_incr_k(x, r, lev.L, lev.D, lev.iD, cols, 0.9),
                      lambda cols=cols: st.gs_incr_plain(x, r, lev.L, lev.D, lev.iD, cols, 0.9)))
    # K13 on a periodic level, from a periodic-synced eps
    for per in ((0, 1, 2), (2,)):
        Lp = bc_vector(L_raw, (0.0,) * 3, perdir=per)
        iDp = ps.make_level(Lp).iD
        ep = per_bc(eps, per)
        for cols in ([0, 1, 0, 1], [1, 0]):
            cases.append(("gauss_sweeps_k", f"{cols} per={''.join(map(str, per))}",
                          lambda cols=cols, per=per, Lp=Lp, iDp=iDp, ep=ep:
                              st.gauss_sweeps_k(ep, r, Lp, iDp, cols, per),
                          lambda cols=cols, per=per, Lp=Lp, iDp=iDp, ep=ep:
                              st.gauss_sweeps_plain(ep, r, Lp, iDp, cols, per)))
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
    # K7 (K6 with no colours) with its norms, each compared on its own scale
    for cols in ([0, 1, 0, 1], []):
        def k7(cols=cols):
            xo, ro, nv = fz.incr_gs_k(x, r, eps, lev.L, lev.D, lev.iD, cols, 0.9, True)
            return xo, ro, nv[0:1], nv[1:2]

        def p7(cols=cols):
            xo, ro, nv = fz.incr_gs_plain(x, r, eps, lev.L, lev.D, lev.iD, cols, 0.9, True)
            return xo, ro, nv[0:1], nv[1:2]
        cases.append(("incr_gs_k", str(cols), k7, p7))
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


def bound_ms(name: str, shape) -> tuple[float, str]:
    """The least time the card could take for the timed case of ``name`` at
    ``shape``: the larger of its bytes over the HBM rate and its float32
    operations over the float32 peak (H100 SXM data sheet, 700 W)."""
    _, _, _, bpc, fpc = KERNELS[name]
    cells = math.prod(shape)
    if bpc is None:
        # K1: u, u0 in and u_new out on every cell, f out on the slab third
        slab = (2 * shape[0] // 3 - shape[0] // 3) / shape[0]
        bpc = 36 + 12 * slab
    t_bytes = bpc * cells / HBM_BYTES_PER_S * 1e3
    t_ops = fpc * cells / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_kernels(torch, np, dev):
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops import stencil3d as st

    rng = np.random.default_rng(SEED)
    fine = (FINE + 2,) * 3
    shapes = [fine, (130,) * 3, (18,) * 3, (50, 34, 34), (51, 34, 35)]
    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None,
                 "library_ms": None} for k in KERNELS}
    seen = set()
    for shape in shapes:
        for name, label, kern, plain in kernel_cases(torch, st, fz, ps, shape,
                                                     rng, dev):
            seen.add(name)
            tol = KERNELS[name][0]
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            check(len(got) == len(want), f"{name} {label}: output count differs")
            for k, (a, b) in enumerate(zip(got, want)):
                check(bool(torch.isfinite(a).all()), f"{name} {label} {shape}: non-finite")
                err = (a - b).abs().max().item()
                scale = max(b.abs().max().item(), 1e-30)
                rel = err / scale
                print(f"phase3 {name:16s} {label:22s} {str(shape):16s} out{k} "
                      f"max|d|={err:.3e} rel={rel:.3e} tol={tol:.0e}", flush=True)
                check(rel <= tol, f"{name} {label} at {shape} output {k}: "
                      f"relative error {rel:.3e} > {tol:.0e}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            del got, want
            if shape == fine:
                ms, pms = median_ms(torch, kern, 20), median_ms(torch, plain, 4)
                print(f"phase3 time {name:16s} {label:22s} at {shape}: kernel "
                      f"{ms:.4f} ms, plain {pms:.4f} ms per call", flush=True)
                if stats[name]["ms"] is None:
                    # the JSON keeps the first case of each kernel (conv_diff:
                    # quick, walls; gs_incr: Jacobi; K13: 4 colours, xyz
                    # periodic; K1: predictor; K7: 4 colours; K9: no CFL, no
                    # exit; K10: no exit)
                    stats[name]["ms"], stats[name]["plain_ms"] = ms, pms
                    stats[name]["bound_ms"], stats[name]["bound_by"] = bound_ms(name, shape)
        if shape == fine:
            u = torch.as_tensor(rng.standard_normal((3,) + fine), dtype=torch.float32,
                                device=dev)
            lib = library_div_ms(torch, u)
            stats["div_k"]["library_ms"] = lib
            print(f"phase3 time div_k library conv3d at {fine}: {lib:.4f} ms per call",
                  flush=True)
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
    if config == "sphere":
        sim = sphere_sim(torch, wt, FINE, dev, engine=engine)
    elif config == "tgv":
        sim = tgv_sim(torch, wt, FINE, dev, engine=engine)
    else:
        sim = drag_sim(torch, wt, 128, dev, engine=engine)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    check(sim.engine == engine, f"{tag}: Simulation runs engine {sim.engine}")
    shape = sim.flow.cfg.shape
    print(f"{tag} build {shape}: {build_s:.2f} s, levels "
          f"{[tuple(l.D.shape) for l in sim.levels]}, band_x "
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
        sim.sim_step(remeasure=False)
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
    for k, n in counts.items():
        if k in PATH_KERNELS[(config, engine)]:
            check(n > 0, f"{tag}: kernel {k} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {k} of another path was launched")
    del sim, u, p
    return dict(counts=counts, ms_step=ms_step, step_ms=step_ms, peak=peak,
                build_s=build_s)


# ------------------------------------------------------------ phase 5
def phase_compare(torch, wt, st, dev, config: str):
    make = {"sphere": (sphere_sim, 64), "tgv": (tgv_sim, 64),
            "drag": (drag_sim, 64)}[config]
    sims = {}
    for mode in ("flat", "flat-plain", "3d"):
        if mode == "flat":
            sim = make[0](torch, wt, make[1], dev)             # engine="auto"
            check(sim.engine == "flat", f"phase5: auto picked {sim.engine} on CUDA")
        else:
            sim = make[0](torch, wt, make[1], dev, engine=mode.split("-")[0])
        if mode == "flat-plain":
            with st.plain_ops():
                sim.sim_step_n(5)
        else:
            sim.sim_step_n(5)
        torch.cuda.synchronize()
        sims[mode] = sim
    k = sims["flat"]
    shape = k.flow.cfg.shape
    for other in ("flat-plain", "3d"):
        o = sims[other]
        du = (k.flow.u - o.flow.u).abs().max().item()
        dp = (k.flow.p - o.flow.p).abs().max().item()
        su, sp = o.flow.u.abs().max().item(), o.flow.p.abs().max().item()
        print(f"phase5 {config} {shape} 5 steps, flat vs {other}: pois_n {k.pois_n} vs "
              f"{o.pois_n}; max|du|={du:.3e} (tol {1e-4 * su:.3e}), "
              f"max|dp|={dp:.3e} (tol {1e-3 * sp:.3e})", flush=True)
        check(len(k.pois_n) == len(o.pois_n) and all(
            abs(a - b) <= 1 for a, b in zip(k.pois_n, o.pois_n)),
            f"phase5 {config}: iteration counts of flat and {other} differ by more than one")
        check(du <= 1e-4 * su, f"phase5 {config}: u of flat differs from {other}")
        check(dp <= 1e-3 * sp, f"phase5 {config}: p of flat differs from {other}")


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

    stats = phase_kernels(torch, np, dev)
    runs = {(c, e): phase_main(torch, wt, st, dev, c, e)
            for c in ("sphere", "tgv", "drag") for e in ("flat", "3d")}
    launches = {k: sum(r["counts"][k] for r in runs.values()) for k in KERNELS}
    check(all(n > 0 for n in launches.values()),
          f"phase4: a kernel was launched by no path: {launches}")
    for config in ("sphere", "tgv", "drag"):
        phase_compare(torch, wt, st, dev, config)

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"],
                "bound_ms": stats[k]["bound_ms"], "bound_by": stats[k]["bound_by"],
                "library_ms": stats[k]["library_ms"]}
               for k, (_, src, rep, _, _) in KERNELS.items()]
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
