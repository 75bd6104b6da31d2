#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the CUDA kernels of ``waterlily_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version in float32 on random inputs
   at the shapes the main paths give it (258³ fine level, 130³ and 18³ MG
   levels, a non-cubic (50, 34, 34)), and the median time of each case at
   258³;
4. both engines at full width: the 256³ static sphere of ``bench.py``
   (radius N/8, ν = radius/1e3, float32, the library's solver defaults),
   built with ``Simulation`` and stepped 10 times with
   ``sim_step(remeasure=False)``, first with ``engine="flat"`` (the fused
   engine, what ``"auto"`` picks on CUDA), then with ``engine="3d"``.  The
   launch counts of each run show it went through its own kernel set, and
   the two runs together launch all eight kernels;
5. on a 64³ sphere, 5 steps: the flat engine with the kernels (built with
   ``engine="auto"``) against the flat engine with ``plain_ops()``, and
   against the 3d engine with the kernels.

Before its last line it prints one JSON object with each kernel's launches
(summed over the two phase-4 runs), error and times, and the card's name
and power limit; the last line is ``{"ok": true, "device": {...}}``.  Needs
no JAX and no network.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
FINE = 256
STEPS = 10
UBC = (1.0, 0.25, -0.5)      # all three components non-zero for BC! corners
_STENCIL = "waterlily_tpu_torch/csrc/stencil3d.cu"
_FUSED = "waterlily_tpu_torch/csrc/fused3d.cu"
# name: (tolerance relative to max|plain|, CUDA source, TPU kernel replaced)
KERNELS = {
    "conv_diff_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:274"),
    "bdim_k": (2e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:372"),
    "mult_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:504"),
    "gs_incr_k": (1e-5, _STENCIL, "waterlily_tpu/ops/pallas3d.py:416"),
    "conv_diff_bdim_k": (2e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:376"),
    "incr_gs_k": (1e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:896"),
    "bc_div_k": (1e-6, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1143"),
    "projbc_k": (1e-5, _FUSED, "waterlily_tpu/ops/pallas_flat.py:1201"),
}
# the kernels each engine launches on the sphere (a body band is set, so the
# flat engine runs K1 and no K12)
PATH_KERNELS = {
    "flat": {"conv_diff_bdim_k", "bdim_k", "mult_k", "gs_incr_k",
             "incr_gs_k", "bc_div_k", "projbc_k"},
    "3d": {"conv_diff_k", "bdim_k", "mult_k", "gs_incr_k"},
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
def kernel_cases(torch, st, fz, ps, bc_vector, shape, rng, dev):
    """(kernel name, case label, kernel thunk, plain thunk) at one shape.
    A thunk returns a tensor or a tuple of tensors to compare."""
    f32 = torch.float32

    def g(*s):
        return torch.as_tensor(rng.standard_normal(s + shape), dtype=f32, device=dev)

    def zero_ghost(a):
        out = torch.zeros(shape, dtype=f32, device=dev)
        out[1:-1, 1:-1, 1:-1] = a[1:-1, 1:-1, 1:-1]
        return out

    u, u0, f, V = g(3), g(3), g(3), 0.1 * g(3)
    mu0, mu1 = g(3).abs(), 0.3 * g(3, 3)
    L = bc_vector(torch.as_tensor(0.2 + rng.random((3,) + shape), dtype=f32,
                                  device=dev), (0.0,) * 3)
    lev = ps.make_level(L)
    x = g()
    r, eps = zero_ghost(g()), zero_ghost(0.3 * g())
    nu = torch.tensor(0.03, dtype=f32, device=dev)
    cases = []
    for sid, scheme in enumerate(st.SCHEMES):
        cases.append(("conv_diff_k", scheme.__name__,
                      lambda sid=sid: st.conv_diff_k(u, nu, sid),
                      lambda scheme=scheme: st.conv_diff_plain(u, nu, scheme)))
    cases.append(("bdim_k", "", lambda: st.bdim_k(u, u0, f, V, mu0, mu1, 0.3),
                  lambda: st.bdim_plain(u, u0, f, V, mu0, mu1, 0.3)))
    cases.append(("mult_k", "", lambda: st.mult_k(x, lev.L, lev.D),
                  lambda: st.mult_plain(x, lev.L, lev.D)))
    for cols in ([], [0, 1, 0, 1], [1, 0]):
        cases.append(("gs_incr_k", str(cols),
                      lambda cols=cols: st.gs_incr_k(x, r, lev.L, lev.D, lev.iD, cols, 0.9),
                      lambda cols=cols: st.gs_incr_plain(x, r, lev.L, lev.D, lev.iD, cols, 0.9)))
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
    for cfl in (False, True):
        cases.append(("projbc_k", f"cfl={cfl}",
                      lambda cfl=cfl: fz.projbc_k(u, x, lev.L, UBC, cfl),
                      lambda cfl=cfl: fz.projbc_plain(u, x, lev.L, UBC, cfl)))
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


def phase_kernels(torch, np, dev):
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops import stencil3d as st
    from waterlily_tpu_torch.ops.bc import bc_vector

    rng = np.random.default_rng(SEED)
    fine = (FINE + 2,) * 3
    shapes = [fine, (130,) * 3, (18,) * 3, (50, 34, 34)]
    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None} for k in KERNELS}
    seen = set()
    for shape in shapes:
        for name, label, kern, plain in kernel_cases(torch, st, fz, ps, bc_vector,
                                                     shape, rng, dev):
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
                print(f"phase3 {name:16s} {label:14s} {str(shape):16s} out{k} "
                      f"max|d|={err:.3e} rel={rel:.3e} tol={tol:.0e}", flush=True)
                check(rel <= tol, f"{name} {label} at {shape} output {k}: "
                      f"relative error {rel:.3e} > {tol:.0e}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            del got, want
            if shape == fine:
                ms, pms = median_ms(torch, kern, 20), median_ms(torch, plain, 4)
                print(f"phase3 time {name:16s} {label:14s} at {shape}: kernel "
                      f"{ms:.4f} ms, plain {pms:.4f} ms per call", flush=True)
                if stats[name]["ms"] is None:
                    # the JSON keeps the first case of each kernel (conv_diff:
                    # quick; gs_incr: Jacobi; K1: predictor; K7: 4 colours)
                    stats[name]["ms"], stats[name]["plain_ms"] = ms, pms
        torch.cuda.empty_cache()
    check(seen == set(KERNELS), f"phase3: kernels without a case: {set(KERNELS) - seen}")
    return stats


# ------------------------------------------------------------ phases 4, 5
def sphere_sim(torch, wt, n: int, dev, **kw):
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e3,
                         body=body, dtype=torch.float32, device=dev, **kw)


def phase_main(torch, wt, st, dev, engine: str):
    """One engine's run of the 256³ sphere, with its own launch counts."""
    tag = f"phase4 [{engine}]"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st.reset_launch_counts()
    t0 = time.perf_counter()
    sim = sphere_sim(torch, wt, FINE, dev, engine=engine)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    check(sim.engine == engine, f"{tag}: Simulation runs engine {sim.engine}")
    print(f"{tag} build {FINE}^3: {build_s:.2f} s, levels "
          f"{[tuple(l.D.shape) for l in sim.levels]}, band_x "
          f"{sim.flow.cfg.band_x}, peak during build "
          f"{build_peak / 2**30:.3f} GiB", flush=True)
    events = []
    for _ in range(STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sim.sim_step(remeasure=False)
        b.record()
        events.append((a, b))
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
    check(tuple(u.shape) == (3,) + (FINE + 2,) * 3 and tuple(p.shape) == (FINE + 2,) * 3,
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
    for k, n in counts.items():
        if k in PATH_KERNELS[engine]:
            check(n > 0, f"{tag}: kernel {k} was not launched")
        else:
            check(n == 0, f"{tag}: kernel {k} of the other engine was launched")
    del sim, u, p
    return dict(counts=counts, ms_step=ms_step, step_ms=step_ms, peak=peak,
                build_s=build_s)


def phase_compare(torch, wt, st, dev):
    n = 64
    sims = {}
    for mode in ("flat", "flat-plain", "3d"):
        if mode == "flat":
            sim = sphere_sim(torch, wt, n, dev)              # engine="auto"
            check(sim.engine == "flat", f"phase5: auto picked {sim.engine} on CUDA")
        else:
            sim = sphere_sim(torch, wt, n, dev, engine=mode.split("-")[0])
        if mode == "flat-plain":
            with st.plain_ops():
                sim.sim_step_n(5)
        else:
            sim.sim_step_n(5)
        torch.cuda.synchronize()
        sims[mode] = sim
    k = sims["flat"]
    for other in ("flat-plain", "3d"):
        o = sims[other]
        du = (k.flow.u - o.flow.u).abs().max().item()
        dp = (k.flow.p - o.flow.p).abs().max().item()
        su, sp = o.flow.u.abs().max().item(), o.flow.p.abs().max().item()
        print(f"phase5 {n}^3 5 steps, flat vs {other}: pois_n {k.pois_n} vs "
              f"{o.pois_n}; max|du|={du:.3e} (tol {1e-4 * su:.3e}), "
              f"max|dp|={dp:.3e} (tol {1e-3 * sp:.3e})", flush=True)
        check(len(k.pois_n) == len(o.pois_n) and all(
            abs(a - b) <= 1 for a, b in zip(k.pois_n, o.pois_n)),
            f"phase5: iteration counts of flat and {other} differ by more than one")
        check(du <= 1e-4 * su, f"phase5: u of flat differs from {other}")
        check(dp <= 1e-3 * sp, f"phase5: p of flat differs from {other}")


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
    runs = {e: phase_main(torch, wt, st, dev, e) for e in ("flat", "3d")}
    launches = {k: sum(r["counts"][k] for r in runs.values()) for k in KERNELS}
    check(all(n > 0 for n in launches.values()),
          f"phase4: a kernel was launched by neither engine: {launches}")
    phase_compare(torch, wt, st, dev)

    kernels = [{"name": k, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[k], "max_abs_err": stats[k]["max_abs_err"],
                "ms": stats[k]["ms"], "plain_ms": stats[k]["plain_ms"]}
               for k, (_, src, rep) in KERNELS.items()]
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
