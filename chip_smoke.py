#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit) and the toolchain;
2. build the CUDA kernels of ``waterlily_tpu_torch/csrc`` with ``nvcc``;
3. each kernel against its plain PyTorch version in float32 on random inputs
   at the shapes the main path gives it (258³ fine level, 130³ and 18³ MG
   levels, a non-cubic (50, 34, 34)), and the median time of each at 258³;
4. the main path at full width: the 256³ static sphere of ``bench.py``
   (radius N/8, ν = radius/1e3, float32, the library's solver defaults),
   built with ``Simulation`` and stepped 10 times with
   ``sim_step(remeasure=False)``; the launch counts of that run show it went
   through every kernel;
5. the same slice with the kernels against the slice with ``plain_ops()``
   on a 64³ sphere, 5 steps.

Before its last line it prints one JSON object with each kernel's launches,
error and times, and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Needs no JAX and no network.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

SEED = 0
FINE = 256
TOL = {"conv_diff_k": 2e-5, "bdim_k": 2e-5, "mult_k": 1e-5, "gs_incr_k": 1e-5}
REPLACES = {
    "conv_diff_k": "waterlily_tpu/ops/pallas3d.py:274",
    "bdim_k": "waterlily_tpu/ops/pallas3d.py:372",
    "mult_k": "waterlily_tpu/ops/pallas3d.py:504",
    "gs_incr_k": "waterlily_tpu/ops/pallas3d.py:416",
}
SOURCE = "waterlily_tpu_torch/csrc/stencil3d.cu"


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
def kernel_cases(torch, np, st, ps, bc_vector, shape, rng, dev):
    """(kernel name, case label, kernel thunk, plain thunk) at one shape."""
    f32 = torch.float32

    def g(*s):
        return torch.as_tensor(rng.standard_normal(s + shape), dtype=f32, device=dev)

    u, u0, f, V = g(3), g(3), g(3), 0.1 * g(3)
    mu0, mu1 = g(3).abs(), 0.3 * g(3, 3)
    L = bc_vector(torch.as_tensor(0.2 + rng.random((3,) + shape), dtype=f32,
                                  device=dev), (0.0,) * 3)
    lev = ps.make_level(L)
    x = g()
    r = torch.zeros(shape, dtype=f32, device=dev)
    r[1:-1, 1:-1, 1:-1] = g()[1:-1, 1:-1, 1:-1]
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


def phase_kernels(torch, np, wt, dev):
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops import stencil3d as st
    from waterlily_tpu_torch.ops.bc import bc_vector

    rng = np.random.default_rng(SEED)
    fine = (FINE + 2,) * 3
    shapes = [fine, (130,) * 3, (18,) * 3, (50, 34, 34)]
    stats = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None} for k in TOL}
    for shape in shapes:
        for name, label, kern, plain in kernel_cases(torch, np, st, ps,
                                                     bc_vector, shape, rng, dev):
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                check(bool(torch.isfinite(a).all()), f"{name} {label} {shape}: non-finite")
                err = (a - b).abs().max().item()
                scale = max(b.abs().max().item(), 1e-30)
                rel = err / scale
                print(f"phase3 {name:12s} {label:12s} {str(shape):16s} "
                      f"max|d|={err:.3e} rel={rel:.3e} tol={TOL[name]:.0e}",
                      flush=True)
                check(rel <= TOL[name], f"{name} {label} at {shape}: relative "
                      f"error {rel:.3e} > {TOL[name]:.0e}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            if shape == fine and stats[name]["ms"] is None:
                # time the first case of each kernel at the fine level
                # (conv_diff: quick; gs_incr: Jacobi, the fine pre-smooth)
                stats[name]["ms"] = median_ms(torch, kern, 20)
                stats[name]["plain_ms"] = median_ms(torch, plain, 4)
                print(f"phase3 time {name:12s} {label:12s} at {shape}: kernel "
                      f"{stats[name]['ms']:.4f} ms, plain "
                      f"{stats[name]['plain_ms']:.4f} ms per call", flush=True)
            del got, want
        torch.cuda.empty_cache()
    # the fine smoother with the default 4 colours, for the record
    lev_rng = np.random.default_rng(SEED + 1)
    cases = kernel_cases(torch, np, st, ps, bc_vector, fine, lev_rng, dev)
    name, label, kern, plain = [c for c in cases if c[1] == "[0, 1, 0, 1]"][0]
    k4, p4 = median_ms(torch, kern, 20), median_ms(torch, plain, 4)
    print(f"phase3 time gs_incr_k    [0, 1, 0, 1] at {fine}: kernel {k4:.4f} ms, "
          f"plain {p4:.4f} ms per call", flush=True)
    del cases
    torch.cuda.empty_cache()
    return stats


# ------------------------------------------------------------ phases 4, 5
def sphere_sim(torch, wt, n: int, dev, **kw):
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e3,
                         body=body, dtype=torch.float32, device=dev, **kw)


def phase_main(torch, wt, st, dev):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st.reset_launch_counts()
    t0 = time.perf_counter()
    sim = sphere_sim(torch, wt, FINE, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    print(f"phase4 build {FINE}^3: {build_s:.2f} s, levels "
          f"{[tuple(l.D.shape) for l in sim.levels]}, peak during build "
          f"{build_peak / 2**30:.3f} GiB", flush=True)
    events = []
    for k in range(10):
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
    print(f"phase4 ms/step (steps 3-10, mean) {ms_step:.3f}; per step "
          f"{[round(t, 3) for t in step_ms]}", flush=True)
    print(f"phase4 pois_n {sim.pois_n}; dt {[round(d, 5) for d in sim.flow.dt]}",
          flush=True)
    print(f"phase4 max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB)", flush=True)
    print(f"phase4 launch counts {counts}", flush=True)
    check(tuple(u.shape) == (3,) + (FINE + 2,) * 3 and tuple(p.shape) == (FINE + 2,) * 3,
          "phase4: wrong field shapes")
    check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(p).all()),
          "phase4: u or p not finite")
    check(all(0.0 < d <= 10.0 for d in sim.flow.dt), "phase4: dt out of (0, 10]")
    check(len(sim.pois_n) == 20 and all(1 <= n <= itmx for n in sim.pois_n),
          f"phase4: a pressure solve left [1, itmx={itmx}]: {sim.pois_n}")
    pmean = sim.flow.p[1:-1, 1:-1, 1:-1][sim.levels[0].iD[1:-1, 1:-1, 1:-1] != 0].mean().item()
    print(f"phase4 pressure mean over active cells {pmean:.3e}", flush=True)
    check(abs(pmean) < 1e-3 * max(p.abs().max().item(), 1.0),
          "phase4: pressure gauge not pinned")
    for k, n in counts.items():
        check(n > 0, f"phase4: kernel {k} was not launched by the main path")
    return dict(counts=counts, ms_step=ms_step, step_ms=step_ms, peak=peak,
                build_s=build_s, pois_n=list(sim.pois_n))


def phase_compare(torch, wt, st, dev):
    n = 64
    sims = {}
    for mode in ("kernels", "plain"):
        sim = sphere_sim(torch, wt, n, dev)
        if mode == "plain":
            with st.plain_ops():
                sim.sim_step_n(5)
        else:
            sim.sim_step_n(5)
        torch.cuda.synchronize()
        sims[mode] = sim
    k, pl = sims["kernels"], sims["plain"]
    du = (k.flow.u - pl.flow.u).abs().max().item()
    dp = (k.flow.p - pl.flow.p).abs().max().item()
    su = pl.flow.u.abs().max().item()
    sp = pl.flow.p.abs().max().item()
    print(f"phase5 {n}^3 5 steps: pois_n kernels {k.pois_n} plain {pl.pois_n}",
          flush=True)
    print(f"phase5 max|du|={du:.3e} (tol {1e-4 * su:.3e}), max|dp|={dp:.3e} "
          f"(tol {1e-3 * sp:.3e})", flush=True)
    check(len(k.pois_n) == len(pl.pois_n) and all(
        abs(a - b) <= 1 for a, b in zip(k.pois_n, pl.pois_n)),
        "phase5: iteration counts differ by more than one")
    check(du <= 1e-4 * su, "phase5: u differs from the plain path")
    check(dp <= 1e-3 * sp, "phase5: p differs from the plain path")


def main() -> int:
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

    stats = phase_kernels(torch, np, wt, dev)
    main_run = phase_main(torch, wt, st, dev)
    phase_compare(torch, wt, st, dev)

    kernels = [{"name": k, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": main_run["counts"][k],
                "max_abs_err": stats[k]["max_abs_err"], "ms": stats[k]["ms"],
                "plain_ms": stats[k]["plain_ms"]} for k in TOL]
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
