#!/usr/bin/env python3
"""Host cost of a launch through this package's kernel binding, on one
NVIDIA GPU.

    PYTHONPATH=. python3 tools/launch_cost.py [--json PATH] [--save PATH]

For every wrapper of `ops/stencil3d.py`, `ops/fused3d.py` and `ops/probe.py`
(on an 18³ multigrid level; the copy probes on 8³ fields, written into
given outputs as `tools/bandwidth_probe.py`'s tiny chain does), and for
``torch.mul(a, c, out=b)`` on the same tensors: ``CALLS`` calls back to back,
then one ``torch.cuda.synchronize()``, the median over ``RUNS`` runs of

* ``host_us``: the host time per call, synchronise included (the figure a
  chain of small launches pays; where the card is slower than the host it
  is the device time);
* ``enqueue_us``: the host time per call of the ``CALLS`` calls alone;
* ``device_us``: the time per call between two CUDA events around them.

Then the pieces of a launch, each timed alone on this host: the two reads of
PyTorch's current stream (``torch.cuda.current_stream(dev).cuda_stream`` and
``torch._C._cuda_getCurrentRawStream(index)``), ``torch.empty_like`` of a
level field, the checkout's validation of two fields (``_check`` where the
checkout has it, ``_fits`` where it has that), the route query through
ctypes and through the checkout's cache (where it has one), the test of
the forward-mode AD flag that every wrapper makes (where it has one), one
launch of K16 straight through ctypes with ``c_void_p`` pointers and with
``int`` pointers, and, where the library has the entry, the copy launched
``CALLS`` times from a C loop (``wlt_copy_scale_loop``): the host floor of a
launch.

The package is imported from the working directory, so run from the root of
another checkout (with this file's path) it times that checkout's binding:
a change and its parent are compared in turns on one card.

    PYTHONPATH=. python3 tools/launch_cost.py --against ROOT

times every wrapper row of this checkout and of the checkout at ``ROOT``
(its package imported under another name, as `tools/bandwidth_probe.py`'s
``load_checkout`` does) in one process, in turns, ``ROUNDS`` rounds with
the order swapped every round: each row's median ``host_us`` on each side
and the median of the paired differences (this − other), and the same for
``enqueue_us`` (the host's own cost where the card is the slower side).
Separate processes move these figures by 20–40 %; turns in one process do
not.  ``--save PATH``
also writes each wrapper's outputs on these inputs (`torch.save`, on the
CPU), so that two checkouts' outputs can be compared bit for bit.  Prints the card's
name and power limit, one line per row and a JSON object of the rows; needs a
CUDA device and imports no JAX.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import time

LEVEL, TINY = (18, 18, 18), (8, 8, 8)
CALLS, RUNS = 20, 7
ROUNDS = 10
UBC = (1.0, 0.25, -0.5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def chain_times(torch, fn) -> dict:
    """``host_us``, ``enqueue_us`` and ``device_us`` per call of ``fn``
    (module docstring), medians over `RUNS` runs of `CALLS` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    host, enq, devt = [], [], []
    for _ in range(RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        b.record()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enq.append((t1 - t0) / CALLS * 1e6)
        host.append((t2 - t0) / CALLS * 1e6)
        devt.append(a.elapsed_time(b) / CALLS * 1e3)
    return dict(host_us=statistics.median(host), enqueue_us=statistics.median(enq),
                device_us=statistics.median(devt))


def piece_us(fn, calls: int = 2000) -> float:
    """Host µs per call of ``fn``, a host-only piece: the least of five runs
    of ``calls`` calls."""
    fn()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def wrapper_cases(torch, np, st, fz, ps, probe, dev):
    """The cases, each (name, wrapper thunk, the ``torch.mul`` thunk it is
    held against), and the tensors `pieces` and `c_loop_us` use."""
    from waterlily_tpu_torch.ops.bc import bc_vector, per_bc

    rng = np.random.default_rng(0)
    f32 = torch.float32

    def g(*s, shape=LEVEL):
        return torch.as_tensor(rng.standard_normal(s + shape), dtype=f32, device=dev)

    u, u0, f, V = g(3), g(3), g(3), 0.1 * g(3)
    mu0, mu1 = g(3).abs(), 0.3 * g(3, 3)
    L_raw = torch.as_tensor(0.2 + rng.random((3,) + LEVEL), dtype=f32, device=dev)
    lev = ps.make_level(bc_vector(L_raw, (0.0,) * 3))
    bf = ps.with_bf16(lev).bf
    Lp = bc_vector(L_raw, (0.0,) * 3, perdir=(0, 1, 2))
    iDp = ps.make_level(Lp).iD
    x = g()
    r = torch.zeros_like(x)
    r[1:-1, 1:-1, 1:-1] = g()[1:-1, 1:-1, 1:-1]
    eps = 0.3 * r.roll(1, 0)
    eps_p = per_bc(eps, (0, 1, 2))
    nu = torch.tensor(0.03, dtype=f32, device=dev)
    band = (LEVEL[0] // 3, 2 * LEVEL[0] // 3)
    a8, b8 = [g(shape=TINY)], [g(shape=TINY)]
    a6, b6 = [g(shape=TINY) for _ in range(6)], [g(shape=TINY) for _ in range(6)]
    out = torch.empty_like(x)

    def mul_level():
        torch.mul(x, 1.0000001, out=out)

    def mul_tiny():
        torch.mul(a8[0], 1.0000001, out=b8[0])

    cases = [
        ("conv_diff_k", lambda: st.conv_diff_k(u, nu, 0), mul_level),
        ("conv_diff_bdim_k", lambda: fz.conv_diff_bdim_k(u, u0, nu, 0.3, 1.0, 0.5, 0,
                                                         band), mul_level),
        ("bdim_k", lambda: st.bdim_k(u, u0, f, V, mu0, mu1, 0.3), mul_level),
        ("bdim_band_k", lambda: st.bdim_band_k(u, u0, f, V, mu0, mu1, 0.3, band),
         mul_level),
        ("mult_k", lambda: st.mult_k(x, lev.L, lev.D), mul_level),
        ("gs_incr_k jacobi", lambda: st.gs_incr_k(x, r, lev.L, lev.D, lev.iD, [], 0.9),
         mul_level),
        ("gs_incr_k 2 colours", lambda: st.gs_incr_k(x, r, lev.L, lev.D, lev.iD,
                                                     [1, 0], 0.9), mul_level),
        ("gs_incr_k 4 colours", lambda: st.gs_incr_k(x, r, lev.L, lev.D, lev.iD,
                                                     [0, 1, 0, 1], 0.9), mul_level),
        ("gs_incr_k mp 2 colours", lambda: st.gs_incr_k(x, r, *bf, [1, 0], 0.9, True),
         mul_level),
        ("gs_incr_k mp 4 colours", lambda: st.gs_incr_k(x, r, *bf, [0, 1, 0, 1], 0.9,
                                                        True), mul_level),
        ("incr_gs_k 4 colours", lambda: fz.incr_gs_k(x, r, eps, lev.L, lev.D, lev.iD,
                                                     [0, 1, 0, 1], 0.9), mul_level),
        ("incr_gs_k 4 colours norms", lambda: fz.incr_gs_k(
            x, r, eps, lev.L, lev.D, lev.iD, [0, 1, 0, 1], 0.9, True), mul_level),
        ("incr_gs_k K6 norms", lambda: fz.incr_gs_k(
            x, r, eps, lev.L, lev.D, lev.iD, [], 0.9, True), mul_level),
        ("incr_gs_k mp 4 colours", lambda: fz.incr_gs_k(
            x, r, eps, *bf, [0, 1, 0, 1], 0.9, False, True), mul_level),
        ("incr_gs_k mp 4 colours norms", lambda: fz.incr_gs_k(
            x, r, eps, *bf, [0, 1, 0, 1], 0.9, True, True), mul_level),
        ("gauss_sweeps_k 4 colours xyz", lambda: st.gauss_sweeps_k(
            eps_p, r, Lp, iDp, [0, 1, 0, 1], (0, 1, 2)), mul_level),
        ("bc_div_k", lambda: fz.bc_div_k(u, UBC), mul_level),
        ("projbc_k cfl", lambda: fz.projbc_k(u, x, lev.L, UBC, True), mul_level),
        ("bc_k", lambda: fz.bc_k(u, UBC), mul_level),
        ("div_k", lambda: fz.div_k(u), mul_level),
        ("copy_scale_k", lambda: probe.copy_scale_k(a8, 256, out=b8), mul_tiny),
        ("copy_scale6_k", lambda: probe.copy_scale_k(a6, 256, out=b6),
         lambda: [torch.mul(p, 1.0000001, out=q) for p, q in zip(a6, b6)]),
    ]
    if hasattr(st, "conv_diff_jvp_k"):     # K12's tangent (absent in older checkouts)
        cases.insert(1, ("conv_diff_jvp_k", lambda: st.conv_diff_jvp_k(u, u0, nu, nu, 0),
                         mul_level))
    return cases, dict(x=x, r=r, lev=lev, a8=a8, b8=b8, band=band)


def pieces(torch, st, lib, dev, t) -> dict:
    """The host cost of each piece of a launch in this checkout (µs)."""
    x, r, lev = t["x"], t["r"], t["lev"]
    shape, idx = tuple(x.shape), x.get_device()
    out = torch.empty_like(x)
    p = {"stream: torch.cuda.current_stream(dev).cuda_stream":
         piece_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
         "stream: torch._C._cuda_getCurrentRawStream(index)":
         piece_us(lambda: torch._C._cuda_getCurrentRawStream(idx)),
         "torch.empty_like(level field)": piece_us(lambda: torch.empty_like(x)),
         "route query through ctypes": piece_us(
             lambda: lib.wlt_gs_incr_route(*shape, 4, 0))}
    if hasattr(st, "_check"):
        p["_check of x and r"] = piece_us(
            lambda: st._check("gs_incr_k", shape, x.device, x=x, r=r))
    if hasattr(st, "_fits"):
        p["_fits of x and r"] = piece_us(
            lambda: st._fits(x.device, torch.float32, x.shape, x, r))
    if hasattr(st, "_rule"):
        p["route from the cache"] = piece_us(
            lambda: st._rule("wlt_gs_incr_route", *shape, 4, 0))
    if hasattr(st, "_no_tangent"):
        # what every wrapper adds for forward-mode AD when none is active:
        # the test of the flag, written out as the wrappers write it
        peek, fwad = st._peek, st._fwad
        p["AD flag test (no transform, no forward-AD level)"] = piece_us(
            lambda: peek() is not None or fwad._current_level >= 0)
    s = torch.cuda.current_stream(dev).cuda_stream
    vp = ctypes.c_void_p
    p["K16 launch, ctypes, c_void_p pointers"] = chain_times(torch, lambda: lib.wlt_mult(
        vp(x.data_ptr()), vp(lev.L.data_ptr()), vp(lev.D.data_ptr()),
        vp(out.data_ptr()), *shape, vp(s)))["enqueue_us"]
    p["K16 launch, ctypes, int pointers"] = chain_times(torch, lambda: lib.wlt_mult(
        x.data_ptr(), lev.L.data_ptr(), lev.D.data_ptr(), out.data_ptr(), *shape,
        s))["enqueue_us"]
    # the C side of a call that launches six kernels (K15, 4 colours, the
    # per-colour route: eps init, four sweeps, the increment)
    cols = (ctypes.c_int * 4)(0, 1, 0, 1)
    e, x2, r2 = (torch.empty_like(x) for _ in range(3))
    p["K15 per-colour, 4 colours (6 launches), ctypes, int pointers"] = chain_times(
        torch, lambda: lib.wlt_gs_incr(
            x.data_ptr(), r.data_ptr(), lev.L.data_ptr(), lev.D.data_ptr(),
            lev.iD.data_ptr(), e.data_ptr(), x2.data_ptr(), r2.data_ptr(), cols, 4,
            0.9, 0, *shape, s))["enqueue_us"]
    return p


def c_loop_us(torch, lib, t):
    """Host µs per launch of the tiny copy launched `CALLS` times from a C
    loop, synchronise included; None where the library has no such entry."""
    if not hasattr(lib, "wlt_copy_scale_loop"):
        return None
    a, b = t["a8"][0], t["b8"][0]
    s = torch.cuda.current_stream(a.device).cuda_stream

    def loop():
        err = lib.wlt_copy_scale_loop(a.data_ptr(), b.data_ptr(), a.numel(), 256,
                                      CALLS, s)
        if err:
            raise RuntimeError(f"wlt_copy_scale_loop failed with error {err}")
    loop()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / CALLS * 1e6)
    return statistics.median(times)


def run(device="cuda", save=None) -> dict:
    """Every row (module docstring), measured on ``device``; ``save``: a
    path for the wrappers' outputs."""
    import numpy as np
    import torch

    from waterlily_tpu_torch.ops import _build
    from waterlily_tpu_torch.ops import fused3d as fz
    from waterlily_tpu_torch.ops import poisson as ps
    from waterlily_tpu_torch.ops import probe
    from waterlily_tpu_torch.ops import stencil3d as st

    if not torch.cuda.is_available():
        raise RuntimeError("launch_cost: needs a CUDA device")
    dev = torch.device(device)
    lib = _build.load()
    cases, t = wrapper_cases(torch, np, st, fz, ps, probe, dev)
    band = t["band"]
    rows = []
    for name, kern, mul in cases:
        k, m = chain_times(torch, kern), chain_times(torch, mul)
        rows.append(dict(name=name, **k, mul_host_us=m["host_us"],
                         mul_enqueue_us=m["enqueue_us"], mul_device_us=m["device_us"]))
    if save is not None:
        outs = {}
        for name, kern, _ in cases:
            got = kern()
            got = got if isinstance(got, (tuple, list)) else (got,)
            # K1's f is defined on its slab rows alone
            outs[name] = [t[:, band[0]:band[1]] if (name, k) == ("conv_diff_bdim_k", 1)
                          else t for k, t in enumerate(got)]
            outs[name] = [t.cpu() for t in outs[name]]
        torch.save(outs, save)
    return dict(rows=rows, pieces=pieces(torch, st, lib, dev, t),
                c_loop_us=c_loop_us(torch, lib, t))


def against(torch, np, root: str, dev) -> list[dict]:
    """Every wrapper row of this checkout and of the one at ``root``, timed
    in turns in one process (module docstring)."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from bandwidth_probe import load_checkout

    kernels = {}
    for label, pkg in (("this", "waterlily_tpu_torch"),
                       ("other", load_checkout(root).__name__)):
        mods = [importlib.import_module(f"{pkg}.ops.{m}")
                for m in ("stencil3d", "fused3d", "poisson", "probe")]
        mods[0]._lib()
        cases, _ = wrapper_cases(torch, np, *mods, dev)
        kernels[label] = {name: kern for name, kern, _ in cases}
    names = [n for n in kernels["this"] if n in kernels["other"]]
    times = {n: {k: [] for k in ("this", "other", "this_enq", "other_enq")}
             for n in names}
    for i in range(ROUNDS):
        for label in ("this", "other") if i % 2 == 0 else ("other", "this"):
            for n in names:
                got = chain_times(torch, kernels[label][n])
                times[n][label].append(got["host_us"])
                times[n][label + "_enq"].append(got["enqueue_us"])

    def paired(a, b):
        return statistics.median(x - y for x, y in zip(a, b))
    return [dict(name=n, this_us=statistics.median(t["this"]),
                 other_us=statistics.median(t["other"]),
                 diff_us=paired(t["this"], t["other"]),
                 enqueue_diff_us=paired(t["this_enq"], t["other_enq"]),
                 this_runs=t["this"], other_runs=t["other"],
                 this_enqueue_runs=t["this_enq"], other_enqueue_runs=t["other_enq"])
            for n, t in times.items()]


def report(res: dict) -> None:
    for r in res["rows"]:
        print(f"launch {r['name']:30s} host {r['host_us']:7.2f} us/call (enqueue "
              f"{r['enqueue_us']:6.2f}, device {r['device_us']:7.2f}); torch.mul "
              f"{r['mul_host_us']:6.2f} ({r['mul_enqueue_us']:6.2f}, "
              f"{r['mul_device_us']:6.2f}); x{r['host_us'] / r['mul_host_us']:.2f}",
              flush=True)
    for k, v in res["pieces"].items():
        print(f"launch piece {k:50s} {v:7.3f} us", flush=True)
    c = res["c_loop_us"]
    print("launch floor: the tiny copy from a C loop "
          + ("not in this library" if c is None else f"{c:.3f} us/launch"), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("launch_cost: needs a CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    if argv[:1] == ["--against"]:
        import numpy as np

        rows = against(torch, np, argv[1], torch.device("cuda"))
        for r in rows:
            print(f"launch {r['name']:30s} host us/call this {r['this_us']:7.2f}, "
                  f"other {r['other_us']:7.2f}; median of this - other "
                  f"{r['diff_us']:+6.2f}; enqueue alone {r['enqueue_diff_us']:+6.2f}",
                  flush=True)
        print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                          "against": argv[1], "rows": rows}))
        return 0
    res = run(save=argv[argv.index("--save") + 1] if "--save" in argv else None)
    report(res)
    line = json.dumps({"device": torch.cuda.get_device_name(0), "card": card, **res})
    if "--json" in argv:
        with open(argv[argv.index("--json") + 1], "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
