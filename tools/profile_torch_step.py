#!/usr/bin/env python3
"""Where the time of one step of the PyTorch + CUDA port goes, on one GPU.

    PYTHONPATH=. python3 tools/profile_torch_step.py [config ...]

``config`` is ``engine:case`` with ``engine`` in ``flat``/``3d`` and ``case``
one of ``sphere`` (the 256³ static sphere of ``bench.py``), ``tgv``
(``examples/tgv3d.py`` at 256³), ``drag`` (``examples/sphere_drag.py`` at
N = 128), ``les`` (``examples/les_sharded.py``'s sphere at 256³ with the
Smagorinsky udf), ``ramp`` (the 256³ sphere with a callable ``ubc`` and
``g``) and ``sphere-mp``/``sphere-s2`` (the 256³ sphere with ``smooth_it=2``
with and without bf16 smoothing); the default runs the first three on both
engines.  Each is built with ``Simulation`` as
``chip_smoke.py`` builds it, stepped ``WARM`` times, then ``STEPS`` steps
run unprofiled (CUDA events around each ``sim_step``, ``synchronize``
after) and ``STEPS`` more under ``torch.profiler``.  Printed per config:
wall ms/step unprofiled, device busy ms/step (the union of the kernel
intervals of the profiled window), the idle share against the profiled
wall, device operations per step, and the ten kernels with the most device
time.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import statistics
import sys
import time

WARM, STEPS = 12, 3


def busy_ms(events) -> float:
    """Length of the union of the device intervals (µs → ms)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as cs
    import waterlily_tpu_torch as wt

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    configs = argv or [f"{e}:{c}" for c in ("sphere", "tgv", "drag")
                       for e in ("flat", "3d")]
    for cfg in configs:
        engine, case = cfg.split(":")
        sim, udf = cs.make_sim(torch, wt, case, 128 if case == "drag" else 256,
                               dev, engine=engine)
        for _ in range(WARM):
            sim.sim_step(remeasure=False, udf=udf)
        torch.cuda.synchronize()
        walls = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            sim.sim_step(remeasure=False, udf=udf)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        n0 = len(sim.pois_n)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEPS):
                sim.sim_step(remeasure=False, udf=udf)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = busy_ms(dev_events) / STEPS
        per_name: dict[str, float] = {}
        for e in dev_events:
            per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
        print(f"{cfg}: wall ms/step unprofiled {statistics.mean(walls):.3f} "
              f"{[round(w, 3) for w in walls]}; profiled wall "
              f"{prof_wall / STEPS:.3f}; device busy {busy:.3f} ms/step; idle "
              f"share {1 - busy / (prof_wall / STEPS):.3f}; device ops/step "
              f"{len(dev_events) / STEPS:.1f}; pois_n {sim.pois_n[n0:]}", flush=True)
        for name, ms in top:
            print(f"    {ms / STEPS:8.3f} ms/step  {name[:100]}", flush=True)
        del sim, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
