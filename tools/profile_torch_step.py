#!/usr/bin/env python3
"""Where the time of one step of the PyTorch + CUDA port goes, on one GPU.

    PYTHONPATH=. python3 tools/profile_torch_step.py [config ...]

``config`` is ``engine:case`` with ``engine`` in ``flat``/``3d`` and ``case``
one of ``sphere`` (the 256³ static sphere of ``bench.py``), ``tgv``
(``examples/tgv3d.py`` at 256³), ``drag`` (``examples/sphere_drag.py`` at
N = 128), ``les`` (``examples/les_sharded.py``'s sphere at 256³ with the
Smagorinsky udf), ``ramp`` (the 256³ sphere with a callable ``ubc`` and
``g``) and ``sphere-mp``/``sphere-s2`` (the 256³ sphere with ``smooth_it=2``
with and without bf16 smoothing) and ``moving`` (``bench.py``'s oscillating
sphere at 128³, each step re-measured: ``sim_step(remeasure=True)``),
``pcg`` (the 256³ sphere with ``psolver="pcg"``, 3d engine only) and
``circle`` (``examples/circle.py`` at R = 64, 1,536×1,024, float32, 3d
engine only: 2-D) and ``ad`` (the 256³ sphere, 3d engine only: one
`mom_step_impl` from the settled state, dt and t as 0-d tensors, profiled
as it is and under `torch.func.jvp` in ν, so the primal and the
forward-mode step read apart) and ``dist`` (the 256³ sphere decomposed over
four shards of the card, `DistSimulation`: (4,) on the flat engine, (2, 2)
on the 3d engine; the note gives the collectives and halo bytes a step);
the default runs the first three on both engines.  Each is built with
``Simulation`` as ``chip_smoke.py`` builds it, stepped ``WARM`` times, then
``STEPS`` steps run unprofiled (host clock around each ``sim_step`` up to a
``synchronize``) and ``STEPS`` more under ``torch.profiler``.  Printed per
config: wall ms/step unprofiled, device busy ms/step (the union of the
kernel intervals of the profiled window), the idle share against the
profiled wall, device operations per step, and the ten kernels with the
most device time.  For ``moving`` the same is printed first for ``STEPS``
calls of the re-measure alone (``sim.measure()``, what each step runs
before its momentum step), so the measure and the step read apart.  Needs a
CUDA device; imports no JAX.

    PYTHONPATH=. python3 tools/profile_torch_step.py --against ROOT [config ...]

builds each config twice, with this checkout's package and with the package
of the checkout at ``ROOT`` (imported under another name by
`tools/bandwidth_probe.py`'s ``load_checkout``), steps both ``WARM`` times
and then times ``STEPS`` unprofiled steps of each in turns, ``ROUNDS``
rounds with the order swapped every round: both walls of every round, their
medians and the median of the paired differences (this − other).  No
profile is taken in this mode.  ``moving`` steps re-measured in both (a
checkout without the box measure re-measures densely); ``ad`` times each
checkout's jvp step (`torch.func.jvp` of one `mom_step_impl` in ν from its
settled sphere).
"""
from __future__ import annotations

import importlib
import statistics
import sys
import time
from pathlib import Path

WARM, STEPS, ROUNDS = 12, 3, 10


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


def size(case: str) -> int:
    """The grid of a case: the drag sphere at N = 128, the moving rung at
    128³, the circle at radius 64, the rest at 256³."""
    return {"drag": 128, "moving": 128, "circle": 64}.get(case, 256)


def walls_ms(torch, fn) -> list[float]:
    """The walls of ``STEPS`` calls of ``fn``, each timed on the host clock
    up to a ``synchronize``."""
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


# the mesh of the ``dist`` case on each engine: four shards of the card
DIST_MESHES = {"flat": (4,), "3d": (2, 2)}


def stepper(sim, udf, case: str):
    """One step of a case: re-measured for ``moving``."""
    return lambda: sim.sim_step(remeasure=case == "moving", udf=udf)


def dist_case(torch, wt, sim, engine: str, dev):
    """The ``dist`` case: ``sim`` decomposed over `DIST_MESHES` on the card,
    its step and a note of the collectives and halo bytes a step since the
    last note."""
    shape = DIST_MESHES[engine]
    d = wt.DistSimulation(sim, wt.make_mesh(shape, [dev] * 4),
                          engine=engine)

    def note():
        c = d.comm
        steps = max(1, len(d.pois_n) // 2 - note.done)
        out = (f"mesh {shape}, collectives a step {sum(c.counts.values()) / steps:.1f} "
               f"{c.counts}, halo MiB a step {c.halo_bytes / steps / 2**20:.2f}, "
               f"pois_n {d.pois_n[-2 * STEPS:]}")
        note.done = len(d.pois_n) // 2
        c.reset_counts()
        return out
    note.done = 0
    return d, (lambda: d.step_once(remeasure=False)), note


def ad_steps(torch, sim, fl=None):
    """One `mom_step_impl` (of the flow module ``fl``, this checkout's by
    default) from the state of ``sim`` (dt and t as 0-d tensors, the
    differentiable runner's form) as it is and under `torch.func.jvp` in ν:
    two thunks."""
    import dataclasses

    if fl is None:
        from waterlily_tpu_torch.models import flow as fl

    cfg, state = sim.flow.cfg, sim.flow.state
    dt = torch.tensor(sim.flow.dt[-1], dtype=cfg.dtype, device=state.u.device)
    t = torch.tensor(sim.time, dtype=cfg.dtype, device=state.u.device)

    def step(nu):
        s, dt_next, _, _ = fl.mom_step_impl(cfg, dataclasses.replace(state, nu=nu),
                                            sim.levels, sim.masks, dt, t)
        return s.u, s.p, dt_next

    nu, one = state.nu, torch.ones_like(state.nu)
    return (lambda: step(nu)), (lambda: torch.func.jvp(step, (nu,), (one,)))


def profiled(torch, label: str, fn, note) -> None:
    """``STEPS`` unprofiled calls of ``fn``, then ``STEPS`` under the
    profiler, and the line and top-ten kernels of the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    walls = walls_ms(torch, fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(dev_events) / STEPS
    per_name: dict[str, float] = {}
    for e in dev_events:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"{label}: wall ms/step unprofiled {statistics.mean(walls):.3f} "
          f"{[round(w, 3) for w in walls]}; profiled wall "
          f"{prof_wall / STEPS:.3f}; device busy {busy:.3f} ms/step; idle "
          f"share {1 - busy / (prof_wall / STEPS):.3f}; device ops/step "
          f"{len(dev_events) / STEPS:.1f}; {note()}", flush=True)
    for name, ms in top:
        print(f"    {ms / STEPS:8.3f} ms/step  {name[:100]}", flush=True)
    del prof


def against(torch, cs, pkgs: dict, configs, dev) -> None:
    """Each config built with each package of ``pkgs`` (label -> package)
    and stepped in turns (module docstring)."""
    for cfg in configs:
        engine, case = cfg.split(":")
        sims = {label: cs.make_sim(torch, wt, "sphere" if case == "ad" else case,
                                   size(case), dev, engine=engine)
                for label, wt in pkgs.items()}
        steps = {label: stepper(sim, udf, case) for label, (sim, udf) in sims.items()}
        for step in steps.values():
            for _ in range(WARM):
                step()
        if case == "ad":
            steps = {label: ad_steps(torch, sims[label][0], importlib.import_module(
                f"{wt.__name__}.models.flow"))[1] for label, wt in pkgs.items()}
        torch.cuda.synchronize()
        labels, walls = list(pkgs), {label: [] for label in pkgs}
        for i in range(ROUNDS):
            for label in labels if i % 2 == 0 else labels[::-1]:
                walls[label].append(statistics.mean(walls_ms(torch, steps[label])))
        a, b = labels
        diff = statistics.median(x - y for x, y in zip(walls[a], walls[b]))
        print(f"{cfg}: wall ms/step in turns, " + "; ".join(
            f"{label} {statistics.median(w):.3f} {[round(t, 3) for t in w]}"
            for label, w in walls.items())
            + f"; median of {a} − {b} {diff:.3f}; pois_n equal "
            f"{list(sims[a][0].pois_n) == list(sims[b][0].pois_n)}", flush=True)
        del sims
        torch.cuda.empty_cache()


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ".")
    import chip_smoke as cs
    import waterlily_tpu_torch as wt

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    other = None
    if argv[:1] == ["--against"]:
        other, argv = argv[1], argv[2:]
    configs = argv or [f"{e}:{c}" for c in ("sphere", "tgv", "drag")
                       for e in ("flat", "3d")]
    if other is not None:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
        from bandwidth_probe import load_checkout
        against(torch, cs, {"this": wt, "other": load_checkout(other)}, configs, dev)
        return 0
    for cfg in configs:
        engine, case = cfg.split(":")
        sim, udf = cs.make_sim(torch, wt, "sphere" if case in ("ad", "dist") else case,
                               size(case), dev, engine=engine)
        step = stepper(sim, udf, case)
        if case == "dist":
            sim, step, dist_note = dist_case(torch, wt, sim, engine, dev)
        for _ in range(WARM):
            step()
        torch.cuda.synchronize()
        if case == "dist":
            dist_note()
            profiled(torch, cfg, step, dist_note)
            sim.close()
            del sim
            torch.cuda.empty_cache()
            continue
        if case == "ad":
            primal, jvp = ad_steps(torch, sim)
            profiled(torch, f"{cfg} primal step", primal, lambda: "one mom_step_impl")
            profiled(torch, f"{cfg} jvp step", jvp, lambda: "torch.func.jvp in nu")
            del sim
            torch.cuda.empty_cache()
            continue
        if case == "moving":
            profiled(torch, f"{cfg} measure alone", sim.measure,
                     lambda: f"box {sim.flow.cfg.band_box}")
        profiled(torch, cfg, step, lambda: f"pois_n {sim.pois_n[-2 * STEPS:]}")
        del sim
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
