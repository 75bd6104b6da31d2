"""One run of one cell: set-up, the users' output loop for a window, the
comparison with the plain reference, the metrics.

Everything that belongs to one configuration, one cell or one metric is a
file found by its name (README.md): ``configs/<config>.json`` with its
builder ``configs/<config>.py`` and its plain reference
``configs/<config>_ref.py``, ``workloads/<traffic>.json`` and
``metrics/<metric>.py``.  `BENCHMARK.json` says which cell uses which
configuration and traffic and which metrics a cell reports.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "waterlily_tpu")
# the check's sampling, the same in every cell: the sampled steps a run,
# and the x rows of the perturbed start it keeps
CHECK_SAMPLES = 2
START_ROWS = 4


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The module in the file ``path``, imported under a name of its own."""
    name = "portbench_" + "_".join(path.relative_to(HERE).with_suffix("").parts)
    name = name.replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_entry(workload: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in {BENCHMARK.name}")


def cell_metrics(workload: str, bench: dict, key: str) -> list[dict]:
    """The metrics of ``key`` (``end_to_end`` or ``per_layer``) that the
    cell reports: those without a ``workloads`` list and those that list
    it."""
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


class Cell:
    """A cell's files: its configuration (data, builder, reference), its
    traffic and the readers of its metrics."""

    def __init__(self, workload: str, bench: dict | None = None,
                 traffic: dict | None = None):
        self.bench = load_json(BENCHMARK) if bench is None else bench
        entry = cell_entry(workload, self.bench)
        self.name, self.config = workload, load_json(HERE / "configs" / f"{entry['config']}.json")
        self.params = self.config["params"]
        self.traffic = (load_json(HERE / "workloads" / f"{entry['traffic']}.json")
                        if traffic is None else traffic)
        self.config_file = HERE / "configs" / f"{entry['config']}.py"
        self.reference_file = HERE / "configs" / f"{entry['config']}_ref.py"
        self.end_to_end = cell_metrics(workload, self.bench, "end_to_end")
        self.per_layer = cell_metrics(workload, self.bench, "per_layer")

    def builder(self):
        return load_module(self.config_file)

    def reference(self):
        return load_module(self.reference_file)

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py")


def plan(traffic: dict, seed: int):
    """The intervals of the window that the check samples and the first
    interval of the traced stretch: the same for every run of a seed."""
    rng = random.Random(seed)
    lo, hi = traffic["check_intervals"]
    checks = sorted(rng.sample(range(lo, hi), CHECK_SAMPLES))
    return checks, traffic["trace_from"], traffic["trace_intervals"]


class Clock:
    """The window's host clock, with the harness's own pauses (the copies
    kept for the check) taken out."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda, self.paused = torch, cuda, 0.0

    def pause(self, fn):
        """``fn()`` on a drained device, its seconds kept out of the
        window."""
        sync(self.torch, self.cuda)
        t0 = time.perf_counter()
        out = fn()
        self.paused += time.perf_counter() - t0
        return out


def host(t):
    return t.detach().to("cpu", copy=True)


def last_step(sim) -> tuple[float, float]:
    """The state time and Δt of the last step taken, as the program held
    them when the step began (`Flow.time`: the sum of the Δt history but
    its newest entry); a step that re-measures takes the body at their
    sum (`Simulation.measure`)."""
    dts = sim.flow.dt
    return float(sum(dts[:-2])), float(dts[-2])


def snapshot(sim) -> dict:
    st = sim.flow.state
    return dict(u=host(st.u), p=host(st.p), dt=float(sim.flow.dt[-1]),
                t=float(sim.time))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", after_build=None) -> dict:
    """Set-up, window, check and metrics of one run.  ``t_start`` is the
    process's start on the host clock; ``after_build(sim)`` lets a test
    break the program under a run.  Returns the result object."""
    rec, snap = drive(cell, seed, seconds, trace, t_start, device, after_build)
    t0 = time.perf_counter()
    nums, _ = judge(cell, snap, seed, device)
    rec["check_s"] = time.perf_counter() - t0
    limits = cell.traffic["limits"]
    correct = all(nums[k] <= limits[k] for k in limits)
    checks = {k: dict(value=nums[k] if math.isfinite(nums[k]) else None, limit=lim)
              for k, lim in limits.items()}
    return result(cell, rec, trace, correct, checks, device)


def judge(cell: Cell, snap: dict, seed: int, device: str, control: bool = False):
    """The compared numbers of a run (and of the control, with
    ``control``), once the program's state is freed."""
    from portbench.reference import compare
    return compare.check(cell.reference(), cell.params, cell.traffic["n"], snap,
                         seed % (1 << 63), cell.traffic["noise"], device, control)


def drive(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
          device: str = "cuda", after_build=None):
    """Set-up and window: returns the run's record for the metrics and what
    the check keeps of the program's state, the program's own state
    freed."""
    import torch

    cuda = device != "cpu"
    p, tr = cell.params, cell.traffic
    n, interval, noise = tr["n"], tr["interval"], tr["noise"]
    builder = cell.builder()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    seed64 = seed % (1 << 63)
    rng = random.Random(seed)
    checks, trace_from, trace_n = plan(tr, seed)
    # --- set-up
    t0 = time.perf_counter()
    sim = builder.build(p, n, device)
    sim_build_s = time.perf_counter() - t0
    sim.perturb(noise, seed64)
    rows = sorted(rng.sample(range(n + 2), START_ROWS))
    start_u = host(sim.flow.state.u[:, rows])
    if after_build is not None:
        after_build(sim)
    t_next = sim.sim_time + interval
    builder.advance(sim, t_next)
    out = builder.output(sim)
    t_next += interval
    sync(torch, cuda)
    setup_s = time.perf_counter() - t_start
    # --- window
    clock, walls, samples = Clock(torch, cuda), [], []
    steps0 = len(sim.flow.dt)
    trace_rec, prof = None, None
    want = max(checks + [trace_from + trace_n - 1]) + 1
    t_win = time.perf_counter()
    k = 0
    while True:
        t_i = time.perf_counter()
        p_i = clock.paused
        if trace and k == trace_from:
            prof, trace_rec = start_trace(torch, sim)
        if k in checks:
            # the interval's first step alone, its state before and after
            # kept on the host
            pre = clock.pause(lambda: snapshot(sim))
            builder.advance(sim, sim.sim_time + 1e-9 * interval)
            post = clock.pause(lambda: snapshot(sim))
            samples.append(dict(u0=pre["u"], p0=pre["p"], dt0=pre["dt"], t0=pre["t"],
                                out0=out,
                                u1=post["u"], p1=post["p"], dt1=post["dt"],
                                iters=list(sim.pois_n[-2:])))
        with span(prof, "portbench.steps"):
            builder.advance(sim, t_next)
        t_o = time.perf_counter()
        with span(prof, "portbench.output"):
            out = builder.output(sim)
        t_e = time.perf_counter()
        if prof is not None:
            trace_rec["output_s"] += t_e - t_o
        walls.append(t_e - t_i - (clock.paused - p_i))
        t_next += interval
        k += 1
        if prof is not None and k == trace_from + trace_n:
            stop_trace(torch, sim, prof, trace_rec)
            prof = None
        if t_e - t_win - clock.paused >= seconds and k >= want:
            break
    window_s = t_e - t_win - clock.paused
    steps = len(sim.flow.dt) - steps0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = dict(cells=n ** 3, shape=tuple(sim.flow.cfg.shape), steps=steps,
               window_s=window_s, interval_ms=[w * 1e3 for w in walls],
               peak_bytes=peak, setup_s=setup_s, sim_build_s=sim_build_s,
               trace=trace_rec)
    # the moments the window's last step left, and the (t0, Δt) of that step
    snap = dict(start_rows=rows, start_u=start_u, samples=samples,
                moments=tuple(host(t) for t in (sim.flow.state.V, sim.flow.state.mu0,
                                                sim.flow.state.mu1)),
                moments_at=last_step(sim))
    del sim, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rec, snap


def forbidden_modules() -> list[str]:
    """The names of `FORBIDDEN` among the top-level names of the loaded
    modules, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def span(prof, name: str):
    """A host span the trace's idle gaps are labelled by, while profiling."""
    import contextlib

    from torch.profiler import record_function
    return record_function(name) if prof is not None else contextlib.nullcontext()


def sync(torch, cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def start_trace(torch, sim):
    """Open the profiler on an interval boundary (the device idle after the
    output's host read) and note what the stretch's counters start from."""
    from torch.profiler import ProfilerActivity, profile

    from waterlily_tpu_torch.ops import stencil3d
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    rec = dict(launches0=stencil3d.launch_counts(), steps0=len(sim.flow.dt),
               pois0=len(sim.pois_n), output_s=0.0, t0=time.perf_counter())
    return prof, rec


def stop_trace(torch, sim, prof, rec) -> None:
    from waterlily_tpu_torch.ops import stencil3d

    from portbench import trace as tr
    rec["wall_s"] = time.perf_counter() - rec.pop("t0")
    prof.stop()
    after = stencil3d.launch_counts()
    rec["launches"] = {k: v - rec["launches0"].get(k, 0) for k, v in after.items()}
    rec["steps"] = len(sim.flow.dt) - rec.pop("steps0")
    rec["pois_n"] = list(sim.pois_n[rec.pop("pois0"):])
    rec["band_x"] = sim.flow.cfg.band_x
    rec.update(tr.reduce(tr.raw_events(torch, prof)))
    del rec["launches0"]


def result(cell: Cell, rec: dict, trace: bool, correct: bool, checks: dict,
           device: str) -> dict:
    import torch

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    cuda = device != "cpu"
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=1, memory_peak_bytes=rec["peak_bytes"])
    out = dict(correct=correct, attempted=len(rec["interval_ms"]),
               failed=0 if correct else 1, metrics=metrics, device=dev)
    if trace and rec["trace"] is not None:
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["wall_s"]
        out["breakdown"] = dict(device_ops=t["top_ops"], idle_gaps=t["idle_gaps"])
    out["checks"] = checks
    out["run"] = {k: rec[k] for k in ("steps", "window_s", "setup_s", "sim_build_s",
                                      "check_s")}
    out["run"]["intervals"] = len(rec["interval_ms"])
    out["checks"] = out.pop("checks")
    return out
