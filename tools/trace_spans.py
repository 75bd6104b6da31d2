"""The program's spans (`waterlily_tpu_torch.tracing`) on a benchmark cell
at its own size, on the card.

    PYTHONPATH=. python3 tools/trace_spans.py idle <cell> [--seed N] [--chrome PATH]

One traced stretch of the cell (its traffic file's ``trace_from`` and
``trace_intervals``, the users' loop of `portbench/configs/`) under
`torch.profiler`: the device's idle gaps (between the union's intervals of
the device operations, as `portbench/trace.py` takes them) summed by the
innermost ``wlt.*`` span open on the host at each gap's middle (a read by
its ``what``; "outside" where none is), the host's synchronise calls (count,
seconds) by the span they start in, the spans' total and self seconds and
the counters.  ``--chrome`` also writes the spans (`write_chrome`).

    PYTHONPATH=. python3 tools/trace_spans.py cost <cell> [--rounds N] [--intervals K]

What recording costs: K output intervals at a time (default the cell's
``trace_intervals``) with `tracing()` off and on in turns (off, on, on,
off, ...) in one process, and the cell updates per second of each; the
median of the paired ratios on/off.  Both print one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def setup(name: str, seed: int):
    """The cell's simulation on the card, perturbed and one interval on."""
    import torch

    from portbench import harness
    cell = harness.Cell(name)
    tr, builder = cell.traffic, cell.builder()
    sim = builder.build(cell.params, tr["n"], "cuda")
    sim.perturb(tr["noise"], seed)
    t_next = sim.sim_time + tr["interval"]
    builder.advance(sim, t_next)
    builder.output(sim)
    torch.cuda.synchronize()
    return cell, builder, sim, t_next + tr["interval"]


def intervals(builder, sim, t_next: float, k: int, interval: float) -> float:
    """``k`` output intervals of the users' loop; returns the next target."""
    for _ in range(k):
        builder.advance(sim, t_next)
        builder.output(sim)
        t_next += interval
    return t_next


def label(span) -> str:
    what = span.attrs.get("what")
    return f"{span.name}[{what}]" if what else span.name


def idle(args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import trace
    from waterlily_tpu_torch import tracing
    cell, builder, sim, t_next = setup(args.cell, args.seed)
    tr = cell.traffic
    t_next = intervals(builder, sim, t_next, tr["trace_from"] - 1, tr["interval"])
    steps0 = len(sim.flow.dt)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    t0 = time.perf_counter()
    intervals(builder, sim, t_next, tr["trace_intervals"], tr["interval"])
    wall = time.perf_counter() - t0
    prof.stop()
    s = tracing.session()
    events = trace.raw_events(torch, prof)
    dev = trace.union((a, b) for _, on, a, b in events if on)
    spans = sorted((x.start / 1e3, x.end / 1e3, label(x)) for x in s.spans
                   if x.end is not None)
    starts = [x[0] for x in spans]
    gaps: dict[str, float] = {}
    for (_, a), (b, _) in zip(dev, dev[1:]):
        inner = trace._innermost(starts, spans, (a + b) / 2) or "outside"
        gaps[inner] = gaps.get(inner, 0.0) + (b - a) / 1e6
    # where the host blocks on the device: the runtime's synchronise calls
    syncs: dict[str, list] = {}
    for name, on, a, b in events:
        if not on and "Synchronize" in name:
            inner = trace._innermost(starts, spans, a) or "outside"
            c = syncs.setdefault(inner, [0, 0.0])
            c[0], c[1] = c[0] + 1, c[1] + (b - a) / 1e6
    if args.chrome:
        tracing.write_chrome(args.chrome)
    names = sorted({x.name for x in s.spans})
    return dict(cell=cell.name, device=torch.cuda.get_device_name(),
                steps=len(sim.flow.dt) - steps0, wall_s=wall,
                busy_s=sum(b - a for a, b in dev) / 1e6,
                idle_between_s=sum(gaps.values()),
                idle_by_span=dict(sorted(gaps.items(), key=lambda kv: -kv[1])),
                syncs_by_span=syncs,
                span_seconds={n: s.seconds(n) for n in names},
                span_count={n: len(s.named(n)) for n in names},
                counters=s.counters, dropped=s.dropped)


def cost(args) -> dict:
    import contextlib

    import torch

    from waterlily_tpu_torch import tracing
    cell, builder, sim, t_next = setup(args.cell, args.seed)
    tr = cell.traffic
    k = args.intervals or tr["trace_intervals"]
    rates: dict[str, list[float]] = {"off": [], "on": []}
    for r in range(args.rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            steps0 = len(sim.flow.dt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with tracing.tracing() if mode == "on" else contextlib.nullcontext():
                t_next = intervals(builder, sim, t_next, k, tr["interval"])
            torch.cuda.synchronize()
            rate = tr["n"] ** 3 * (len(sim.flow.dt) - steps0) / (time.perf_counter() - t0)
            rates[mode].append(rate / 1e6)
    ratios = [a / b for a, b in zip(rates["on"], rates["off"])]
    return dict(cell=cell.name, device=torch.cuda.get_device_name(),
                intervals_per_sample=k, mcell_per_s=rates,
                median_off=statistics.median(rates["off"]),
                median_on=statistics.median(rates["on"]),
                median_ratio_on_off=statistics.median(ratios))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("idle", "cost"))
    ap.add_argument("cell")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--intervals", type=int, default=0)
    ap.add_argument("--chrome", default="")
    args = ap.parse_args()
    print(json.dumps((idle if args.mode == "idle" else cost)(args)))


if __name__ == "__main__":
    main()
