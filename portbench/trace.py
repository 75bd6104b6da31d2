"""The reduction of a `torch.profiler` trace to the numbers the metrics
read, and the arithmetic of a kernel's roofline share.

`reduce` takes the events of the traced stretch: the device's busy time is
the union of the device intervals (kernels, copies, memsets), as
`tools/profile_torch_step.py`'s ``busy_ms`` takes it (copied here, commit
aaf499b); an idle gap is labelled by what the host was doing at its middle:
the innermost host operation running then, under the harness's span
(``portbench.steps`` or ``portbench.output``) that holds it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

# NVIDIA H100 SXM data sheet: HBM3 bytes per second (700 W)
HBM_BYTES_PER_S = 3.35e12
SPANS = ("portbench.steps", "portbench.output")
TOP = 10


def union(intervals) -> list[tuple[float, float]]:
    """The merged intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _innermost(starts, events, t: float, limit: int = 512):
    """The host event with the latest start that still runs at ``t``."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(-1, k - limit), -1):
        if events[j][1] >= t:
            return events[j][2]
    return None


def raw_events(torch, prof) -> list[tuple[str, bool, float, float]]:
    """``(name, on the device, start µs, end µs)`` of every event of a
    stopped profiler, from its raw trace (fifty times faster than building
    `prof.events()`)."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.device_type() == cuda, e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()]


def reduce(events) -> dict:
    """Busy seconds, device operations, device seconds by name, the ten
    names with the most device time and the ten host labels with the most
    idle device time, from `raw_events`."""
    dev, spans, host = [], [], []
    for name, on_dev, s, t in events:
        if name in SPANS:        # the harness's spans (on the device too)
            if not on_dev:
                spans.append((s, t, name))
        elif on_dev:
            dev.append((s, t, name))
        else:
            host.append((s, t, name))
    by_name = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) / 1e6
    busy = union((s, t) for s, t, _ in dev)
    host.sort()
    spans.sort()
    hs, ss = [h[0] for h in host], [s[0] for s in spans]
    idle = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        span = _innermost(ss, spans, mid) or "outside"
        idle[f"{span}: {_innermost(hs, host, mid) or 'python'}"] += (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=sum(t - s for s, t in busy) / 1e6, ops=len(dev),
                kernels=dict(by_name), top_ops=[[k[:200], v] for k, v in top],
                idle_gaps=[[k[:200], v] for k, v in gaps])


def device_seconds(rec: dict, symbols) -> float:
    """Device seconds of the operations whose name holds every part of one
    of ``symbols`` (a list of lists of substrings)."""
    return sum(v for k, v in rec["kernels"].items()
               if any(all(part in k for part in sym) for sym in symbols))


def roofline(rec: dict, launch: str, symbols, bytes_per_launch) -> float | None:
    """A kernel's share of its floor, in %: each launch's bytes over the
    published HBM rate, over the device time of the kernel's symbols; None
    when the kernel did not launch or left no device time."""
    t = rec.get("trace")
    if not t:
        return None
    launches = t["launches"].get(launch, 0)
    seconds = device_seconds(t, symbols)
    if launches == 0 or seconds <= 0:
        return None
    floor = launches * bytes_per_launch(rec) / HBM_BYTES_PER_S
    return 100.0 * floor / seconds
