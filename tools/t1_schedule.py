"""Per-file seconds of a whole test run, and the wall time each order of
handing files to xdist's workers would give.

    python3 tools/t1_schedule.py RUN.xml [--workers 6]

``RUN.xml`` is the junit file of a whole run of the suite
(``--junitxml``).  The tool prints each file's summed test seconds, then
replays the run on ``--workers`` workers as `--dist loadfile` schedules it
(a worker takes the next file when two or fewer of its tests are left) for
three orders: most tests first (xdist's default), collection order
(alphabetical), and longest first (the root `conftest.py`'s order, from
this run's seconds).  The replay keeps each test's own seconds, so it
leaves out what workers take from one another and the start-up.  The
files of 100 s or more make the ``SECONDS`` table of `conftest.py`.
"""
from __future__ import annotations

import argparse
import collections
import xml.etree.ElementTree as ET


def file_times(path: str) -> dict[str, list[float]]:
    """Each test file's list of test seconds, in report order."""
    out: dict[str, list[float]] = collections.defaultdict(list)
    for tc in ET.parse(path).getroot().iter("testcase"):
        cls = tc.get("classname", "")
        mod = cls.split(".")[1] if cls.startswith("tests.") else cls.split(".")[0]
        out[mod + ".py"].append(float(tc.get("time", 0.0)))
    return dict(out)


def replay(order: list[str], times: dict[str, list[float]], workers: int):
    """The wall time of handing ``order`` out, and each file's start."""
    queue = list(order)
    clock = [0.0] * workers
    pending: list[list[float]] = [[] for _ in range(workers)]
    start = {}

    def take(w):
        if queue:
            f = queue.pop(0)
            start[f] = clock[w]
            pending[w].extend(times[f])

    for w in range(workers):
        take(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            take(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]), key=lambda w: clock[w])
        clock[w] += pending[w].pop(0)
        if len(pending[w]) <= 2:
            take(w)
    return max(clock), start


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("xml")
    ap.add_argument("--workers", type=int, default=6)
    a = ap.parse_args()
    times = file_times(a.xml)
    total = {f: sum(t) for f, t in times.items()}
    for f in sorted(total, key=lambda f: -total[f]):
        print(f"{total[f]:8.1f} s {len(times[f]):5d} tests  {f}")
    print(f"{sum(total.values()):8.1f} s in all; / {a.workers} workers = "
          f"{sum(total.values()) / a.workers:.1f} s")
    orders = {
        "most tests first": sorted(times, key=lambda f: -len(times[f])),
        "collection order": sorted(times),
        "longest first": sorted(times, key=lambda f: -total[f]),
    }
    for name, order in orders.items():
        wall, start = replay(order, times, a.workers)
        last = max(start, key=lambda f: start[f] + total[f])
        print(f"{name:17s} replayed wall {wall:7.1f} s; ends with {last} "
              f"(starts at {start[last]:.1f} s)")


if __name__ == "__main__":
    main()
