#!/usr/bin/env python3
"""The readings the limits of a cell are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 12 --control 3 \
        [--first SEED] [--seconds S] [--out FILE]

For each of ``--seeds`` seeds (``--first``, then each the next one drawn
from it) the cell's set-up and a window of ``--seconds`` (0: just the
intervals its check samples) at the cell's own size, then the compared
numbers of the program against the plain reference in float64; for the
first ``--control`` seeds also those of the control, the reference in
bfloat16 put in the program's place.  Prints a line per seed and, last,
the largest number of the program's runs (the lower reading) and the
smallest of the control's (the upper reading) for each compared number,
and writes them as JSON to ``--out``.  The benchmark's own runs never run
the control.  Needs a CUDA device.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=2_400_000_017)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    rng = random.Random(args.first)
    seeds = [args.first] + [rng.randrange(1 << 31, 1 << 32) for _ in range(args.seeds - 1)]
    runs = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        rec, snap = harness.drive(cell, seed, args.seconds, False, t0, "cuda")
        prog, ctl = harness.judge(cell, snap, seed, "cuda", control=i < args.control)
        runs.append(dict(seed=seed, program=prog, control=ctl, steps=rec["steps"],
                         intervals=len(rec["interval_ms"]), seconds=time.perf_counter() - t0))
        print(f"seed {seed}: program {prog}; control {ctl}; "
              f"{runs[-1]['seconds']:.1f} s", flush=True)
        del snap
    names = list(runs[0]["program"])
    lower = {k: max(r["program"][k] for r in runs) for k in names}
    upper = {k: min(r["control"][k] for r in runs if r["control"]) for k in names}
    out = dict(workload=args.workload, device=torch.cuda.get_device_name(), lower=lower,
               upper=upper, runs=runs)
    for k in names:
        print(f"{k}: lower {lower[k]:.6g}, upper {upper[k]:.6g}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
