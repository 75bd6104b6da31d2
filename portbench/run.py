#!/usr/bin/env python3
"""The benchmark of waterlily_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell's `Simulation` (the kernel library loads from the
checkout's ``build/``, which the first run there compiles), runs the
users' output loop for ``--seconds``, holds the steps it sampled against
the plain reference, and prints the numbers compared beside their limits
as the last lines of standard error and one JSON object as the last line
of standard output.  ``--trace 1`` profiles a fixed stretch of the window
and reports the per-layer metrics instead of the end-to-end ones.  Needs a
CUDA device: with none, or fewer than the cell asks for, it exits with 2
and prints no result.  README.md says how to add a cell, a configuration
or a metric.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.Cell(args.workload)
    chips = harness.cell_entry(args.workload, cell.bench)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # load from one process with one host thread: the program's host work is
    # the launch path, and an idle intra-op pool only adds contention
    torch.set_num_threads(1)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run imported {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"run: {json.dumps(out['run'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
