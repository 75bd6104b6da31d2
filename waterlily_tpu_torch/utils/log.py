"""Pressure-solver logging.

PyTorch counterpart of `waterlily_tpu/utils/log.py` (the `@log`/`logger`
channel of the reference, `src/core.jl:4-24`, and the `plot_logger` parser,
`ext/WaterLilyPlotsExt.jl:55-104`).  Each step leaves its residual history
in ``sim.solver_stats``: one list of ``(r_inf, r_1, ω)`` rows per
projection, row 0 at the solve's entry (the JAX package keeps them padded in
one ``(2, itmx+1, 3)`` array).  `SolverLogger.log_step` writes them as the
reference's "p/c, iter, r_inf, r_1, omega" rows, each number printed in the
simulation's dtype, so a run of either package writes the same text.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SolverLogger", "parse_log"]

HEADER = "p/c, iter, r_inf, r_1, omega\n"


class SolverLogger:
    """Collect per-projection residual histories into a WaterLily-style log
    file; call ``logger.log_step(sim)`` after each `sim_step`."""

    def __init__(self, fname: str = "WaterLily"):
        self.fname = fname if fname.endswith(".log") else fname + ".log"
        with open(self.fname, "w") as f:
            f.write(HEADER)

    def log_step(self, sim):
        """Append the predictor and corrector residual rows of the last step
        (`@log`, `core.jl:4-24`)."""
        if sim.solver_stats is None:
            return
        npdt = torch.empty((), dtype=sim.flow.cfg.dtype).numpy().dtype
        iters = sim.pois_n[-2:]
        with open(self.fname, "a") as f:
            for phase, tag in ((0, "p"), (1, "c")):
                f.write(tag)
                n = iters[phase] if phase < len(iters) else 0
                rows = np.asarray(sim.solver_stats[phase], npdt)
                for k in range(n + 1):
                    row = rows[k]
                    om = row[2] if row.shape[0] > 2 else 1.0
                    f.write(f", {k}, {row[0]}, {row[1]}, {om}\n")


def parse_log(fname: str = "WaterLily.log"):
    """Parse a solver log into per-projection residual arrays (what
    `plot_logger` draws): ``(counts, r_inf, r_1)`` lists."""
    counts, rinf, r1 = [], [], []
    cur_inf, cur_1 = [], []
    with open(fname) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("p/c"):
                continue
            if line[0] in "pc":
                if cur_inf:
                    counts.append(len(cur_inf) - 1)
                    rinf.append(np.asarray(cur_inf))
                    r1.append(np.asarray(cur_1))
                cur_inf, cur_1 = [], []
                line = line[1:].lstrip(", ")
                if not line:
                    continue
            parts = [p.strip() for p in line.split(",") if p.strip()]
            if len(parts) >= 3:
                cur_inf.append(float(parts[1]))
                cur_1.append(float(parts[2]))
    if cur_inf:
        counts.append(len(cur_inf) - 1)
        rinf.append(np.asarray(cur_inf))
        r1.append(np.asarray(cur_1))
    return counts, rinf, r1
