"""User-facing simulation orchestration.

PyTorch counterpart of `waterlily_tpu/simulation.py` (the port of
`src/WaterLily.jl:86-161`): the `Simulation` constructor wires the flow, the
body measure and the multigrid pressure solver, and `sim_step` drives the
host time loop around `mom_step_impl` (data-dependent CFL, like the
reference's `sim_step!` loop at `WaterLily.jl:128-139`).

Supported: the multigrid solver on non-periodic domains with constant
boundary velocity, static or moving `AutoBody` geometry re-measured densely.
`sim_step_n` is a host loop over `step_once`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .models import flow as fl
from .models.body import Body, NoBody, measure_fill
from .ops import multigrid as mg

__all__ = ["Simulation", "check_fn"]


def check_fn(f, D: int, dtype, nargs: int, name: str) -> None:
    """Constructor-time validation of a user callable (`check_fn`,
    `src/WaterLily.jl:78-84`).  The port takes no callable ubc/g/u0 yet, so
    any callable raises (ROADMAP queue 1, item 10)."""
    if f is not None and callable(f):
        raise NotImplementedError(
            f"callable {name} is not ported yet: {fl.ROADMAP_FLOW_CONFIGS}")


def _as_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (the JAX package's `jnp.asarray(v, dtype)`
    of the host Δt and time)."""
    return torch.tensor(v, dtype=dtype).item()


class Simulation:
    """`Simulation(dims, ubc, L; ...)` (`src/WaterLily.jl:36-75`).

    ``dims`` interior grid size, ``ubc`` constant boundary velocity,
    ``L``/``U`` the length/velocity scales of ``sim_time = t U / L``, ``nu``
    viscosity, ``eps`` BDIM kernel width, ``scheme`` the convective flux
    limiter, ``body`` immersed geometry, ``dtype`` precision and ``device``
    where every tensor lives.  The solver knobs default to the non-TPU
    values of the JAX package: ``smooth_it=4``, ``fine_presmooth=True``, a
    dense coarse solve below ``min_coarse_cells=64``."""

    def __init__(self, dims, ubc, L, *, U=None, dt=0.25, nu=0.0,
                 g: Optional[Callable] = None, eps: float = 1.0,
                 perdir: tuple[int, ...] = (), u0=None, exit_bc: bool = False,
                 scheme: Callable = fl.quick, body: Optional[Body] = None,
                 dtype=torch.float32, tol: float = 2e-3, itmx: int = 32,
                 smooth_it: Optional[int] = None,
                 fine_smooth_it: Optional[int] = None,
                 mp_smooth: Optional[bool] = None,
                 fine_presmooth: Optional[bool] = None,
                 min_coarse_cells: Optional[int] = None,
                 flow_ctor: Optional[Callable] = None, psolver: str = "mg",
                 device="cpu"):
        D = len(dims)
        check_fn(ubc, D, dtype, 3, "ubc")
        check_fn(g, D, dtype, 3, "g")
        check_fn(u0, D, dtype, 2, "u0")
        if flow_ctor is not None:
            raise NotImplementedError(
                "flow_ctor is not ported yet: ROADMAP queue 1, item 13 "
                "(solver injection)")
        if psolver != "mg":
            raise NotImplementedError(
                f"psolver={psolver!r} is not ported yet: ROADMAP queue 1, "
                "item 13 (solver injection)")
        if U is None:
            U = math.sqrt(sum(float(v) ** 2 for v in ubc))
        self.U, self.L, self.eps = U, L, eps
        self.device = torch.device(device)
        self.flow = fl.Flow(tuple(dims), ubc, dt=dt, nu=nu, g=g, u0=u0,
                            perdir=tuple(perdir), exit_bc=exit_bc,
                            scheme=scheme, dtype=dtype, tol=tol, itmx=itmx,
                            smooth_it=smooth_it, fine_smooth_it=fine_smooth_it,
                            mp_smooth=mp_smooth, fine_presmooth=fine_presmooth,
                            device=self.device)
        self.body = body if body is not None else NoBody()
        self.psolver = psolver
        self.solver_stats = None   # last step's per-projection residual logs
        self._min_coarse = (mg.MIN_COARSE_CELLS if min_coarse_cells is None
                            else min_coarse_cells)
        cfg = self.flow.cfg
        self.masks = tuple(mg.level_shapes(cfg.shape,
                                           min_cells=self._min_coarse)[1])
        if isinstance(self.body, NoBody):
            self.levels = mg.update_mg(self.masks, self.flow.state.mu0)
        else:
            self.measure(t=0.0)

    # ------------------------------------------------------------- time
    @property
    def time(self) -> float:
        return self.flow.time

    @property
    def sim_time(self) -> float:
        """Dimensionless time tU/L (`sim_time`, `WaterLily.jl:111-117`)."""
        return self.time * self.U / self.L

    @property
    def pois_n(self):
        """Pressure iterations per projection (reference `sim.pois.n`)."""
        return self.flow.pois_n

    # ------------------------------------------------------------- stepping
    def measure(self, t: Optional[float] = None):
        """Measure the body and rebuild the multigrid coefficients
        (`measure!(sim)`, `WaterLily.jl:146-149`), densely over the grid."""
        if isinstance(self.body, NoBody):
            return
        cfg = self.flow.cfg
        if t is None:
            t = self.time + self.flow.dt[-1]
        V, mu0, mu1, _ = measure_fill(self.body, cfg.shape,
                                      _as_dtype(t, cfg.dtype), float(self.eps),
                                      cfg.dtype, self.device)
        self.flow.state = dataclasses.replace(self.flow.state,
                                              V=V, mu0=mu0, mu1=mu1)
        self.levels = mg.update_mg(self.masks, mu0)

    def step_once(self, remeasure: bool = True, udf=None):
        """One `mom_step` (+ optional body re-measure) with the host
        bookkeeping of the Δt history and solver iteration counts."""
        if udf is not None:
            raise NotImplementedError(
                "udf is not ported yet: ROADMAP queue 1, item 10 (udf/LES)")
        if remeasure:
            self.measure()
        cfg = self.flow.cfg
        dt = _as_dtype(self.flow.dt[-1], cfg.dtype)
        t0 = _as_dtype(self.time, cfg.dtype)
        state, dt_next, iters, stats = fl.mom_step_impl(
            cfg, self.flow.state, self.levels, self.masks, dt, t0)
        self.flow.state = state
        self.flow.dt.append(dt_next.item())
        self.flow.pois_n += iters
        self.solver_stats = stats
        return self

    def sim_step_n(self, n: int, *, udf=None, remeasure: bool = False):
        """``n`` CFL-limited steps without body re-measure: a host loop over
        `step_once` (the JAX package runs one `lax.scan`; a device-resident
        loop is ROADMAP queue 1, item 8)."""
        if remeasure:
            raise NotImplementedError(
                "sim_step_n(remeasure=True) is not ported yet: ROADMAP queue "
                "1, item 9 (moving bodies)")
        for _ in range(n):
            self.step_once(remeasure=False, udf=udf)
        return self

    def sim_step(self, t_end: Optional[float] = None, *, remeasure: bool = True,
                 max_steps: int = 10**9, verbose: bool = False, udf=None):
        """Advance to dimensionless time ``t_end`` (one step if omitted)
        (`sim_step!`, `WaterLily.jl:128-139`)."""
        if t_end is None:
            return self.step_once(remeasure, udf)
        steps = 0
        while self.sim_time < t_end and steps < max_steps:
            self.step_once(remeasure, udf)
            steps += 1
            if verbose:
                self.sim_info()
        return self

    def sim_info(self):
        """One-line status print (`sim_info`, `WaterLily.jl:155`)."""
        print(f"tU/L={self.sim_time:.4f}, dt={self.flow.dt[-1]:.3f}")
