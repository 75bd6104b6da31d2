"""User-facing simulation orchestration.

PyTorch counterpart of `waterlily_tpu/simulation.py` (the port of
`src/WaterLily.jl:86-161`): the `Simulation` constructor wires the flow, the
body measure and the multigrid pressure solver, and `sim_step` drives the
host time loop around `mom_step_impl` (data-dependent CFL, like the
reference's `sim_step!` loop at `WaterLily.jl:128-139`).

Supported: the multigrid solver, a constant or callable boundary velocity
``ubc(i, x, t)``, a body force ``g(i, x, t)``, the ``udf`` forcing hook of the
step (`utils.les.sgs` is one), periodic directions (``perdir``), the
convective outlet (``exit_bc``), a constant or callable initial velocity
``u0``, static or moving `AutoBody` geometry re-measured densely, and
mixed-precision smoothing (``mp_smooth``) on the flat engine.  `sim_step_n`
is a host loop over `step_once`.  Every tensor lives on ``device``, the card
unless the caller asks for the CPU.

Two engines step the flow, as in the JAX package: ``engine="3d"`` runs
`flow.mom_step_impl` (the generic engine, kernels of `ops/stencil3d.py`),
``engine="flat"`` runs `flowflat.mom_step_flat_impl` (the fused engine,
kernels of `ops/fused3d.py`, on the body's x band `cfg.band_x`).
``engine="auto"`` takes the flat engine on a CUDA device in float32 and 3-D
(the counterpart of the JAX rule "flat on the TPU") and the 3d engine
elsewhere.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .models import flow as fl
from .models import flowflat as ff
from .models.body import Body, NoBody, measure_fill
from .ops import mgflat
from .ops import multigrid as mg

__all__ = ["Simulation", "check_fn"]

ENGINES = ("auto", "flat", "3d")
_BAND_PAD = 4    # rows of slack around the band (`simulation.py:213`)


def check_fn(f, D: int, dtype, nargs: int, name: str) -> None:
    """Constructor-time validation of a user callable (`check_fn`,
    `src/WaterLily.jl:78-84`): call it once per component on a dummy point
    and raise a readable error on a bad signature or a non-scalar result.
    ``nargs == 3`` is ``f(i, x, t)`` (``ubc``, ``g``), ``nargs == 2`` an
    initial condition ``f(i, x)``."""
    if f is None or not callable(f):
        return
    args = (torch.zeros((D,), dtype=dtype), torch.zeros((), dtype=dtype))[:nargs - 1]
    sig = f"({', '.join(['i', 'x', 't'][:nargs])})"
    for i in range(D):
        try:
            out = f(i, *args)
        except TypeError as e:
            raise ValueError(
                f"{name} must have signature {name}{sig} with i an int "
                f"component index, x a ({D},) position and t a scalar time: "
                f"{e}") from e
        except Exception as e:
            raise ValueError(
                f"{name}{sig} failed on a dummy point (i={i}, x=zeros({D}), "
                f"t=0) — it must be written with torch ops: {e}") from e
        if torch.as_tensor(out).shape != ():
            raise ValueError(f"{name}{sig} must return a scalar per "
                             f"component, got shape "
                             f"{tuple(torch.as_tensor(out).shape)} for i={i}")


def _as_dtype(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (the JAX package's `jnp.asarray(v, dtype)`
    of the host Δt and time)."""
    return torch.tensor(v, dtype=dtype).item()


def _band_box(V: torch.Tensor, mu0: torch.Tensor, mu1: torch.Tensor,
              perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """Per-dim padded-index ``[lo, hi)`` bounds of the interior cells whose
    BDIM moments deviate from the far field: μ1 = 0, V = 0, and μ0 = 1 but
    on the face-1 plane of each non-periodic direction, which the
    measure-time BC fill zeroes (the JAX `_band_box`, `simulation.py:145-186`,
    no box).  A ``(D, 2)`` int tensor; dim d reads ``(shape[d], 0)`` when
    nothing deviates."""
    D, shape = mu0.shape[0], tuple(mu0.shape[1:])
    sl = (slice(None),) + tuple(slice(1, n - 1) for n in shape)
    m0 = mu0[sl]
    exp = torch.ones_like(m0)
    for d in range(D):
        if d not in perdir:
            exp[(d,) + (slice(None),) * d + (0,)] = 0.0
    dev_cell = ((m0 != exp).any(dim=0) | (V[sl] != 0).any(dim=0)
                | (mu1[(slice(None),) + sl] != 0).flatten(0, 1).any(dim=0))
    out = []
    for d in range(D):
        dev = dev_cell.any(dim=tuple(k for k in range(D) if k != d))
        ix = torch.arange(1, shape[d] - 1, device=dev.device)
        out.append(torch.stack([torch.where(dev, ix, shape[d]).min(),
                                torch.where(dev, ix + 1, 0).max()]))
    return torch.stack(out)


class Simulation:
    """`Simulation(dims, ubc, L; ...)` (`src/WaterLily.jl:36-75`).

    ``dims`` interior grid size, ``ubc`` boundary velocity (a tuple, or a
    callable ``ubc(i, x, t)`` written with torch ops, and then ``U`` must be
    given), ``L``/``U`` the length/velocity scales of ``sim_time = t U / L``,
    ``nu`` viscosity, ``g(i, x, t)`` body acceleration, ``eps`` BDIM kernel
    width, ``scheme`` the convective flux limiter, ``body`` immersed
    geometry, ``dtype`` precision and ``device`` where every tensor lives.
    The solver knobs default to the non-TPU values of the JAX package:
    ``smooth_it=4`` in float32, ``fine_presmooth=True``, a dense coarse
    solve below ``min_coarse_cells=64``; ``mp_smooth=True`` asks for bf16
    smoothing, which takes effect on the flat engine in float32 with no
    periodic direction (`mgflat.mp_applies`).  ``engine`` picks the
    stepping engine (module docstring); ``"flat"`` needs D = 3.  ``perdir``
    lists the periodic directions (0-based), ``exit_bc`` puts the convective
    outlet on the x-high face, ``u0`` is a constant tuple or a callable
    ``u0(i, x)`` written with torch ops.  ``device`` defaults to the card
    (``"cuda"``); CPU callers pass ``device="cpu"``."""

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
                 engine: str = "auto", device="cuda"):
        D = len(dims)
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
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
            if callable(ubc):
                raise ValueError("U (velocity scale) must be given when ubc "
                                 "is a function")
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
        cfg = self.flow.cfg
        if engine == "auto":
            engine = ("flat" if self.device.type == "cuda"
                      and dtype == torch.float32 and ff.flat_supported(cfg)
                      else "3d")
        if engine == "flat" and not ff.flat_supported(cfg):
            raise ValueError("engine='flat' needs D=3")
        self.engine = engine
        self.solver_stats = None   # last step's per-projection residual logs
        self._min_coarse = (mg.MIN_COARSE_CELLS if min_coarse_cells is None
                            else min_coarse_cells)
        self.masks = tuple(mg.level_shapes(cfg.shape,
                                           min_cells=self._min_coarse)[1])
        if isinstance(self.body, NoBody):
            self.levels = self._levels(self.flow.state.mu0)
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
                                      cfg.dtype, self.device, cfg.perdir,
                                      cfg.exit_bc)
        self.flow.state = dataclasses.replace(self.flow.state,
                                              V=V, mu0=mu0, mu1=mu1)
        self.levels = self._levels(mu0)
        if self.engine == "flat":
            self._set_band(_band_box(V, mu0, mu1, cfg.perdir))

    def _levels(self, mu0: torch.Tensor):
        """The multigrid stack of ``mu0``; where ``mp_smooth`` takes effect,
        with the bf16 coefficient copies of `mgflat.mp_levels`."""
        cfg = self.flow.cfg
        levels = mg.update_mg(self.masks, mu0, cfg.perdir)
        if self.engine == "flat" and mgflat.mp_applies(
                cfg.mp_smooth, cfg.dtype, cfg.perdir):
            levels = mgflat.mp_levels(levels)
        return levels

    def _set_band(self, band: torch.Tensor):
        """Set ``cfg.band_x`` from the raw x bounds of `_band_box` (one host
        read), padded by `_BAND_PAD` rows and clamped to ``[1, Nx−1]``; no
        band when nothing deviates (the static part of the JAX `_set_band`,
        `simulation.py:380-415`)."""
        cfg = self.flow.cfg
        lo, hi = band[0].tolist()
        band_x = (None if hi <= lo else
                  (max(1, lo - _BAND_PAD), min(cfg.shape[0] - 1, hi + _BAND_PAD)))
        self.flow.cfg = dataclasses.replace(cfg, band_x=band_x)

    def step_once(self, remeasure: bool = True, udf=None):
        """One `mom_step` (+ optional body re-measure) with the host
        bookkeeping of the Δt history and solver iteration counts.  ``udf(f,
        state, u_adv, t)`` returns the forced momentum RHS of each phase."""
        if remeasure:
            self.measure()
        cfg = self.flow.cfg
        dt = _as_dtype(self.flow.dt[-1], cfg.dtype)
        t0 = _as_dtype(self.time, cfg.dtype)
        step = ff.mom_step_flat_impl if self.engine == "flat" else fl.mom_step_impl
        state, dt_next, iters, stats = step(cfg, self.flow.state, self.levels,
                                            self.masks, dt, t0, udf)
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
