"""Flow state and the BDIM predictor-corrector momentum step.

PyTorch counterpart of `waterlily_tpu/models/flow.py` (the port of
`src/Flow.jl`).  The per-cell kernels of the reference (conv_diff!, BDIM!,
projection, CFL) are functions over a `FlowState` of tensors; the
conv–diff RHS and the BDIM update route 3-D float32 CUDA fields to the hand
kernels K12 and K14 of `ops/stencil3d.py`, where the convection schemes and
the boundary-slab fluxes (`_phi_slabs`) also live beside the kernel that
mirrors them.

Layout: velocity ``u[i, x, y(, z)]`` component-first, pressure
``p[x, y(, z)]``, BDIM moments ``mu0`` like ``u`` and ``mu1[i, j, ...]``.
The time-step history and the pressure iteration counts are host lists
(`Flow.jl:127`).

Supported: a constant tuple or a callable ``ubc(i, x, t)``; a body force
``g(i, x, t)`` and the frame acceleration ∂ubc/∂t (`accelerate`); the
``udf(f, state, u_adv, t)`` forcing hook of the step; a constant tuple or a
callable ``u0(i, x)`` (batched with `torch.func.vmap`); periodic directions
``perdir``; the convective outlet ``exit_bc`` on the x-high face; the
multigrid solver, with ``mp_smooth`` (bf16 smoothing) on the flat engine,
or an injected ``solve_fn`` (the PCG solver of ``psolver="pcg"``).

Differentiable runs (the JAX package's `jax.jacfwd` through
`mom_step_impl`): `torch.func.jvp` (and `torch.func.jacfwd` on the CPU's
plain route) through `mom_step_impl` gives the forward-mode derivative of a
step in any tensor it reads (``state.nu``, a body parameter through
``V``/``mu0``/``mu1`` and the level stack, the initial field, ``dt``).  The
pressure solve is `multigrid.solve_mg_implicit` with its exact implicit
rule; on the card K12 and K14 have forward-mode rules of their own
(`ops/stencil3d.py`).  ``dt`` and ``t0`` may be 0-d tensors, as the JAX
runner carries ``dt``: its tangent then flows through `cfl`.  The flat
engine (`models/flowflat.py`) is not differentiable (its kernels raise on a
tangent), nor is `Simulation`'s host loop, as in the JAX package.

Distributed (``ctx``, ``n_dist``: the per-shard step of
`parallel.dist.DistSimulation`): the conv–diff's boundary-slab fluxes come
from the ring neighbours (`_ring_slabs`), `accelerate` and the BCs take
global coordinates, ``f*`` is halo-refreshed before the BDIM, the solve is
`multigrid.solve_mg_implicit` with ``ctx`` and the CFL a maximum over the
shards; a ``udf`` is called as on one device, as the JAX `_phase` calls it.
Every op is plain PyTorch under ``ctx`` (the JAX gate
`pallas3d.use_pallas(a, ctx)`) but the injected PCG's A·x (K16); the flat
engine keeps four kernels there.  `torch.func.jvp` of the per-shard step,
each shard's entered with `ops.dist.shard_jvp`, is the decomposed step's
forward-mode derivative: the collectives carry the tangents.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import tracing
from ..ops import multigrid as mg
from ..ops import stencil3d as st
from ..ops.bc import apply_vector, bc_vector, eval_points, exit_bc
from ..ops.dist import (edge_hi, edge_lo, fetch_hi, fetch_lo, offsets,
                        pmax_all, sharded, sync_vector)
from ..ops.fused3d import cfl_max, div_field, proj_correct
from ..ops.grid import interior, set_interior, shift, slab
from ..ops.stencil3d import cds, median3, quick, vanleer

__all__ = [
    "quick", "cds", "vanleer", "median3",
    "FlowState", "FlowCfg", "Flow", "init_state",
    "conv_diff", "accelerate", "bdim_update", "project", "cfl",
    "mom_step_impl", "div_field", "scale_interior", "ACCELERATE_CHUNK",
]

# points per vmapped batch of `accelerate` (as `body.MEASURE_CHUNK`): bounds
# the temporaries of the batched callables and of the forward-mode derivative
ACCELERATE_CHUNK = 1 << 21


@dataclasses.dataclass
class FlowState:
    """Fields of a flow (`Flow{D,T}`, `Flow.jl:114-131`): ``u0`` is the
    previous velocity, ``V``/``mu0``/``mu1`` the BDIM body velocity and
    kernel moments, ``nu`` a 0-d tensor on the fields' device (one that
    carries a forward-mode tangent keeps it: `init_state`)."""
    u: torch.Tensor
    u0: torch.Tensor
    p: torch.Tensor
    V: torch.Tensor
    mu0: torch.Tensor
    mu1: torch.Tensor
    nu: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FlowCfg:
    """Static configuration of a flow (the JAX `FlowCfg` restricted to the
    supported features)."""
    shape: tuple[int, ...]          # padded grid Ng = N + 2
    ubc: Any                        # tuple of floats or callable (i, x, t)
    g: Optional[Callable] = None    # body acceleration g(i, x, t)
    perdir: tuple[int, ...] = ()    # periodic directions (0-based)
    exit_bc: bool = False           # convective outlet on the x-high face
    scheme: Callable = quick
    dtype: Any = torch.float32
    tol: float = 2e-3               # pressure solver tolerance
    itmx: int = 32                  # pressure solver max iterations
    smooth_it: int = 4              # MG smoother sweeps (`Poisson.jl:135`)
    fine_smooth_it: int = 0         # fine post-V-cycle sweeps (0 → smooth_it)
    fine_presmooth: bool = True     # fine Jacobi pre-smooth of each V-cycle
    # x rows [lo, hi) outside which the BDIM moments are the far field (μ0 = 1
    # but the face-1 planes, μ1 = 0, V = 0): the flat engine runs the full
    # BDIM on that slab only; set by `Simulation` from the measure
    band_x: Optional[tuple[int, int]] = None
    # per-dim padded-index [lo, hi) box of the moving-body re-measure
    # (`body.measure_fill(band_box=)`), kept by `Simulation` beside band_x
    band_box: Optional[tuple[tuple[int, int], ...]] = None
    # mixed-precision smoothing on the flat engine in float32 with no
    # periodic direction: bf16 coefficients and correction, f32 x and r
    # (`fused3d.incr_gs_k(mp=True)`); ignored elsewhere, as in the JAX package
    mp_smooth: bool = False

    @property
    def D(self) -> int:
        return len(self.shape)


def scale_interior(u: torch.Tensor, s) -> torch.Tensor:
    """u *= s on interior faces only (`scale_u!`, `Flow.jl:211-214`)."""
    d = u.dim() - 1
    return set_interior(u, interior(u, d) * s, d)


def conv_diff(u: torch.Tensor, scheme: Callable, nu,
              perdir: tuple[int, ...] = (), ctx=None) -> torch.Tensor:
    """Convective + diffusive momentum RHS (`conv_diff!`, `Flow.jl:38-62`),
    periodic in ``perdir``: `stencil3d.conv_diff_plain`, or the K12 kernel
    for 3-D float32 CUDA fields and a scheme the kernel covers (a user's
    scheme runs as plain PyTorch).  Every cell of the result is defined; the
    ghost rows matter because `bdim_update` reads ``f*`` at them.  Under
    ``ctx`` the plain version with the ring variant of the slab fluxes of
    the sharded directions (`_ring_slabs`): a K12 launch on a shard cannot
    read its neighbours' planes."""
    if ctx is not None:
        slabs = {(i, j): ph for j in range(u.shape[0]) if sharded(ctx, j)
                 for i, ph in enumerate(_ring_slabs(u, j, scheme, nu, perdir, ctx))}
        return st.conv_diff_plain(u, nu, scheme, perdir, slabs)
    sid = st.scheme_id(scheme)
    if sid is not None and st.use_kernels(u[0]):
        return st.conv_diff_k(u, nu, sid, perdir)
    return st.conv_diff_plain(u, nu, scheme, perdir)


def _ring_slabs(u, j: int, scheme, nu, perdir, ctx):
    """The fixed fluxes of every pair (i, j) of a sharded direction ``j``
    (the JAX `_phi_slabs` with ``ctx``, `flow.py:185-250`): at the first
    interior slab the generic flux with its second-upwind value from the
    left neighbour's slab n−3 (the periodic ϕuP read when the ring wraps),
    one-sided ϕuL on the low physical edge; at the top ghost slab the right
    neighbour's first-slab flux, ϕuR on the high physical edge.  Two ring
    exchanges for all components.  Returns ``[(phi_lo, phi_hi)]`` per i."""
    D = u.shape[0]
    n = u.shape[1 + j]
    per = j in perdir
    f_mm = fetch_lo(ctx, u, 1 + j, j, n - 3)
    one_lo = not per and edge_lo(ctx, j)
    one_hi = not per and edge_hi(ctx, j)

    def uadv(i, idx):
        sl = st._slab_ix(j, idx)
        if i == j:
            return 0.5 * (u[j][sl] + u[j][st._slab_ix(j, idx - 1)])
        return 0.5 * (u[j][sl] + shift(u[j][sl], i, -1))

    los = []
    for i in range(D):
        f = u[i]
        f0, f1, f2 = slab(f, j, 0), slab(f, j, 1), slab(f, j, 2)
        ua = uadv(i, 1)
        if one_lo:
            phi = ua * torch.where(ua > 0, 0.5 * (f1 + f0), scheme(f2, f1, f0))
        else:
            phi = ua * torch.where(ua > 0, scheme(f_mm[i], f0, f1), scheme(f2, f1, f0))
        los.append(phi - nu * (f1 - f0))
    wrap = fetch_hi(ctx, torch.stack(los), 1 + j, j, 0)
    out = []
    for i in range(D):
        if one_hi:
            f = u[i]
            fm1, fm2, fm3 = slab(f, j, n - 1), slab(f, j, n - 2), slab(f, j, n - 3)
            ua_h = uadv(i, n - 1)
            phi_hi = (ua_h * torch.where(ua_h < 0, 0.5 * (fm1 + fm2),
                                         scheme(fm3, fm2, fm1))
                      - nu * (fm1 - fm2))
        else:
            phi_hi = wrap[i]
        out.append((los[i], phi_hi))
    return out


def _face_points(i: int, shape: tuple[int, ...], k0: int, k1: int, dtype,
                 device, offset=None) -> torch.Tensor:
    """Rows ``[k0, k1)`` of ``loc_grid(i, shape, offset=offset).reshape(D,
    -1).T``, built from the flat cell indices without the whole grid of
    coordinates."""
    idx = torch.arange(k0, k1, device=device)
    cols = []
    for d in reversed(range(len(shape))):
        c = (idx % shape[d]).to(dtype) - 0.5
        if offset is not None and offset[d]:
            c = c + offset[d]
        cols.append(c - 0.5 if d == i else c)
        idx = idx // shape[d]
    return torch.stack(cols[::-1], dim=1)


def accelerate(f: torch.Tensor, t, g: Optional[Callable], ubc,
               dtype, ctx=None) -> torch.Tensor:
    """Applied and reference-frame acceleration ``f_i += g(i, x, t) +
    ∂ubc(i, x, t)/∂t`` at every face point, ghosts included (`accelerate!`,
    `Flow.jl:69-73`).  The time derivative of a callable boundary spec is the
    exact forward-mode derivative (`torch.func.jvp`; the JAX package uses
    `jax.jvp`, the reference ForwardDiff).  Evaluated in chunks of
    `ACCELERATE_CHUNK` points at global coordinates under ``ctx``; returns
    a new tensor."""
    has_ubc_t = callable(ubc)
    if g is None and not has_ubc_t:
        return f
    shape = tuple(f.shape[1:])
    off = offsets(ctx, shape) if ctx is not None else None
    t = torch.as_tensor(t, dtype=dtype, device=f.device)
    one = torch.ones_like(t)
    f = f.clone(memory_format=torch.contiguous_format)
    for i in range(f.shape[0]):
        fi = f[i].view(-1)
        for k in range(0, fi.numel(), ACCELERATE_CHUNK):
            pts = _face_points(i, shape, k, min(k + ACCELERATE_CHUNK, fi.numel()),
                               dtype, f.device, off)
            add = 0.0
            if g is not None:
                add = add + eval_points(lambda x: g(i, x, t), pts, dtype)
            if has_ubc_t:
                def dudt(x):
                    def at(tt):
                        return torch.as_tensor(ubc(i, x, tt), dtype=dtype,
                                               device=f.device)
                    return torch.func.jvp(at, (t,), (one,))[1]
                add = add + eval_points(dudt, pts, dtype)
            fi[k:k + pts.shape[0]] += add
    return f


def bdim_update(u, u0, f, V, mu0, mu1, dt, ctx=None) -> torch.Tensor:
    """BDIM convolution (`BDIM!`, `Flow.jl:176-180`):
    ``f* = u0 + dt·f − V``, ``u += μ1·∇f* + V + μ0·f*`` on interior faces;
    the K14 kernel for 3-D float32 CUDA fields.  Under ``ctx`` the μ1·∇f*
    gradient reads halos of ``f*``, which are ring-refreshed first (bodies
    that straddle shards; edge ghosts keep their values), in plain
    PyTorch."""
    if ctx is not None:
        return st.bdim_apply(u, sync_vector(u0 + dt * f - V, ctx), V, mu0, mu1)
    if st.use_kernels(u[0]):
        return st.bdim_k(u, u0, f, V, mu0, mu1, dt)
    return st.bdim_plain(u, u0, f, V, mu0, mu1, dt)


def project(u: torch.Tensor, p: torch.Tensor, levels, masks, dt_w: float,
            cfg: FlowCfg, t=0.0, solve_fn=None, ctx=None, n_dist: int = 0):
    """Pressure projection (`mom_project!`, `Flow.jl:223-232`): solve
    ``A x = div(u)`` warm-started from ``p·dt_w``, ``u_i -= L_i ∂_i x``,
    `BC!` at time ``t``, ``p = x/dt_w``.  ``solve_fn(levels, masks, x, z,
    tol, itmx, perdir)`` is the pressure-solver injection point (`pois_ctor`,
    `src/WaterLily.jl:96-97`; default the multigrid solve with its implicit
    forward-mode rule, `multigrid.solve_mg_implicit`, as `flow.py:388-394`
    of the JAX package, distributed under ``ctx``).
    ``dt_w`` is a float or a 0-d tensor.  Returns ``(u, p, iters,
    stats)``."""
    z = div_field(u)
    x = p * dt_w
    opts = dict(tol=cfg.tol, itmx=cfg.itmx, smooth_it=cfg.smooth_it,
                fine_smooth_it=cfg.fine_smooth_it,
                fine_presmooth=cfg.fine_presmooth, perdir=cfg.perdir)
    if solve_fn is not None:
        res = solve_fn(levels, masks, x, z, cfg.tol, cfg.itmx, cfg.perdir)
    else:
        res = mg.solve_mg_implicit(levels, masks, x, z, ctx=ctx, n_dist=n_dist,
                                   **opts)
    x = res.x
    u = bc_vector(proj_correct(u, x, levels[0].L), cfg.ubc, t,
                  save_exit=cfg.exit_bc, perdir=cfg.perdir, ctx=ctx)
    return u, x / dt_w, res.iters, res.stats


def cfl(u: torch.Tensor, nu, dt_max: float = 10.0, ctx=None) -> torch.Tensor:
    """New time step from the max outflow flux (`CFL`, `Flow.jl:234-244`),
    a 0-d tensor on the device; the max over the shards under ``ctx``.
    `torch.minimum` (not a clamp): at a tie its derivative splits ½/½, as
    the JAX package's `jnp.minimum` does."""
    dt = 1.0 / (pmax_all(cfl_max(u), ctx) + 5 * nu)
    return torch.minimum(torch.full_like(dt, dt_max), dt)


def _phase(state: FlowState, u_adv, u_into, f_t, dt, cfg: FlowCfg, udf=None,
           ctx=None):
    """One momentum phase (`mom_predict!`/`mom_correct!`, `Flow.jl:190-210`):
    conv–diff, the ``udf`` hook, `accelerate` at time ``f_t``, BDIM."""
    f = conv_diff(u_adv, cfg.scheme, state.nu, cfg.perdir, ctx)
    if udf is not None:
        # the udf sees the field being built (interior zeroed in the
        # predictor) and the advecting field (`udf!`, `Flow.jl:255-257`)
        f = udf(f, dataclasses.replace(state, u=u_into), u_adv, f_t)
    f = accelerate(f, f_t, cfg.g, cfg.ubc, cfg.dtype, ctx)
    return bdim_update(u_into, state.u0, f, state.V, state.mu0, state.mu1, dt,
                       ctx)


def mom_step_impl(cfg: FlowCfg, state: FlowState, levels, masks, dt: float,
                  t0: float = 0.0, udf=None, solve_fn=None, ctx=None,
                  n_dist: int = 0):
    """One time step (`mom_step!`, `Flow.jl:156-167`): predictor advected by
    u0 and forced at ``t0``, `BC!` at ``t1 = t0 + dt`` and (``exit_bc``) the
    convective outlet, projection (w=1), corrector advected by the projected
    u and forced at ``t1``, blend ½, `BC!`, projection (w=½), then the CFL
    limit.  ``dt`` and ``t0`` are host floats already rounded to
    ``cfg.dtype``, or 0-d tensors of ``cfg.dtype`` on the fields' device
    (the differentiable runner's: a tangent of ``dt`` is kept, and a float
    gives the same bits as before); ``udf(f, state, u_adv, t)`` returns the
    forced RHS;
    ``solve_fn`` replaces the multigrid solve of both projections
    (`project`).  ``ctx``/``n_dist`` select the per-shard step of a
    decomposed flow (module docstring).  Returns ``(state', dt_next (0-d
    tensor), [iters1, iters2], [stats1, stats2])``."""
    t1 = t0 + dt
    u0 = state.u
    state = dataclasses.replace(state, u0=u0)
    with tracing.span("wlt.predict"):
        u = scale_interior(u0, 0.0)
        u = _phase(state, u0, u, t0, dt, cfg, udf, ctx)
        u = bc_vector(u, cfg.ubc, t1, save_exit=cfg.exit_bc, perdir=cfg.perdir,
                      ctx=ctx)
        if cfg.exit_bc:
            u = exit_bc(u, u0, dt, ctx)
        u, p, n1, s1 = project(u, state.p, levels, masks, dt, cfg, t1, solve_fn,
                               ctx, n_dist)
    with tracing.span("wlt.correct"):
        u = _phase(state, u, u, t1, dt, cfg, udf, ctx)
        u = scale_interior(u, 0.5)
        u = bc_vector(u, cfg.ubc, t1, save_exit=cfg.exit_bc, perdir=cfg.perdir,
                      ctx=ctx)
        u, p, n2, s2 = project(u, p, levels, masks, 0.5 * dt, cfg, t1,
                              solve_fn, ctx, n_dist)
        state = dataclasses.replace(state, u=u, p=p)
        dt_next = cfl(u, state.nu, ctx=ctx)
    return state, dt_next, [n1, n2], [s1, s2]


def init_state(cfg: FlowCfg, nu, device, u0=None) -> FlowState:
    """Initial `FlowState` (`Flow`, `Flow.jl:133-147`): ``u0`` (a constant
    tuple, a callable ``u0(i, x)`` evaluated at every face, or ``ubc``, at
    t = 0 when callable) on all faces, BCs, the constructor-time
    `exitBC!(u,u,0)`, and the moments of an empty domain."""
    D, shape, dtype = cfg.D, cfg.shape, cfg.dtype
    if callable(u0):
        u = apply_vector(u0, D, shape, dtype, device)
    elif u0 is None and callable(cfg.ubc):
        t = torch.zeros((), dtype=dtype, device=device)
        u = apply_vector(lambda i, x: cfg.ubc(i, x, t), D, shape, dtype, device)
    else:
        vals = cfg.ubc if u0 is None else tuple(float(v) for v in u0)
        u = torch.tensor(vals, dtype=dtype, device=device).reshape(
            (D,) + (1,) * D).expand((D,) + shape).clone()
    u = bc_vector(u, cfg.ubc, save_exit=cfg.exit_bc, perdir=cfg.perdir)
    u = exit_bc(u, u, 0.0)
    mu0 = bc_vector(torch.ones((D,) + shape, dtype=dtype, device=device),
                    (0.0,) * D, perdir=cfg.perdir)
    return FlowState(
        u=u, u0=u, p=torch.zeros(shape, dtype=dtype, device=device),
        V=torch.zeros((D,) + shape, dtype=dtype, device=device), mu0=mu0,
        mu1=torch.zeros((D, D) + shape, dtype=dtype, device=device),
        nu=torch.as_tensor(nu, dtype=dtype, device=device))


class Flow:
    """Host-side flow container: a `FlowState`, a `FlowCfg` and the host
    time-step history (`Flow`, `Flow.jl:131-148`)."""

    def __init__(self, N: tuple[int, ...], ubc, dt: float = 0.25,
                 nu: float = 0.0, g: Optional[Callable] = None, u0=None,
                 perdir: tuple[int, ...] = (), exit_bc: bool = False,
                 scheme: Callable = quick, dtype=torch.float32,
                 tol: float = 2e-3, itmx: int = 32,
                 smooth_it: Optional[int] = None,
                 fine_smooth_it: Optional[int] = None,
                 mp_smooth: Optional[bool] = None,
                 fine_presmooth: Optional[bool] = None,
                 device="cuda"):
        shape = tuple(n + 2 for n in N)
        self.cfg = FlowCfg(
            shape=shape,
            ubc=ubc if callable(ubc) else tuple(float(v) for v in ubc), g=g,
            mp_smooth=bool(mp_smooth), perdir=tuple(int(j) for j in perdir), exit_bc=bool(exit_bc),
            scheme=scheme, dtype=dtype, tol=tol, itmx=itmx,
            smooth_it=4 if smooth_it is None else int(smooth_it),
            fine_smooth_it=0 if fine_smooth_it is None else int(fine_smooth_it),
            fine_presmooth=True if fine_presmooth is None else bool(fine_presmooth))
        self.device = torch.device(device)
        self.state = init_state(self.cfg, nu, self.device, u0)
        self.dt = [float(dt)]           # host-side Δt history (`Flow.jl:127`)
        self.pois_n: list[int] = []     # pressure iterations per projection

    @property
    def u(self):
        return self.state.u

    @property
    def p(self):
        return self.state.p

    @property
    def mu0(self):
        return self.state.mu0

    @property
    def V(self):
        return self.state.V

    @property
    def nu(self):
        return float(self.state.nu)

    @property
    def time(self) -> float:
        """Current flow time = sum(dt[:-1]) (`time`, `Flow.jl:174`)."""
        return float(sum(self.dt[:-1]))
