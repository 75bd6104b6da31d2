"""Plain reference of one time step of the BDIM flow solver, in any dtype.

WaterLily's `mom_step!` (`Flow.jl:156-167`): a predictor and a corrector,
each a convection-diffusion RHS (median-limited QUICK), the BDIM update, the
domain BCs and a pressure projection by geometric multigrid
(`MultiLevelPoisson.jl`), then the CFL time step.  Written from that
algorithm in plain `torch` operations on padded ``(D, nx+2, ny+2, nz+2)``
tensors, for a constant boundary velocity, no body force, no user forcing
and no outlet, with any set of periodic directions.  It imports nothing of
the program under test: it is what the benchmark holds the program's
timed step against (in float64) and what its control is (in bfloat16).

Every function takes its dtype from its inputs; `_rnd` rounds the host
scalars of the solver (ω, the stop tolerances) to that dtype, as the
program rounds its own to float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

MIN_COARSE_CELLS = 64      # the coarsest level keeps at least this many cells
DENSE_COARSE_MAX = 1024    # a level this small is solved with its pseudo-inverse


# ---------------------------------------------------------------- grid
def shift(a: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """``b[I] = a[I + s·e_axis]``, wrapping at the ends."""
    return torch.roll(a, -s, axis) if s else a


def inside(shape, device) -> torch.Tensor:
    m = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    m[(slice(1, -1),) * len(shape)] = True
    return m


def zero_ghost(a: torch.Tensor, nd: Optional[int] = None) -> torch.Tensor:
    nd = a.dim() if nd is None else nd
    return torch.where(inside(a.shape[a.dim() - nd:], a.device), a, 0.0)


def interior(a: torch.Tensor, nd: Optional[int] = None) -> torch.Tensor:
    nd = a.dim() if nd is None else nd
    return a[(slice(None),) * (a.dim() - nd) + (slice(1, -1),) * nd]


def grow(a: torch.Tensor, nd: Optional[int] = None, fill: float = 0.0) -> torch.Tensor:
    nd = a.dim() if nd is None else nd
    return F.pad(a, (1, 1) * nd, value=fill)


def slab(a: torch.Tensor, axis: int, idx: int) -> torch.Tensor:
    return a.narrow(axis, idx % a.shape[axis], 1)


def parity(shape, device) -> torch.Tensor:
    """``Σ_d I_d mod 2``: the red-black colour of each cell."""
    s = torch.zeros(tuple(shape), dtype=torch.int32, device=device)
    for d, n in enumerate(shape):
        view = [1] * len(shape)
        view[d] = n
        s = s + torch.arange(n, dtype=torch.int32, device=device).reshape(view)
    return s % 2


def per_bc(a: torch.Tensor, perdir, lead: int = 0) -> torch.Tensor:
    """Periodic ghost copies (`perBC!`)."""
    if not perdir:
        return a
    a = a.clone()
    for j in perdir:
        ax, n = lead + j, a.shape[lead + j]
        slab(a, ax, 0).copy_(slab(a, ax, n - 2))
        slab(a, ax, n - 1).copy_(slab(a, ax, 1))
    return a


def bc_vector(u: torch.Tensor, ubc, perdir=()) -> torch.Tensor:
    """Domain BCs of a vector field (`BC!`) for a constant ``ubc``: the
    normal component Dirichlet on the ghost and first interior face, the
    tangential ones a copy of their neighbour, periodic wrap in
    ``perdir``."""
    D, shape = u.shape[0], tuple(u.shape[1:])
    u = u.clone()
    for j in range(D):
        n = shape[j]
        for i in range(D):
            ui = u[i]
            if j in perdir:
                slab(ui, j, 0).copy_(slab(ui, j, n - 2))
                slab(ui, j, n - 1).copy_(slab(ui, j, 1))
            elif i == j:
                slab(ui, j, 0).fill_(ubc[i])
                slab(ui, j, n - 1).fill_(ubc[i])
                slab(ui, j, 1).fill_(ubc[i])
            else:
                slab(ui, j, 0).copy_(slab(ui, j, 1))
                slab(ui, j, n - 1).copy_(slab(ui, j, n - 2))
    return u


def exit_plane_start(u: torch.Tensor) -> torch.Tensor:
    """`exitBC!(u, u, 0)` of the flow's constructor (`Flow.jl:141`): the x
    component's exit ghost plane shifted so that its mean equals the mean
    of the inflow plane."""
    inner = (slice(1, -1),) * (u.dim() - 2)
    ex = (0, slice(-1, None)) + inner
    u_in = torch.mean(u[(0, slice(1, 2)) + inner])
    u = u.clone()
    u[ex] = u[ex] - (torch.mean(u[ex]) - u_in)
    return u


# ---------------------------------------------------------------- momentum
def median3(a, b, c):
    return torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))


def quick(u, c, d):
    """Median-limited QUICK (`Flow.jl:4`): upstream, centre, downstream."""
    return median3((5 * c + 2 * d - u) / 6, c, median3(10 * c - 9 * u, c, d))


def _sl(axis: int, idx: int):
    return (slice(None),) * axis + (slice(idx, idx + 1),)


def _edge_fluxes(u, f, i, j, nu, perdir):
    """The fluxes of component ``i`` across direction ``j`` at the first
    interior face and at the top ghost face (`Flow.jl:56-62`): one-sided
    (`ϕuL`, `ϕuR`) at a wall, `ϕuP` (second upwind value from the periodic
    partner n−3) in a periodic direction."""
    n = f.shape[j]

    def uadv(idx):
        s = _sl(j, idx)
        if i == j:
            return 0.5 * (u[j][s] + u[j][_sl(j, idx - 1)])
        return 0.5 * (u[j][s] + shift(u[j][s], i, -1))

    f0, f1, f2 = f[_sl(j, 0)], f[_sl(j, 1)], f[_sl(j, 2)]
    ua = uadv(1)
    if j in perdir:
        lo = ua * torch.where(ua > 0, quick(f[_sl(j, n - 3)], f0, f1),
                              quick(f2, f1, f0)) - nu * (f1 - f0)
        return lo, lo
    lo = ua * torch.where(ua > 0, 0.5 * (f1 + f0), quick(f2, f1, f0)) - nu * (f1 - f0)
    fm1, fm2, fm3 = f[_sl(j, n - 1)], f[_sl(j, n - 2)], f[_sl(j, n - 3)]
    uh = uadv(n - 1)
    hi = uh * torch.where(uh < 0, 0.5 * (fm1 + fm2), quick(fm3, fm2, fm1)) - nu * (fm1 - fm2)
    return lo, hi


def conv_diff(u: torch.Tensor, nu, perdir=()) -> torch.Tensor:
    """Convection + diffusion RHS (`conv_diff!`, `Flow.jl:38-62`): per
    component i and direction j the face flux
    ``Φ = ū_j·QUICK(u_i) − ν ∂_j u_i``, fixed at the domain faces, and
    ``r_i = Σ_j Φ − Φ(+e_j)``."""
    D = u.shape[0]
    out = []
    for i in range(D):
        f = u[i]
        ri = torch.zeros_like(f)
        for j in range(D):
            n = f.shape[j]
            ua = 0.5 * (u[j] + shift(u[j], i, -1))
            up = quick(shift(f, j, -2), shift(f, j, -1), f)
            dn = quick(shift(f, j, 1), f, shift(f, j, -1))
            phi = ua * torch.where(ua > 0, up, dn) - nu * (f - shift(f, j, -1))
            lo, hi = _edge_fluxes(u, f, i, j, nu, perdir)
            phi[_sl(j, 1)] = lo
            phi[_sl(j, n - 1)] = hi
            ri = ri + (phi - shift(phi, j, 1))
        out.append(ri)
    return torch.stack(out)


def bdim(u, u0, f, V, mu0, mu1, dt) -> torch.Tensor:
    """`BDIM!` (`Flow.jl:176-180`): ``f* = u0 + dt·f − V``, then
    ``u_i += ½Σ_j μ1[i,j]·(f*_i(+e_j) − f*_i(−e_j)) + V_i + μ0_i·f*_i`` on
    interior faces."""
    fp = u0 + dt * f - V
    D = u.shape[0]
    terms = []
    for i in range(D):
        acc = torch.zeros_like(fp[i])
        for j in range(D):
            acc = acc + mu1[i, j] * (shift(fp[i], j, 1) - shift(fp[i], j, -1))
        terms.append(0.5 * acc + V[i] + mu0[i] * fp[i])
    return u + zero_ghost(torch.stack(terms), D)


def scale_interior(u: torch.Tensor, s: float) -> torch.Tensor:
    out = u.clone()
    ix = (slice(None),) + (slice(1, -1),) * (u.dim() - 1)
    out[ix] = u[ix] * s
    return out


def div(u: torch.Tensor) -> torch.Tensor:
    s = torch.zeros_like(u[0])
    for i in range(u.shape[0]):
        s = s + (shift(u[i], i, 1) - u[i])
    return zero_ghost(s)


def cfl_max(u: torch.Tensor) -> float:
    """Max over the interior of ``Σ_i max(0, u_i(+e_i)) + max(0, −u_i)``."""
    s = torch.zeros_like(u[0])
    for i in range(u.shape[0]):
        s = s + torch.clamp(shift(u[i], i, 1), min=0) + torch.clamp(-u[i], min=0)
    return interior(s).max().item()


# ---------------------------------------------------------------- multigrid
class Level(NamedTuple):
    L: torch.Tensor                  # (D, *Ng) lower-face coefficients
    Dg: torch.Tensor                 # diagonal, 0 in ghosts
    iD: torch.Tensor                 # 1/diagonal, 0 where the diagonal is 0
    Ainv: Optional[torch.Tensor] = None


def _rnd(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``."""
    return torch.tensor(v, dtype=torch.float64).to(dtype).item()


def make_level(L: torch.Tensor) -> Level:
    d = torch.zeros_like(L[0])
    for i in range(L.shape[0]):
        d = d - (L[i] + shift(L[i], i, 1))
    d = zero_ghost(d)
    iD = torch.where(d == 0, torch.zeros_like(d), 1.0 / torch.where(d == 0, 1.0, d))
    return Level(L, d, iD)


def level_masks(shape, min_cells: int = MIN_COARSE_CELLS, maxlevels: int = 10):
    """The per-level coarsening masks: a padded extent is halved while it
    is even and above 4; stop before a level would hold fewer than
    ``min_cells`` interior cells once three levels exist."""
    shapes, masks = [tuple(shape)], []
    while len(shapes) <= maxlevels:
        c = tuple(n % 2 == 0 and n > 4 for n in shapes[-1])
        if not any(c):
            break
        nxt = tuple(1 + n // 2 if ci else n for n, ci in zip(shapes[-1], c))
        if len(shapes) >= 3 and math.prod(n - 2 for n in nxt) < min_cells:
            break
        masks.append(c)
        shapes.append(nxt)
    return masks


def _pair_sum(a, axis):
    n = a.shape[axis]
    return (a[(slice(None),) * axis + (slice(0, n, 2),)]
            + a[(slice(None),) * axis + (slice(1, n, 2),)])


def restrict(b: torch.Tensor, c) -> torch.Tensor:
    a = interior(b)
    for d, ci in enumerate(c):
        if ci:
            a = _pair_sum(a, d)
    return grow(a)


def prolongate(b: torch.Tensor, c) -> torch.Tensor:
    a = interior(b)
    for d, ci in enumerate(c):
        if ci:
            a = torch.repeat_interleave(a, 2, dim=d)
    return grow(a)


def restrict_L(Lf: torch.Tensor, c, perdir) -> torch.Tensor:
    """Coarse face coefficients (`restrictL`): the normal direction keeps
    the first fine face of each pair and halves it, the tangential
    coarsened directions sum pairs; ghosts from the zero-velocity BC."""
    D = Lf.shape[0]
    comps = []
    for i in range(D):
        a = interior(Lf[i])
        for d, ci in enumerate(c):
            if not ci:
                continue
            if d == i:
                a = a[(slice(None),) * d + (slice(0, a.shape[d], 2),)]
            else:
                a = _pair_sum(a, d)
        if c[i]:
            a = a / 2
        comps.append(grow(a))
    return bc_vector(torch.stack(comps), (0.0,) * D, perdir)


def _mult_raw(lv: Level, x: torch.Tensor) -> torch.Tensor:
    s = x * lv.Dg
    for i in range(lv.L.shape[0]):
        s = s + shift(x, i, -1) * lv.L[i] + shift(x, i, 1) * shift(lv.L[i], i, 1)
    return zero_ghost(s)


def dense_pinv(lv: Level, perdir) -> Level:
    """The coarsest level's pseudo-inverse over its interior cells (its
    operator applied to the identity basis; singular values cut at
    ``10·n·eps`` of the largest).  Formed in float64 at least and held in
    the level's dtype (no bfloat16 inverse exists)."""
    sp = tuple(lv.Dg.shape)
    inner = tuple(d - 2 for d in sp)
    n = math.prod(inner)
    if n > DENSE_COARSE_MAX:
        return lv
    work = torch.float64
    nd = len(sp)
    x = grow(torch.eye(n, dtype=work, device=lv.Dg.device).reshape((n,) + inner), nd)
    x = per_bc(x, perdir, lead=1)
    L, Dg = lv.L.to(work), lv.Dg.to(work)
    s = x * Dg
    for i in range(L.shape[0]):
        s = s + shift(x, i + 1, -1) * L[i] + shift(x, i + 1, 1) * shift(L[i], i, 1)
    A = interior(s, nd).reshape(n, n)
    eps = torch.finfo(lv.Dg.dtype).eps
    Ainv = torch.linalg.pinv(A, rtol=10 * n * eps)
    return lv._replace(Ainv=Ainv.to(lv.Dg.dtype))


def make_levels(mu0: torch.Tensor, perdir) -> tuple[list[Level], list]:
    masks = level_masks(tuple(mu0.shape[1:]))
    levels, L = [make_level(mu0)], mu0
    for c in masks:
        L = restrict_L(L, c, perdir)
        levels.append(make_level(L))
    levels[-1] = dense_pinv(levels[-1], perdir)
    return levels, masks


def _norms(r: torch.Tensor) -> tuple[float, float]:
    a = torch.abs(r)
    return torch.sum(a).item(), torch.max(a).item()


def residual(lv: Level, x, z, perdir) -> torch.Tensor:
    """``r = z − A·x``, zero where the diagonal is zero, the interior mean
    removed unless it is within 2·eps of zero (`Poisson.jl:92-98`)."""
    r = zero_ghost(torch.where(lv.iD == 0, 0.0, z - _mult_raw(lv, per_bc(x, perdir))))
    s = torch.sum(r) / math.prod(n - 2 for n in r.shape)
    eps2 = 2 * torch.finfo(r.dtype).eps
    return r - torch.where(torch.abs(s) <= eps2, 0.0, s) * zero_ghost(torch.ones_like(r))


def increment(lv: Level, x, r, eps, omega, perdir):
    eps = per_bc(eps, perdir)
    return x + omega * zero_ghost(eps), r - omega * _mult_raw(lv, eps)


def jacobi(lv: Level, x, r, perdir):
    return increment(lv, x, r, zero_ghost(r * lv.iD), 1.0, perdir)


def gauss_seidel_rb(lv: Level, x, r, it: int, omega, perdir):
    """``it`` red-black sweeps of the correction from ``r·iD``, each after
    the periodic ghost copies, then the increment (`GaussSeidelRB!`)."""
    D = lv.L.shape[0]
    par, ins = parity(r.shape, r.device), inside(r.shape, r.device)
    eps = zero_ghost(r * lv.iD)
    for k0 in range(1, it + 1):
        colour = (1 - D - k0) % 2
        eps = per_bc(eps, perdir)
        s = r
        for i in range(D):
            s = s - (shift(eps, i, -1) * lv.L[i] + shift(eps, i, 1) * shift(lv.L[i], i, 1))
        eps = torch.where((par == colour) & ins, s * lv.iD, eps)
    return increment(lv, x, r, eps, omega, perdir)


def coarse_solve(lv: Level, x, r, it, omega, perdir):
    if lv.Ainv is None:
        return gauss_seidel_rb(lv, x, r, it, omega, perdir)
    inner = tuple(d - 2 for d in r.shape)
    eps = grow(torch.sum(lv.Ainv * interior(r).reshape(-1)[None, :], dim=1).reshape(inner))
    return increment(lv, x, r, eps, 1.0, perdir)


def v_cycle(levels, masks, x, r, omega, l: int, smooth_it: int, perdir):
    """`Vcycle!` (`MultiLevelPoisson.jl:88-101`): a Jacobi pre-smooth,
    restrict, recurse, smooth the coarse level, prolongate, increment."""
    fine, coarse, c = levels[l], levels[l + 1], masks[l]
    x, r = jacobi(fine, x, r, perdir)
    rc = restrict(r, c)
    xc = torch.zeros_like(rc)
    if l + 1 < len(levels) - 1:
        xc, rc = v_cycle(levels, masks, xc, rc, omega, l + 1, smooth_it, perdir)
    xc, rc = coarse_solve(coarse, xc, rc, smooth_it, omega, perdir)
    return increment(fine, x, r, prolongate(xc, c), omega, perdir)


def solve(levels, masks, x, z, tol: float, itmx: int, perdir, smooth_it: int = 4):
    """`solver!` (`MultiLevelPoisson.jl:108-128`): V-cycles, each followed
    by a fine red-black smooth, with ω ∈ [0.2, 1] (×0.9 when the L1 norm of
    the residual did not drop, ×1.02 when it did), until
    ``L1 < tol/10·N`` and ``Linf < tol`` or ``itmx`` iterations; then the
    active interior's mean removed.  Returns ``(x, iterations)``."""
    fine, dtype = levels[0], x.dtype
    r1tol = _rnd(tol / 10 * math.prod(n - 2 for n in x.shape), dtype)
    rinf_tol = _rnd(tol, dtype)
    r = residual(fine, x, z, perdir)
    r1, rinf = _norms(r)
    omega, n = 1.0, 0
    while n < itmx and (n == 0 or not (r1 < r1tol and rinf < rinf_tol)):
        x, r = v_cycle(levels, masks, x, r, omega, 0, smooth_it, perdir)
        x, r = gauss_seidel_rb(fine, x, r, smooth_it, omega, perdir)
        rnew, rinf = _norms(r)
        if rnew >= r1:
            omega = max(_rnd(0.2, dtype), _rnd(_rnd(0.9, dtype) * omega, dtype))
        else:
            omega = min(1.0, _rnd(_rnd(1.02, dtype) * omega, dtype))
        r1 = rnew
        n += 1
    ins = zero_ghost(torch.ones_like(x))
    act = torch.where(fine.iD != 0, ins, 0.0)
    m = torch.sum(x * act) / torch.clamp(torch.sum(act), min=1.0)
    x = torch.where(act > 0, x - m, x * (1.0 - ins))
    return per_bc(x, perdir), n


# ---------------------------------------------------------------- the step
class Case(NamedTuple):
    """What a step needs besides the fields: the constant boundary
    velocity, ν, the periodic directions and the solver's tolerance and
    iteration cap."""
    ubc: tuple
    nu: float
    perdir: tuple = ()
    tol: float = 2e-3
    itmx: int = 32


def project(u, p, levels, masks, dt_w: float, case: Case):
    """`mom_project!` (`Flow.jl:223-232`): solve ``A x = ∇·u`` from
    ``p·dt_w``, ``u_i −= L_i ∂_i x``, `BC!`, ``p = x/dt_w``."""
    x, n = solve(levels, masks, p * dt_w, div(u), case.tol, case.itmx, case.perdir)
    L = levels[0].L
    u = torch.stack([u[i] - zero_ghost(L[i] * (x - shift(x, i, -1)))
                     for i in range(u.shape[0])])
    return bc_vector(u, case.ubc, case.perdir), x / dt_w, n


def mom_step(u, p, V, mu0, mu1, levels, masks, dt: float, case: Case):
    """One time step from ``(u, p)``: returns ``(u, p, dt_next,
    [iterations of the two projections])``."""
    u0 = u
    u = bdim(scale_interior(u0, 0.0), u0, conv_diff(u0, case.nu, case.perdir),
             V, mu0, mu1, dt)
    u = bc_vector(u, case.ubc, case.perdir)
    u, p, n1 = project(u, p, levels, masks, dt, case)
    u = bdim(u, u0, conv_diff(u, case.nu, case.perdir), V, mu0, mu1, dt)
    u = bc_vector(scale_interior(u, 0.5), case.ubc, case.perdir)
    u, p, n2 = project(u, p, levels, masks, 0.5 * dt, case)
    dt_next = min(10.0, 1.0 / (cfl_max(u) + 5 * case.nu))
    return u, p, dt_next, [n1, n2]


def static_step(side, u, p, dt: float, t: float):
    """`mom_step` on the moments and levels of ``side`` (`compare.Side`),
    for a configuration whose body does not move: ``t``, the time before
    the step, is not needed.  Returns `mom_step`'s result and the levels
    it stepped on."""
    V, mu0, mu1 = side.moments
    return (*mom_step(u, p, V, mu0, mu1, side.levels, side.masks, dt, side.case),
            side.levels)
