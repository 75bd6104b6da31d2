"""Geometric multigrid with semi-coarsening for the pressure Poisson equation.

PyTorch counterpart of `waterlily_tpu/ops/multigrid.py` (the port of
`src/MultiLevelPoisson.jl`).  The level stack is a tuple of `PoissonLevel`s
whose shapes and coarsening masks are plain Python data; restriction and
prolongation are pair sums and `repeat_interleave` on the interior.

The outer iteration (`MultiLevelPoisson.jl:108-128`) is a host loop: each
iteration reads ``(L1, Linf)`` of the residual back once, tests the
dual-norm stop and updates the adaptive relaxation ω on the host in the
working dtype, exactly as the JAX `lax.while_loop` does on the device.  The
distributed branches and the implicit-JVP wrapper `solve_mg_implicit` (whose
forward pass is `solve_mg`) are not ported yet (ROADMAP queue 1, items 12
and 14).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .bc import bc_vector
from .grid import grow, interior
from .poisson import (_inside_ones, coarse_solve, dense_pinv, gauss_seidel_rb,
                      increment, jacobi, make_level, norms, residual)

__all__ = [
    "divisible", "coarsen_mask", "coarse_shape", "level_shapes",
    "restrict", "prolongate", "restrict_L", "make_mg", "update_mg",
    "v_cycle", "solve_loop", "solve_mg", "canonical_gauge", "MGSolveResult",
    "MIN_COARSE_CELLS",
]

# interior-cell floor of the coarse levels on the flow path (the JAX
# package's `_MIN_COARSE_CELLS` default)
MIN_COARSE_CELLS = 64


def divisible(n: int) -> bool:
    """A padded dimension can be coarsened if even and > 4
    (`MultiLevelPoisson.jl:52`)."""
    return n % 2 == 0 and n > 4


def coarsen_mask(shape: tuple[int, ...]) -> tuple[bool, ...]:
    """Per-direction semi-coarsening decision (`MultiLevelPoisson.jl:29-31`)."""
    return tuple(divisible(n) for n in shape)


def coarse_shape(shape: tuple[int, ...], c: tuple[bool, ...]) -> tuple[int, ...]:
    """Padded shape one level down (`MultiLevelPoisson.jl:52-54`)."""
    return tuple(1 + n // 2 if ci else n for n, ci in zip(shape, c))


def level_shapes(shape: tuple[int, ...], maxlevels: int = 10,
                 min_cells: int = 0):
    """Shapes and per-transition coarsening masks of the level stack
    (`MultiLevelPoisson.jl:68-77`); ``min_cells > 0`` stops before a level
    would drop below that interior-cell count once three levels exist."""
    shapes, masks = [tuple(shape)], []
    while any(coarsen_mask(shapes[-1])) and len(shapes) <= maxlevels:
        c = coarsen_mask(shapes[-1])
        nxt = coarse_shape(shapes[-1], c)
        if len(shapes) >= 3 and math.prod(n - 2 for n in nxt) < min_cells:
            break
        masks.append(c)
        shapes.append(nxt)
    if len(shapes) <= 2:
        raise ValueError("MultiLevelPoisson requires size=a2^n, where n>2")
    return shapes, masks


def _pair_sum(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum adjacent pairs along ``axis`` (even length)."""
    n = a.shape[axis]
    lo = (slice(None),) * axis + (slice(0, n, 2),)
    hi = (slice(None),) * axis + (slice(1, n, 2),)
    return a[lo] + a[hi]


def restrict(b: torch.Tensor, c: tuple[bool, ...]) -> torch.Tensor:
    """Residual restriction: sum the fine children of each coarse cell
    (`restrict`, `MultiLevelPoisson.jl:16-19,49`)."""
    a = interior(b)
    for d, ci in enumerate(c):
        if ci:
            a = _pair_sum(a, d)
    return grow(a)


def prolongate(b: torch.Tensor, c: tuple[bool, ...]) -> torch.Tensor:
    """Injection prolongation: each fine interior cell copies its coarse
    parent, ghosts zero (`MultiLevelPoisson.jl:8,50`)."""
    a = interior(b)
    for d, ci in enumerate(c):
        if ci:
            a = torch.repeat_interleave(a, 2, dim=d)
    return grow(a)


def restrict_L(Lf: torch.Tensor, c: tuple[bool, ...]) -> torch.Tensor:
    """Restrict face coefficients (`restrictL`, `MultiLevelPoisson.jl:10-26,
    42-47`): the face-normal direction keeps the fine face at the pair start
    and is halved when coarsened; tangential coarsened directions pair-sum;
    boundary faces come from the zero-velocity vector BC."""
    D = Lf.shape[0]
    comps = []
    for i in range(D):
        a = interior(Lf[i])
        for d, ci in enumerate(c):
            if not ci:
                continue
            if d == i:
                n = a.shape[d]
                a = a[(slice(None),) * d + (slice(0, n, 2),)]
            else:
                a = _pair_sum(a, d)
        if c[i]:
            a = a / 2
        comps.append(grow(a))
    return bc_vector(torch.stack(comps), (0.0,) * D)


def make_mg(mu0: torch.Tensor, maxlevels: int = 10, min_cells: int = 0):
    """Level stack from the fine face coefficients; returns
    ``(levels, masks)`` with ``masks`` plain Python data."""
    _, masks = level_shapes(tuple(mu0.shape[1:]), maxlevels, min_cells)
    return update_mg(tuple(masks), mu0), tuple(masks)


def update_mg(masks, mu0: torch.Tensor):
    """Re-restrict the coefficients down every level (`update!`,
    `MultiLevelPoisson.jl:79-86`) and attach the coarsest level's dense
    pseudo-inverse."""
    new = [make_level(mu0)]
    L = mu0
    for c in masks:
        L = restrict_L(L, c)
        new.append(make_level(L))
    new[-1] = dense_pinv(new[-1])
    return tuple(new)


def v_cycle(levels, masks, x: torch.Tensor, r: torch.Tensor, omega,
            l: int = 0, smooth_it: int = 4, presmooth: bool = True):
    """One V-cycle (`Vcycle!`, `MultiLevelPoisson.jl:88-101`): Jacobi
    pre-smooth, restrict the residual, recurse, coarse solve, prolongate and
    increment."""
    fine, coarse = levels[l], levels[l + 1]
    c = masks[l]
    if presmooth or l > 0:
        x, r = jacobi(fine, x, r, it=1, omega=1.0)
    rc = restrict(r, c)
    xc = torch.zeros_like(rc)
    if l + 1 < len(levels) - 1:
        xc, rc = v_cycle(levels, masks, xc, rc, omega, l + 1, smooth_it)
    xc, rc = coarse_solve(coarse, xc, rc, it=smooth_it, omega=omega)
    eps = prolongate(xc, c)
    return increment(fine, x, r, eps, omega)


class MGSolveResult(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    iters: int
    stats: list          # per iteration (r_inf, r_1, omega), row 0 = entry


def solve_loop(p, x: torch.Tensor, z: torch.Tensor, tol: float, itmx: int,
               iterate) -> MGSolveResult:
    """The outer iteration of `solver!` (`MultiLevelPoisson.jl:108-128`): a
    do-while of ``iterate(x, r, omega) -> (x, r, norms)`` (``norms`` the
    device 2-vector ``(L1, Linf)`` of the new residual, read back once per
    iteration), adaptive ω ∈ [0.2, 1] (×0.9 when the L1 norm did not drop,
    ×1.02 when it did) and the dual-norm stop ``L1 < tol/10·N`` ∧
    ``Linf < tol``, then `canonical_gauge` on the fine level ``p``."""
    npdt = np.dtype(str(x.dtype).replace("torch.", ""))
    r1tol = float(npdt.type((tol / 10.0) * math.prod(n - 2 for n in x.shape)))
    rinf_tol = float(npdt.type(tol))
    r = residual(p, x, z)
    r1, rinf = torch.stack(norms(r)).tolist()     # one device→host read
    omega = npdt.type(1.0)
    stats = [(rinf, r1, float(omega))]
    n = 0
    while n < itmx and (n == 0 or not (r1 < r1tol and rinf < rinf_tol)):
        x, r, nv = iterate(x, r, float(omega))
        rnew, rinf = nv.tolist()
        if rnew >= r1:
            omega = max(npdt.type(0.2), npdt.type(0.9) * omega)
        else:
            omega = min(npdt.type(1.0), npdt.type(1.02) * omega)
        r1 = rnew
        n += 1
        stats.append((rinf, r1, float(omega)))
    x = canonical_gauge(x, p.iD)
    return MGSolveResult(x, r, n, stats)


def solve_mg(levels, masks, x: torch.Tensor, z: torch.Tensor,
             tol: float = 2e-3, itmx: int = 32, smooth_it: int = 4,
             fine_smooth_it: int = 0,
             fine_presmooth: bool = True) -> MGSolveResult:
    """Multigrid pressure solve (`solver!`, `MultiLevelPoisson.jl:108-128`):
    `solve_loop` over a V-cycle plus the fine red-black smooth."""
    p = levels[0]

    def iterate(x, r, omega):
        x, r = v_cycle(levels, masks, x, r, omega, 0, smooth_it,
                       presmooth=fine_presmooth)
        x, r = gauss_seidel_rb(p, x, r, it=fine_smooth_it or smooth_it,
                               omega=omega)
        return x, r, torch.stack(norms(r))

    return solve_loop(p, x, z, tol, itmx, iterate)


def canonical_gauge(x: torch.Tensor, iD: torch.Tensor) -> torch.Tensor:
    """Pin the pressure representative (JAX `canonical_gauge`): active
    interior cells (iD ≠ 0) get zero mean, dead interior cells get zero,
    ghosts keep their values."""
    inside = _inside_ones(x)
    act = torch.where(iD != 0, inside, 0.0)
    n_act = torch.sum(act)
    m = torch.sum(x * act) / torch.clamp(n_act, min=1.0)
    return torch.where(act > 0, x - m, x * (1.0 - inside))
