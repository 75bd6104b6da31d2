"""Multigrid pressure solve of the flat engine, on dense levels.

PyTorch counterpart of `waterlily_tpu/ops/mgflat.py` (`solve_mg_flat`,
`_v_cycle_flat`) without its layout half: the TPU keeps its large levels in
the ``(x, y·z)`` lane layout, the port keeps every level dense, so the level
stack is `ops/multigrid.py`'s and restriction and prolongation are its
`restrict`/`prolongate`.

The algorithm is `multigrid.solve_mg`'s (`solver!`,
`MultiLevelPoisson.jl:88-128`: the same stop rule, ω update, stats rows and
`canonical_gauge`, through `multigrid.solve_loop`) with the launch structure
of the flat engine: each lower level's coarse-correction increment is the
K6 increment (`fused3d.incr_gs_k` with no colours), and the fine level's
increment is deferred and fused with the fine red-black smooth into one K7
call that also returns the stop rule's ``(L1, Linf)``.  The fused norms
reduce in another order than `poisson.norms`, so near the tolerance the
iteration count may differ by one from `solve_mg` (`mgflat.py:271-275`).
"""
from __future__ import annotations

import torch

from . import fused3d as fz
from . import stencil3d as st
from .multigrid import MGSolveResult, prolongate, restrict, solve_loop
from .poisson import PoissonLevel, coarse_solve, jacobi

__all__ = ["solve_mg_flat"]


def _incr_gs(p: PoissonLevel, x, r, eps, colors, omega, want_norms=False):
    """`fused3d.incr_gs_k` for 3-D float32 CUDA fields, else its plain
    version."""
    if st.use_kernels(x):
        return fz.incr_gs_k(x, r, eps, p.L, p.D, p.iD, colors, omega, want_norms)
    return fz.incr_gs_plain(x, r, eps, p.L, p.D, p.iD, colors, omega, want_norms)


def _v_cycle_flat(levels, masks, x: torch.Tensor, r: torch.Tensor, omega,
                  smooth_it: int = 4, l: int = 0, presmooth: bool = True):
    """One V-cycle level step (`Vcycle!`, `MultiLevelPoisson.jl:88-101`):
    Jacobi pre-smooth, restrict, recurse, smooth the coarse level
    (`coarse_solve`), prolongate.  Below the fine level the increment
    follows (K6); at the fine level it is deferred: returns
    ``(x, r, eps)`` for the caller's fused tail."""
    fine, coarse = levels[l], levels[l + 1]
    c = masks[l]
    if presmooth or l > 0:
        x, r = jacobi(fine, x, r, it=1, omega=1.0)
    rc = restrict(r, c)
    xc = torch.zeros_like(rc)
    if l + 1 < len(levels) - 1:
        xc, rc = _v_cycle_flat(levels, masks, xc, rc, omega, smooth_it, l + 1)
    xc, rc = coarse_solve(coarse, xc, rc, it=smooth_it, omega=omega)
    eps = prolongate(xc, c)
    if l == 0:
        return x, r, eps
    return _incr_gs(fine, x, r, eps, [], omega)


def solve_mg_flat(levels, masks, x: torch.Tensor, z: torch.Tensor,
                  tol: float = 2e-3, itmx: int = 32, smooth_it: int = 4,
                  fine_smooth_it: int = 0,
                  fine_presmooth: bool = True) -> MGSolveResult:
    """Multigrid solve with the fused fine tail (`solve_mg_flat`,
    `mgflat.py:254-349`): per iteration a V-cycle with the fine increment
    deferred, then one `incr_gs` of that increment and the fine red-black
    smooth, whose in-kernel ``(L1, Linf)`` feed the stop rule."""
    p = levels[0]
    Dim = p.L.shape[0]
    colors = [(1 - Dim - k0) % 2 for k0 in range(1, (fine_smooth_it or smooth_it) + 1)]

    def iterate(x, r, omega):
        x, r, eps = _v_cycle_flat(levels, masks, x, r, omega, smooth_it,
                                  presmooth=fine_presmooth)
        return _incr_gs(p, x, r, eps, colors, omega, want_norms=True)

    return solve_loop(p, x, z, tol, itmx, iterate)
