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

With periodic directions (``perdir``) there is no fused tail
(`mgflat.py:300`): every increment, the Jacobi pre-smooth included, is K6
on an ``eps`` whose periodic ghosts were refreshed (`increment_flat`,
`jacobi_flat`, `ops/flat.py:470-507`), and every red-black smooth is K13's
colour sweeps then K6.  The JAX flat engine runs that smoother as jnp
(`gauss_seidel_rb_flat`'s periodic branch, `ops/flat.py:510-545`); the port
runs K13 there, the same arithmetic.  The coarsest level's dense solve
stays `poisson.coarse_solve`, as in the JAX engine's replicated tail, and
the stop rule's norms are `poisson.norms`.

Mixed precision (``mp``, `mgflat.py:186-224, 305-317`): in float32 with no
periodic direction, the smoothers of the levels the TPU keeps in its flat
layout (the fine level and each level below it with at least
`FLAT_MIN_CELLS` padded cells, `mp_levels`) run their bf16 instantiations:
the Jacobi pre-smooth and the coarse red-black smooth K15 with ``mp``, the
fused fine tail K7 with ``mp``.  The smaller levels, the K6 increments, the
entry residual, the norms, the stop rule and the gauge stay float32.
"""
from __future__ import annotations

import torch

from . import fused3d as fz
from . import stencil3d as st
from .bc import per_bc
from .grid import zero_ghost
from .multigrid import MGSolveResult, prolongate, restrict, solve_loop
from .poisson import PoissonLevel, coarse_solve, jacobi, norms, with_bf16

__all__ = ["solve_mg_flat", "mp_applies", "mp_levels", "FLAT_MIN_CELLS"]

# padded cells below which the TPU keeps a level out of its flat layout, and
# with that out of the mixed-precision smoother (`mgflat._FLAT_MIN_CELLS`)
FLAT_MIN_CELLS = 100_000


def mp_applies(mp: bool, dtype: torch.dtype, perdir: tuple[int, ...]) -> bool:
    """Whether ``mp_smooth`` takes effect: in float32 with no periodic
    direction (`pallas_flat.use_pallas_flat`, `flat.py:502, 524`)."""
    return bool(mp) and dtype == torch.float32 and not perdir


def mp_levels(levels) -> tuple[PoissonLevel, ...]:
    """The stack with bf16 coefficient copies on the levels that smooth in
    mixed precision: the fine level and every level below it down to the
    first one with fewer than `FLAT_MIN_CELLS` padded cells
    (`mgflat._n_flat`)."""
    out, flat = [], True
    for l, p in enumerate(levels):
        flat = flat and (l == 0 or p.D.numel() >= FLAT_MIN_CELLS)
        out.append(with_bf16(p) if flat else p)
    return tuple(out)


def _incr_gs(p: PoissonLevel, x, r, eps, colors, omega, want_norms=False,
             mp=False):
    """`fused3d.incr_gs_k` for 3-D float32 CUDA fields, else its plain
    version; with ``mp`` on the level's bf16 coefficients."""
    mp = mp and p.bf is not None
    name = "incr_gs_mp_k" if mp else "incr_gs_k"
    fn = fz.incr_gs_k if st.use_kernels(x, name) else fz.incr_gs_plain
    L, D, iD = p.bf if mp else (p.L, p.D, p.iD)
    return fn(x, r, eps, L, D, iD, colors, omega, want_norms, mp)


def _gs_incr(p: PoissonLevel, x, r, colors, omega):
    """The mixed-precision K15 (`stencil3d.gs_incr_k(mp=True)`) for 3-D
    float32 CUDA fields, else its plain version."""
    fn = (st.gs_incr_k if st.use_kernels(x, "gs_incr_mp_k")
          else st.gs_incr_plain)
    return fn(x, r, *p.bf, colors, omega, True)


def _colors(p: PoissonLevel, it: int) -> list[int]:
    """The colour sequence of `poisson.gauss_seidel_rb` for ``it`` sweeps."""
    Dim = p.L.shape[0]
    return [(1 - Dim - k0) % 2 for k0 in range(1, it + 1)]


def _increment(p: PoissonLevel, x, r, eps, omega, perdir):
    """`increment!` as K6, the periodic ghosts of ``eps`` refreshed
    first."""
    return _incr_gs(p, x, r, per_bc(eps, perdir), [], omega)


def _jacobi(p: PoissonLevel, x, r, perdir, mp=False):
    """One Jacobi pre-smooth: K15 (no colours) on a non-periodic level, K6
    on ``eps = r·iD`` with ``perdir``."""
    if mp and p.bf is not None:
        return _gs_incr(p, x, r, [], 1.0)
    if not perdir:
        return jacobi(p, x, r, it=1, omega=1.0)
    return _increment(p, x, r, zero_ghost(r * p.iD), 1.0, perdir)


def _gauss_seidel_rb(p: PoissonLevel, x, r, it, omega, perdir):
    """The periodic red-black smoother: K13's colour sweeps, then K6."""
    eps = zero_ghost(r * p.iD)
    if st.use_kernels(x):
        eps = st.gauss_sweeps_k(eps, r, p.L, p.iD, _colors(p, it), perdir)
    else:
        eps = st.gauss_sweeps_plain(eps, r, p.L, p.iD, _colors(p, it), perdir)
    return _increment(p, x, r, eps, omega, perdir)


def _coarse_solve(p: PoissonLevel, x, r, it, omega, perdir, mp=False):
    """`poisson.coarse_solve`, its periodic smoother `_gauss_seidel_rb`, its
    mixed-precision smoother `_gs_incr`."""
    if mp and p.bf is not None and p.Ainv is None:
        return _gs_incr(p, x, r, _colors(p, it), omega)
    if perdir and p.Ainv is None:
        return _gauss_seidel_rb(p, x, r, it, omega, perdir)
    return coarse_solve(p, x, r, it=it, omega=omega, perdir=perdir)


def _v_cycle_flat(levels, masks, x: torch.Tensor, r: torch.Tensor, omega,
                  smooth_it: int = 4, l: int = 0, presmooth: bool = True,
                  perdir: tuple[int, ...] = (), mp: bool = False):
    """One V-cycle level step (`Vcycle!`, `MultiLevelPoisson.jl:88-101`):
    Jacobi pre-smooth, restrict, recurse, smooth the coarse level
    (`coarse_solve`), prolongate.  Below the fine level the increment
    follows (K6); at the fine level it is deferred: returns
    ``(x, r, eps)`` for the caller's tail."""
    fine, coarse = levels[l], levels[l + 1]
    c = masks[l]
    if presmooth or l > 0:
        x, r = _jacobi(fine, x, r, perdir, mp)
    rc = restrict(r, c)
    xc = torch.zeros_like(rc)
    if l + 1 < len(levels) - 1:
        xc, rc = _v_cycle_flat(levels, masks, xc, rc, omega, smooth_it, l + 1,
                               perdir=perdir, mp=mp)
    xc, rc = _coarse_solve(coarse, xc, rc, smooth_it, omega, perdir, mp)
    eps = prolongate(xc, c)
    if l == 0:
        return x, r, eps
    return _increment(fine, x, r, eps, omega, perdir)


def solve_mg_flat(levels, masks, x: torch.Tensor, z: torch.Tensor,
                  tol: float = 2e-3, itmx: int = 32, smooth_it: int = 4,
                  fine_smooth_it: int = 0, fine_presmooth: bool = True,
                  perdir: tuple[int, ...] = (),
                  mp: bool = False) -> MGSolveResult:
    """Multigrid solve with the fused fine tail (`solve_mg_flat`,
    `mgflat.py:254-349`): per iteration a V-cycle with the fine increment
    deferred, then one `incr_gs` of that increment and the fine red-black
    smooth, whose in-kernel ``(L1, Linf)`` feed the stop rule.  With
    ``perdir`` the increment, the periodic smooth and `poisson.norms`
    instead.  ``mp`` (where `mp_applies`) needs the stack of `mp_levels`."""
    p = levels[0]
    it_fine = fine_smooth_it or smooth_it
    mp = mp_applies(mp, x.dtype, perdir)
    if mp and p.bf is None:
        raise ValueError("solve_mg_flat: mp=True needs the bf16 coefficient "
                         "copies of `mgflat.mp_levels(levels)`")

    def iterate(x, r, omega):
        x, r, eps = _v_cycle_flat(levels, masks, x, r, omega, smooth_it,
                                  presmooth=fine_presmooth, perdir=perdir,
                                  mp=mp)
        if perdir:
            x, r = _increment(p, x, r, eps, omega, perdir)
            x, r = _gauss_seidel_rb(p, x, r, it_fine, omega, perdir)
            return x, r, torch.stack(norms(r))
        return _incr_gs(p, x, r, eps, _colors(p, it_fine), omega,
                        want_norms=True, mp=mp)

    return solve_loop(p, x, z, tol, itmx, iterate, perdir)
