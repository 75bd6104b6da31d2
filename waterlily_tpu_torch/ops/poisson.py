"""Matrix-free variable-coefficient Poisson operator and smoothers.

PyTorch counterpart of `waterlily_tpu/ops/poisson.py` (the port of
`src/Poisson.jl`).  The system is

    A x = [L + D + L'] x = z,   D[I] = -sum_i (L[I,i] + L[I+e_i,i])

with face coefficients ``L`` of shape ``(D, *Ng)`` (the BDIM moment ``mu0``
on the fine level, `src/WaterLily.jl:97`).  Every op returns new tensors.
The A·x product and the smoothers route 3-D float32 CUDA fields to the hand
kernels of `ops/stencil3d.py`; everything else is plain torch.

Periodic directions (``perdir``): each op refreshes the periodic ghosts of
the field it reads first (`per_bc`, the single-device `sync_scalar` of the
JAX `ops/dist.py`; `psum_all`/`pmax_all` are the identity and the inside
count is the interior cell count).  With ``perdir`` the Jacobi smoother is
the plain increment (its A·x is K16) and the red-black smoother is K13's
colour sweeps then the increment, as in the JAX `poisson.py:134,163-172`;
without it both are K15.  `pcg` and `solve` are the standalone
Jacobi-preconditioned conjugate-gradient solver that ``psolver="pcg"``
injects in place of the multigrid one; its A·x is K16 as well.

Under domain decomposition (``ctx``, `ops/dist.py`) each op refreshes the
ghosts of the field it reads by ring halos (`dist.sync_scalar`), the means
and norms are sums and maxima over the shards, and the red-black colours
carry the shard's global parity (`dist.parity_shift`).  Under ``ctx`` the
multigrid ops are plain PyTorch, as the JAX gate `pallas3d.use_pallas(a,
ctx)` keeps the 3d engine's kernels to one device; `pcg` keeps K16 for its
A·x on every shard, and the flat engine's solve (`ops/mgflat.py`) keeps
its kernels under ``ctx``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import tracing
from . import stencil3d as st
from .bc import per_bc
from .dist import (global_inside_count, parity_shift, pmax_all, psum_all,
                   sync_scalar)
from .grid import grow, index_sum_parity, inside_mask, interior, shift, zero_ghost

__all__ = [
    "PoissonLevel", "make_level", "with_bf16", "set_diag", "mult", "residual",
    "null_space_fix", "increment",
    "jacobi", "gauss_seidel_rb", "norms", "dense_pinv",
    "coarse_solve", "pcg", "solve", "stop_tolerances",
]


class PoissonLevel(NamedTuple):
    L: torch.Tensor    # (D, *Ng) lower-face coefficients
    D: torch.Tensor    # (*Ng) diagonal, 0 in ghosts
    iD: torch.Tensor   # (*Ng) 1/diagonal, 0 where D == 0
    Ainv: Optional[torch.Tensor] = None   # dense pseudo-inverse over the
                                          # interior, coarsest level only
    bf: Optional[tuple] = None            # (L, D, iD) as bfloat16, on the
                                          # levels that smooth in mixed
                                          # precision (`with_bf16`)


def set_diag(L: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagonal and its guarded inverse (`Poisson.jl:43-55`)."""
    d = torch.zeros(L.shape[1:], dtype=L.dtype, device=L.device)
    for i in range(L.shape[0]):
        d = d - (L[i] + shift(L[i], i, 1))
    d = zero_ghost(d)
    iD = torch.where(d == 0, torch.zeros_like(d), 1.0 / torch.where(d == 0, 1.0, d))
    return d, iD


def make_level(L: torch.Tensor) -> PoissonLevel:
    """PoissonLevel from face coefficients (`Poisson.jl:43-55`).  ``L`` is
    held, not copied."""
    d, iD = set_diag(L)
    return PoissonLevel(L, d, iD)


def with_bf16(p: PoissonLevel) -> PoissonLevel:
    """The level with bfloat16 copies of ``L``, ``D`` and ``iD`` beside the
    float32 ones, for the mixed-precision smoother.  Made once when the level
    is built or updated (the JAX wrapper casts on every call, under jit:
    `pallas_flat.py:881-883`)."""
    return p._replace(bf=tuple(t.to(torch.bfloat16) for t in (p.L, p.D, p.iD)))


def _mult_raw(p: PoissonLevel, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """A·x on the interior, zero ghosts (`mult`, `Poisson.jl:70-76`), the
    ghosts of ``x`` taken as they are; the K16 kernel for 3-D float32 CUDA
    fields on one device."""
    if ctx is None and st.use_kernels(x):
        return st.mult_k(x, p.L, p.D)
    return st.mult_plain(x, p.L, p.D)


def mult(p: PoissonLevel, x: torch.Tensor,
         perdir: tuple[int, ...] = (), ctx=None) -> torch.Tensor:
    """A·x with the periodic (or halo) ghosts of ``x`` refreshed first
    (`mult!`, `Poisson.jl:63-68`)."""
    return _mult_raw(p, sync_scalar(x, ctx, perdir), ctx)


def _inside_ones(x: torch.Tensor) -> torch.Tensor:
    return zero_ghost(torch.ones_like(x))


def null_space_fix(r: torch.Tensor, ctx=None) -> torch.Tensor:
    """Remove the interior mean of a residual whose ghosts and dead cells
    are zero, unless it is within 2·eps of zero (`Poisson.jl:92-98`); the
    mean is over the global interior under ``ctx``."""
    s = psum_all(torch.sum(r), ctx) / global_inside_count(ctx, tuple(r.shape))
    eps2 = 2 * torch.finfo(r.dtype).eps
    return r - torch.where(torch.abs(s) <= eps2, 0.0, s) * _inside_ones(r)


def residual(p: PoissonLevel, x: torch.Tensor, z: torch.Tensor,
             perdir: tuple[int, ...] = (), ctx=None) -> torch.Tensor:
    """r = z - A·x with the two null-space fixes of `Poisson.jl:92-98`:
    r = 0 where iD == 0, and the interior mean removed unless it is within
    2·eps of zero (`null_space_fix`)."""
    r = torch.where(p.iD == 0, 0.0, z - mult(p, x, perdir, ctx))
    return null_space_fix(zero_ghost(r), ctx)


def increment(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor,
              eps: torch.Tensor, omega=1.0, perdir: tuple[int, ...] = (),
              ctx=None):
    """x += ω·eps, r -= ω·A·eps on the interior (`increment!`,
    `Poisson.jl:100-104`), the periodic (or halo) ghosts of ``eps``
    refreshed first."""
    eps = sync_scalar(eps, ctx, perdir)
    r = r - omega * _mult_raw(p, eps, ctx)
    x = x + omega * zero_ghost(eps)
    return x, r


def jacobi(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor, it: int = 1,
           omega=1.0, perdir: tuple[int, ...] = (), ctx=None):
    """Jacobi smoother (`Jacobi!`, `Poisson.jl:111-114`); the K15 kernel
    with no colours for 3-D float32 CUDA fields, the plain increment with
    ``perdir`` or ``ctx``."""
    for _ in range(it):
        if perdir or ctx is not None:
            x, r = increment(p, x, r, zero_ghost(r * p.iD), omega, perdir, ctx)
        elif st.use_kernels(x):
            x, r = st.gs_incr_k(x, r, p.L, p.D, p.iD, [], omega)
        else:
            x, r = st.gs_incr_plain(x, r, p.L, p.D, p.iD, [], omega)
    return x, r


def gauss_seidel_rb(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor,
                    it: int = 4, omega=1.0, perdir: tuple[int, ...] = (),
                    ctx=None):
    """Red-black Gauss-Seidel smoother (`GaussSeidelRB!`,
    `Poisson.jl:141-148`): sweep ``k0`` updates the interior cells whose
    1-based index sum has parity ``(k0+1) % 2``, i.e. 0-based parity
    ``(1 - Dim - k0) % 2``; then the increment.  The K15 kernel for 3-D
    float32 CUDA fields; with ``perdir`` the colour sweeps (K13, each after
    a periodic ghost refresh) then the increment; with ``ctx`` `dist_sweeps`
    then the increment."""
    Dim = p.L.shape[0]
    colors = [(1 - Dim - k0) % 2 for k0 in range(1, it + 1)]
    if ctx is not None:
        eps = dist_sweeps(p, r, colors, perdir, ctx)
        return increment(p, x, r, eps, omega, perdir, ctx)
    if perdir:
        eps = zero_ghost(r * p.iD)
        if st.use_kernels(x):
            eps = st.gauss_sweeps_k(eps, r, p.L, p.iD, colors, perdir)
        else:
            eps = st.gauss_sweeps_plain(eps, r, p.L, p.iD, colors, perdir)
        return increment(p, x, r, eps, omega, perdir)
    if st.use_kernels(x):
        return st.gs_incr_k(x, r, p.L, p.D, p.iD, colors, omega)
    return st.gs_incr_plain(x, r, p.L, p.D, p.iD, colors, omega)


def dist_sweeps(p: PoissonLevel, r: torch.Tensor, colors, perdir, ctx):
    """The red-black colour sweeps of a distributed level (the JAX
    `gauss_seidel_rb` and `gauss_seidel_rb_flat` under ``ctx``), plain
    PyTorch: ``eps = r·iD`` with zero ghosts, then per colour a halo refresh
    of ``eps`` and the update of the interior cells whose global index-sum
    parity is the colour."""
    shape = tuple(r.shape)
    par = (index_sum_parity(shape, r.device) + parity_shift(ctx, shape)) % 2
    inside = inside_mask(shape, r.device)
    eps = zero_ghost(r * p.iD)
    for c in colors:
        eps = sync_scalar(eps, ctx, perdir)
        eps = torch.where((par == c) & inside, st._gauss(r, eps, p.L, p.iD), eps)
    return eps


# interior-cell cap for the dense coarse solve (`poisson._DENSE_COARSE_MAX`)
DENSE_COARSE_MAX = 1024


def dense_pinv(p: PoissonLevel, perdir: tuple[int, ...] = ()) -> PoissonLevel:
    """Attach the dense pseudo-inverse of the level operator over its
    interior cells (exact coarse-grid solve; JAX `dense_pinv`).  A is
    assembled by applying the stencil to the identity basis, whose periodic
    ghosts are refreshed first (so a periodic A has its constant null
    space); the pinv cuts singular values at ``10·n·eps`` of the largest, as
    `jnp.linalg.pinv` does (torch's own default is ``n·eps``)."""
    sp = tuple(p.D.shape)
    inner = tuple(d - 2 for d in sp)
    n = math.prod(inner)
    if n > DENSE_COARSE_MAX:
        return p
    dtype = p.D.dtype
    nd = len(sp)
    eye = torch.eye(n, dtype=dtype, device=p.D.device)
    x = grow(eye.reshape((n,) + inner), nd)       # (n, *sp): one basis vector each
    x = per_bc(x, perdir, lead=1)
    s = x * p.D
    for i in range(p.L.shape[0]):
        s = s + shift(x, i + 1, -1) * p.L[i] + shift(x, i + 1, 1) * shift(p.L[i], i, 1)
    A = interior(s, nd).reshape(n, n)             # symmetric
    Ainv = torch.linalg.pinv(A, rtol=10 * n * torch.finfo(dtype).eps)
    return PoissonLevel(p.L, p.D, p.iD, Ainv)


def coarse_solve(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor,
                 it: int = 4, omega=1.0, perdir: tuple[int, ...] = (), ctx=None):
    """Coarsest-level solve: ``eps = A⁺ r`` when the level carries ``Ainv``
    (then a full, unrelaxed increment; a replicated level), else red-black
    GS sweeps (distributed under ``ctx``).  The matvec is multiply + sum,
    not a matmul, as in the JAX package."""
    if p.Ainv is None:
        return gauss_seidel_rb(p, x, r, it, omega, perdir, ctx)
    inner = tuple(d - 2 for d in r.shape)
    ri = interior(r).reshape(-1)
    eps = grow(torch.sum(p.Ainv * ri[None, :], dim=1).reshape(inner))
    return increment(p, x, r, eps, 1.0, perdir)


def norms(r: torch.Tensor, ctx=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(L1, Linf) of the residual as device scalars; ghosts are zero so the
    full-tensor reductions equal the interior ones (`Poisson.jl:188-191`).
    A sum and a max over the shards under ``ctx``."""
    a = torch.abs(r)
    return psum_all(torch.sum(a), ctx), pmax_all(torch.max(a), ctx)


def _pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interior dot product (`perdot`, `Poisson.jl:153-158`)."""
    return torch.sum(interior(a) * interior(b))


def pcg(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor, it: int = 6,
        perdir: tuple[int, ...] = (), ctx=None):
    """Jacobi-preconditioned conjugate gradient with the reference's
    early-exit guards (`pcg!`, `Poisson.jl:166-186`): stop when ρ falls
    below ``10·eps(dtype)``, when α leaves [1e-2, 1e2] (that iteration then
    moves nothing) or after ``it`` iterations.  All ``it`` iterations are
    issued with no host read: once the stop flag ``go`` is down, the step
    length is 0 and the search direction restarts from the preconditioned
    residual, so ``x`` and ``r`` stay bit for bit where the JAX
    `lax.while_loop` stops, with no full-field select.

    Under ``ctx`` the search direction's ghosts are halo-refreshed before
    A·x and the three dot products are sums over the shards, which every
    shard gets bit for bit, so every shard stops where the others do.  A·x
    is K16 on every 3-D float32 CUDA field, on one device or on a shard
    (the direction's ghosts are refreshed: the kernel reads them as
    given)."""
    tiny = 10 * torch.finfo(x.dtype).eps
    eps = zero_ghost(r * p.iD)
    rho = psum_all(torch.sum(r * eps), ctx)
    go = torch.abs(rho) >= tiny
    for i in range(it):
        epsb = sync_scalar(eps, ctx, perdir)
        zz = _mult_raw(p, epsb)
        alpha = rho / psum_all(_pdot(zz, epsb), ctx)
        bad = (torch.abs(alpha) < 1e-2) | (torch.abs(alpha) > 1e2)
        a = torch.where(go & ~bad, alpha, 0.0)
        x = x + a * zero_ghost(epsb)
        r = r - a * zz
        z2 = zero_ghost(r * p.iD)
        rho2 = psum_all(torch.sum(r * z2), ctx)
        more = go & ~bad & (i + 1 < it) & (torch.abs(rho2) >= tiny)
        eps = zero_ghost(torch.where(more, rho2 / rho, 0.0) * epsb + z2)
        rho = torch.where(go, rho2, rho)
        go = more
    return x, r


def stop_tolerances(x: torch.Tensor, tol: float, ctx=None) -> tuple[float, float]:
    """The dual-norm stop ``L1 < tol/10·N_inside`` ∧ ``Linf < tol``
    (`Poisson.jl:194`) as host floats rounded to ``x``'s dtype, so that a
    comparison with a norm read back from the device is the dtype's;
    ``N_inside`` is the global interior count under ``ctx``."""
    npdt = torch.empty((), dtype=x.dtype).numpy().dtype.type
    return (float(npdt((tol / 10.0) * global_inside_count(ctx, tuple(x.shape)))),
            float(npdt(tol)))


def solve(p: PoissonLevel, x: torch.Tensor, z: torch.Tensor, tol: float = 2e-3,
          itmx: int = 1000, perdir: tuple[int, ...] = (), ctx=None):
    """Standalone PCG Poisson solver (`solver!`, `Poisson.jl:212-223`): a
    do-while of `pcg` (6 inner iterations) bounded by ``itmx`` outer
    iterations, stopped by ``L1 < tol/10·N`` ∧ ``Linf < tol`` (both in the
    working dtype), reading the two norms back once per outer iteration.
    Returns ``(x, r, iters, stats)`` with ``x``'s periodic ghosts refreshed
    (no gauge is pinned) and ``stats`` the rows ``(r_inf, r_1, 0.0)``, row 0
    at entry: the layout of the multigrid rows with ω = 0.  Under ``ctx``
    (one shard of a decomposed level) the norms and ``N`` are global, the
    same on every shard bit for bit, and ``x``'s ghosts are
    halo-refreshed."""
    with tracing.span("wlt.solve") as sp:
        r1tol, rinf_tol = stop_tolerances(x, tol, ctx)
        r = residual(p, x, z, perdir, ctx)
        nv = torch.stack(norms(r, ctx))
        with tracing.span("wlt.read", what="norms"):
            r1, rinf = nv.tolist()
        stats = [(rinf, r1, 0.0)]
        n = 0
        while n < itmx and (n == 0 or not (r1 < r1tol and rinf < rinf_tol)):
            x, r = pcg(p, x, r, it=6, perdir=perdir, ctx=ctx)
            nv = torch.stack(norms(r, ctx))
            with tracing.span("wlt.read", what="norms"):
                r1, rinf = nv.tolist()
            n += 1
            stats.append((rinf, r1, 0.0))
        x = sync_scalar(x, ctx, perdir)
        sp.set(iters=n)
    return x, r, n, stats
