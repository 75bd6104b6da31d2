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
without it both are K15.  The PCG solver is not ported yet (ROADMAP queue
1, item 13).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import stencil3d as st
from .bc import per_bc
from .grid import grow, interior, shift, zero_ghost

__all__ = [
    "PoissonLevel", "make_level", "with_bf16", "set_diag", "mult", "residual",
    "increment",
    "jacobi", "gauss_seidel_rb", "norms", "dense_pinv",
    "coarse_solve",
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


def _mult_raw(p: PoissonLevel, x: torch.Tensor) -> torch.Tensor:
    """A·x on the interior, zero ghosts (`mult`, `Poisson.jl:70-76`); the
    K16 kernel for 3-D float32 CUDA fields."""
    if st.use_kernels(x):
        return st.mult_k(x, p.L, p.D)
    return st.mult_plain(x, p.L, p.D)


def mult(p: PoissonLevel, x: torch.Tensor,
         perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """A·x with the periodic ghosts of ``x`` refreshed first (`mult!`,
    `Poisson.jl:63-68`)."""
    return _mult_raw(p, per_bc(x, perdir))


def _inside_ones(x: torch.Tensor) -> torch.Tensor:
    return zero_ghost(torch.ones_like(x))


def residual(p: PoissonLevel, x: torch.Tensor, z: torch.Tensor,
             perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """r = z - A·x with the two null-space fixes of `Poisson.jl:92-98`:
    r = 0 where iD == 0, and the interior mean removed unless it is within
    2·eps of zero."""
    r = torch.where(p.iD == 0, 0.0, z - mult(p, x, perdir))
    r = zero_ghost(r)
    n_inside = math.prod(n - 2 for n in x.shape)
    s = torch.sum(r) / n_inside
    eps2 = 2 * torch.finfo(x.dtype).eps
    r = r - torch.where(torch.abs(s) <= eps2, 0.0, s) * _inside_ones(x)
    return r


def increment(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor,
              eps: torch.Tensor, omega=1.0, perdir: tuple[int, ...] = ()):
    """x += ω·eps, r -= ω·A·eps on the interior (`increment!`,
    `Poisson.jl:100-104`), the periodic ghosts of ``eps`` refreshed
    first."""
    eps = per_bc(eps, perdir)
    r = r - omega * _mult_raw(p, eps)
    x = x + omega * zero_ghost(eps)
    return x, r


def jacobi(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor, it: int = 1,
           omega=1.0, perdir: tuple[int, ...] = ()):
    """Jacobi smoother (`Jacobi!`, `Poisson.jl:111-114`); the K15 kernel
    with no colours for 3-D float32 CUDA fields, the plain increment with
    ``perdir``."""
    for _ in range(it):
        if perdir:
            x, r = increment(p, x, r, zero_ghost(r * p.iD), omega, perdir)
        elif st.use_kernels(x):
            x, r = st.gs_incr_k(x, r, p.L, p.D, p.iD, [], omega)
        else:
            x, r = st.gs_incr_plain(x, r, p.L, p.D, p.iD, [], omega)
    return x, r


def gauss_seidel_rb(p: PoissonLevel, x: torch.Tensor, r: torch.Tensor,
                    it: int = 4, omega=1.0, perdir: tuple[int, ...] = ()):
    """Red-black Gauss-Seidel smoother (`GaussSeidelRB!`,
    `Poisson.jl:141-148`): sweep ``k0`` updates the interior cells whose
    1-based index sum has parity ``(k0+1) % 2``, i.e. 0-based parity
    ``(1 - Dim - k0) % 2``; then the increment.  The K15 kernel for 3-D
    float32 CUDA fields; with ``perdir`` the colour sweeps (K13, each after
    a periodic ghost refresh) then the increment."""
    Dim = p.L.shape[0]
    colors = [(1 - Dim - k0) % 2 for k0 in range(1, it + 1)]
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
                 it: int = 4, omega=1.0, perdir: tuple[int, ...] = ()):
    """Coarsest-level solve: ``eps = A⁺ r`` when the level carries ``Ainv``
    (then a full, unrelaxed increment), else red-black GS sweeps.  The
    matvec is multiply + sum, not a matmul, as in the JAX package."""
    if p.Ainv is None:
        return gauss_seidel_rb(p, x, r, it, omega, perdir)
    inner = tuple(d - 2 for d in r.shape)
    ri = interior(r).reshape(-1)
    eps = grow(torch.sum(p.Ainv * ri[None, :], dim=1).reshape(inner))
    return increment(p, x, r, eps, 1.0, perdir)


def norms(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(L1, Linf) of the residual as device scalars; ghosts are zero so the
    full-tensor reductions equal the interior ones (`Poisson.jl:188-191`)."""
    a = torch.abs(r)
    return torch.sum(a), torch.max(a)
