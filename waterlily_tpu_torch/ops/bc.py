"""Boundary conditions as whole-tensor ops.

PyTorch counterpart of `waterlily_tpu/ops/bc.py`: `BC!`, `perBC!`,
`exitBC!` (`src/core.jl:192-243`) and `apply!` for a vector field
(`src/Flow.jl:76-83`).  Each function returns a new tensor; the slab writes
happen in place on that copy.

A boundary spec ``ubc`` is a tuple of ``D`` numbers: constant Dirichlet
velocity.  A callable ``ubc(i, x, t)`` is not supported yet (ROADMAP queue 1,
item 10).
"""
from __future__ import annotations

import torch
from torch.func import vmap

from .grid import loc_grid, slab

__all__ = ["bc_field", "bc_vector", "per_bc", "exit_bc", "apply_vector"]

_CALLABLE_UBC = ("callable ubc/g/u0 are not ported yet "
                 "(ROADMAP queue 1, item 10: remaining flow configurations)")


def bc_field(ubc, i: int) -> float:
    """Boundary value of component ``i`` for a constant tuple spec (the JAX
    `bc_field` returns the same 0-d value for tuples)."""
    if callable(ubc):
        raise NotImplementedError(_CALLABLE_UBC)
    return float(ubc[i])


def bc_vector(u: torch.Tensor, ubc, t=0.0, save_exit: bool = False,
              perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """Apply domain BCs to a vector field ``u`` of shape ``(D, *Ng)``
    (`src/core.jl:199-224`).

    Dirichlet on the normal component (ghost slab and first interior face),
    zero-gradient copy for the tangential components, periodic wrap for the
    directions in ``perdir``; ``save_exit`` keeps the ``i=0`` exit plane.  The
    (i, j) loop order and slab update order match the JAX `bc_vector`, so
    corner ghosts agree bitwise.  ``t`` is unused for constant specs."""
    D, shape = u.shape[0], u.shape[1:]
    u = u.clone()
    for i in range(D):
        ui = u[i]
        Ui = bc_field(ubc, i)
        for j in range(D):
            n = shape[j]
            if j in perdir:
                slab(ui, j, 0).copy_(slab(ui, j, n - 2))
                slab(ui, j, n - 1).copy_(slab(ui, j, 1))
            elif i == j:  # normal component: Dirichlet
                slab(ui, j, 0).fill_(Ui)
                if not (save_exit and i == 0):
                    slab(ui, j, n - 1).fill_(Ui)
                slab(ui, j, 1).fill_(Ui)
            else:  # tangential, constant spec: u_g = u at the neighbour
                slab(ui, j, 0).copy_(slab(ui, j, 1))
                slab(ui, j, n - 1).copy_(slab(ui, j, n - 2))
    return u


def per_bc(a: torch.Tensor, perdir: tuple[int, ...], lead: int = 0) -> torch.Tensor:
    """Periodic ghost update of a field (`perBC!`, `src/core.jl:239-243`);
    ``lead`` counts leading component axes."""
    if not perdir:
        return a
    a = a.clone()
    for j in perdir:
        ax = lead + j
        n = a.shape[ax]
        slab(a, ax, 0).copy_(slab(a, ax, n - 2))
        slab(a, ax, n - 1).copy_(slab(a, ax, 1))
    return a


def exit_bc(u: torch.Tensor, u_old: torch.Tensor, dt) -> torch.Tensor:
    """1-D convective outlet on the ``i=0`` exit plane plus the mass-flux
    correction (`exitBC!`, `src/core.jl:226-233`): the exit plane of ``u``
    takes ``u_old``'s convected by the mean inflow ``u_in`` over ``dt``,
    shifted so that its mean equals ``u_in``.  Run at construction
    (`exitBC!(u,u,0)`, `Flow.jl:141`) and, with ``exit_bc=True``, after the
    predictor's `BC!` of every step (`Flow.jl:160`)."""
    D = u.shape[0]
    inner = (slice(1, -1),) * (D - 1)
    exit_ix = (0, slice(-1, None)) + inner
    prev_ix = (0, slice(-2, -1)) + inner
    in_ix = (0, slice(1, 2)) + inner
    u_in = torch.mean(u[in_ix])
    ue = u_old[exit_ix]
    new = ue - u_in * dt * (ue - u_old[prev_ix])
    new = new - (torch.mean(new) - u_in)
    u = u.clone()
    u[exit_ix] = new
    return u


def apply_vector(f, D: int, shape: tuple[int, ...], dtype, device) -> torch.Tensor:
    """A vector field with ``f(i, x)`` at the face-``i`` location of every
    cell, ghosts included (`apply!`, `src/Flow.jl:81-83`); ``f`` is written
    with torch ops on a ``(D,)`` point and is batched with `vmap`."""
    def at(i, x):
        v = f(i, x)
        return v if isinstance(v, torch.Tensor) else torch.tensor(v, dtype=dtype)

    comps = []
    for i in range(D):
        pts = loc_grid(i, shape, dtype, device).reshape(D, -1).T
        comps.append(vmap(lambda x, i=i: at(i, x))(pts).reshape(shape))
    return torch.stack(comps).to(dtype)
