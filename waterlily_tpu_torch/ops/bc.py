"""Boundary conditions as whole-tensor ops.

PyTorch counterpart of `waterlily_tpu/ops/bc.py`: `BC!`, `perBC!`,
`exitBC!` (`src/core.jl:192-243`) and `apply!` for a vector field
(`src/Flow.jl:76-83`).  Each function returns a new tensor; the slab writes
happen in place on that copy.

A boundary spec ``ubc`` is either a tuple of ``D`` numbers (constant
Dirichlet velocity) or a callable ``ubc(i, x, t) -> scalar`` with 0-based
component ``i``, position ``x`` a ``(D,)`` tensor and time ``t`` a 0-d tensor
(the reference's `uBC(i,x,t)`, `src/WaterLily.jl:50-52`), written with torch
ops so that `torch.func` can batch and differentiate it.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from .grid import loc_grid, slab

__all__ = ["eval_points", "bc_field", "bc_vector", "per_bc", "exit_bc",
           "apply_vector"]


def eval_points(f, pts: torch.Tensor, dtype) -> torch.Tensor:
    """``f(x)`` at every row ``x`` of ``pts`` (``(M, D)``) with `vmap`; a
    result that is a Python number or does not depend on ``x`` is spread
    over the points."""
    def at(x):
        v = f(x)
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(
            v, dtype=dtype, device=pts.device)

    return vmap(at)(pts).to(dtype)


def bc_field(ubc, i: int, shape: tuple[int, ...], j: int, idx: int, t, dtype,
             device) -> torch.Tensor | float:
    """Boundary value of component ``i`` on the slab ``idx`` of direction
    ``j`` (`bc_field`, the JAX package evaluates the whole face grid and
    slices; here only the slab's face points are evaluated).  A constant
    tuple gives its float; a callable gives a tensor of the slab's shape
    (extent 1 along ``j``) at time ``t``."""
    if not callable(ubc):
        return float(ubc[i])
    idx %= shape[j]
    sshape = shape[:j] + (1,) + shape[j + 1:]
    coords = loc_grid(i, sshape, dtype, device)
    coords[j] += idx                      # loc_grid counted the slab from 0
    t = torch.as_tensor(t, dtype=dtype, device=device)
    pts = coords.reshape(len(shape), -1).T
    return eval_points(lambda x: ubc(i, x, t), pts, dtype).reshape(sshape)


def bc_vector(u: torch.Tensor, ubc, t=0.0, save_exit: bool = False,
              perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """Apply domain BCs to a vector field ``u`` of shape ``(D, *Ng)``
    (`src/core.jl:199-224`).

    Dirichlet on the normal component (ghost slab and first interior face),
    ``u_g = U_g + (u − U)|neighbour`` for the tangential components (a copy
    of the neighbour for a constant spec, where ``U_g − U`` cancels),
    periodic wrap for the directions in ``perdir``; ``save_exit`` keeps the
    ``i=0`` exit plane.  The (i, j) loop order and slab update order match
    the JAX `bc_vector`, so corner ghosts agree bitwise.  ``t`` matters for
    a callable spec only."""
    D, shape = u.shape[0], tuple(u.shape[1:])
    u = u.clone()

    def U(i, j, idx):
        return bc_field(ubc, i, shape, j, idx, t, u.dtype, u.device)

    for i in range(D):
        ui = u[i]
        for j in range(D):
            n = shape[j]
            if j in perdir:
                slab(ui, j, 0).copy_(slab(ui, j, n - 2))
                slab(ui, j, n - 1).copy_(slab(ui, j, 1))
            elif i == j:  # normal component: Dirichlet
                _set(slab(ui, j, 0), U(i, j, 0))
                if not (save_exit and i == 0):
                    _set(slab(ui, j, n - 1), U(i, j, n - 1))
                _set(slab(ui, j, 1), U(i, j, 1))
            elif callable(ubc):  # tangential: u_g = U_g + (u - U)|neighbour
                slab(ui, j, 0).copy_(U(i, j, 0) + slab(ui, j, 1) - U(i, j, 1))
                slab(ui, j, n - 1).copy_(U(i, j, n - 1) + slab(ui, j, n - 2)
                                         - U(i, j, n - 2))
            else:  # tangential, constant spec: u_g = u at the neighbour
                slab(ui, j, 0).copy_(slab(ui, j, 1))
                slab(ui, j, n - 1).copy_(slab(ui, j, n - 2))
    return u


def _set(view: torch.Tensor, v) -> None:
    """Write a boundary value (a float, or a tensor of the slab's shape)."""
    if isinstance(v, torch.Tensor):
        view.copy_(v)
    else:
        view.fill_(v)


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
    comps = []
    for i in range(D):
        pts = loc_grid(i, shape, dtype, device).reshape(D, -1).T
        comps.append(eval_points(lambda x, i=i: f(i, x), pts, dtype).reshape(shape))
    return torch.stack(comps)
