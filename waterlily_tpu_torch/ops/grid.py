"""Grid conventions, index algebra and shift primitives.

PyTorch counterpart of `waterlily_tpu/ops/grid.py`, itself the rebuild of the
reference index-algebra layer (`src/core.jl:26-61,170-190`).  Stencils are
whole-tensor shifts, slab selections and broadcast index coordinates.

Conventions (identical to the JAX package, 0-based indexing):

* A scalar field has shape ``Ng = N + 2`` per spatial dim: ``N`` interior cells
  plus one ghost cell per side.  Interior cells are indices ``1..Ng-2``.
* A vector field is stored component-first: shape ``(D, *Ng)``.  ``u[i]``
  lives on the lower ``i``-face of its cell (marker-and-cell staggering).
* A tensor field has shape ``(D, D, *Ng)``.
* World coordinates (`src/core.jl:177-178`): the center of cell ``I`` is at
  ``x = I - 0.5`` per dim; the ``i``-face is at ``x_i = I_i - 1`` in dim ``i``
  and at the center in the others.  The interior spans ``[0, N]``.

Every constructor takes an explicit ``device`` and ``dtype``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = [
    "shift", "interior", "set_interior", "grow", "slab", "set_slab",
    "loc_grid", "index_sum_parity", "inside_mask", "zero_ghost",
]


def shift(a: torch.Tensor, axis: int, s: int) -> torch.Tensor:
    """Return ``b`` with ``b[I] = a[I + s*e_axis]``, wrapping at the ends.

    Same semantics as the JAX `shift` (`jnp.roll(a, -s, axis)`): the wrapped
    values land only in cells whose stencil would leave the grid in the
    reference, and callers mask or overwrite those slabs."""
    if s == 0:
        return a
    return torch.roll(a, -s, axis)


def interior(a: torch.Tensor, d: int | None = None, buff: int = 1) -> torch.Tensor:
    """Slice off ``buff`` ghost layers from the trailing ``d`` spatial dims
    (`inside(a; buff)`, `src/core.jl:47`); ``d`` defaults to all dims."""
    if d is None:
        d = a.dim()
    if buff == 0:
        return a
    ix = (slice(None),) * (a.dim() - d) + (slice(buff, -buff),) * d
    return a[ix]


def set_interior(a: torch.Tensor, values: torch.Tensor,
                 d: int | None = None) -> torch.Tensor:
    """Copy of ``a`` with the interior of the trailing ``d`` dims replaced."""
    if d is None:
        d = a.dim()
    ix = (slice(None),) * (a.dim() - d) + (slice(1, -1),) * d
    out = a.clone()
    out[ix] = values
    return out


def grow(values: torch.Tensor, d: int | None = None, fill=0) -> torch.Tensor:
    """Pad ``values`` with one ghost layer of constant ``fill`` on the
    trailing ``d`` spatial dims."""
    if d is None:
        d = values.dim()
    return F.pad(values, (1, 1) * d, value=float(fill))


def slab(a: torch.Tensor, axis: int, idx: int) -> torch.Tensor:
    """The hyperplane ``a[..., idx, ...]`` at ``axis``, keeping the dim."""
    return a.narrow(axis, idx % a.shape[axis], 1)


def set_slab(a: torch.Tensor, axis: int, idx: int, values) -> torch.Tensor:
    """Copy of ``a`` with the hyperplane at ``axis``/``idx`` set to
    ``values`` (a tensor that broadcasts to the slab, or a number)."""
    out = a.clone()
    s = slab(out, axis, idx)
    if isinstance(values, torch.Tensor):
        s.copy_(values)
    else:
        s.fill_(values)
    return out


def loc_grid(i: int | None, shape: tuple[int, ...], dtype: torch.dtype,
             device: torch.device | str, offset=None) -> torch.Tensor:
    """World coordinates of every grid point, shape ``(D, *shape)``.

    ``i`` is the 0-based face component (``None`` for cell centers); with
    0-based index ``I`` the coordinate is ``I - 0.5 - 0.5*δ_{di}`` in dim
    ``d`` (`loc(i,I,T)`, `src/core.jl:177-178`).  ``offset`` (per dim)
    shifts a shard's local indices to global ones under domain
    decomposition (`dist.offsets`)."""
    D = len(shape)
    coords = []
    for d in range(D):
        view = [1] * D
        view[d] = shape[d]
        c = torch.arange(shape[d], dtype=dtype, device=device).reshape(view) - 0.5
        if offset is not None and offset[d]:
            c = c + offset[d]
        if i is not None and d == i:
            c = c - 0.5
        coords.append(c.expand(shape))
    return torch.stack(coords)


def index_sum_parity(shape: tuple[int, ...],
                     device: torch.device | str) -> torch.Tensor:
    """``(sum_d I_d) % 2`` over the grid: the red/black checkerboard color."""
    s = torch.zeros(shape, dtype=torch.int32, device=device)
    for d in range(len(shape)):
        view = [1] * len(shape)
        view[d] = shape[d]
        s = s + torch.arange(shape[d], dtype=torch.int32,
                             device=device).reshape(view)
    return s % 2


@functools.lru_cache(maxsize=64)
def _inside(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[(slice(1, -1),) * len(shape)] = True
    return m


def inside_mask(shape: tuple[int, ...],
                device: torch.device | str) -> torch.Tensor:
    """Boolean mask of interior cells (ghost layer False).  Cached per shape
    and device; callers must not write to it."""
    return _inside(tuple(shape), torch.device(device))


def zero_ghost(a: torch.Tensor, nd: int | None = None) -> torch.Tensor:
    """Zero the ghost layer of the trailing ``nd`` spatial dims with a select
    (not a mask multiply), so NaN and inf in ghosts behave as in the JAX
    package's `jnp.where` form."""
    nd = a.dim() if nd is None else nd
    return torch.where(inside_mask(a.shape[a.dim() - nd:], a.device), a, 0.0)
