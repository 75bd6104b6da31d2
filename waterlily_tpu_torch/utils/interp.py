"""Multilinear field sampling and dimension spreading.

PyTorch counterpart of `waterlily_tpu/utils/interp.py` (the port of
`src/util.jl:17-43,78-128`): the reference's clamped, staggered-aware
sampling.  The JAX package samples one point and vmaps it; here a query is
``(D,)`` or a batch ``(N, D)`` of points along a leading axis, sampled with
gathers on the field's device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch

__all__ = ["interp_scalar", "interp_vector", "squeeze", "spread",
           "spread_sim"]


def _interp_core(x: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """Multilinear samples of ``arr`` at the 0-based array coordinates
    ``x + 0.5`` of the rows of ``x`` (``(N, D)``) (`_interp`,
    `util.jl:33-43`)."""
    D = arr.dim()
    xx = x + 0.5
    i0 = torch.floor(xx).long()
    y = xx - i0
    s = torch.zeros(x.shape[0], dtype=arr.dtype, device=arr.device)
    for corner in itertools.product((0, 1), repeat=D):
        w = torch.prod(torch.stack([y[:, d] if c else 1 - y[:, d]
                                    for d, c in enumerate(corner)], dim=1), dim=1)
        s = s + arr[tuple(i0[:, d] + c for d, c in enumerate(corner))] * w
    return s


def _clamp(x: torch.Tensor, shape) -> torch.Tensor:
    """The query clamped into ``[0, n − 2]`` per dimension, the valid
    interpolation domain (`_interp_clamp`, `util.jl:17-18`)."""
    hi = torch.tensor([n - 2 for n in shape], dtype=x.dtype, device=x.device)
    return torch.minimum(torch.clamp(x, min=0.0), hi)


def _points(x, like: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """The query as an ``(N, D)`` tensor of ``like``'s dtype and device, and
    whether it was one point."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return (x[None], True) if x.dim() == 1 else (x, False)


def interp_scalar(x, arr: torch.Tensor) -> torch.Tensor:
    """Sample a scalar field at world coordinates ``x`` (``(D,)`` or
    ``(N, D)``) (`interp`, `util.jl:29-31`): a 0-d or ``(N,)`` tensor."""
    pts, one = _points(x, arr)
    s = _interp_core(_clamp(pts, arr.shape), arr)
    return s[0] if one else s


def interp_vector(x, u: torch.Tensor) -> torch.Tensor:
    """Sample a staggered vector field ``(D, *Ng)`` at ``x`` (``(D,)`` or
    ``(N, D)``): each component's query moves +½ in its own direction
    before the clamp (`interp`, `util.jl:22-27`).  A ``(D,)`` or ``(N, D)``
    tensor."""
    D = u.shape[0]
    pts, one = _points(x, u)
    out = []
    for i in range(D):
        sh = torch.zeros(D, dtype=u.dtype, device=u.device)
        sh[i] = 0.5
        out.append(_interp_core(_clamp(pts + sh, u.shape[1:]), u[i]))
    v = torch.stack(out, dim=1)
    return v[0] if one else v


def squeeze(a: torch.Tensor) -> torch.Tensor:
    """Drop singleton dims (`squeeze`, `util.jl:78`)."""
    return torch.squeeze(a)


def spread(src: torch.Tensor, n_new: int, dim: int = 2, lead: int = 0,
           noise: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Extrude a field along a new spatial axis of length ``n_new`` inserted
    at spatial position ``dim`` (``lead`` leading component axes), plus
    uniform noise of amplitude ``noise`` drawn from ``generator`` (default:
    one seeded with 0) (`spread!`, `util.jl:102-127`)."""
    ax = lead + dim
    out = src.unsqueeze(ax).expand(src.shape[:ax] + (n_new,) + src.shape[ax:])
    if noise != 0.0:
        out = out + noise * _uniform(out, generator)
    return out


def _uniform(like: torch.Tensor, generator) -> torch.Tensor:
    if generator is None:
        generator = torch.Generator(device=like.device).manual_seed(0)
    return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def spread_sim(sim3d, sim2d, dim: int = 2, noise: float = 0.0,
               generator: Optional[torch.Generator] = None):
    """Extrude a 2-D simulation's state into a 3-D one (the simulation-level
    `spread!`, `util.jl:102-127`): ``u``'s in-plane components extruded
    along the new (0-based) axis ``dim``, its out-of-plane component zero,
    plus uniform noise of amplitude ``noise`` from ``generator``; ``p``
    extruded; ``u0 = u``.  Raises `ValueError` when the in-plane grids
    differ or the bodies' signed distances differ in the middle plane."""
    s2, s3 = sim2d.flow.cfg.shape, sim3d.flow.cfg.shape
    plane = tuple(n for d, n in enumerate(s3) if d != dim)
    if plane != tuple(s2):
        raise ValueError(f"in-plane grids differ: {plane} vs {s2}")
    ix = tuple(slice(None) if d != dim else s3[dim] // 2 for d in range(3))
    sd2 = sim2d.sdf_field().cpu().double()
    sd3 = sim3d.sdf_field()[ix].cpu().double()
    if not torch.allclose(sd2, sd3, atol=1e-4):
        raise ValueError("2D and 3D bodies do not match in the spread plane")
    st2, st3 = sim2d.flow.state, sim3d.flow.state
    dtype, dev = st3.u.dtype, st3.u.device
    comps, k2 = [], 0
    for i in range(3):
        if i == dim:
            comps.append(torch.zeros(s3, dtype=dtype, device=dev))
        else:
            comps.append(spread(st2.u[k2].to(dtype=dtype, device=dev), s3[dim], dim))
            k2 += 1
    u = torch.stack(comps)
    if noise != 0.0:
        u = u + noise * _uniform(u, generator)
    p = spread(st2.p.to(dtype=dtype, device=dev), s3[dim], dim).contiguous()
    sim3d.flow.state = dataclasses.replace(st3, u=u, u0=u, p=p)
    return sim3d
