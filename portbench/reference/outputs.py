"""Plain reference of the output the users read: the force on a body
(`Metrics.jl:126-160`) and the kinetic energy and enstrophy of the
interior (`Metrics.jl:33-86`), summed in float64."""
from __future__ import annotations

import math

import torch

from .measure import BLOCK_POINTS, distance_normal, face_points
from .solver import grow, interior, shift


def dudx(i: int, j: int, u: torch.Tensor) -> torch.Tensor:
    """∂u_i/∂x_j at the cell centres: the staggered difference for i = j,
    the four-point average of the two neighbouring differences otherwise."""
    if i == j:
        return shift(u[i], i, 1) - u[i]
    a, b = shift(u[i], j, 1), shift(u[i], j, -1)
    return (a + shift(a, i, 1) - b - shift(b, i, 1)) / 4


def nds(sdf, shape, dtype, device) -> torch.Tensor:
    """``n·K(d)`` at every interior cell centre (`nds`, `Metrics.jl:116-119`),
    ghosts zero; ``K(d) = (1 + cos πd)/2`` on |d| ≤ 1."""
    D = len(shape)
    inner = tuple(n - 2 for n in shape)
    out = torch.zeros((D,) + inner, dtype=dtype, device=device)
    rows = max(1, BLOCK_POINTS // math.prod(inner[1:]))
    for a in range(1, shape[0] - 1, rows):
        xr = (a, min(shape[0] - 1, a + rows))
        d, n = distance_normal(sdf, face_points(None, shape, xr, dtype, device))
        k = (1 + torch.cos(math.pi * torch.clamp(d, -1.0, 1.0))) / 2
        out[:, xr[0] - 1:xr[1] - 1] = (n * k[:, None]).T.reshape(
            (D, xr[1] - xr[0]) + inner[1:])
    return torch.stack([grow(out[i]) for i in range(D)])


def force(u: torch.Tensor, p: torch.Tensor, nu: float, sdf) -> list[float]:
    """Pressure plus viscous force on the body: ``∮ p n dS − ∮ 2ν S·n dS``
    with the BDIM surface measure, summed in float64."""
    w = nds(sdf, tuple(p.shape), u.dtype, u.device)
    total = [torch.sum((p * w[i]).to(torch.float64)).item() for i in range(3)]
    for i in range(3):
        for j in range(3):
            s = (dudx(i, j, u) + dudx(j, i, u)) / 2
            total[i] += torch.sum((-2.0 * nu * s * w[j]).to(torch.float64)).item()
    return total


def ke_enstrophy(u: torch.Tensor) -> list[float]:
    """Mean kinetic energy ``½|u|²`` and enstrophy ``|∇×u|²`` over the
    interior cells."""
    n = math.prod(s - 2 for s in u.shape[1:])
    ke = sum((u[i] + shift(u[i], i, 1)) ** 2 for i in range(3)) * 0.125
    w2 = sum((dudx((i + 2) % 3, (i + 1) % 3, u) - dudx((i + 1) % 3, (i + 2) % 3, u)) ** 2
             for i in range(3))
    return [torch.sum(interior(ke).to(torch.float64)).item() / n,
            torch.sum(interior(w2).to(torch.float64)).item() / n]
