"""Plain reference of the body measure: the BDIM moments from a signed
distance function.

WaterLily's `measure!` (`Body.jl:28-51`) for a static body: at every face
of component i the distance d and the unit normal n (the gradient of the
distance, by `torch.autograd` on the batched function), the distance's sign
taken from the cell centre outside |d| ≤ ½, then inside the band
``σ² < (2+ε)²`` around the surface ``μ0 = K0(d/ε)``, ``μ1 = ε·K1(d/ε)·n``
and outside it ``μ0`` 0 in the body and 1 in the fluid, ``μ1 = 0``; ghosts
from the zero-velocity BC.  The body's velocity V is zero.  Computed in
blocks of x rows so that the batched gradient fits beside the fields.

``sdf(x)`` takes an ``(N, D)`` tensor of points and returns their ``(N,)``
distances, written in plain `torch`.
"""
from __future__ import annotations

import math

import torch

from .solver import bc_vector, grow

BLOCK_POINTS = 1 << 22


def face_points(i, shape, x_rows, dtype, device) -> torch.Tensor:
    """Coordinates of the interior points of component ``i`` (None: cell
    centres) on padded x rows ``x_rows``: index I sits at ``I − ½`` in each
    dim, ``I − 1`` in dim ``i`` (`loc`, `core.jl:177-178`)."""
    axes = []
    for d, n in enumerate(shape):
        idx = (torch.arange(*x_rows, device=device) if d == 0
               else torch.arange(1, n - 1, device=device)).to(dtype) - 0.5
        axes.append(idx - 0.5 if i == d else idx)
    grid = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(grid, dim=-1).reshape(-1, len(shape))


def distance_normal(sdf, pts: torch.Tensor):
    """Distance and unit normal of each point; the distance is divided by
    the gradient's length, as a pseudo-distance is (`AutoBody.jl:29-37`)."""
    x = pts.detach().requires_grad_(True)
    with torch.enable_grad():
        d = sdf(x)
        (g,) = torch.autograd.grad(d.sum(), x)
    d = d.detach()
    m = torch.sqrt(torch.sum(g * g, dim=1))
    ok = m > 0
    ms = torch.where(ok, m, torch.ones_like(m))
    return torch.where(ok, d / ms, d), torch.where(ok[:, None], g / ms[:, None], 0.0)


def kern0(d):
    return (1 + d + torch.sin(math.pi * d) / math.pi) / 2


def kern1(d):
    return ((1 - d ** 2) / 4
            - (d * torch.sin(math.pi * d) + (1 + torch.cos(math.pi * d)) / math.pi)
            / (2 * math.pi))


def measure(sdf, shape, dtype, device, eps: float = 1.0, perdir=(),
            stated=torch.float32):
    """``(V, mu0, mu1)`` of the body on the padded grid ``shape``.  The
    cut of μ0 deep in the kernel, ``−1 + √eps``, takes the machine epsilon
    of the ``stated`` precision, the configuration's (`Body.jl:59`)."""
    D = len(shape)
    band2 = (2.0 + eps) ** 2
    cut = -1 + math.sqrt(torch.finfo(stated).eps)
    plane = math.prod(n - 2 for n in shape[1:])
    rows = max(1, BLOCK_POINTS // plane)
    inner = tuple(n - 2 for n in shape)
    mu0 = torch.ones((D,) + inner, dtype=dtype, device=device)
    mu1 = torch.zeros((D, D) + inner, dtype=dtype, device=device)
    for a in range(1, shape[0] - 1, rows):
        xr = (a, min(shape[0] - 1, a + rows))
        sub = (xr[1] - xr[0],) + inner[1:]
        sig = distance_normal(sdf, face_points(None, shape, xr, dtype, device))[0]
        sig = sig.reshape(sub)
        in_band = sig ** 2 < band2
        for i in range(D):
            d, n = distance_normal(sdf, face_points(i, shape, xr, dtype, device))
            d = torch.where(torch.abs(d.reshape(sub)) <= 0.5, d.reshape(sub),
                            torch.copysign(d.reshape(sub), sig))
            s = d / eps
            m0 = torch.where(s < cut, 0.0, kern0(torch.clamp(s, max=1.0)))
            rows_i = slice(xr[0] - 1, xr[1] - 1)
            mu0[i, rows_i] = torch.where(in_band, m0, torch.where(sig < 0, 0.0, 1.0))
            m1 = eps * kern1(torch.clamp(s, -1.0, 1.0))
            for j in range(D):
                mu1[i, j, rows_i] = torch.where(in_band, m1 * n[:, j].reshape(sub), 0.0)
    zeros = (0.0,) * D
    mu0 = bc_vector(torch.stack([grow(mu0[i], fill=1.0) for i in range(D)]), zeros, perdir)
    mu1 = torch.stack([torch.stack([grow(mu1[i, j]) for j in range(D)]) for i in range(D)])
    V = torch.zeros((D,) + tuple(shape), dtype=dtype, device=device)
    return V, mu0, mu1


def empty_box(shape, dtype, device, perdir=()):
    """``(V, mu0, mu1)`` of a box with no body."""
    D = len(shape)
    mu0 = bc_vector(torch.ones((D,) + tuple(shape), dtype=dtype, device=device),
                    (0.0,) * D, perdir)
    return (torch.zeros((D,) + tuple(shape), dtype=dtype, device=device), mu0,
            torch.zeros((D, D) + tuple(shape), dtype=dtype, device=device))
