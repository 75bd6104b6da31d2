"""Flow diagnostics: kinetic energy, vorticity, strain and body forces.

PyTorch counterpart of the part of `waterlily_tpu/utils/metrics.py` (the
port of `src/Metrics.jl`) that the sphere-drag and Taylor–Green examples
use.  Pointwise metrics are whole-tensor shift expressions; the surface
integrals evaluate the body normal at every interior cell with one vmapped
sweep (`models.body` chunks it) and sum in float64 on either device, as the
reference does (`Metrics.jl:127`).  The JAX package sums in float32 with a
Neumaier-compensated scan on the TPU only because the TPU has no fast
float64; the card has it.  Moments, `lambda2_field`, `helicity_field`,
`omega_theta_field` and `MeanFlow` are not ported yet (ROADMAP queue 1,
[utils]).
"""
from __future__ import annotations

import torch

from ..models.body import Body, _interior_points, _measure_points, kern
from ..ops.grid import grow, shift

__all__ = [
    "dudx", "ke_field", "curl_edge", "omega_field", "omega_mag_field",
    "vorticity", "strain_field",
    "nds_field", "pressure_force", "viscous_force", "total_force",
]


def dudx(i: int, j: int, u: torch.Tensor) -> torch.Tensor:
    """∂u_i/∂x_j at cell centres (`∂(i,j,I,u)`, `Metrics.jl:42-44`): the
    staggered difference for i == j, a 4-point average for cross terms."""
    if i == j:
        return shift(u[i], i, 1) - u[i]
    a = shift(u[i], j, 1)
    b = shift(u[i], j, -1)
    return (a + shift(a, i, 1) - b - shift(b, i, 1)) / 4


def ke_field(u: torch.Tensor, U=None) -> torch.Tensor:
    """½|u − U|² at cell centres (`ke`, `Metrics.jl:33-35`)."""
    s = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    for i in range(u.shape[0]):
        Ui = 0.0 if U is None else U[i]
        s = s + (u[i] + shift(u[i], i, 1) - 2 * Ui) ** 2
    return 0.125 * s


def _cyclic(i: int):
    return (i + 1) % 3, (i + 2) % 3


def curl_edge(i: int, u: torch.Tensor) -> torch.Tensor:
    """Component i of ∇×u at the cell edge (`curl`, `Metrics.jl:68-72`)."""
    j, k = _cyclic(i)
    return (u[k] - shift(u[k], j, -1)) - (u[j] - shift(u[j], k, -1))


def omega_field(u: torch.Tensor) -> torch.Tensor:
    """∇×u at cell centres (`ω`, `Metrics.jl:77-79`)."""
    comps = []
    for i in range(3):
        j, k = _cyclic(i)
        comps.append(dudx(k, j, u) - dudx(j, k, u))
    return torch.stack(comps)


def omega_mag_field(u: torch.Tensor) -> torch.Tensor:
    """|∇×u| (`ω_mag`, `Metrics.jl:84-86`)."""
    return torch.sqrt(torch.sum(omega_field(u) ** 2, dim=0))


def vorticity(u: torch.Tensor) -> torch.Tensor:
    """2-D: ∂v/∂x − ∂u/∂y at cell centres; 3-D: |∇×u|."""
    if u.shape[0] == 2:
        return dudx(1, 0, u) - dudx(0, 1, u)
    return omega_mag_field(u)


def strain_field(u: torch.Tensor) -> torch.Tensor:
    """Rate-of-strain tensor S at cell centres (`S`, `Metrics.jl:140`)."""
    D = u.shape[0]
    return torch.stack([torch.stack([(dudx(i, j, u) + dudx(j, i, u)) / 2
                                     for j in range(D)]) for i in range(D)])


def _grid_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum of ``(D, *grid)`` over the grid axes, accumulated in float64."""
    return torch.sum(a.to(torch.float64), dim=tuple(range(1, a.dim())))


def nds_field(body: Body, shape: tuple[int, ...], t=0.0, dtype=torch.float32,
              device="cuda") -> torch.Tensor:
    """BDIM-masked surface normal n·K(d) at every interior cell centre
    (`nds`, `Metrics.jl:116-119`); ghosts zero.  Shape ``(D, *shape)``."""
    D = len(shape)
    t = torch.tensor(t, dtype=dtype, device=device)
    d, n, _ = _measure_points(body, _interior_points(None, shape, dtype, device),
                              t, 1.0)
    vals = (n * kern(torch.clamp(d, -1.0, 1.0))[:, None]).T
    vals = vals.reshape((D,) + tuple(k - 2 for k in shape)).to(dtype)
    return torch.stack([grow(vals[i]) for i in range(D)])


def pressure_force(p: torch.Tensor, body: Body, t=0.0) -> torch.Tensor:
    """∮ p n dS over the body (`pressure_force`, `Metrics.jl:126-133`), a
    float64 ``(D,)`` tensor on ``p``'s device."""
    nds = nds_field(body, tuple(p.shape), t, p.dtype, p.device)
    return _grid_sum(p[None] * nds)


def viscous_force(u: torch.Tensor, nu, body: Body, t=0.0) -> torch.Tensor:
    """−∮ 2ν S·n dS (`viscous_force`, `Metrics.jl:147-154`), a float64
    ``(D,)`` tensor on ``u``'s device."""
    nds = nds_field(body, tuple(u.shape[1:]), t, u.dtype, u.device)
    df = -2.0 * nu * torch.einsum("ij...,j...->i...", strain_field(u), nds)
    return _grid_sum(df)


def total_force(sim) -> torch.Tensor:
    """Pressure + viscous force on the body of a `Simulation`
    (`total_force`, `Metrics.jl:160`)."""
    st = sim.flow.state
    return (pressure_force(st.p, sim.body, sim.time)
            + viscous_force(st.u, st.nu, sim.body, sim.time))
