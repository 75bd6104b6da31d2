"""Plain reference of a body that moves: `AutoBody(sdf, map)` measured at
a time, and one step on the moments and multigrid levels of that step's
own measure.

The measure is WaterLily's `measure!` (`Body.jl:28-51`) of an `AutoBody`
(`AutoBody.jl:29-37`) at the time t.  At every point x (the cell centres
and the faces of each component i):

* ξ = map(x, t) and d = sdf(ξ, t);
* where d² > (2+ε)², d is kept as it is and n = V = 0 (the measure's
  ``fastd²``); so too where ∇sdf(ξ) has a NaN or Jᵀ∇sdf(ξ) is zero;
* elsewhere n = Jᵀ∇sdf(ξ) with J = ∂map/∂x, then the pseudo-distance
  d /= |n| and n /= |n|, and the body's velocity V = −J⁻¹ ∂map/∂t.

Then, as `measure.measure` does for a static body: the face distance's sign
is taken from the cell centre's outside |d| ≤ ½; inside the band
σ² < (2+ε)² of the cell centre's σ, μ0 = K0(d/ε) (cut deep in the kernel),
μ1 = ε·K1(d/ε)·n and V_i; outside it μ0 is 0 in the body and 1 in the
fluid, μ1 = 0 and V = 0; the ghosts of μ0 and V from the zero-velocity BC.
Computed in blocks of x rows so that the batched derivatives fit beside
the fields.

A step (`moving_step`) is WaterLily's `sim_step!(sim, remeasure=true)`:
`measure!(sim, t = sum(Δt))`, the body at the end of the step, with the
levels rebuilt from that μ0 (`update!(pois)`), then `mom_step!` with that V.

``sdf(ξ, t)`` takes an ``(N, D)`` tensor of points and a 0-d time and
returns their ``(N,)`` distances; ``map(x, t)`` returns the ``(N, D)``
body-frame points, each row from its own row of ``x``.  Both are plain
`torch`.

Where this departs from WaterLily:

* The time of a step's measure is t0 + Δt, summed on the host in float64
  as the program sums its Δt history, then rounded to the precision the
  configuration states (float32) before the measure, as the port's
  `_as_dtype` does; WaterLily sums Δt in the flow's own type.  The time of
  an output is the state's, rounded the same way.
* ∇sdf, J and ∂map/∂t come from `torch.autograd` and `torch.func.jvp` on
  the batched functions, not from ForwardDiff point by point; J⁻¹∂map/∂t
  is taken by J's adjugate (a 2×2 or 3×3 solve in closed form), so that
  the bfloat16 control can run it (no `torch.linalg.solve` takes
  bfloat16).
* The cell centres are measured as the faces are, so σ is the
  pseudo-distance where σ² ≤ (2+ε)² (the port's `measure_fill`; WaterLily's
  `sdf` of an `AutoBody` returns the raw distance); for a map whose
  Jacobian is a rotation, as every rigid motion's is, the two agree.
* The cut of μ0 deep in the kernel, −1 + √eps, takes the machine epsilon
  of the stated precision, as `measure.measure` does.
"""
from __future__ import annotations

import math

import torch

from . import solver as sv
from .measure import BLOCK_POINTS, face_points, kern0, kern1
from .solver import bc_vector, grow


def measure_time(t0: float, dt: float, stated) -> float:
    """The time a step from the state time ``t0`` with Δt ``dt`` measures
    its body at: their float64 sum, rounded to ``stated``."""
    return sv._rnd(t0 + dt, stated)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[:, (k + 1) % 3] * b[:, (k + 2) % 3]
                        - a[:, (k + 2) % 3] * b[:, (k + 1) % 3] for k in range(3)], dim=1)


def _solve(J: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``J⁻¹ b`` for a batch of 2×2 or 3×3 matrices, by the adjugate."""
    if J.shape[-1] == 2:
        det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        x0 = J[:, 1, 1] * b[:, 0] - J[:, 0, 1] * b[:, 1]
        x1 = J[:, 0, 0] * b[:, 1] - J[:, 1, 0] * b[:, 0]
        return torch.stack([x0, x1], dim=1) / det[:, None]
    # row k of the cofactors: the cross product of J's other two rows;
    # J⁻¹ = cofᵀ / det
    cof = [_cross(J[:, (k + 1) % 3], J[:, (k + 2) % 3]) for k in range(3)]
    det = torch.sum(J[:, 0] * cof[0], dim=1)
    return sum(cof[k] * b[:, k:k + 1] for k in range(3)) / det[:, None]


def distance_normal_velocity(sdf, mapf, pts: torch.Tensor, t: torch.Tensor,
                             band2: float):
    """``(d, n, V)`` of each point at the 0-d time ``t``
    (`AutoBody.jl:29-37`), n and V zero and d raw where d² > ``band2``."""
    D = pts.shape[1]
    x = pts.detach()
    xi = mapf(x, t).detach().requires_grad_(True)
    with torch.enable_grad():
        d = sdf(xi, t)
        (g,) = torch.autograd.grad(d.sum(), xi)
    d = d.detach()
    nan = torch.isnan(g).any(dim=1)
    g = torch.where(torch.isnan(g), 0.0, g)
    cols = []
    for j in range(D):
        e = torch.zeros_like(x)
        e[:, j] = 1
        cols.append(torch.func.jvp(lambda z: mapf(z, t), (x,), (e,))[1])
    J = torch.stack(cols, dim=2)                 # J[:, i, j] = ∂map_i/∂x_j
    dmdt = torch.func.jvp(lambda s: mapf(x, s), (t,), (torch.ones_like(t),))[1]
    n = sum(J[:, i] * g[:, i:i + 1] for i in range(D))   # Jᵀ ∇sdf(ξ)
    m = torch.sqrt(torch.sum(n * n, dim=1))
    V = -_solve(J, dmdt)
    skip = (d * d > band2) | nan | (m == 0)
    ms = torch.where(skip, torch.ones_like(m), m)
    keep = ~skip[:, None]
    return (torch.where(skip, d, d / ms), torch.where(keep, n / ms[:, None], 0.0),
            torch.where(keep, V, 0.0))


def measure(sdf, mapf, shape, t: float, dtype, device, eps: float = 1.0, perdir=(),
            stated=torch.float32):
    """``(V, mu0, mu1)`` of the body at time ``t`` on the padded grid
    ``shape``, in ``dtype``."""
    D = len(shape)
    band2 = (2.0 + eps) ** 2
    cut = -1 + math.sqrt(torch.finfo(stated).eps)
    plane = math.prod(n - 2 for n in shape[1:])
    rows = max(1, BLOCK_POINTS // plane)
    inner = tuple(n - 2 for n in shape)
    tt = torch.tensor(t, dtype=dtype, device=device)
    mu0 = torch.ones((D,) + inner, dtype=dtype, device=device)
    mu1 = torch.zeros((D, D) + inner, dtype=dtype, device=device)
    V = torch.zeros((D,) + inner, dtype=dtype, device=device)
    for a in range(1, shape[0] - 1, rows):
        xr = (a, min(shape[0] - 1, a + rows))
        sub = (xr[1] - xr[0],) + inner[1:]
        sig = distance_normal_velocity(
            sdf, mapf, face_points(None, shape, xr, dtype, device), tt, band2)[0]
        sig = sig.reshape(sub)
        in_band = sig ** 2 < band2
        rows_i = slice(xr[0] - 1, xr[1] - 1)
        for i in range(D):
            d, n, v = distance_normal_velocity(
                sdf, mapf, face_points(i, shape, xr, dtype, device), tt, band2)
            d = torch.where(torch.abs(d.reshape(sub)) <= 0.5, d.reshape(sub),
                            torch.copysign(d.reshape(sub), sig))
            s = d / eps
            m0 = torch.where(s < cut, 0.0, kern0(torch.clamp(s, max=1.0)))
            mu0[i, rows_i] = torch.where(in_band, m0, torch.where(sig < 0, 0.0, 1.0))
            m1 = eps * kern1(torch.clamp(s, -1.0, 1.0))
            for j in range(D):
                mu1[i, j, rows_i] = torch.where(in_band, m1 * n[:, j].reshape(sub), 0.0)
            V[i, rows_i] = torch.where(in_band, v[:, i].reshape(sub), 0.0)
    zeros = (0.0,) * D
    mu0 = bc_vector(torch.stack([grow(mu0[i], fill=1.0) for i in range(D)]), zeros, perdir)
    mu1 = torch.stack([torch.stack([grow(mu1[i, j]) for j in range(D)]) for i in range(D)])
    V = bc_vector(torch.stack([grow(V[i]) for i in range(D)]), zeros, perdir)
    return V, mu0, mu1


def moving_step(side, u, p, dt: float, t: float):
    """One step from the state at time ``t``: the configuration's moments
    at the step's measure time (``side.ref.moments(..., at=(t, dt))``), the
    multigrid levels of that μ0, and `solver.mom_step` with that V.
    Returns ``(u, p, dt_next, [iterations], levels)``: the levels' fine L
    weights the sample's pressure (`compare.Side.step`)."""
    V, mu0, mu1 = side.ref.moments(side.params, side.n, side.dtype, side.device,
                                   at=(t, dt))
    levels, masks = sv.make_levels(mu0, side.case.perdir)
    u1, p1, dt1, iters = sv.mom_step(u, p, V, mu0, mu1, levels, masks, dt, side.case)
    return u1, p1, dt1, iters, levels
