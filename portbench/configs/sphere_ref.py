"""The static sphere's plain reference: its signed distance, its initial
field, the step's constants, its moments, its step and its output (the
force on the body), in plain `torch`, from `sphere.json` alone."""
from __future__ import annotations

import torch

from portbench.reference import measure, outputs, solver

# one step from the state before it, on the moments and levels of
# `moments`: the body is static
step = solver.static_step


def geometry(p: dict, n: int):
    return n // p["radius_divisor"], [c * n for c in p["centre_over_n"]]


def sdf(p: dict, n: int):
    radius, ctr = geometry(p, n)

    def fn(x):
        c = torch.tensor(ctr, dtype=x.dtype, device=x.device)
        return torch.sqrt(torch.sum((x - c) ** 2, dim=1)) - radius
    return fn


def case(p: dict, n: int) -> solver.Case:
    radius, _ = geometry(p, n)
    nu = solver._rnd(radius * p["nu_over_radius"], getattr(torch, p["dtype"]))
    return solver.Case(tuple(p["ubc"]), nu, (), p["tol"], p["itmx"])


def moments(p: dict, n: int, dtype, device, at=None):
    """``(V, mu0, mu1)`` measured from the signed distance; the body is
    static, so the time of the measure, ``at``, is not needed."""
    return measure.measure(sdf(p, n), (n + 2,) * 3, dtype, device, p["eps"],
                           stated=getattr(torch, p["dtype"]))


def velocity_scale(p: dict) -> float:
    return sum(v * v for v in p["ubc"]) ** 0.5


def initial_u(p: dict, n: int, dtype, device) -> torch.Tensor:
    """The uniform inflow on every face, with the domain BCs."""
    u = torch.tensor(p["ubc"], dtype=dtype, device=device).reshape(3, 1, 1, 1)
    u = u.expand((3,) + (n + 2,) * 3).clone()
    return solver.exit_plane_start(solver.bc_vector(u, tuple(p["ubc"])))


def output(u, pr, p: dict, n: int, t=None) -> list[float]:
    """The force on the body; static, so the state's time ``t`` is not
    needed."""
    return outputs.force(u, pr, case(p, n).nu, sdf(p, n))
