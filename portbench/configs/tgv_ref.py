"""The Taylor–Green vortex's plain reference: its initial field, the
step's constants, its moments, its step and its output (mean kinetic
energy and enstrophy), in plain `torch`, from `tgv.json` alone.  No body:
the BDIM moments are those of an empty box."""
from __future__ import annotations

import math

import torch

from portbench.reference import measure, outputs, solver

# one step from the state before it, on the moments and levels of
# `moments`: nothing moves between steps
step = solver.static_step


def case(p: dict, n: int) -> solver.Case:
    kappa = 2 * math.pi / n
    nu = solver._rnd(1 / (kappa * p["re"]), getattr(torch, p["dtype"]))
    return solver.Case(tuple(p["ubc"]), nu, tuple(p["perdir"]), p["tol"], p["itmx"])


def velocity_scale(p: dict) -> float:
    return 1.0


def moments(p: dict, n: int, dtype, device, at=None):
    """An empty box's moments, the same at every time ``at``."""
    return measure.empty_box((n + 2,) * 3, dtype, device, tuple(p["perdir"]))


def initial_u(p: dict, n: int, dtype, device) -> torch.Tensor:
    """Case C3.5's vortex at every face (component i's face sits at
    ``I − 1`` in dim i and ``I − ½`` in the others), the box's corner at
    the origin, with the periodic BCs."""
    kappa = 2 * math.pi / n
    shape = (n + 2,) * 3
    comps = []
    for i in range(3):
        ax = []
        for d in range(3):
            view = [1, 1, 1]
            view[d] = shape[d]
            c = torch.arange(shape[d], dtype=dtype, device=device) - 0.5
            ax.append(((c - 0.5) if d == i else c).reshape(view) * kappa)
        a, b, c = ax
        if i == 0:
            v = -torch.sin(a) * torch.cos(b) * torch.cos(c)
        elif i == 1:
            v = torch.cos(a) * torch.sin(b) * torch.cos(c)
        else:
            v = torch.zeros_like(a * b * c)
        comps.append(v.expand(shape))
    u = solver.bc_vector(torch.stack(comps), tuple(p["ubc"]), tuple(p["perdir"]))
    return solver.exit_plane_start(u)


def output(u, pr, p: dict, n: int, t=None) -> list[float]:
    return outputs.ke_enstrophy(u)
