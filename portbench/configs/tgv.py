"""The Taylor–Green vortex through the port's public API: `build` makes
the `Simulation` of `tgv.json` at n³ (as `chip_smoke.py`'s `tgv_sim`
does, with the workshop case's initial field), `advance` runs the users'
loop to a time, `output` is what `examples/tgv3d.py` reads every output
interval: the interior's mean kinetic energy and enstrophy, on the
host."""
from __future__ import annotations

import math

import torch

import waterlily_tpu_torch as wt
from waterlily_tpu_torch.utils import metrics

OUTPUT_NAMES = ("ke", "enstrophy")


def build(p: dict, n: int, device):
    kappa = 2 * math.pi / n

    def u0(i, x):
        a, b, c = x[0] * kappa, x[1] * kappa, x[2] * kappa
        if i == 0:
            return -torch.sin(a) * torch.cos(b) * torch.cos(c)
        if i == 1:
            return torch.cos(a) * torch.sin(b) * torch.cos(c)
        return torch.zeros_like(a)
    return wt.Simulation((n, n, n), tuple(p["ubc"]), n, U=1, nu=1 / (kappa * p["re"]),
                         u0=u0, perdir=tuple(p["perdir"]),
                         dtype=getattr(torch, p["dtype"]), tol=p["tol"],
                         itmx=p["itmx"], psolver=p["psolver"], engine=p["engine"],
                         device=device)


def advance(sim, t: float) -> None:
    sim.sim_step(t, remeasure=False)


def output(sim) -> list[float]:
    u = sim.flow.state.u
    n = math.prod(s - 2 for s in u.shape[1:])
    inner = (slice(1, -1),) * 3
    ke = metrics.ke_field(u)[inner].double().sum() / n
    ens = (metrics.omega_mag_field(u)[inner].double() ** 2).sum() / n
    return torch.stack([ke, ens]).tolist()
