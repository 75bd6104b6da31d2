"""The static sphere through the port's public API: `build` makes the
`Simulation` of `sphere.json` at n³ (as `chip_smoke.py`'s `sphere_sim`
does), `advance` runs the users' loop to a time (the body is static: no
re-measure), `output` is what `examples/sphere_drag.py` reads every
output interval: the total force on the body, on the host."""
from __future__ import annotations

import torch

import waterlily_tpu_torch as wt
from waterlily_tpu_torch.utils import metrics

OUTPUT_NAMES = ("force_x", "force_y", "force_z")


def build(p: dict, n: int, device):
    radius = n // p["radius_divisor"]
    ctr = torch.tensor([c * n for c in p["centre_over_n"]], dtype=torch.float32,
                       device=device)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), tuple(p["ubc"]), radius,
                         nu=radius * p["nu_over_radius"], body=body, eps=p["eps"],
                         dtype=getattr(torch, p["dtype"]), tol=p["tol"],
                         itmx=p["itmx"], psolver=p["psolver"], engine=p["engine"],
                         device=device)


def advance(sim, t: float) -> None:
    sim.sim_step(t, remeasure=False)


def output(sim) -> list[float]:
    return metrics.total_force(sim).tolist()
