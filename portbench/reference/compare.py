"""The comparison that decides `correct`.

The program's state cannot be followed over a whole window: float32
trajectories part a little with every step, so after hundreds of steps two
sound runs differ in every digit that matters.  So the reference follows the
program step by step from the program's own state, and checks by itself
the start and what a single step skips:

* ``start``: the program's perturbed initial field (a few x rows drawn from
  the seed, copied at set-up) against the configuration's initial field
  plus the same noise, ``noise·U·N(0, 1)`` drawn on the device from the seed
  (`Simulation.perturb`'s generator);
* ``moments``: the BDIM moments μ0, μ1 and V the program held at the end
  of its window, against the configuration's own (``ref.moments``: a
  measure from the signed distance, or an empty box's; largest absolute
  gap) at the time the program measured them: ``at = (t0, Δt)``, the state
  time and Δt of the window's last step, whose re-measure, for a body that
  moves, took the body at t0 + Δt (a static body ignores it);
* for each sampled step of the window, from the program's state before it
  (u, p, Δt and the time), the configuration's step (``ref.step``):
  ``u`` and ``p`` after the step (largest gap over the
  largest value; p weighted by each cell's largest face coefficient in
  the fine level the reference's own step used, as a pressure moves the
  flow only through L·∇p: the configuration's levels for a static body,
  those of the step's own measure for a moving one), ``dt`` the
  next Δt (relative gap), ``iters`` the pressure iterations of its two
  projections (largest difference), and ``output`` the output the program
  read on that state at the end of the interval before, at the state's
  time (largest gap over the largest value).

The reference runs in float64 (`REFERENCE`); its control is the same code
in bfloat16 (`CONTROL`), the precision below the configuration's float32,
put in the program's place.
"""
from __future__ import annotations

import math

import torch

from . import solver as sv

REFERENCE = torch.float64
CONTROL = torch.bfloat16
NAMES = ("start", "moments", "u", "p", "dt", "iters", "output")


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a − b| over the largest |b|, in float64."""
    a, b = a.to(REFERENCE), b.to(REFERENCE)
    return (torch.max(torch.abs(a - b)) / torch.max(torch.abs(b))).item()


def face_weight(L: torch.Tensor) -> torch.Tensor:
    """The largest face coefficient of each cell."""
    w = L.amax(dim=0)
    for d in range(L.shape[0]):
        w = torch.maximum(w, sv.shift(L[d], d, 1))
    return w


def _moment_gap(prog, mine) -> float:
    gap = 0.0
    for a, b in zip(prog, mine):
        for k in range(a.shape[0]):
            d = a[k].to(b.device, REFERENCE) - b[k].to(REFERENCE)
            gap = max(gap, torch.max(torch.abs(d)).item())
    return gap


class Side:
    """The reference at one dtype: the configuration's moments at ``at``
    (``ref.moments``) and their multigrid levels, and one step of the
    configuration (``ref.step``) from a given state."""

    def __init__(self, ref, params: dict, n: int, dtype, device, at):
        self.ref, self.params, self.n = ref, params, n
        self.dtype, self.device = dtype, device
        self.case = ref.case(params, n)
        self.moments = ref.moments(params, n, dtype, device, at=at)
        self.levels, self.masks = sv.make_levels(self.moments[1], self.case.perdir)

    def step(self, u, p, dt: float, t: float):
        """The step from the state at time ``t``, the output on that state,
        and the pressure's weight from the fine level the step used."""
        u = u.to(self.device, self.dtype)
        p = p.to(self.device, self.dtype)
        out = self.ref.output(u, p, self.params, self.n, t=t)
        u1, p1, dt1, iters, levels = self.ref.step(self, u, p, dt, t)
        return dict(u=u1, p=p1, dt=dt1, iters=iters, output=out,
                    weight=face_weight(levels[0].L))


def start_rows(ref, params: dict, n: int, seed: int, noise: float, rows, dtype,
               device) -> torch.Tensor:
    """The configuration's initial field plus the seed's noise, at x rows
    ``rows``."""
    shape = (3,) + (n + 2,) * 3
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(shape, generator=gen, dtype=getattr(torch, params["dtype"]),
                    device=device)
    u = ref.initial_u(params, n, dtype, device)
    u = u + noise * ref.velocity_scale(params) * z.to(dtype)
    return u[:, list(rows)].clone()


def numbers(prog_sample: dict, mine: dict) -> dict:
    """The step's numbers of one sample: ``prog_sample`` against ``mine``,
    the pressure weighted by ``mine``'s weight."""
    dev, weight = mine["u"].device, mine["weight"]
    pa = prog_sample["p"].to(dev, REFERENCE) * weight
    pb = mine["p"].to(REFERENCE) * weight
    oa, ob = prog_sample["output"], mine["output"]
    return dict(
        u=_gap(prog_sample["u"].to(dev), mine["u"]),
        p=(torch.max(torch.abs(pa - pb)) / torch.max(torch.abs(pb))).item(),
        dt=abs(prog_sample["dt"] - mine["dt"]) / abs(mine["dt"]),
        iters=float(max(abs(a - b) for a, b in zip(prog_sample["iters"], mine["iters"]))),
        output=max(abs(a - b) for a, b in zip(oa, ob)) / max(abs(b) for b in ob))


def _merge(acc: dict, new: dict) -> None:
    for k, v in new.items():
        acc[k] = max(acc.get(k, -math.inf), v) if v == v else math.nan


def check(ref, params: dict, n: int, snap: dict, seed: int, noise: float, device,
          control: bool = False):
    """The numbers of the program's run (``snap``: what the harness kept,
    `harness.drive`), and with ``control`` those of the reference at
    `CONTROL` in its place, both against the reference at `REFERENCE`.
    Frees each sample's tensors as it goes."""
    rows = snap["start_rows"]
    hi = start_rows(ref, params, n, seed, noise, rows, REFERENCE, device)
    prog = dict(start=_gap(snap["start_u"].to(device), hi))
    ctl = {}
    if control:
        ctl["start"] = _gap(start_rows(ref, params, n, seed, noise, rows, CONTROL,
                                       device), hi)
    del hi
    at = snap["moments_at"]
    side = Side(ref, params, n, REFERENCE, device, at)
    prog["moments"] = _moment_gap(snap["moments"], side.moments)
    low = Side(ref, params, n, CONTROL, device, at) if control else None
    if low is not None:
        ctl["moments"] = _moment_gap(low.moments, side.moments)
    for s in snap["samples"]:
        mine = side.step(s["u0"], s["p0"], s["dt0"], s["t0"])
        _merge(prog, numbers(dict(u=s["u1"], p=s["p1"], dt=s["dt1"], iters=s["iters"],
                                  output=s["out0"]), mine))
        if low is not None:
            theirs = low.step(s["u0"], s["p0"], s["dt0"], s["t0"])
            _merge(ctl, numbers(theirs, mine))
            del theirs
        del mine
    return prog, ctl
