"""The check holds a body that moves: an oscillating sphere (bench.py's
moving case: R = n/8, moved by amp·sin(ωt) in x with amp = R/2 and
ω = 1/R, the static sphere's flow and solver), defined here and in no cell,
stepped through `sim_step(remeasure=True)` at 32³ on the CPU.  A sound run
is correct; a body not re-measured, a velocity V zeroed after each
measure, and a measure one step late are not, each caught by a number
named here; each sample's pressure takes the weight of its own measure;
the plain moving reference (`reference/moving.py`) equals the port's
float64 moving step."""
import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch
from conftest import SMALL

import waterlily_tpu_torch as wt
from portbench import harness
from portbench.reference import compare, moving, outputs, solver
from waterlily_tpu_torch.utils import metrics

N = 32
SPHERE = harness.load_json(harness.HERE / "configs" / "sphere.json")["params"]
PARAMS = dict(SPHERE, amplitude_over_radius=0.5, omega_times_radius=1.0)
STATIC_REF = harness.load_module(harness.HERE / "configs" / "sphere_ref.py")


def motion(p: dict, n: int):
    radius = n // p["radius_divisor"]
    return (radius, [c * n for c in p["centre_over_n"]],
            p["amplitude_over_radius"] * radius, p["omega_times_radius"] / radius)


# ---- the program: bench.py's oscillating sphere through the public API
def build(p: dict, n: int, device):
    radius, ctr, amp, om = motion(p, n)
    c = torch.tensor(ctr, dtype=getattr(torch, p["dtype"]), device=device)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c) ** 2)) - radius,
                       lambda x, t: x - torch.stack([amp * torch.sin(om * t), 0 * t, 0 * t]))
    return wt.Simulation((n, n, n), tuple(p["ubc"]), radius,
                         nu=radius * p["nu_over_radius"], body=body, eps=p["eps"],
                         dtype=getattr(torch, p["dtype"]), tol=p["tol"],
                         itmx=p["itmx"], psolver=p["psolver"], engine=p["engine"],
                         device=device)


def advance(sim, t: float) -> None:
    sim.sim_step(t, remeasure=True)


def output(sim) -> list[float]:
    return metrics.total_force(sim).tolist()


PROGRAM = SimpleNamespace(build=build, advance=advance, output=output)


# ---- its plain reference
def ref_body(p: dict, n: int):
    radius, ctr, amp, om = motion(p, n)

    def sdf(xi, t):
        c = torch.tensor(ctr, dtype=xi.dtype, device=xi.device)
        return torch.sqrt(torch.sum((xi - c) ** 2, dim=1)) - radius

    def mapf(x, t):
        return x - torch.stack([amp * torch.sin(om * t), 0 * t, 0 * t])
    return sdf, mapf


def ref_moments(p: dict, n: int, dtype, device, at=(0.0, 0.0)):
    """The moments a step from ``at = (t0, Δt)`` measures: at t0 + Δt."""
    stated = getattr(torch, p["dtype"])
    sdf, mapf = ref_body(p, n)
    return moving.measure(sdf, mapf, (n + 2,) * 3, moving.measure_time(*at, stated),
                          dtype, device, p["eps"], stated=stated)


def ref_output(u, pr, p: dict, n: int, t=0.0) -> list[float]:
    """The force on the body where it is at the state's time ``t``."""
    sdf, mapf = ref_body(p, n)
    tt = torch.tensor(solver._rnd(t, getattr(torch, p["dtype"])), dtype=u.dtype,
                      device=u.device)
    return outputs.force(u, pr, STATIC_REF.case(p, n).nu, lambda x: sdf(mapf(x, tt), tt))


REFERENCE = SimpleNamespace(case=STATIC_REF.case, moments=ref_moments,
                            step=moving.moving_step, initial_u=STATIC_REF.initial_u,
                            velocity_scale=STATIC_REF.velocity_scale, output=ref_output)


class MovingCell(harness.Cell):
    """A cell of the oscillating sphere with sphere-256's traffic and
    metrics, cut to ``n``³ and checked as `conftest.small_cell` checks."""

    def __init__(self, n: int = N, dtype: str = "float32", device: str = "cpu",
                 traffic: dict | None = None):
        self.bench = harness.load_json(harness.BENCHMARK)
        self.name = self.config = "sphere-moving"
        self.params = dict(PARAMS, dtype=dtype,
                           engine="flat" if device == "cpu" else PARAMS["engine"])
        if traffic is None:
            traffic = harness.load_json(harness.HERE / "workloads" / "sphere-256.json")
            traffic.update(SMALL, n=n)
        self.traffic = traffic
        self.end_to_end = harness.cell_metrics("sphere-256", self.bench, "end_to_end")
        self.per_layer = harness.cell_metrics("sphere-256", self.bench, "per_layer")

    def builder(self):
        return PROGRAM

    def reference(self):
        return REFERENCE


# ---- faults planted under the run
def not_remeasured(sim):
    """Every step keeps the body where it was built (``remeasure=False``)."""
    step = sim.step_once
    sim.step_once = lambda remeasure=True, udf=None: step(False, udf)


def velocity_zeroed(sim):
    """Every measure's body velocity V is set to zero."""
    measure = sim.measure

    def zeroed(t=None):
        measure(t)
        st = sim.flow.state
        sim.flow.state = dataclasses.replace(st, V=torch.zeros_like(st.V))
    sim.measure = zeroed


def measured_late(sim):
    """Every step measures the body at its start, t0, not at t0 + Δt."""
    measure = sim.measure
    sim.measure = lambda t=None: measure(sim.time if t is None else t)


def run(cell, seed, after_build=None):
    return harness.run_cell(cell, seed, 0.0, False, time.perf_counter(), "cpu",
                            after_build=after_build)


def test_a_sound_moving_run_is_correct():
    out = run(MovingCell(), 4_100_000_003)
    assert out["correct"] is True, out["checks"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("fault, caught_by", [(not_remeasured, "moments"),
                                              (velocity_zeroed, "moments"),
                                              (measured_late, "moments"),
                                              (velocity_zeroed, "u"),
                                              (measured_late, "u")])
def test_a_broken_moving_step_is_not_correct(fault, caught_by):
    out = run(MovingCell(), 4_100_000_007, after_build=fault)
    assert out["correct"] is False
    c = out["checks"][caught_by]
    assert c["value"] > c["limit"], out["checks"]


def test_the_moving_reference_equals_the_port_in_float64():
    """The float64 port on its flat engine against `reference/moving.py`:
    the moments of the window's last measure and every sampled step."""
    cell = MovingCell(dtype="float64")
    seed = 4_100_000_011
    _, snap = harness.drive(cell, seed, 0.0, False, time.perf_counter(), "cpu")
    prog, _ = harness.judge(cell, snap, seed, "cpu")
    assert prog["moments"] < 1e-12, prog
    assert prog["u"] < 1e-10 and prog["p"] < 1e-10, prog
    assert prog["iters"] == 0, prog


def test_the_moving_control_fails():
    """The reference in bfloat16 in the program's place fails the cell's
    limits."""
    cell = MovingCell()
    seed = 4_100_000_013
    _, snap = harness.drive(cell, seed, 0.0, False, time.perf_counter(), "cpu")
    prog, ctl = harness.judge(cell, snap, seed, "cpu", control=True)
    limits = cell.traffic["limits"]
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert [k for k in limits if not ctl[k] <= limits[k]], ctl
    assert set(ctl) == set(compare.NAMES)


def test_each_sample_weights_its_pressure_by_its_own_measure():
    """The pressure's weight of a sample is the face coefficients of the
    reference's own step there: the body measured at t0 + Δt, not where
    it was when the window closed."""
    params = dict(PARAMS, engine="flat")
    side = compare.Side(REFERENCE, params, N, torch.float64, "cpu", at=(0.0, 0.25))
    u = STATIC_REF.initial_u(params, N, torch.float64, "cpu")
    t0, dt = 9.5, 0.5
    mine = side.step(u, torch.zeros_like(u[0]), dt, t0)
    mu0 = ref_moments(params, N, torch.float64, "cpu", at=(t0, dt))[1]
    levels, _ = solver.make_levels(mu0, ())
    assert torch.equal(mine["weight"], compare.face_weight(levels[0].L))
    assert not torch.equal(mine["weight"], compare.face_weight(side.levels[0].L))
