"""Moving bodies in the port's flow against the JAX package's, float64 on
the CPU, in 3-D (the port's 2-D `Simulation` waits on ROADMAP [sim-2d]).

From `tests/test_simulation.py`, on a 16³ box with a body of size
R = 4 at its centre, ν = R/250, one re-measured `sim_step` each:

- `test_moving_body_exact_translation`: a sphere carried at the free
  stream's speed (V = U) leaves u = U in the fluid (every cell but those
  deep inside the body, where μ0 = 0 and V = 0 give u = 0), exactly, with
  and without the convective outlet, on the flat engine (the band BDIM of
  K1 and the slab K14, K10, K11 and K9's exit mode on the card);
- `test_accelerating_body`: a sphere accelerating from rest in still fluid
  (x − 2t²) sets the fluid moving, faster than the body's own velocity
  field, in fewer than 5 pressure iterations a solve;
- `test_deforming_body`: a capsule rotating about z, once under a map
  callable (its Jacobian and velocity by `torch.func`) and once under a
  `RigidMap` (given by the map), in fewer than 5 iterations a solve.

Each run equals the JAX package's run of the same engine: equal `pois_n`,
dt rel 1e-10, u and p within 1e-10 of their max.  Every port object lives
on ``device="cpu"``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.models.rigidmap import RigidMap as RigidMapJ
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.models.rigidmap import RigidMap

F64 = torch.float64
R = 4
NM = (4 * R,) * 3
NU = R / 250


def close_rel(t, j, rel):
    t, j = np.asarray(t), np.asarray(j)
    assert np.abs(t - j).max() <= rel * np.abs(j).max(), np.abs(t - j).max()


def sphere(xp):
    return lambda x, t: xp.sqrt(xp.sum((x - 2 * R) ** 2)) - R


def move(xp):
    return lambda x, t: x - xp.stack([t, 0 * t, 0 * t])


def accel(xp):
    return lambda x, t: x - xp.stack([2 * t**2, 0 * t, 0 * t])


def capsule(xp):
    def sdf(x, t):
        c = xp.clip(x[0], -R + 2, R - 2)
        return xp.sqrt(xp.sum((x - xp.stack([c, 0 * c, 0 * c])) ** 2)) - 2
    return sdf


def rotate(xp):
    def fn(x, t):
        s, c = xp.sin(t / R + 1), xp.cos(t / R + 1)
        y = x - 2 * R
        return xp.stack([c * y[0] + s * y[1], -s * y[0] + c * y[1], y[2]])
    return fn


def rigid(xp, Map):
    a = lambda v: xp.asarray(v, dtype=xp.float64)
    return Map(a([2.0 * R] * 3), a([0.0, 0.0, 1.0]), omega=a([0.0, 0.0, 1.0 / R]))


CASES = {  # name: (sdf, map, ubc, U)
    "translate": (sphere, move, (1.0, 0.0, 0.0), None),
    "accelerate": (sphere, accel, (0.0, 0.0, 0.0), 1.0),
    "rotate": (capsule, rotate, (0.0, 0.0, 0.0), 1.0),
    "rigidmap": (capsule, lambda xp: rigid(xp, RigidMap if xp is torch else RigidMapJ),
                 (0.0, 0.0, 0.0), 1.0),
}


def pair(case, engine, exit_bc=False):
    """The case's port `Simulation` and JAX `Simulation`, each stepped once
    with a re-measure."""
    sdf, mp, ubc, U = CASES[case]
    sim_t = Simulation(NM, ubc, R, U=U, nu=NU, body=AutoBody(sdf(torch), mp(torch)),
                       dtype=F64, exit_bc=exit_bc, engine=engine, device="cpu")
    sim_j = SimulationJ(NM, ubc, R, U=U, nu=NU, body=AutoBodyJ(sdf(jnp), mp(jnp)),
                        dtype=jnp.float64, exit_bc=exit_bc, engine=engine)
    sim_t.sim_step()
    sim_j.sim_step()
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    close_rel(sim_t.flow.u, sim_j.flow.u, 1e-10)
    close_rel(sim_t.flow.p, sim_j.flow.p, 1e-10)
    return sim_t


@pytest.mark.parametrize("exit_bc,engine", [(False, "flat"), (True, "flat")])
def test_moving_body_exact_translation(exit_bc, engine):
    sim = pair("translate", engine, exit_bc)
    u = sim.flow.u
    inner = (slice(1, -1),) * 3
    fluid = sim.flow.state.mu0[0][inner] > 0     # all but deep inside the body
    assert torch.allclose(u[0][inner][fluid], torch.ones_like(u[0][inner][fluid]), atol=1e-8)
    assert float(u[1:, 1:-1, 1:-1, 1:-1].abs().max()) < 1e-8


@pytest.mark.parametrize("exit_bc", [False, True])
def test_accelerating_body(exit_bc):
    sim = pair("accelerate", "3d", exit_bc)
    assert len(sim.pois_n) == 2 and all(n < 5 for n in sim.pois_n)
    assert float(sim.flow.u.max()) > float(sim.flow.V.max()) > 0


@pytest.mark.parametrize("case", ["rotate", "rigidmap"])
def test_deforming_body(case):
    sim = pair(case, "3d")
    assert len(sim.pois_n) == 2 and all(n < 5 for n in sim.pois_n)
    assert 0.0 < sim.flow.dt[-1] < 10.0
    assert float(sim.flow.V.abs().max()) > 0
