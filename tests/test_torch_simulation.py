"""The port's `Simulation` against the JAX package's generic engine
(`Simulation(engine="3d")`), float64 on the CPU: the 48×32×32 sphere of
`__graft_entry__.entry()` (R=8, ν=R/250).

Gates: the build's V, μ0, μ1 and level stack at 1e-12 (iD, which holds
1/D for tiny D, at rel 1e-12); a 5-step trajectory with equal `pois_n`, dt
history rel 1e-10, u atol 1e-9 and p atol 1e-8.  Also: the options outside
the ported slices (`psolver="pcg"`, `flow_ctor`, `sim_step_n(remeasure=True)`)
raise `NotImplementedError`.  Every port object is built
with ``device="cpu"`` (the entry points default to the card)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.models import body as body_j
from waterlily_tpu_torch import AutoBody, NoBody, Simulation, measure_sdf

F64 = torch.float64
DIMS, R = (48, 32, 32), 8.0


def close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def port_sphere(dims=DIMS, radius=R, **kw):
    ctr = torch.tensor([dims[0] / 3] + [d / 2 for d in dims[1:]], dtype=F64)
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return Simulation(dims, (1.0, 0.0, 0.0), radius, nu=radius / 250,
                      body=body, dtype=F64, device="cpu", **kw)


@pytest.fixture(scope="module")
def pair():
    ctr = jnp.asarray([DIMS[0] / 3, DIMS[1] / 2, DIMS[2] / 2], jnp.float64)
    body = AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - ctr) ** 2)) - R)
    sim_j = SimulationJ(DIMS, (1.0, 0.0, 0.0), R, nu=R / 250, body=body,
                        dtype=jnp.float64, engine="3d")
    return sim_j, port_sphere()


def test_build(pair):
    sim_j, sim_t = pair
    assert sim_t.masks == sim_j.masks
    for k in ("V", "mu0", "mu1", "u", "p"):
        close(getattr(sim_t.flow.state, k), getattr(sim_j.flow.state, k), 1e-12)
    assert len(sim_t.levels) == len(sim_j.levels) == 4
    for a, b in zip(sim_t.levels, sim_j.levels):
        close(a.L, b.L, 1e-12)
        close(a.D, b.D, 1e-12)
        close(a.iD, b.iD, 1e-12, rtol=1e-12)
        assert (a.Ainv is None) == (b.Ainv is None)
    close(sim_t.levels[-1].Ainv, sim_j.levels[-1].Ainv, 1e-12)


def test_trajectory(pair):
    sim_j, sim_t = pair
    for _ in range(5):
        sim_j.sim_step(remeasure=False)
        sim_t.sim_step(remeasure=False)
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    close(sim_t.flow.u, sim_j.flow.u, 1e-9)
    close(sim_t.flow.p, sim_j.flow.p, 1e-8)
    assert sim_t.sim_time == pytest.approx(sim_j.sim_time, rel=1e-10)


def test_remeasure_static_body_and_step_n():
    """A static body re-measured every step gives the same run as no
    re-measure; `sim_step_n` equals the host loop of `sim_step`."""
    a = port_sphere((24, 16, 16), 4.0)
    b = port_sphere((24, 16, 16), 4.0)
    c = port_sphere((24, 16, 16), 4.0)
    for _ in range(2):
        a.sim_step()
        b.sim_step(remeasure=False)
    c.sim_step_n(2)
    assert a.pois_n == b.pois_n == c.pois_n
    assert a.flow.dt == b.flow.dt == c.flow.dt
    assert torch.equal(a.flow.u, b.flow.u) and torch.equal(b.flow.u, c.flow.u)
    assert torch.equal(a.flow.p, b.flow.p)


def test_sim_step_to_time():
    sim = port_sphere((24, 16, 16), 4.0)
    sim.sim_step(0.2, remeasure=False)
    assert sim.sim_time >= 0.2
    assert sim.sim_time - sim.flow.dt[-2] * sim.U / sim.L < 0.2
    assert len(sim.pois_n) == 2 * (len(sim.flow.dt) - 1)


def test_measure_sdf():
    shape = (26, 18, 18)
    ctr = [8.0, 9.0, 9.0]
    cj, ct = jnp.asarray(ctr, jnp.float64), torch.tensor(ctr, dtype=F64)
    want = body_j.measure_sdf(
        AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - 4.0),
        shape, 0.0, jnp.float64)
    got = measure_sdf(AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - 4.0),
                      shape, 0.0, F64, "cpu")
    close(got, want, 1e-12)


def test_no_body_uniform_flow_stays_uniform():
    sim = Simulation((16, 8), (1.0, 0.0), 4.0, body=NoBody(), dtype=F64,
                     u0=(1.0, 0.0), device="cpu")
    sim.sim_step_n(2)
    inner = sim.flow.u[:, 1:-1, 1:-1]
    assert torch.allclose(inner[0], torch.ones_like(inner[0]))
    assert torch.allclose(inner[1], torch.zeros_like(inner[1]))
    assert float(sim.flow.p.abs().max()) < 1e-12


@pytest.mark.parametrize("kw", [dict(psolver="pcg"), dict(flow_ctor=object)],
                         ids=["pcg", "flow_ctor"])
def test_unsupported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation((16, 8), (1.0, 0.0), 4.0, dtype=F64, device="cpu", **kw)


def test_unsupported_stepping_raises():
    sim = Simulation((16, 8), (1.0, 0.0), 4.0, dtype=F64, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.sim_step_n(1, remeasure=True)
