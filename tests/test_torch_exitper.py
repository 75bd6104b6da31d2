"""The convective-outlet and periodic configurations of the port against the
JAX package, on the CPU (their kernels and modules one by one:
`tests/test_torch_exitper_ops.py`).

(c) The slice: port `Simulation` against JAX `Simulation`, float64, 3 steps
    on both engines of a 16³ Taylor–Green vortex (``perdir=(0, 1, 2)``,
    callable ``u0``) and of the 32×16×16 R=4 sphere with ``exit_bc=True``:
    equal `pois_n`, dt to rtol 1e-10, u and p to 1e-10 relative to max |·|
    (the construction to 1e-12).
(d) `utils.metrics` against `waterlily_tpu.utils.metrics` on the stepped
    sphere's state, to 1e-10 relative to max |·| (`total_force` of the two
    simulations, whose states agree to 1e-10, to 1e-9)."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.utils import metrics as mt_j
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.simulation import _band_box
from waterlily_tpu_torch.utils import metrics as mt

F64 = torch.float64


def T(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def Jx(t):
    return jnp.asarray(np.asarray(t))


def rel_close(t, j, rtol):
    """max |port − JAX| ≤ rtol · max |JAX|."""
    a, b = np.asarray(t), np.asarray(j)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale


# ------------------------------------------------------------ (c) the slice
def tgv_u0(lib, L):
    kappa = 2 * math.pi / L

    def u0(i, x):
        a, b, c = x[0] * kappa, x[1] * kappa, x[2] * kappa
        if i == 0:
            return lib.cos(a) * lib.sin(b) * lib.sin(c)
        if i == 1:
            return -lib.sin(a) * lib.cos(b) * lib.sin(c) / 2
        return -lib.sin(a) * lib.sin(b) * lib.cos(c) / 2
    return u0


def tgv_pair(engine, L=16, Re=1600):
    nu = 1 / (2 * math.pi / L * Re)
    kw = dict(U=1, nu=nu, perdir=(0, 1, 2))
    sim_j = SimulationJ((L, L, L), (0.0,) * 3, L, u0=tgv_u0(jnp, L),
                        dtype=jnp.float64, engine=engine, **kw)
    sim_t = Simulation((L, L, L), (0.0,) * 3, L, u0=tgv_u0(torch, L),
                       dtype=F64, engine=engine, device="cpu", **kw)
    return sim_j, sim_t


R = 4.0
DIMS = (32, 16, 16)


def exit_sphere_pair(engine):
    ctr = [DIMS[0] / 3, DIMS[1] / 2, DIMS[2] / 2]
    cj, ct = jnp.asarray(ctr, jnp.float64), torch.tensor(ctr, dtype=F64)
    kw = dict(nu=R / 1e3, exit_bc=True, engine=engine)
    sim_j = SimulationJ(DIMS, (1.0, 0.0, 0.0), R, dtype=jnp.float64,
                        body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - R),
                        **kw)
    sim_t = Simulation(DIMS, (1.0, 0.0, 0.0), R, dtype=F64, device="cpu",
                       body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - R),
                       **kw)
    return sim_j, sim_t


def run_pair(sim_j, sim_t, steps=3):
    rel_close(sim_t.flow.u, sim_j.flow.u, 1e-12)       # the construction
    for _ in range(steps):
        sim_j.sim_step(remeasure=False)
        sim_t.sim_step(remeasure=False)
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    rel_close(sim_t.flow.u, sim_j.flow.u, 1e-10)
    rel_close(sim_t.flow.p, sim_j.flow.p, 1e-10)


@pytest.mark.parametrize("engine", ["3d", "flat"])
def test_tgv_trajectory(engine):
    sim_j, sim_t = tgv_pair(engine)
    assert sim_t.engine == engine
    run_pair(sim_j, sim_t)
    u = sim_t.flow.u
    for j in range(3):        # periodic ghost planes equal their partners
        n = u.shape[1 + j]
        assert torch.equal(u.narrow(1 + j, 0, 1), u.narrow(1 + j, n - 2, 1))
        assert torch.equal(u.narrow(1 + j, n - 1, 1), u.narrow(1 + j, 1, 1))


@pytest.fixture(scope="module")
def stepped_sphere():
    """The exit sphere of both packages after 3 steps of the flat engine."""
    sim_j, sim_t = exit_sphere_pair("flat")
    run_pair(sim_j, sim_t)
    return sim_j, sim_t


@pytest.mark.parametrize("engine", ["3d", "flat"])
def test_exit_sphere_trajectory(engine, request):
    if engine == "flat":
        sim_j, sim_t = request.getfixturevalue("stepped_sphere")
    else:
        sim_j, sim_t = exit_sphere_pair("3d")
        run_pair(sim_j, sim_t)
    assert sim_t.flow.cfg.band_x == sim_j.flow.cfg.band_x
    np.testing.assert_allclose(sim_t.flow.state.V.numpy(),
                               np.asarray(sim_j.flow.state.V), atol=1e-12)
    u = sim_t.flow.u
    # the mass-flux correction of the outlet: mean outflow = mean inflow
    assert float(u[0, -1, 1:-1, 1:-1].mean()) == pytest.approx(
        float(u[0, 1, 1:-1, 1:-1].mean()), rel=1e-12)


def test_band_box_periodic():
    shape, perdir = (12, 10, 8), (1, 2)
    ctr = torch.tensor([6.0, 5.0, 4.0], dtype=F64)
    sim = Simulation(tuple(n - 2 for n in shape), (1.0, 0.0, 0.0), 2.0,
                     dtype=F64, device="cpu", perdir=perdir,
                     body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - 2.0))
    from waterlily_tpu.simulation import _band_box as band_box_j
    s = sim.flow.state
    np.testing.assert_array_equal(
        _band_box(s.V, s.mu0, s.mu1, perdir).numpy(),
        np.asarray(band_box_j(Jx(s.V), Jx(s.mu0), Jx(s.mu1), perdir)))


# ------------------------------------------------------------ (d) metrics
FIELDS = {
    "ke_field": lambda m, u: m.ke_field(u),
    "ke_field_U": lambda m, u: m.ke_field(u, (1.0, 0.0, 0.0)),
    "omega_field": lambda m, u: m.omega_field(u),
    "omega_mag_field": lambda m, u: m.omega_mag_field(u),
    "vorticity": lambda m, u: m.vorticity(u),
    "strain_field": lambda m, u: m.strain_field(u),
    "dudx": lambda m, u: np.stack([m.dudx(i, j, u) for i in range(3) for j in range(3)]),
    "curl_edge": lambda m, u: np.stack([m.curl_edge(i, u) for i in range(3)]),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_metric_fields(stepped_sphere, name):
    sim_j, _ = stepped_sphere
    u = np.asarray(sim_j.flow.u)
    got = FIELDS[name](mt, T(u))
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    rel_close(got, FIELDS[name](mt_j, jnp.asarray(u)), 1e-10)


def test_forces(stepped_sphere):
    sim_j, sim_t = stepped_sphere
    st_j = sim_j.flow.state
    u, p, nu = np.asarray(st_j.u), np.asarray(st_j.p), float(st_j.nu)
    t = sim_j.time
    rel_close(mt.nds_field(sim_t.body, tuple(p.shape), t, F64, "cpu"),
              mt_j.nds_field(sim_j.body, p.shape, t, jnp.float64), 1e-10)
    fp = mt.pressure_force(T(p), sim_t.body, t)
    fv = mt.viscous_force(T(u), nu, sim_t.body, t)
    assert fp.dtype == fv.dtype == F64
    rel_close(fp, mt_j.pressure_force(jnp.asarray(p), sim_j.body, t), 1e-10)
    rel_close(fv, mt_j.viscous_force(jnp.asarray(u), nu, sim_j.body, t), 1e-10)
    # total_force of the two stepped simulations (states equal to 1e-10)
    rel_close(mt.total_force(sim_t), mt_j.total_force(sim_j), 1e-9)
