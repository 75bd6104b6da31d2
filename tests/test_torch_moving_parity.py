"""``sim_step_n(n, remeasure=True)`` of the port against the JAX package's
moving scan, float64 on the CPU (`tests/test_simulation.py::
test_sim_step_n_remeasure_matches_host_loop`, `tests/test_flat.py::
test_sim_step_n_remeasure_flat_banded`).

The translating sphere of `tests/test_torch_moving.py` on (32, 16, 16),
4 steps, on both engines: flat at speed 4 (the body leaves its box, which
widens) and 3d at speed 1.5.  The port's host loop `sim_step_n(4,
remeasure=True)` equals 4 calls of `sim_step` bit for bit, and JAX's scan:
equal `pois_n`, dt rel 1e-10, u and p within 1e-10 of their max, and the
state (V, μ0, μ1) and level stack equal at 1e-12 to JAX's after JAX's
deferred re-measure runs (the port does not defer it: its state belongs to
the step's end time when the call returns).  Every port object lives on
``device="cpu"``."""
import numpy as np
import pytest
import torch

from test_torch_moving import close_rel, jax_sim, port_sim


@pytest.mark.parametrize("engine,speed", [("flat", 4.0), ("3d", 1.5)])
def test_sim_step_n_remeasure(engine, speed):
    loop, scan = port_sim(speed, engine), port_sim(speed, engine)
    for _ in range(4):
        loop.sim_step(remeasure=True)
    scan.sim_step_n(4, remeasure=True)
    assert loop.pois_n == scan.pois_n and loop.flow.dt == scan.flow.dt
    for name in ("u", "p", "V", "mu0", "mu1"):
        assert torch.equal(getattr(loop.flow.state, name),
                           getattr(scan.flow.state, name)), name
    sim_j = jax_sim(speed, engine)
    sim_j.sim_step_n(4, remeasure=True)
    st_j = sim_j.flow.state          # runs JAX's deferred re-measure
    assert scan.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(scan.flow.dt, sim_j.flow.dt, rtol=1e-10)
    close_rel(scan.flow.u, st_j.u, 1e-10)
    close_rel(scan.flow.p, st_j.p, 1e-10)
    for name in ("V", "mu0", "mu1"):
        np.testing.assert_allclose(getattr(scan.flow.state, name).numpy(),
                                   np.asarray(getattr(st_j, name)), atol=1e-12,
                                   err_msg=name)
    assert len(scan.levels) == len(sim_j.levels)
    for a, b in zip(scan.levels, sim_j.levels):
        for f in ("L", "D"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                       atol=1e-12, err_msg=f)
        np.testing.assert_allclose(a.iD.numpy(), np.asarray(b.iD), atol=1e-12, rtol=1e-12)
        assert (a.Ainv is None) == (b.Ainv is None)
    np.testing.assert_allclose(scan.levels[-1].Ainv.numpy(),
                               np.asarray(sim_j.levels[-1].Ainv), atol=1e-10)
