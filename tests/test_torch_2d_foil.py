"""The flapping foil of `examples/flapping_foil.py` on the port against the
JAX package, float64 on the CPU (the gates of `test_torch_2d.py`): L = 8
(64×32), 5 steps each re-measured, with its μ0 and signed distance; the
same foil in float32, the example's dtype, building and stepping; and
`Simulation.perturb` (statistics and seeds) and `sdf_field` of a moving
body."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_2d import F64, close_rel, run_sims
from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu_torch import AutoBody, Simulation


def test_flapping_foil():
    """`examples/flapping_foil.py` at L = 8 (64×32): the heaving, pitching
    segment re-measured every step, 5 steps."""
    L, Re, St = 8, 250, 0.3
    A = 0.5 * L
    f = St / (2 * A)

    def foil(lib, stack):
        def map_fn(x, t):
            h = A * lib.sin(2 * math.pi * f * t)
            th = 0.3 * lib.cos(2 * math.pi * f * t)
            c, s = lib.cos(th), lib.sin(th)
            y = x - stack([2.0 * L + 0 * h, 2.0 * L + h])
            return stack([c * y[0] + s * y[1], -s * y[0] + c * y[1]])

        def sdf(x, t):
            cl = lib.clip(x[0], 0.0, L)
            return lib.sqrt((x[0] - cl) ** 2 + x[1] ** 2) - 2.0
        return sdf, map_fn

    sim_j = SimulationJ((8 * L, 4 * L), (1.0, 0.0), L, nu=L / Re,
                        body=AutoBodyJ(*foil(jnp, jnp.stack)), dtype=jnp.float64)
    sim_t = Simulation((8 * L, 4 * L), (1.0, 0.0), L, nu=L / Re,
                       body=AutoBody(*foil(torch, torch.stack)), dtype=F64,
                       device="cpu")
    run_sims(sim_j, sim_t, 5, remeasure=True)
    close_rel(sim_t.flow.state.mu0, sim_j.flow.state.mu0)
    close_rel(sim_t.sdf_field(), sim_j.sdf_field())


def test_flapping_foil_float32_builds():
    """The foil in float32 (the example's dtype): its map's time derivative
    by forward mode comes out float64 for 0-d float32 scalars, and the
    measure casts it back; the build and a re-measured step run."""
    L = 8
    A, f = 0.5 * L, 0.3 / L

    def map_fn(x, t):
        h = A * torch.sin(2 * math.pi * f * t)
        th = 0.3 * torch.cos(2 * math.pi * f * t)
        c, s = torch.cos(th), torch.sin(th)
        y = x - torch.stack([2.0 * L + 0 * h, 2.0 * L + h])
        return torch.stack([c * y[0] + s * y[1], -s * y[0] + c * y[1]])

    sim = Simulation((8 * L, 4 * L), (1.0, 0.0), L, nu=L / 250, device="cpu",
                     body=AutoBody(lambda x, t: torch.sqrt(
                         (x[0] - torch.clamp(x[0], 0.0, L)) ** 2 + x[1] ** 2) - 2.0, map_fn))
    sim.sim_step(remeasure=True)
    assert sim.flow.state.V.dtype == torch.float32 and sim.flow.state.V.abs().max() > 0
    assert torch.isfinite(sim.flow.u).all()


def test_perturb_statistics_and_seeds():
    """`perturb` adds N(0, (noise·U)²) to every face, ghosts included: the
    same seed gives the same field, another seed another; JAX's draw (other
    bits) has the same statistics."""
    def sim():
        return Simulation((64, 64), (1.0, 0.0), 8.0, U=2.0, dtype=F64, device="cpu")
    a, b, c = sim(), sim(), sim()
    u0 = a.flow.u.clone()
    a.perturb(0.1, seed=3)
    b.perturb(0.1, seed=3)
    c.perturb(0.1, seed=4)
    assert torch.equal(a.flow.u, b.flow.u) and not torch.equal(a.flow.u, c.flow.u)
    d = (a.flow.u - u0).numpy()
    assert (d != 0).all()                       # the ghosts too
    assert abs(d.mean()) < 4 * 0.2 / math.sqrt(d.size)
    assert d.std() == pytest.approx(0.2, rel=0.02)
    sj = SimulationJ((64, 64), (1.0, 0.0), 8.0, U=2.0, dtype=jnp.float64)
    dj = np.asarray(sj.perturb(0.1, seed=3).flow.u) - np.asarray(u0)
    assert dj.std() == pytest.approx(d.std(), rel=0.03)
    assert a.flow.u.dtype == F64


def test_sdf_field_moving():
    """`sdf_field` at now and at a given time, equal to JAX's."""
    def pair():
        sj = SimulationJ((32, 24), (1.0, 0.0), 4.0, dtype=jnp.float64,
                         body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - 12.0) ** 2)) - 4.0,
                                        lambda x, t: x - jnp.stack([t, 0 * t])))
        st = Simulation((32, 24), (1.0, 0.0), 4.0, dtype=F64, device="cpu",
                        body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 12.0) ** 2)) - 4.0,
                                      lambda x, t: x - torch.stack([t, 0 * t])))
        return sj, st
    sj, st = pair()
    close_rel(st.sdf_field(), sj.sdf_field(), 1e-12)
    close_rel(st.sdf_field(2.5), sj.sdf_field(2.5), 1e-12)
    # cell (13, 12) is centred at (12.5, 11.5); at t = 2.5 the circle is at (14.5, 12)
    assert st.sdf_field(2.5)[13, 12].item() == pytest.approx(math.hypot(2.0, 0.5) - 4.0)
