"""The port's 2-D `Simulation` against the JAX package, float64 on the CPU
(the gates of `test_torch_2d.py`): the reference README's circle (96×64,
radius 8, Re = 100, 10 steps) with its pressure force, the accelerating
circle of `tests/test_simulation.py` (a callable ``ubc`` = t, scaled to
radius 4 on 64×64) and the 8:1 semi-coarsened channel."""

import numpy as np
import torch

import jax.numpy as jnp

from test_torch_2d import circle_pair, run_sims
from waterlily_tpu.utils import metrics as mtj
from waterlily_tpu_torch.utils import metrics as mt


def test_circle_drag_parity_with_reference():
    """The reference README's circle (96×64, radius 8 at 31, Re = 100), 10
    steps, and its pressure force equal to JAX's."""
    sim_j, sim_t = circle_pair((96, 64), [31.0, 31.0], 8.0, 16.0, 16.0 / 100)
    run_sims(sim_j, sim_t, 10)
    fj = np.asarray(mtj.pressure_force(sim_j.flow.state.p, sim_j.body, sim_j.time))
    ft = mt.pressure_force(sim_t.flow.p, sim_t.body, sim_t.time).numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-9, atol=1e-9 * np.abs(fj).max())


def test_accelerating_circle_added_mass():
    """The impulsively accelerated circle (a callable ``ubc`` = t), radius 4
    in an 8-radius half domain (64×64), 4 steps."""
    sim_j, sim_t = circle_pair(
        (64, 64), [32.0, 32.0], 4.0, 4.0, 0.0, U=(1, 1),
        ubc=(lambda i, x, t: jnp.where(i == 0, t, jnp.zeros_like(t)),
             lambda i, x, t: t if i == 0 else torch.zeros_like(t)))
    run_sims(sim_j, sim_t, 4)
    assert all(n <= 3 for n in sim_t.pois_n[2:])


def test_semicoarsening_channel():
    """The 8:1 channel with a half-blocking circle (128×16), 4 steps: the
    multigrid stays within 10 iterations (`test_poisson.jl:72-82`)."""
    H = 16
    sim_j, sim_t = circle_pair((8 * H, H), [4.0 * H, H / 2], H / 4, H / 4, H / 400)
    assert sim_t.masks == sim_j.masks
    run_sims(sim_j, sim_t, 4)
    assert all(n <= 10 for n in sim_t.pois_n)
