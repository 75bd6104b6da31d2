"""Differentiable runs through a body parameter, port against the JAX
package, float64 on the CPU.

`tests/test_diff.py`'s spinning cylinder (`_spin_lift`, D = 8, 4 steps:
d lift / d spin through the map's time derivative, the measure's V and the
force metrics) and re-measured rotated plate (`_rot_psum`, L = 16, 2 steps:
d Σp² / dθ through a measure and an `update_mg` every step, the operator
tangent Ȧ·x of the implicit solve).  As in `test_torch_diff.py` (whose
runners this file shares): `torch.func.jvp` through the port against the
JAX package's derivative within 1e-8 relative, equal iteration counts of
every primal and tangent solve, and the port's central difference at the
JAX test's step and 5 % (its subgradient-noise tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diff import (F64, J64, central_fd, jax_derivative, plate_j, plate_t,
                             port_derivative, rel, run_j, run_t)
from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu.models import flow as flj
from waterlily_tpu.models.body import measure_fill as measure_fill_j
from waterlily_tpu.ops import multigrid as mgj
from waterlily_tpu.ops.grid import interior as interior_j
from waterlily_tpu.utils.metrics import pressure_force as pressure_force_j
from waterlily_tpu.utils.metrics import viscous_force as viscous_force_j
from waterlily_tpu_torch import AutoBody
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.models.body import measure_fill
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops.grid import interior
from waterlily_tpu_torch.utils.metrics import pressure_force, viscous_force

# ---------------------------------------------------------------- spinning cylinder
D_SPIN, STEPS_SPIN, XI = 8, 4, 2.0


def spin_lift_j(xi):
    """`test_diff._spin_lift` at D = 8, 4 steps."""
    D, Re = D_SPIN, 500.0
    C, R, U = D, D // 2, 1.0

    def rot(th):
        c, s = jnp.cos(th), jnp.sin(th)
        return jnp.asarray([[c, -s], [s, c]])

    body = AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum(x**2)) - R,
                     lambda x, t: rot(xi * U * t / R) @ (x - C))
    flow = flj.Flow((2 * D, 2 * D), (U, 0.0), nu=U * D / Re, dtype=J64,
                    tol=1e-6, itmx=64)
    V, mu0, mu1, _ = measure_fill_j(body, flow.cfg.shape, 0.0, 1.0, J64)
    state = dataclasses.replace(flow.state, V=V, mu0=mu0, mu1=mu1)
    levels, masks = mgj.make_mg(mu0)
    state, t, _ = run_j(flow.cfg, state, levels, masks, STEPS_SPIN)
    fp = pressure_force_j(state.p, body, t)
    fv = viscous_force_j(state.u, state.nu, body, t)
    return (fp[1] + fv[1]) / (xi**2 * U**2 * D)


def spin_lift_t(xi):
    D, Re = D_SPIN, 500.0
    C, R, U = D, D // 2, 1.0

    def rot(th):
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])

    body = AutoBody(lambda x, t: torch.sqrt(torch.sum(x**2)) - R,
                    lambda x, t: rot(xi * U * t / R) @ (x - C))
    flow = fl.Flow((2 * D, 2 * D), (U, 0.0), nu=U * D / Re, dtype=F64,
                   tol=1e-6, itmx=64, device="cpu")
    V, mu0, mu1, _ = measure_fill(body, flow.cfg.shape, 0.0, 1.0, F64, device="cpu")
    state = dataclasses.replace(flow.state, V=V, mu0=mu0, mu1=mu1)
    levels, masks = mg.make_mg(mu0)
    state, t = run_t(flow.cfg, state, levels, masks, STEPS_SPIN)
    fp = pressure_force(state.p, body, t)
    fv = viscous_force(state.u, state.nu, body, t)
    return (fp[1] + fv[1]) / (xi**2 * U**2 * D)


@pytest.fixture(scope="module")
def spin_runs():
    return jax_derivative(spin_lift_j, XI), port_derivative(spin_lift_t, XI)


def test_dlift_dspin_matches_jax(spin_runs):
    (pj, dj, _), (pt, dt, _) = spin_runs
    assert rel(pt, pj) < 1e-8
    assert rel(dt, dj) < 1e-8


def test_dlift_dspin_iterations(spin_runs):
    (_, _, nj), (_, _, nt) = spin_runs
    assert len(nj) == 4 * STEPS_SPIN and nt == nj


def test_dlift_dspin_fd(spin_runs):
    """The JAX test's check: 5 % of the central difference (h = 1e-4)."""
    _, (_, d, _) = spin_runs
    assert rel(d, central_fd(spin_lift_t, XI, 1e-4)) < 5e-2


# ---------------------------------------------------------------- re-measured plate
L_ROT, STEPS_ROT, THETA = 16, 2, np.pi / 36


def rot_psum_j(theta):
    """`test_diff._rot_psum` at L = 16, 2 steps: the plate measured at
    t + dt and the level stack updated every step."""
    L = L_ROT
    body = plate_j(theta, L)
    flow = flj.Flow((2 * L, 2 * L), (1.0, 0.0), nu=L / 100.0, dtype=J64,
                    tol=1e-6, itmx=64)
    levels, masks = mgj.make_mg(flow.state.mu0)

    def step(carry, _):
        state, levels, dt, t = carry
        V, mu0, mu1, _ = measure_fill_j(body, flow.cfg.shape, t + dt, 1.0, J64)
        state = dataclasses.replace(state, V=V, mu0=mu0, mu1=mu1)
        levels = mgj.update_mg(levels, masks, mu0)
        state, dt_next, _, _ = flj.mom_step_impl(flow.cfg, state, levels, masks, dt, t)
        return (state, levels, dt_next, t + dt), None

    carry = (flow.state, levels, jnp.asarray(0.25, J64), jnp.asarray(0.0, J64))
    (state, _, _, _), _ = jax.lax.scan(step, carry, None, length=STEPS_ROT)
    return jnp.sum(interior_j(state.p) ** 2)


def rot_psum_t(theta):
    L = L_ROT
    body = plate_t(theta, L)
    flow = fl.Flow((2 * L, 2 * L), (1.0, 0.0), nu=L / 100.0, dtype=F64,
                   tol=1e-6, itmx=64, device="cpu")
    _, masks = mg.make_mg(flow.state.mu0)
    state = flow.state
    dt, t = torch.tensor(0.25, dtype=F64), torch.tensor(0.0, dtype=F64)
    for _ in range(STEPS_ROT):
        V, mu0, mu1, _ = measure_fill(body, flow.cfg.shape, t + dt, 1.0, F64,
                                      device="cpu")
        state = dataclasses.replace(state, V=V, mu0=mu0, mu1=mu1)
        levels = mg.update_mg(masks, mu0)
        state, dt_next, _, _ = fl.mom_step_impl(flow.cfg, state, levels, masks, dt, t)
        t, dt = t + dt, dt_next
    return torch.sum(interior(state.p) ** 2)


@pytest.fixture(scope="module")
def rot_runs():
    return jax_derivative(rot_psum_j, THETA), port_derivative(rot_psum_t, THETA)


def test_dpsum_dtheta_matches_jax(rot_runs):
    (pj, dj, _), (pt, dt, _) = rot_runs
    assert rel(pt, pj) < 1e-8
    assert rel(dt, dj) < 1e-8


def test_dpsum_dtheta_iterations(rot_runs):
    (_, _, nj), (_, _, nt) = rot_runs
    assert len(nj) == 4 * STEPS_ROT and nt == nj


def test_dpsum_dtheta_fd(rot_runs):
    """The JAX test's check: 5 % of the central difference (h = θ/1000)."""
    _, (_, d, _) = rot_runs
    assert rel(d, central_fd(rot_psum_t, THETA, THETA / 1000)) < 5e-2


def test_box_measure_under_jvp():
    """The moving-body box measure (`measure_fill(band_box=)`, its paste into
    the far field) under `torch.func.jvp` in θ equals the dense measure's
    derivative."""
    shape = (2 * L_ROT + 2,) * 2
    box = ((L_ROT - 6, L_ROT + 8), (L_ROT - 12, L_ROT + 14))

    def fill(theta, band_box=None):
        V, mu0, mu1, sdf = measure_fill(plate_t(theta), shape, 0.25, 1.0, F64,
                                        device="cpu", band_box=band_box)
        return mu0, mu1

    th, one = torch.tensor(THETA, dtype=F64), torch.tensor(1.0, dtype=F64)
    dense = torch.func.jvp(fill, (th,), (one,))
    boxed = torch.func.jvp(lambda t: fill(t, box), (th,), (one,))
    for a, b in zip(boxed, dense):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert dense[1][0].abs().max() > 0
