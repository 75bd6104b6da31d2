"""Differentiable runs of the port against the JAX package, float64 on the CPU.

The cases of `tests/test_diff.py` at smaller sizes, here the Taylor–Green
energy in Re (`_tgv_ke`, L = 32, 3 steps) and the θ-rotated plate's solve
(`_solve_of_theta`, L = 16); the spinning cylinder and the re-measured plate
are in `test_torch_diff_body.py`.  Each runs `torch.func.jvp` through the
port's `mom_step_impl` (or `solve_mg_implicit`) against the JAX package's
forward-mode derivative (`jax.jacfwd` for the solve, `jax.jvp` along 1 for
the step runs: the same number at a scalar, and quicker to compile), and is
held to

* the JAX derivative and primal within 1e-8 relative,
* equal iteration counts of every primal and tangent solve, in order (the
  port's `multigrid.iteration_log`; on the JAX side an ordered debug
  callback added to its `solve_mg` for the run, the package unchanged),
* the port's own central difference at the JAX test's step and tolerance.

The JAX runs are shared by the tests of a case through module fixtures."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu.models import flow as flj
from waterlily_tpu.models.body import measure_fill as measure_fill_j
from waterlily_tpu.ops import multigrid as mgj
from waterlily_tpu.ops.grid import interior as interior_j
from waterlily_tpu.utils.metrics import ke_field as ke_field_j
from waterlily_tpu_torch import AutoBody
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.models.body import measure_fill
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops.grid import interior
from waterlily_tpu_torch.utils.metrics import ke_field

F64 = torch.float64
J64 = jnp.float64


# ---------------------------------------------------------------- runners
def run_j(cfg, state, levels, masks, nsteps, dt0=0.25):
    """`test_diff.run_fixed_steps`: the fixed-step runner carrying dt, with
    the iteration counts of each step's two projections."""
    def body(carry, _):
        state, dt, t = carry
        state, dt_next, n, _ = flj.mom_step_impl(cfg, state, levels, masks, dt, t)
        return (state, dt_next, t + dt), n

    carry = (state, jnp.asarray(dt0, J64), jnp.asarray(0.0, J64))
    (state, _, t), ns = jax.lax.scan(body, carry, None, length=nsteps)
    return state, t, ns


def run_t(cfg, state, levels, masks, nsteps, dt0=0.25):
    """The port's runner: dt and t as 0-d tensors, so dt's tangent flows
    through the CFL as in the JAX runner."""
    dt, t = torch.tensor(dt0, dtype=F64), torch.tensor(0.0, dtype=F64)
    for _ in range(nsteps):
        state, dt_next, _, _ = fl.mom_step_impl(cfg, state, levels, masks, dt, t)
        t, dt = t + dt, dt_next
    return state, t


def jax_derivative(fn, x0, jacfwd=False):
    """The JAX package's derivative of ``fn`` at ``x0`` (``jax.jvp`` along
    1, or ``jax.jacfwd``: the same number for a scalar input, jacfwd a vmap
    of that jvp, slower to compile on a step run), with the
    primal value and the iteration counts of every solve in call order:
    `solve_mg` is wrapped for the run with an ordered debug callback
    (primal, then tangent, per `solve_mg_implicit`)."""
    log = []
    orig = mgj.solve_mg

    def logged(*a, **k):
        res = orig(*a, **k)
        jax.debug.callback(lambda n: log.append(int(n)), res.iters, ordered=True)
        return res

    x = jnp.asarray(x0, J64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mgj, "solve_mg", logged)
        if jacfwd:
            d, val = jax.jit(jax.jacfwd(lambda x: (lambda v: (v, v))(fn(x)),
                                        has_aux=True))(x)
        else:
            val, d = jax.jit(lambda x: jax.jvp(fn, (x,), (jnp.ones_like(x),)))(x)
        jax.effects_barrier()
    return float(val), float(d), log


def port_derivative(fn, x0):
    """`torch.func.jvp` of ``fn`` at ``x0``: primal, derivative, and the
    iteration counts of every solve (`multigrid.iteration_log`)."""
    with mg.iteration_log() as log:
        val, d = torch.func.jvp(fn, (torch.tensor(x0, dtype=F64),),
                                (torch.tensor(1.0, dtype=F64),))
    return float(val), float(d), list(log)


def central_fd(fn, x0, h):
    return (float(fn(torch.tensor(x0 + h, dtype=F64)))
            - float(fn(torch.tensor(x0 - h, dtype=F64)))) / (2 * h)


def rel(a, b):
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------- Taylor–Green
L_TGV, STEPS_TGV, RE = 32, 3, 100.0


def tgv_ke_j(re):
    """`test_diff._tgv_ke` at L = 32."""
    L = L_TGV
    kappa = 2 * jnp.pi / L
    nu = 1 / (kappa * re)

    def tgv(i, xy, t):
        x, y = xy[0] * kappa, xy[1] * kappa
        dec = jnp.exp(-2 * kappa**2 * nu * t)
        return jnp.where(i == 0, -jnp.sin(x) * jnp.cos(y) * dec,
                         jnp.cos(x) * jnp.sin(y) * dec)

    flow = flj.Flow((L, L), tgv, nu=0.0, perdir=(0, 1), dtype=J64)
    state = dataclasses.replace(flow.state, nu=jnp.asarray(nu, J64))
    levels, masks = mgj.make_mg(state.mu0, flow.cfg.perdir)
    state, _, _ = run_j(flow.cfg, state, levels, masks, STEPS_TGV)
    return jnp.sum(interior_j(ke_field_j(state.u)))


def tgv_ke_t(re):
    """The port's `_tgv_ke`: ν = 1/(κ·Re) a tensor in the state and in the
    callable ``ubc`` (whose time derivative `accelerate` adds)."""
    L = L_TGV
    kappa = 2 * math.pi / L
    nu = 1 / (kappa * re)

    def tgv(i, xy, t):
        x, y = xy[0] * kappa, xy[1] * kappa
        dec = torch.exp(-2 * kappa**2 * nu * t)
        if i == 0:
            return -torch.sin(x) * torch.cos(y) * dec
        return torch.cos(x) * torch.sin(y) * dec

    flow = fl.Flow((L, L), tgv, nu=0.0, perdir=(0, 1), dtype=F64, device="cpu")
    state = dataclasses.replace(flow.state, nu=nu)
    levels, masks = mg.make_mg(state.mu0, perdir=flow.cfg.perdir)
    state, _ = run_t(flow.cfg, state, levels, masks, STEPS_TGV)
    return torch.sum(interior(ke_field(state.u)))


@pytest.fixture(scope="module")
def tgv_runs():
    return jax_derivative(tgv_ke_j, RE), port_derivative(tgv_ke_t, RE)


def test_dKE_dRe_matches_jax(tgv_runs):
    (pj, dj, _), (pt, dt, _) = tgv_runs
    assert rel(pt, pj) < 1e-8
    assert rel(dt, dj) < 1e-8


def test_dKE_dRe_iterations(tgv_runs):
    (_, _, nj), (_, _, nt) = tgv_runs
    assert len(nj) == 4 * STEPS_TGV       # two projections a step, each primal + tangent
    assert nt == nj


def test_dKE_dRe_fd(tgv_runs):
    """The JAX test's check: AD within 10 % of the central difference
    (h = 1)."""
    _, (_, d, _) = tgv_runs
    assert rel(d, central_fd(tgv_ke_t, RE, 1.0)) < 1e-1


def test_dKE_dRe_jacfwd(tgv_runs):
    """`torch.func.jacfwd` (vmap over the tangent, the tangent solves
    looped) gives `torch.func.jvp`'s derivative."""
    _, (_, d, n) = tgv_runs
    with mg.iteration_log() as log:
        dj = float(torch.func.jacfwd(tgv_ke_t)(torch.tensor(RE, dtype=F64)))
    assert rel(dj, d) < 1e-12 and log == n


# ---------------------------------------------------------------- θ-rotated plate solve
L_PLATE = 16
THETA = np.pi / 36
_RHS = np.zeros((2 * L_PLATE + 2,) * 2)
_RHS[1:-1, 1:-1] = 0.01 * np.random.default_rng(5).standard_normal((2 * L_PLATE,) * 2)


def plate_j(theta, L=L_PLATE):
    """`test_diff`'s θ-rotated plate: a capsule of half-length L/2 and
    radius 2 centred at (L, L)."""
    s, c = jnp.sin(theta), jnp.cos(theta)

    def plate_sdf(xi, t):
        cl = jnp.clip(xi[0], -L / 2, L / 2)
        return jnp.sqrt(jnp.sum((xi - jnp.stack([jnp.zeros_like(cl), cl])) ** 2)) - 2

    return AutoBodyJ(lambda xi, t: plate_sdf(jnp.asarray([[c, -s], [s, c]]) @ (xi - L), t))


def plate_t(theta, L=L_PLATE):
    s, c = torch.sin(theta), torch.cos(theta)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])

    def plate_sdf(xi, t):
        cl = torch.clamp(xi[0], -L / 2, L / 2)
        return torch.sqrt(torch.sum((xi - torch.stack([torch.zeros_like(cl), cl])) ** 2)) - 2

    return AutoBody(lambda xi, t: plate_sdf(rot @ (xi - L), t))


def solve_of_theta_j(theta, tol=1e-9):
    """`test_diff._solve_of_theta` at L = 16 (the rhs from numpy)."""
    shape = (2 * L_PLATE + 2,) * 2
    _, mu0, _, _ = measure_fill_j(plate_j(theta), shape, 0.25, 1.0, J64)
    levels, masks = mgj.make_mg(mu0)
    z = jnp.asarray(_RHS)
    res = mgj.solve_mg_implicit(levels, masks, jnp.zeros_like(z), z, tol=tol, itmx=128)
    return jnp.sum(interior_j(res.x) ** 2)


def solve_of_theta_t(theta, tol=1e-9):
    shape = (2 * L_PLATE + 2,) * 2
    _, mu0, _, _ = measure_fill(plate_t(theta), shape, 0.25, 1.0, F64, device="cpu")
    levels, masks = mg.make_mg(mu0)
    z = torch.as_tensor(_RHS)
    res = mg.solve_mg_implicit(levels, masks, torch.zeros_like(z), z, tol=tol, itmx=128)
    return torch.sum(interior(res.x) ** 2)


@pytest.fixture(scope="module")
def solve_runs():
    return (jax_derivative(solve_of_theta_j, THETA, jacfwd=True),
            port_derivative(solve_of_theta_t, THETA))


def test_dsolve_dtheta_matches_jax(solve_runs):
    (pj, dj, _), (pt, dt, _) = solve_runs
    assert rel(pt, pj) < 1e-8
    assert rel(dt, dj) < 1e-8


def test_dsolve_dtheta_iterations(solve_runs):
    (_, _, nj), (_, _, nt) = solve_runs
    assert len(nj) == 2 and nt == nj


def test_dsolve_dtheta_fd(solve_runs):
    """The JAX test's check: the implicit JVP with the operator-tangent
    term is exact on one converged solve, 1e-5 of the central difference
    (h = 1e-5)."""
    _, (_, d, _) = solve_runs
    assert rel(d, central_fd(solve_of_theta_t, THETA, 1e-5)) < 1e-5


def test_dsolve_dtheta_jacfwd(solve_runs):
    _, (_, d, _) = solve_runs
    assert rel(float(torch.func.jacfwd(solve_of_theta_t)(torch.tensor(THETA, dtype=F64))),
               d) < 1e-12
