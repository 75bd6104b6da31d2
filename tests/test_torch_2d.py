"""The port's 2-D path against the JAX package, float64 on the CPU.

Smaller cases (at most 64×64 cells' worth of grid, at most 10 steps) of
the reference's 2-D tests, held to equal `pois_n`, dt rel 1e-10 and u, p
within 1e-10 of their max (p of max(max|p|, max|u|²), `close_up`), plus
the reference test's own check where its run fits in the steps taken.
This file: `tests/test_flow.py`'s impulsive box, Taylor–Green decay and
scheme selection (the port's `Flow` and `mom_step_impl` against the JAX
`Flow` and `mom_step`; cds against JAX, quick against cds), and the
helpers of `test_torch_2d_forced.py`, `test_torch_2d_sim.py` and
`test_torch_2d_foil.py`.  Every port object lives on ``device="cpu"``."""
import math

import numpy as np
import torch

import jax
import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.models import flow as flj
from waterlily_tpu.ops import multigrid as mgj
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops.grid import loc_grid

F64 = torch.float64


def close_rel(t, j, rel=1e-10, scale=0.0):
    """``t`` within ``rel`` of max(max|j|, ``scale``) of ``j``."""
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=rel * max(np.abs(j).max(), scale, 1e-300))


def close_up(t, j):
    """u within 1e-10 of max|u|, and p within 1e-10 of max(max|p|,
    max|u|²): the pressure scale ρU² stands in where the flow's pressure is
    near zero (a uniform or boundary-layer flow), whose rounding follows
    u, not p."""
    close_rel(t.u, j.u)
    close_rel(t.p, j.p, scale=float(np.abs(np.asarray(j.u)).max()) ** 2)


_update_mg_j = jax.jit(lambda mu0, masks, perdir: mgj.update_mg(None, masks, mu0, perdir),
                       static_argnums=(1, 2))


def step_flow(f, udf=None):
    """`test_flow.step_flow` with the level stack built by one jitted
    `update_mg` (as the JAX `Simulation` builds it) rather than eagerly."""
    masks = tuple(mgj.level_shapes(f.cfg.shape)[1])
    levels = _update_mg_j(f.state.mu0, masks, f.cfg.perdir)
    state, dt_next, n, _ = flj.mom_step(f.cfg, f.state, levels, masks,
                                       jnp.asarray(f.dt[-1], f.cfg.dtype),
                                       jnp.asarray(f.time, f.cfg.dtype), udf)
    f.state = state
    f.dt.append(float(dt_next))
    f.pois_n += [int(n[0]), int(n[1])]
    return f


def step_port(f, udf=None):
    """The port's counterpart of `test_flow.step_flow`: one `mom_step_impl`
    on a level stack rebuilt from the flow's μ0."""
    levels, masks = mg.make_mg(f.state.mu0, perdir=f.cfg.perdir)
    f.state, dt_next, n, _ = fl.mom_step_impl(f.cfg, f.state, levels, masks,
                                              f.dt[-1], f.time, udf)
    f.dt.append(dt_next.item())
    f.pois_n += list(n)
    return f


def run_flows(make_j, make_t, steps, udf_j=None, udf_t=None):
    """``steps`` steps of a JAX `Flow` and the port's, compared after the
    last: equal `pois_n`, dt rel 1e-10, u and p within 1e-10 of max."""
    fj, ft = make_j(), make_t()
    for _ in range(steps):
        step_flow(fj, udf_j)
        step_port(ft, udf_t)
    assert ft.pois_n == list(fj.pois_n)
    np.testing.assert_allclose(ft.dt, fj.dt, rtol=1e-10)
    close_up(ft, fj)
    return fj, ft


def l2_inside(a):
    a = np.asarray(a)
    sl = (slice(None),) * (a.ndim - 2) + (slice(1, -1),) * 2
    return float(np.sum(a[sl] ** 2))


# ------------------------------------------------------------ test_flow.py
def test_impulsive_box():
    """Impulsive uniform flow stays uniform (`test_flow.jl:76-84`)."""
    U = (2 / 3, -1 / 3)
    _, ft = run_flows(lambda: flj.Flow((16, 16), U, dtype=jnp.float64),
                      lambda: fl.Flow((16, 16), U, dtype=F64, device="cpu"), 1)
    u = ft.u.numpy()
    assert np.sum((u[0, 1:-1, 1:-1] - U[0]) ** 2) < 2e-5
    assert np.sum((u[1, 1:-1, 1:-1] - U[1]) ** 2) < 1e-5


def test_tgv_decay():
    """The 2-D Taylor–Green vortex (64², Re = 1e8) to tU/L = π/100 against
    the exact decay (`test_flow.jl:100-108`, the JAX bound 1.2e-4)."""
    L, Re = 64, 1e8
    kappa = 2 * np.pi / L
    nu = 1 / (kappa * Re)

    def tgv_j(i, xy, t):
        x, y = xy[0] * kappa, xy[1] * kappa
        dec = jnp.exp(-2 * kappa ** 2 * nu * t)
        return jnp.where(i == 0, -jnp.sin(x) * jnp.cos(y) * dec,
                         jnp.cos(x) * jnp.sin(y) * dec)

    def tgv_t(i, xy, t):
        x, y = xy[0] * kappa, xy[1] * kappa
        dec = torch.exp(-2 * kappa ** 2 * nu * t)
        if i == 0:
            return -torch.sin(x) * torch.cos(y) * dec
        return torch.cos(x) * torch.sin(y) * dec

    fj = flj.Flow((L, L), tgv_j, nu=nu, perdir=(0, 1), dtype=jnp.float64)
    ft = fl.Flow((L, L), tgv_t, nu=nu, perdir=(0, 1), dtype=F64, device="cpu")
    t_end = (math.pi / 100) * L
    steps = 0
    while ft.time < t_end:
        step_flow(fj)
        step_port(ft)
        steps += 1
    assert steps <= 10
    assert ft.pois_n == list(fj.pois_n)
    close_up(ft, fj)
    t = torch.tensor(ft.time, dtype=F64)
    x = loc_grid(0, ft.cfg.shape, F64, "cpu"), loc_grid(1, ft.cfg.shape, F64, "cpu")
    ue = torch.stack([tgv_t(i, x[i], t) for i in range(2)])
    assert l2_inside(ft.u[0] - ue[0]) < 1.2e-4
    assert l2_inside(ft.u[1] - ue[1]) < 1.2e-4


def test_scheme_selection_diverges():
    """quick and cds part on a non-uniform periodic field (`test_flow.jl`
    "Convection scheme selection"); cds, not the default, equal to JAX's."""
    def make_t(st):
        return fl.Flow((16, 16), (1.0, 0.0), perdir=(0, 1), scheme=st,
                       u0=lambda i, x: torch.sin(torch.pi * x[0] / 8) if i == 0
                       else 0.0 * x[0], dtype=F64, device="cpu")
    uc = run_flows(lambda: flj.Flow((16, 16), (1.0, 0.0), perdir=(0, 1), scheme=flj.cds,
                                    u0=lambda i, x: jnp.where(i == 0, jnp.sin(jnp.pi * x[0] / 8),
                                                              0.0 * x[0]), dtype=jnp.float64),
                   lambda: make_t(fl.cds), 1)[1].u
    uq = step_port(make_t(fl.quick)).u
    assert (uq - uc).abs().max().item() > 1e-6


def run_sims(sim_j, sim_t, steps, remeasure=False):
    for _ in range(steps):
        sim_j.sim_step(remeasure=remeasure)
        sim_t.sim_step(remeasure=remeasure)
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    close_up(sim_t.flow, sim_j.flow)


def circle_pair(dims, ctr, radius, L, nu, **kw):
    cj, ct = jnp.asarray(ctr, jnp.float64), torch.tensor(ctr, dtype=F64)
    kj = {k: v[0] for k, v in kw.items()}
    kt = {k: v[1] for k, v in kw.items()}
    sim_j = SimulationJ(dims, kj.pop("ubc", (1.0, 0.0)), L, nu=nu,
                        body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - radius),
                        dtype=jnp.float64, **kj)
    sim_t = Simulation(dims, kt.pop("ubc", (1.0, 0.0)), L, nu=nu,
                       body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - radius),
                       dtype=F64, device="cpu", **kt)
    return sim_j, sim_t
