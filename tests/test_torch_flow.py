"""The port's momentum step (`waterlily_tpu_torch.models.flow`) against the
JAX package's generic engine (`waterlily_tpu.models.flow`), float64 on the
CPU.  States and MG stacks are carried across with
`waterlily_tpu_torch.interop`.  Tolerances: 1e-12 for single ops, and for a
whole step dt_next rel 1e-10, equal iteration counts, u atol 1e-9, p atol
1e-8."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.models import flow as fl_j
from waterlily_tpu_torch import interop
from waterlily_tpu_torch.models import flow as fl_t

F64 = torch.float64


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def J(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


def jax_sphere_sim(dims, radius, nu):
    """The `__graft_entry__` sphere (centre at dims[0]/3 and mid-span) in f64
    on the generic engine; a circle in 2D."""
    ctr = jnp.asarray([dims[0] / 3] + [d / 2 for d in dims[1:]], jnp.float64)
    body = AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - ctr) ** 2)) - radius)
    ubc = (1.0,) + (0.0,) * (len(dims) - 1)
    return SimulationJ(dims, ubc, radius, nu=nu, body=body, dtype=jnp.float64,
                       engine="3d")


def perturbed(sim, seed, amp=0.05):
    """The sim's state with seeded noise on u, as numpy arrays."""
    st = sim.flow.state
    d = {k: np.asarray(getattr(st, k)) for k in ("u", "u0", "p", "V", "mu0",
                                                  "mu1", "nu")}
    d["u"] = d["u"] + amp * np.random.default_rng(seed).standard_normal(d["u"].shape)
    d["u0"] = d["u"]
    return d


def port_cfg(cfg_j):
    return fl_t.FlowCfg(shape=cfg_j.shape, ubc=cfg_j.ubc, dtype=F64,
                        tol=cfg_j.tol, itmx=cfg_j.itmx, smooth_it=cfg_j.smooth_it,
                        fine_smooth_it=cfg_j.fine_smooth_it,
                        fine_presmooth=cfg_j.fine_presmooth)


def state_j(d):
    return fl_j.FlowState(**{k: J(v) for k, v in d.items()})


def step_both(sim, d, dt=0.3):
    cfg_j = sim.flow.cfg
    lev_np = [(np.asarray(l.L), np.asarray(l.D), np.asarray(l.iD),
               None if l.Ainv is None else np.asarray(l.Ainv)) for l in sim.levels]
    sj, dtj, itj, _ = fl_j.mom_step(cfg_j, state_j(d), sim.levels, sim.masks,
                                    jnp.asarray(dt, jnp.float64),
                                    jnp.asarray(0.0, jnp.float64))
    st_t = interop.flow_state_from_numpy(d, "cpu", F64)
    lev_t = interop.levels_from_numpy(lev_np, "cpu", F64)
    stt, dtt, itt, _ = fl_t.mom_step_impl(port_cfg(cfg_j), st_t, lev_t, sim.masks, dt)
    return (sj, dtj, itj), (stt, dtt, itt)


@pytest.fixture(scope="module")
def sphere():
    """The `__graft_entry__.entry()` sphere: 48×32×32, R=8, ν=R/250."""
    return jax_sphere_sim((48, 32, 32), 8.0, 8.0 / 250)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("scheme", ["quick", "vanleer", "cds"])
def test_conv_diff(D, scheme):
    shape = (12, 10, 8)[:D]
    u = np.random.default_rng(D).standard_normal((D,) + shape)
    close(fl_t.conv_diff(T(u), getattr(fl_t, scheme), T(0.02)),
          fl_j.conv_diff(J(u), getattr(fl_j, scheme), J(0.02)), 1e-12)


@pytest.mark.parametrize("D", [2, 3])
def test_bdim_update_div_scale_cfl(D):
    shape = (12, 10, 8)[:D]
    rng = np.random.default_rng(10 + D)
    g = lambda *s: rng.standard_normal(s + shape)
    u, u0, f, V, mu0, mu1 = g(D), g(D), g(D), g(D), g(D), g(D, D)
    close(fl_t.bdim_update(*map(T, (u, u0, f, V, mu0, mu1)), 0.3),
          fl_j.bdim_update(*map(J, (u, u0, f, V, mu0, mu1)), J(0.3)), 1e-12)
    close(fl_t.div_field(T(u)), fl_j.div_field(J(u)), 1e-12)
    close(fl_t.scale_interior(T(u), 0.5), fl_j.scale_interior(J(u), 0.5), 1e-14)
    close(fl_t.cfl(T(u), T(0.01)), fl_j.cfl(J(u), J(0.01)), 1e-14)


def test_project(sphere):
    d = perturbed(sphere, 1)
    cfg_j = sphere.flow.cfg
    proj = jax.jit(fl_j.project, static_argnames=("masks", "cfg"))
    uj, pj, nj, _ = proj(J(d["u"]), J(d["p"]), sphere.levels, sphere.masks,
                         J(0.3), cfg_j, J(0.0))
    lev_t = interop.levels_from_numpy(
        [(l.L, l.D, l.iD, l.Ainv) for l in sphere.levels], "cpu", F64)
    ut, pt, nt, _ = fl_t.project(T(d["u"]), T(d["p"]), lev_t, sphere.masks, 0.3,
                                 port_cfg(cfg_j))
    assert nt == int(nj)
    close(ut, uj, 1e-9)
    close(pt, pj, 1e-8)


def _check_step(res_j, res_t):
    (sj, dtj, itj), (stt, dtt, itt) = res_j, res_t
    assert itt == [int(n) for n in np.asarray(itj)]
    np.testing.assert_allclose(dtt.item(), float(dtj), rtol=1e-10)
    close(stt.u, sj.u, 1e-9)
    close(stt.p, sj.p, 1e-8)
    close(stt.u0, sj.u0, 0.0)


def test_mom_step_entry_sphere(sphere):
    """One `mom_step_impl` from the entry() sphere state (with seeded noise)."""
    res_j, res_t = step_both(sphere, perturbed(sphere, 2, amp=0.02))
    _check_step(res_j, res_t)


def test_mom_step_2d():
    """The plain path is general in D: one 2D step on a (34, 18) grid."""
    sim = jax_sphere_sim((32, 16), 4.0, 4.0 / 100)
    res_j, res_t = step_both(sim, perturbed(sim, 3, amp=0.02))
    _check_step(res_j, res_t)


def test_interop_roundtrip(sphere):
    d = perturbed(sphere, 4)
    st = interop.flow_state_from_numpy(d, "cpu", F64)
    for k, v in d.items():
        assert np.array_equal(getattr(st, k).numpy(), v)
    assert st.nu.dim() == 0
    with pytest.raises(KeyError):
        interop.flow_state_from_numpy({k: v for k, v in d.items() if k != "p"},
                                      "cpu", F64)
    st2 = dataclasses.replace(st, p=st.p + 1)
    assert not torch.equal(st2.p, st.p)
