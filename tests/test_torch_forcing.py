"""Forced flows of the port against the JAX package, on the CPU: the
band-sparse BDIM (K2), a callable ``ubc``, `accelerate`, the ``udf`` hook and
the Smagorinsky LES, on both engines.  Inputs come from a numpy seed; every
port object is built with ``device="cpu"``.

(a) `stencil3d.bdim_band_plain` against `pallas_flat.bdim_band` in Pallas
    interpret mode (float32, the inputs of `tests/test_pallas_kernels.py`'s
    `test_bdim_band`, atol 2e-5: the two round in another order) and against
    the port's full `bdim_plain` in float64 where the band premise holds
    (1e-13 of max): a band in the middle, at row 1, at row Nx−1, empty, and
    with ``perdir=(2,)``.
(b) `accelerate`, the callable `bc_vector` and `les.sgs` against JAX in
    float64, 1e-12.
(c) Whole steps in float64 against JAX, 3 steps of a 32×16×16 sphere with
    ``udf=sgs(...)``, with ``g``, with a callable ``ubc``: equal `pois_n`, u
    and p to 1e-10 of max, on ``engine="3d"`` and ``engine="flat"``.
(d) The three cases of `tests/test_les.py` on the port in 2-D, and the
    constructor's checks of 3-argument callables."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.models import flow as fl_j
from waterlily_tpu.ops import bc as bc_j
from waterlily_tpu.ops import flat as fo
from waterlily_tpu.ops import pallas_flat as plf
from waterlily_tpu.utils import les as les_j
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.models import flowflat as ff
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector
from waterlily_tpu_torch.ops.grid import interior
from waterlily_tpu_torch.utils import les

F64 = torch.float64
SHAPE = (12, 10, 7)
# (lo, hi): in the middle, touching row 1, touching row Nx-1, empty
BANDS = {"middle": (4, 9), "row1": (1, 5), "top": (7, 11), "empty": (1, 1)}


# ------------------------------------------------------------ (a) K2
def band_fields(band, perdir, dtype, seed=0):
    """The inputs of `test_pallas_kernels.test_bdim_band`: moments that are
    the far field outside the x rows ``[lo, hi)``."""
    lo, hi = band
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.standard_normal((3,) + SHAPE), dtype=dtype)
    inb = ((torch.arange(SHAPE[0]) >= lo) & (torch.arange(SHAPE[0]) < hi))
    inb = inb.to(dtype)[:, None, None]
    mu0_far = bc_vector(torch.ones_like(u), (0.0,) * 3, perdir=perdir)
    return dict(u=u, u0=u + 0.1, f=0.5 * u, V=0.2 * u * inb,
                mu0=mu0_far + (u.abs() - mu0_far) * inb,
                mu1=torch.stack([0.1 * u, 0.2 * u, 0.3 * u]) * inb)


@pytest.mark.parametrize("perdir", [(), (2,)], ids=["walls", "perz"])
@pytest.mark.parametrize("band", BANDS.values(), ids=BANDS.keys())
def test_bdim_band_vs_pallas(monkeypatch, band, perdir):
    monkeypatch.setattr(plf, "_INTERPRET", True)
    d = band_fields(band, perdir, torch.float32)
    geom = fo.geom_of(SHAPE)
    args = [fo.to_flat(jnp.asarray(d[k].numpy()), geom)
            for k in ("u", "u0", "f", "V", "mu0", "mu1")]
    want = plf.bdim_band(*args, jnp.float32(0.2), geom, band, perdir)
    got = st.bdim_band_plain(*d.values(), 0.2, band, perdir)
    np.testing.assert_allclose(got.numpy(), np.asarray(fo.from_flat(want, geom)),
                               atol=2e-5)


@pytest.mark.parametrize("perdir", [(), (2,)], ids=["walls", "perz"])
@pytest.mark.parametrize("band", BANDS.values(), ids=BANDS.keys())
def test_bdim_band_equals_full_bdim_f64(band, perdir):
    d = band_fields(band, perdir, F64, seed=1)
    got = st.bdim_band_plain(*d.values(), 0.2, band, perdir)
    want = st.bdim_plain(*d.values(), 0.2)
    assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max())
    # the wrapper on the CPU is the plain version
    assert torch.equal(st.bdim_band_k(*d.values(), 0.2, band, perdir), got)


def test_bdim_band_never_reads_moments_outside_the_slab():
    d = band_fields((4, 9), (), F64, seed=2)
    want = st.bdim_band_plain(*d.values(), 0.2, (4, 9))
    for k in ("V", "mu0", "mu1"):
        junk = d[k].clone()
        junk[..., :3, :, :] = float("nan")
        junk[..., 10:, :, :] = float("nan")
        d2 = dict(d, **{k: junk})
        assert torch.equal(st.bdim_band_plain(*d2.values(), 0.2, (4, 9)), want)


# ------------------------------------------------------------ (b) pieces
def ubc_j(i, x, t):
    ramp = 0.5 * (1 - jnp.cos(jnp.pi * jnp.minimum(t, 1.0)))
    return ramp * (1.0 + 0.1 * jnp.sin(0.3 * x[1])) if i == 0 else 0.05 * t * x[0]


def ubc_t(i, x, t):
    ramp = 0.5 * (1 - torch.cos(torch.pi * torch.clamp(t, max=1.0)))
    return ramp * (1.0 + 0.1 * torch.sin(0.3 * x[1])) if i == 0 else 0.05 * t * x[0]


def g_j(i, x, t):
    return 0.05 * jnp.cos(0.2 * x[0] + t) if i == 1 else 0.0


def g_t(i, x, t):
    return 0.05 * torch.cos(0.2 * x[0] + t) if i == 1 else 0.0


def close64(t, j, tol=1e-12):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, atol=tol * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("shape", [(9, 8, 7), (10, 9)], ids=["3d", "2d"])
@pytest.mark.parametrize("which", ["g", "ubc", "both"])
def test_accelerate_vs_jax(monkeypatch, shape, which):
    monkeypatch.setattr(fl, "ACCELERATE_CHUNK", 100)     # several chunks
    D = len(shape)
    f = np.random.default_rng(3).standard_normal((D,) + shape)
    gj, gt = (g_j, g_t) if which != "ubc" else (None, None)
    uj, ut = (ubc_j, ubc_t) if which != "g" else ((1.0,) * D, (1.0,) * D)
    want = fl_j.accelerate(jnp.asarray(f), 0.4, gj, uj, jnp.float64)
    got = fl.accelerate(torch.as_tensor(f), 0.4, gt, ut, F64)
    close64(got, want)
    assert got.data_ptr() != torch.as_tensor(f).data_ptr()


@pytest.mark.parametrize("shape", [(9, 8, 7), (10, 9)], ids=["3d", "2d"])
@pytest.mark.parametrize("save_exit", [False, True])
def test_callable_bc_vector_vs_jax(shape, save_exit):
    D = len(shape)
    u = np.random.default_rng(4).standard_normal((D,) + shape)
    want = bc_j.bc_vector(jnp.asarray(u), ubc_j, jnp.float64(0.7), save_exit)
    got = bc_vector(torch.as_tensor(u), ubc_t, 0.7, save_exit)
    close64(got, want)
    # a periodic direction keeps its wrap
    want = bc_j.bc_vector(jnp.asarray(u), ubc_j, jnp.float64(0.7), save_exit, (1,))
    close64(bc_vector(torch.as_tensor(u), ubc_t, 0.7, save_exit, (1,)), want)


@pytest.mark.parametrize("shape", [(9, 8, 7), (10, 9)], ids=["3d", "2d"])
def test_sgs_vs_jax(shape):
    D = len(shape)
    rng = np.random.default_rng(5)
    f, u = rng.standard_normal((2, D) + shape)
    want = les_j.sgs(les_j.smagorinsky(0.2, 1.5))(jnp.asarray(f), None,
                                                  jnp.asarray(u), 0.0)
    got = les.sgs(les.smagorinsky(0.2, 1.5))(torch.as_tensor(f), None,
                                             torch.as_tensor(u), 0.0)
    close64(got, want)


# ------------------------------------------------------------ (c) the slice
DIMS, R = (32, 16, 16), 4.0
CASES = {
    "les": (dict(ubc=(1.0, 0.0, 0.0)), dict(ubc=(1.0, 0.0, 0.0)), True),
    "g": (dict(ubc=(1.0, 0.0, 0.0), g=g_j), dict(ubc=(1.0, 0.0, 0.0), g=g_t), False),
    "ubc": (dict(ubc=ubc_j, U=1.0), dict(ubc=ubc_t, U=1.0), False),
}


@pytest.mark.parametrize("engine", ["3d", "flat"])
@pytest.mark.parametrize("case", CASES)
def test_forced_trajectory_f64(case, engine):
    kw_j, kw_t, with_udf = CASES[case]
    kw_j, kw_t = dict(kw_j), dict(kw_t)
    ctr = [DIMS[0] / 2, DIMS[1] / 2, DIMS[2] / 2]
    cj, ct = jnp.asarray(ctr, jnp.float64), torch.tensor(ctr, dtype=F64)
    sim_j = SimulationJ(DIMS, kw_j.pop("ubc"), R, nu=R / 100, dtype=jnp.float64,
                        body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - R),
                        engine=engine, **kw_j)
    sim_t = Simulation(DIMS, kw_t.pop("ubc"), R, nu=R / 100, dtype=F64,
                       body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - R),
                       engine=engine, device="cpu", **kw_t)
    assert sim_t.engine == engine
    close64(sim_t.flow.u, sim_j.flow.u)
    udf_j = les_j.sgs(les_j.smagorinsky(0.17)) if with_udf else None
    udf_t = les.sgs(les.smagorinsky(0.17)) if with_udf else None
    for _ in range(3):
        sim_j.sim_step(remeasure=False, udf=udf_j)
        sim_t.sim_step(remeasure=False, udf=udf_t)
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    close64(sim_t.flow.u, sim_j.flow.u, 1e-10)
    close64(sim_t.flow.p, sim_j.flow.p, 1e-10)


def test_flat_forced_step_takes_the_band(monkeypatch):
    """A forced half step of the flat engine runs the band-sparse BDIM on
    ``cfg.band_x`` and no fused conv–diff; the plain step the reverse."""
    seen = []
    real = ff.bdim_band
    monkeypatch.setattr(ff, "bdim_band",
                        lambda *a: seen.append(a[7:]) or real(*a))
    monkeypatch.setattr(ff, "conv_diff_bdim", None)      # never called
    ct = torch.tensor([16.0, 8.0, 8.0], dtype=F64)
    sim = Simulation(DIMS, (1.0, 0.0, 0.0), R, nu=R / 100, dtype=F64, g=g_t,
                     body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - R),
                     engine="flat", device="cpu")
    sim.sim_step(remeasure=False)
    assert seen == [(sim.flow.cfg.band_x, ())] * 2 and sim.flow.cfg.band_x == (6, 28)


# ------------------------------------------------------------ (d) udf, checks
def test_udf_advecting_velocity():
    calls = []

    def rec(f, state, u_adv, t):
        calls.append((float(interior(state.u, 2).abs().max()), float(t)))
        return f

    flow = fl.Flow((16, 16), (1.0, 0.0), dtype=F64, device="cpu")
    levels, masks = mg.make_mg(flow.state.mu0)
    fl.mom_step_impl(flow.cfg, flow.state, levels, masks, 0.25, 0.0, rec)
    # once per phase; the predictor's field has its interior zeroed and is
    # forced at t0, the corrector's is the projected field, forced at t1
    assert len(calls) == 2 and calls[0] == (0.0, 0.0)
    assert calls[1][0] > 0.5 and calls[1][1] == 0.25
    state, *_ = fl.mom_step_impl(flow.cfg, flow.state, levels, masks, 0.25, 0.0,
                                 lambda f, state, u_adv, t: f + u_adv)
    assert float((interior(state.u, 2) - 1.0).abs().max()) > 0.05


def test_2arg_style_force_udf():
    calls = {"n": 0}

    def grav(f, state, u_adv, t, g=0.5):
        calls["n"] += 1
        return f + g

    sim = Simulation((16, 16), (1.0, 0.0), 16, U=1.0, dtype=F64, device="cpu")
    sim.sim_step(udf=grav)
    assert calls["n"] == 2
    assert bool(torch.isfinite(sim.flow.u).all())


def test_sgs_runs_and_dissipates():
    def ic(i, x):
        return torch.sin(2 * torch.pi * x[1] / 16) if i == 0 else 0.0

    sim = Simulation((16, 16), (0.0, 0.0), 16, U=1.0, u0=ic, perdir=(0, 1),
                     dtype=F64, device="cpu")
    ke0 = float(torch.sum(interior(sim.flow.u, 2) ** 2))
    udf = les.sgs(les.smagorinsky(Cs=0.2, delta=1.0))
    sim.sim_step_n(5, udf=udf)
    assert bool(torch.isfinite(sim.flow.u).all())
    assert float(torch.sum(interior(sim.flow.u, 2) ** 2)) < ke0


@pytest.mark.parametrize("kw,match", [
    (dict(ubc=lambda i, x: 0.0, U=1.0), "signature ubc"),
    (dict(g=lambda i, x, t: x), "scalar per component"),
    (dict(g=lambda i, x, t: x.foo), "failed on a dummy point"),
    (dict(ubc=lambda i, x, t: 0.0), "U .velocity scale. must be given"),
], ids=["two_args", "vector", "raises", "no_U"])
def test_callable_checks(kw, match):
    ubc = kw.pop("ubc", (1.0, 0.0))
    with pytest.raises(ValueError, match=match):
        Simulation((16, 8), ubc, 4.0, dtype=F64, device="cpu", **kw)


def test_callable_ubc_initial_state():
    """With no ``u0`` the initial field is ``ubc`` at t = 0 on every face."""
    sim = Simulation((16, 8), lambda i, x, t: 0.5 + 0.1 * x[1] + t if i == 0 else 0.0,
                     4.0, U=1.0, dtype=F64, device="cpu")
    y = torch.arange(10, dtype=F64) - 0.5
    assert torch.allclose(sim.flow.u[0], (0.5 + 0.1 * y).expand(18, 10))
    assert float(sim.flow.u[1].abs().max()) == 0.0
