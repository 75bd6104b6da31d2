"""The port's flat engine (`engine="flat"`) against the JAX package's, on
the CPU.

(a) Each plain version of `ops/fused3d.py` against its TPU kernel of
    `waterlily_tpu/ops/pallas_flat.py` in Pallas interpret mode, float32 at
    (12, 10, 7): the same numpy inputs go to JAX through `ops.flat.to_flat`
    and come back through `from_flat`.  atol 2e-5, as in
    `tests/test_pallas_kernels.py` (the two round in another order).
(b) The slice: port `Simulation(engine="flat")` against JAX
    `Simulation(engine="flat")` (its jnp path), float64, 3 steps of an R=4
    sphere where the body slab reaches ghost row 0 (24×16×16 at x=8: the
    band is clamped to row 1 and ``f_rows`` is None) and where it is
    interior (32×16×16 at x=16: ``f_rows`` is the slab).  Equal `pois_n`,
    dt rtol 1e-10, u atol 1e-9, p atol 1e-8.  Also with no body, and the
    ``engine="auto"`` rule on the CPU.
(c) float32: port flat (plain versions) against JAX flat with its Pallas
    kernels in interpret mode, 16×12×12, 2 steps: `pois_n` ±1 (the fused
    norms reduce in another order), u atol 1e-5, p atol 1e-4."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import NoBody as NoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.models import flow as fl_j
from waterlily_tpu.ops import flat as fo
from waterlily_tpu.ops import pallas_flat as plf
from waterlily_tpu.simulation import _band_box as band_box_j
from waterlily_tpu_torch import AutoBody, NoBody, Simulation
from waterlily_tpu_torch.models import flowflat as ff
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.simulation import _band_box

SHAPE = (12, 10, 7)
UBC = (1.0, 0.25, -0.5)
ATOL = 2e-5


# ------------------------------------------------------------ (a) kernels
@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(plf, "_INTERPRET", True)


def fields(seed):
    """Random float32 fields at SHAPE as torch tensors: u, u0, x, r and eps
    (both with zero ghosts), a level (L > 0, D, iD)."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s + SHAPE), dtype=torch.float32)
    inner = (slice(1, -1),) * 3
    r, eps = torch.zeros(SHAPE), torch.zeros(SHAPE)
    r[inner] = g()[inner]
    eps[inner] = 0.3 * g()[inner]
    L = torch.as_tensor(0.2 + rng.random((3,) + SHAPE), dtype=torch.float32)
    return dict(u=g(3), u0=g(3), x=g(), r=r, eps=eps, lev=ps.make_level(L))


GEOM = fo.geom_of(SHAPE)


def J(t):
    return fo.to_flat(jnp.asarray(t.numpy()), GEOM)


def close(t, j, atol=ATOL, rows=slice(None)):
    a = t.numpy()
    b = np.asarray(fo.from_flat(j, GEOM))
    np.testing.assert_allclose(a[..., rows, :, :], b[..., rows, :, :], atol=atol)


@pytest.mark.parametrize("keep_base,scale", [(0.0, 1.0), (1.0, 0.5)],
                         ids=["predictor", "corrector"])
@pytest.mark.parametrize("f_rows", [None, (4, 9)], ids=["full", "slab"])
def test_conv_diff_bdim_vs_pallas(interpret, keep_base, scale, f_rows):
    d = fields(0)
    nu, dt = 0.1, 0.2
    u_t, f_t = fz.conv_diff_bdim_plain(d["u"], d["u0"], torch.tensor(nu), dt,
                                       keep_base, scale, st.quick)
    u_j, f_j = plf.conv_diff_k(J(d["u"]), jnp.float32(nu), fl_j.quick, GEOM,
                               cheap=(J(d["u0"]), jnp.float32(dt), keep_base,
                                      scale), f_rows=f_rows)
    close(u_t, u_j)
    close(f_t, f_j, rows=slice(*f_rows) if f_rows else slice(None))


@pytest.mark.parametrize("colors", [[], [0, 1, 0, 1]], ids=["K6", "K7"])
def test_incr_gs_vs_pallas(interpret, colors):
    d = fields(1)
    lev, om = d["lev"], 0.8
    x_t, r_t, n_t = fz.incr_gs_plain(d["x"], d["r"], d["eps"], lev.L, lev.D,
                                     lev.iD, colors, om, want_norms=True)
    args = [J(d[k]) for k in ("x", "r", "eps")] + [J(lev.L), J(lev.D), J(lev.iD)]
    if colors:
        x_j, r_j, (l1, linf) = plf.incr_gs(*args, colors, jnp.float32(om), GEOM,
                                           want_norms=True)
    else:
        x_j, r_j = plf.increment_k(*args[:5], jnp.float32(om), GEOM)
        a = jnp.abs(fo.from_flat(r_j, GEOM))
        l1, linf = jnp.sum(a), jnp.max(a)
    close(x_t, x_j)
    close(r_t, r_j)
    np.testing.assert_allclose(n_t.numpy(), [float(l1), float(linf)], rtol=1e-5)


def test_bc_div_vs_pallas(interpret):
    d = fields(2)
    u_t, div_t = fz.bc_div_plain(d["u"], UBC)
    u_j, div_j = plf.bc_div_k(J(d["u"]), UBC, GEOM)
    close(u_t, u_j)
    close(div_t, div_j)


@pytest.mark.parametrize("want_cfl", [False, True])
def test_projbc_vs_pallas(interpret, want_cfl):
    d = fields(3)
    L = d["lev"].L
    got = fz.projbc_plain(d["u"], d["x"], L, UBC, want_cfl)
    want = plf.projbc_k(J(d["u"]), J(d["x"]), J(L), UBC, GEOM,
                        want_cfl=want_cfl)
    if want_cfl:
        (u_t, s_t), (u_j, s_j) = got, want
        # the kernel's (8, 128) max partial (`_fold8`) holds max(s)
        np.testing.assert_allclose(float(s_t), float(jnp.max(s_j)), rtol=1e-6)
    else:
        u_t, u_j = got, want
    close(u_t, u_j)


def test_fused_wrappers_on_cpu_take_the_plain_version():
    d = fields(4)
    lev = d["lev"]
    before = st.launch_counts()
    nu = torch.tensor(0.1)
    for a, b in zip(fz.conv_diff_bdim_k(d["u"], d["u0"], nu, 0.2, 1.0, 0.5, 0, (4, 9)),
                    fz.conv_diff_bdim_plain(d["u"], d["u0"], nu, 0.2, 1.0, 0.5, st.quick)):
        assert torch.equal(a, b)
    for colors in ([], [0, 1, 0, 1]):
        for a, b in zip(fz.incr_gs_k(d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD,
                                     colors, 0.8, want_norms=True),
                        fz.incr_gs_plain(d["x"], d["r"], d["eps"], lev.L, lev.D,
                                         lev.iD, colors, 0.8, want_norms=True)):
            assert torch.equal(a, b)
    for a, b in zip(fz.bc_div_k(d["u"], UBC), fz.bc_div_plain(d["u"], UBC)):
        assert torch.equal(a, b)
    for a, b in zip(fz.projbc_k(d["u"], d["x"], lev.L, UBC, True),
                    fz.projbc_plain(d["u"], d["x"], lev.L, UBC, True)):
        assert torch.equal(a, b)
    assert st.launch_counts() == before        # no kernel launched on the CPU


def test_incr_gs_equals_increment_then_smooth():
    """K7's contract: the fused tail is the increment followed by the fine
    red-black smooth (`poisson.increment` + `poisson.gauss_seidel_rb`)."""
    d = fields(5)
    lev = d["lev"]
    colors = [(1 - 3 - k0) % 2 for k0 in range(1, 5)]   # gauss_seidel_rb's
    x1, r1 = ps.increment(lev, d["x"], d["r"], d["eps"], 0.8)
    want = ps.gauss_seidel_rb(lev, x1, r1, it=4, omega=0.8)
    got = fz.incr_gs_plain(d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD,
                           colors, 0.8)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# ------------------------------------------------------------ (b) the slice
R = 4.0


def sphere_pair(dims, xc, dtype_j, dtype_t, engine="flat"):
    cj = jnp.asarray([xc, dims[1] / 2, dims[2] / 2], dtype_j)
    ct = torch.tensor([xc, dims[1] / 2, dims[2] / 2], dtype=dtype_t)
    sim_j = SimulationJ(dims, (1.0, 0.0, 0.0), R, nu=R / 100, dtype=dtype_j,
                        body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - R),
                        engine="flat")
    sim_t = Simulation(dims, (1.0, 0.0, 0.0), R, nu=R / 100, dtype=dtype_t,
                       body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - R),
                       engine=engine, device="cpu")
    return sim_j, sim_t


def spy_f_rows(monkeypatch):
    """Record the ``f_rows`` of every fused conv–diff call of the flat step."""
    seen = []
    real = ff.conv_diff_bdim

    def spy(*args, **kw):
        seen.append(args[-1])
        return real(*args, **kw)

    monkeypatch.setattr(ff, "conv_diff_bdim", spy)
    return seen


@pytest.mark.parametrize("dims,xc,band,f_rows", [
    ((24, 16, 16), 8.0, (1, 20), None),
    ((32, 16, 16), 16.0, (6, 28), (5, 29)),
], ids=["slab_at_ghost_row", "slab_interior"])
def test_flat_trajectory_f64(monkeypatch, dims, xc, band, f_rows):
    sim_j, sim_t = sphere_pair(dims, xc, jnp.float64, torch.float64)
    assert sim_t.engine == "flat"
    st_t, st_j = sim_t.flow.state, sim_j.flow.state
    np.testing.assert_array_equal(_band_box(st_t.V, st_t.mu0, st_t.mu1).numpy(),
                                  np.asarray(band_box_j(st_j.V, st_j.mu0, st_j.mu1)))
    assert sim_t.flow.cfg.band_x == sim_j.flow.cfg.band_x == band
    seen = spy_f_rows(monkeypatch)
    for _ in range(3):
        sim_j.sim_step(remeasure=False)
        sim_t.sim_step(remeasure=False)
    assert seen == [f_rows] * 6
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    np.testing.assert_allclose(sim_t.flow.u.numpy(), np.asarray(sim_j.flow.u), atol=1e-9)
    np.testing.assert_allclose(sim_t.flow.p.numpy(), np.asarray(sim_j.flow.p), atol=1e-8)


def test_flat_no_body_f64():
    dims, ubc = (16, 12, 12), (1.0, 0.25, -0.5)
    sim_j = SimulationJ(dims, ubc, 4.0, nu=0.04, body=NoBodyJ(),
                        dtype=jnp.float64, engine="flat")
    sim_t = Simulation(dims, ubc, 4.0, nu=0.04, body=NoBody(),
                       dtype=torch.float64, engine="flat", device="cpu")
    assert sim_t.flow.cfg.band_x is None and sim_j.flow.cfg.band_x is None
    for _ in range(2):
        sim_j.sim_step()
        sim_t.sim_step()
    assert sim_t.pois_n == list(sim_j.pois_n)
    np.testing.assert_allclose(sim_t.flow.dt, sim_j.flow.dt, rtol=1e-10)
    np.testing.assert_allclose(sim_t.flow.u.numpy(), np.asarray(sim_j.flow.u), atol=1e-9)
    np.testing.assert_allclose(sim_t.flow.p.numpy(), np.asarray(sim_j.flow.p), atol=1e-8)


def test_engine_selection_on_cpu():
    cpu = dict(device="cpu")
    assert Simulation((16, 12, 12), (1.0, 0.0, 0.0), 4.0, **cpu).engine == "3d"
    assert Simulation((16, 12, 12), (1.0, 0.0, 0.0), 4.0,
                      dtype=torch.float64, **cpu).engine == "3d"
    assert Simulation((16, 12, 12), (1.0, 0.0, 0.0), 4.0,
                      engine="flat", **cpu).engine == "flat"
    with pytest.raises(ValueError, match="D=3"):
        Simulation((16, 8), (1.0, 0.0), 4.0, engine="flat", **cpu)
    with pytest.raises(ValueError, match="engine"):
        Simulation((16, 12, 12), (1.0, 0.0, 0.0), 4.0, engine="pallas", **cpu)


def test_flat_static_remeasure_keeps_band():
    """A static body re-measured every step keeps its band and its run."""
    a = sphere_pair((24, 16, 16), 8.0, jnp.float64, torch.float64)[1]
    b = Simulation((24, 16, 16), (1.0, 0.0, 0.0), R, nu=R / 100,
                   dtype=torch.float64, body=a.body, engine="flat",
                   device="cpu")
    for _ in range(2):
        a.sim_step()
        b.sim_step(remeasure=False)
    assert a.flow.cfg.band_x == b.flow.cfg.band_x == (1, 20)
    assert a.pois_n == b.pois_n
    assert torch.equal(a.flow.u, b.flow.u) and torch.equal(a.flow.p, b.flow.p)


# ------------------------------------------------------------ (c) float32
def test_flat_trajectory_f32_vs_pallas(interpret):
    dims = (16, 12, 12)
    sim_j, sim_t = sphere_pair(dims, dims[0] / 3, jnp.float32, torch.float32)
    assert sim_t.flow.cfg.band_x == sim_j.flow.cfg.band_x
    for _ in range(2):
        sim_j.sim_step(remeasure=False)
        sim_t.sim_step(remeasure=False)
    assert len(sim_t.pois_n) == len(sim_j.pois_n)
    assert all(abs(a - b) <= 1 for a, b in zip(sim_t.pois_n, sim_j.pois_n))
    np.testing.assert_allclose(sim_t.flow.u.numpy(), np.asarray(sim_j.flow.u), atol=1e-5)
    np.testing.assert_allclose(sim_t.flow.p.numpy(), np.asarray(sim_j.flow.p), atol=1e-4)
