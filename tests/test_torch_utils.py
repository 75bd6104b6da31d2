"""The port's utilities against the JAX package, float64 on the CPU:
`utils.metrics` (λ₂, azimuthal vorticity, helicity, moments, `MeanFlow`;
`tests/test_metrics.py`'s cases), `utils.interp` (`tests/test_util.py`'s
cases, batched over a points axis), `utils.log` (`tests/test_io.py::
test_solver_logger`: the same text for the same numbers, equal tables for
the same case) and `utils.io` (`tests/test_io.py`'s npz and VTK round
trips and size check, and an npz of either package stepping on in the
other).  Every port object lives on ``device="cpu"``."""
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.ops.bc import apply_vector as apply_vector_j
from waterlily_tpu.utils import interp as ip_j
from waterlily_tpu.utils import io as io_j
from waterlily_tpu.utils import log as log_j
from waterlily_tpu.utils import metrics as mt_j
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.interop import meanflow_from_numpy
from waterlily_tpu_torch.ops.grid import loc_grid
from waterlily_tpu_torch.utils import interp as ip
from waterlily_tpu_torch.utils import io
from waterlily_tpu_torch.utils import log
from waterlily_tpu_torch.utils import metrics as mt

F64 = torch.float64


def T(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def close_rel(t, j, rel=1e-12):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * max(np.abs(j).max(), 1e-300))


# ------------------------------------------------------------ metrics
def test_pointwise_metrics():
    """u_i = x_i + x0·x1·x2 on (3, 4, 5), probed at (1, 2, 3)
    (`test_metrics.jl`): λ₂ = 1, ω and ω·θ̂ analytic; every field equal to
    JAX's."""
    shape = (3, 4, 5)
    uj = apply_vector_j(lambda i, x: x[i] + x[0] * x[1] * x[2], 3, shape, jnp.float64)
    u = T(uj)
    J = (1, 2, 3)
    x = loc_grid(None, shape, F64, "cpu")[:, 1, 2, 3].numpy()
    px = np.prod(x)
    w_exact = np.cross(1.0 / x, np.repeat(px, 3))
    lam2 = mt.lambda2_field(u)
    assert lam2[J].item() == pytest.approx(1.0)
    close_rel(lam2, mt_j.lambda2_field(uj))
    center = x + np.array([0, 1, 2])
    wth = mt.omega_theta_field(u, (0, 0, 1), center)
    assert wth[J].item() == pytest.approx(w_exact[0])
    close_rel(wth, mt_j.omega_theta_field(uj, (0, 0, 1), center))
    close_rel(mt.omega_field(u)[:, 1, 2, 3], w_exact)


def test_lambda2_chunks(monkeypatch):
    """`lambda2_field` over several `eigvalsh` chunks equals one call."""
    u = torch.tensor(np.random.default_rng(1).standard_normal((3, 9, 8, 7)))
    whole = mt.lambda2_field(u)
    monkeypatch.setattr(mt, "LAMBDA2_CHUNK", 100)
    assert torch.equal(mt.lambda2_field(u), whole)
    close_rel(whole, mt_j.lambda2_field(jnp.asarray(u.numpy())))


def test_helicity():
    """u = (x, 0, 0), ω = (y + ½, 0, 0): h = u_mid·ω_mid (`test_metrics.jl`),
    and equal to JAX's on random fields."""
    shape = (6, 6, 6)
    x = loc_grid(0, shape, F64, "cpu")
    u = torch.stack([x[0], 0 * x[0], 0 * x[0]])
    w = torch.stack([loc_grid(0, shape, F64, "cpu")[1] + 0.5, 0 * x[0], 0 * x[0]])
    xl = loc_grid(None, shape, F64, "cpu")[:, 2, 2, 2]
    assert mt.helicity_field(u, w)[2, 2, 2].item() == pytest.approx(
        (xl[0] * (xl[1] + 1)).item())
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((3,) + shape), rng.standard_normal((3,) + shape)
    close_rel(mt.helicity_field(T(a), T(b)), mt_j.helicity_field(jnp.asarray(a),
                                                                jnp.asarray(b)))


def circle_bodies(N):
    return (AutoBody(lambda x, t: torch.sqrt(torch.sum((x - N / 2) ** 2)) - N // 4),
            AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - N / 2) ** 2)) - N // 4))


@pytest.mark.parametrize("D", [2, 3])
def test_moments(D):
    """Zero velocity gives no viscous force or moment, hydrostatic p no
    moment about the centre (`test_metrics.jl`); random fields give JAX's
    moments to 1e-10, summed in float64."""
    N = 32 if D == 2 else 16
    bt, bj = circle_bodies(N)
    c = np.full(D, N / 2)
    shape = (N,) * D
    u0 = torch.zeros((D,) + shape, dtype=F64)
    assert torch.allclose(mt.viscous_force(u0, 1.0, bt), torch.zeros(D, dtype=F64))
    assert torch.allclose(mt.viscous_moment(c, u0, 1.0, bt), torch.zeros(1 if D == 2 else 3,
                                                                         dtype=F64))
    p = loc_grid(None, shape, F64, "cpu")[1]
    m = mt.pressure_moment(c, p, bt)
    assert m.dtype == F64 and torch.allclose(m, torch.zeros_like(m), atol=1e-8)
    rng = np.random.default_rng(D)
    pr, ur = rng.standard_normal(shape), rng.standard_normal((D,) + shape)
    x0 = c + 1.5
    close_rel(mt.pressure_moment(x0, T(pr), bt), mt_j.pressure_moment(x0, jnp.asarray(pr), bj),
              1e-10)
    close_rel(mt.viscous_moment(x0, T(ur), 0.1, bt),
              mt_j.viscous_moment(x0, jnp.asarray(ur), 0.1, bj), 1e-10)


def bl_ubc(L):
    def ubc(i, x, t):
        prof = 4.0 * (((x[1] + 0.5) / (2 * L)) - ((x[1] + 0.5) / (2 * L)) ** 2)
        return prof if i == 0 else 0.0 * prof
    return ubc


def test_meanflow():
    """`test_metrics.jl`'s boundary-layer channel (16², float32) to steady
    state: the means track the flow, ``uu`` is UU − U⊗U, `reset` restarts;
    each update equal to the JAX `MeanFlow`'s on the same fields."""
    L = 16
    sim = Simulation((L, L), bl_ubc(L), L, U=1, nu=0.001, dtype=torch.float32,
                     device="cpu")
    mf = mt.MeanFlow(flow=sim.flow, uu_stats=True)
    mfj = mt_j.MeanFlow(shape=(L, L), uu_stats=True)

    class Snap:              # the JAX MeanFlow reads ``time`` and ``state``
        pass
    for k, t in enumerate(np.arange(0, 10.0, 0.1)):
        sim.sim_step(float(t))
        mf.update(sim.flow)
        snap = Snap()
        snap.time = sim.flow.time
        snap.state = Snap()
        snap.state.u, snap.state.p = (jnp.asarray(sim.flow.u.numpy()),
                                      jnp.asarray(sim.flow.p.numpy()))
        mfj.update(snap)
        if k in (0, 1, 50):
            for a, b in ((mf.U, mfj.U), (mf.P, mfj.P), (mf.UU, mfj.UU)):
                close_rel(a, b, 1e-6)
    tol = 1e-3
    assert torch.allclose(sim.flow.u, mf.U, atol=tol)
    assert torch.allclose(sim.flow.p, mf.P, atol=tol)
    uu = torch.einsum("i...,j...->ij...", sim.flow.u, sim.flow.u)
    assert torch.allclose(uu, mf.UU, atol=2 * tol)
    assert torch.allclose(mf.uu(), mf.UU - torch.einsum("i...,j...->ij...", mf.U, mf.U))
    assert sim.flow.time == pytest.approx(mf.time)
    assert mf.t == pytest.approx(mfj.t)
    mf.reset()
    assert mf.U.abs().max().item() == 0.0 and mf.t == [0.0]


# ------------------------------------------------------------ interp
def test_interp():
    """`test_util.jl`'s queries, clamped ones included, one point and a
    batch (each row equal to JAX's sample of that point)."""
    shape = (8, 8)
    u = torch.stack([loc_grid(i, shape, F64, "cpu")[i] for i in range(2)])
    p = loc_grid(None, shape, F64, "cpu")[0]
    assert torch.allclose(ip.interp_vector([2.5, 1.0], u), torch.tensor([2.5, 1.0], dtype=F64))
    assert torch.allclose(ip.interp_vector([3.5, 3.0], u), torch.tensor([3.5, 3.0], dtype=F64))
    assert torch.allclose(ip.interp_vector([-1.0, 4.0], u), torch.tensor([-0.5, 4.0], dtype=F64))
    assert ip.interp_scalar([2.5, 1.0], p).item() == pytest.approx(2.5)
    assert ip.interp_scalar([10.0, 10.0], p).item() == pytest.approx(6.0)
    rng = np.random.default_rng(3)
    ur, pr = rng.standard_normal((2,) + shape), rng.standard_normal(shape)
    pts = rng.uniform(-2.0, 9.0, (40, 2))
    vj = np.stack([np.asarray(ip_j.interp_vector(jnp.asarray(q), jnp.asarray(ur)))
                   for q in pts])
    sj = np.stack([np.asarray(ip_j.interp_scalar(jnp.asarray(q), jnp.asarray(pr)))
                   for q in pts])
    close_rel(ip.interp_vector(pts, T(ur)), vj)
    close_rel(ip.interp_scalar(pts, T(pr)), sj)


def test_spread_and_squeeze():
    src = torch.tensor(np.random.default_rng(0).random((2, 3)))
    d3 = ip.spread(src, 4, dim=2)
    assert d3.shape == (2, 3, 4) and all(torch.equal(d3[:, :, k], src) for k in range(4))
    srcv = torch.tensor(np.random.default_rng(1).random((2, 4, 5)))
    d4 = ip.spread(srcv, 3, dim=2, lead=1)
    assert d4.shape == (2, 4, 5, 3) and torch.equal(d4[..., 1], srcv)
    g = torch.Generator().manual_seed(5)
    noisy = ip.spread(src, 4, dim=2, noise=0.1, generator=g)
    d = noisy - d3
    assert 0.0 <= d.min().item() and d.max().item() < 0.1 and d.std().item() > 0.01
    assert ip.squeeze(torch.zeros((3, 1, 4))).shape == (3, 4)


def test_spread_sim():
    """A 2-D circle extruded into a periodic 3-D cylinder (`test_util.jl:
    27-36`); a wrong axis and a mismatched body raise."""
    cyl = lambda x, t: torch.sqrt((x[0] - 8) ** 2 + (x[1] - 8) ** 2) - 6   # noqa: E731
    sim2 = Simulation((32, 16), (1.0, 0.0), 1.0, body=AutoBody(cyl), dtype=F64, device="cpu")
    shape = sim2.flow.cfg.shape
    sim2.flow.state.p = loc_grid(None, shape, F64, "cpu")[0]
    sim2.flow.state.u = torch.stack([loc_grid(i, shape, F64, "cpu")[i] for i in range(2)])
    sim3 = Simulation((32, 16, 8), (1.0, 0.0, 0.0), 1.0, body=AutoBody(cyl), perdir=(2,),
                      dtype=F64, device="cpu")
    ip.spread_sim(sim3, sim2, dim=2)
    u3, p3 = sim3.flow.u, sim3.flow.p
    for k in (0, 2, 5, 7):
        assert torch.equal(u3[:2, :, :, k], sim2.flow.u)
        assert torch.equal(p3[:, :, k], sim2.flow.p)
    assert u3[2].abs().max().item() == 0.0 and torch.equal(sim3.flow.state.u0, u3)
    sim3.sim_step(remeasure=False)
    assert torch.isfinite(sim3.flow.u).all()
    with pytest.raises(ValueError):
        ip.spread_sim(sim3, sim2, dim=0)
    ball = Simulation((32, 16, 8), (1.0, 0.0, 0.0), 1.0, perdir=(2,), dtype=F64,
                      device="cpu",
                      body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 8.0) ** 2)) - 6))
    with pytest.raises(ValueError):
        ip.spread_sim(ball, sim2, dim=2)


# ------------------------------------------------------------ log and io
def circle_pair():
    """`tests/test_io.py::make_sim(2)` (16², radius 4) in float64, in both
    packages."""
    sj = SimulationJ((16, 16), (1.0, 0.0), 4.0, nu=0.02, dtype=jnp.float64,
                     body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - 8.0) ** 2)) - 4.0))
    st = Simulation((16, 16), (1.0, 0.0), 4.0, nu=0.02, dtype=F64, device="cpu",
                    body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 8.0) ** 2)) - 4.0))
    return sj, st


def port_sim(D=2, dtype=torch.float32):
    dims = (16,) * D
    return Simulation(dims, (1.0,) + (0.0,) * (D - 1), 4.0, nu=0.02, dtype=dtype,
                      device="cpu",
                      body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 8.0) ** 2)) - 4.0))


@pytest.fixture(scope="module")
def jax_pair():
    """The 16² circle of `circle_pair`, shared: the logger test steps it
    twice, the npz test on from there."""
    return circle_pair()


def test_solver_logger(tmp_path, jax_pair):
    """Two steps of the same f64 case in both packages: the two logs' tables
    (`parse_log`) are equal; and the JAX logger writes the port's rows as
    the same text (float32 and float64, PCG's ω = 0 too)."""
    sj, st = jax_pair
    lj, lt = log_j.SolverLogger(str(tmp_path / "j")), log.SolverLogger(str(tmp_path / "t"))
    for _ in range(2):
        sj.sim_step(remeasure=False)
        st.sim_step(remeasure=False)
        lj.log_step(sj)
        lt.log_step(st)
    cj, rij, r1j = log.parse_log(lj.fname)
    ct, rit, r1t = log.parse_log(lt.fname)
    assert ct == cj == list(st.pois_n) and len(ct) == 4
    for a, b in zip(rit + r1t, rij + r1j):
        np.testing.assert_allclose(a, b, rtol=1e-10)
    assert all(a[-1] < 2e-3 for c, a in zip(ct, rit) if c > 0)
    for dtype, psolver in ((torch.float32, "mg"), (F64, "mg"), (torch.float32, "pcg")):
        sim = Simulation((16, 16), (1.0, 0.0), 4.0, nu=0.02, dtype=dtype, device="cpu",
                         psolver=psolver)
        sim.perturb(0.1)
        sim.sim_step(remeasure=False)
        a, b = log.SolverLogger(str(tmp_path / "a")), log_j.SolverLogger(str(tmp_path / "b"))
        a.log_step(sim)
        npdt = np.float32 if dtype == torch.float32 else np.float64
        pad = np.zeros((2, sim.flow.cfg.itmx + 1, 3), npdt)
        for k, rows in enumerate(sim.solver_stats):
            pad[k, :len(rows)] = rows
        b.log_step(type("S", (), {"solver_stats": pad, "pois_n": sim.pois_n})())
        assert open(a.fname).read() == open(b.fname).read()


@pytest.mark.parametrize("D", [2, 3])
def test_npz_roundtrip(tmp_path, D):
    """`test_io.py::test_npz_roundtrip` on the port: fields, dt and the
    `MeanFlow` come back bit for bit, and stepping continues."""
    sim = port_sim(D)
    sim.sim_step(0.2, remeasure=False)
    mf = mt.MeanFlow(flow=sim.flow, uu_stats=True)
    mf.update(sim.flow)
    f = str(tmp_path / "ckpt.npz")
    io.save_state(f, sim, meanflow=mf)
    sim2 = port_sim(D)
    mf2 = mt.MeanFlow(flow=sim2.flow, uu_stats=True)
    io.load(f, sim2, meanflow=mf2)
    assert torch.equal(sim2.flow.u, sim.flow.u) and torch.equal(sim2.flow.p, sim.flow.p)
    assert torch.equal(sim2.flow.state.u0, sim.flow.u)
    assert sim2.flow.dt == sim.flow.dt and mf2.t == mf.t
    assert torch.equal(mf2.U, mf.U) and torch.equal(mf2.UU, mf.UU)
    sim.sim_step(remeasure=False)
    sim2.sim_step(remeasure=False)
    assert torch.equal(sim2.flow.u, sim.flow.u)


def test_size_mismatch_and_orbax_raise(tmp_path):
    """A checkpoint of another size is refused (`WaterLilyJLD2Ext.jl:30-41`);
    orbax paths raise."""
    f = str(tmp_path / "ckpt.npz")
    io.save_state(f, port_sim(2))
    other = Simulation((8, 8), (1.0, 0.0), 4.0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        io.load_state(f, other)
    for call in (io.save, io.load):
        with pytest.raises(ValueError, match="orbax"):
            call(str(tmp_path / "state.ckpt"), other)


@pytest.mark.parametrize("D", [2, 3])
def test_vtk_roundtrip(tmp_path, D, monkeypatch):
    """`test_io.py::test_vtk_roundtrip`: three writes, a restart from the
    collection restores u, p and the time, and the writer appends."""
    monkeypatch.chdir(tmp_path)
    sim = port_sim(D)
    w = io.VTKWriter("wl")
    for k in range(3):
        if k:
            sim.sim_step(remeasure=False)
        w.write(sim)
    w.close()
    sim2, w2 = io.load_vtk(port_sim(D), "wl.pvd")
    assert torch.allclose(sim2.flow.u, sim.flow.u, atol=1e-6)
    assert torch.allclose(sim2.flow.p, sim.flow.p, atol=1e-6)
    assert sim2.time == pytest.approx(sim.time, abs=1e-6)
    sim2.sim_step(remeasure=False)
    w2.write(sim2)
    assert w2.count == 4 and os.path.exists(os.path.join("vtk_data", "wl_000003.vti"))
    fields = io._read_vti(os.path.join("vtk_data", "wl_000000.vti"))
    ref = io_j._read_vti(os.path.join("vtk_data", "wl_000000.vti"))
    assert fields.keys() == ref.keys()
    assert all(np.array_equal(fields[k], ref[k]) for k in fields)


def test_npz_across_packages(tmp_path, jax_pair):
    """An npz of the JAX package's `save_state` loads into the port and
    the next step equals JAX's next step (f64); and the other way round,
    with a `MeanFlow` each way."""
    sj, _ = jax_pair
    while len(sj.flow.dt) < 3:
        sj.sim_step(remeasure=False)
    mfj = mt_j.MeanFlow(flow=sj.flow, uu_stats=True)
    mfj.update(sj.flow)
    fj = str(tmp_path / "jax.npz")
    io_j.save_state(fj, sj, meanflow=mfj)
    _, st = circle_pair()
    mft = mt.MeanFlow(flow=st.flow, uu_stats=True)
    io.load_state(fj, st, meanflow=mft)
    mfn = meanflow_from_numpy({"P": np.asarray(mfj.P), "U": np.asarray(mfj.U),
                               "UU": np.asarray(mfj.UU), "t": mfj.t}, "cpu", F64)
    assert torch.equal(mft.UU, mfn.UU) and mft.t == mfn.t
    sj.sim_step(remeasure=False)
    st.sim_step(remeasure=False)
    assert st.pois_n[-2:] == list(sj.pois_n[-2:])
    close_rel(st.flow.u, sj.flow.u, 1e-10)
    close_rel(st.flow.p, sj.flow.p, 1e-10)
    ft = str(tmp_path / "port.npz")
    io.save_state(ft, st, meanflow=mft)
    sj2, _ = circle_pair()
    mfj2 = mt_j.MeanFlow(flow=sj2.flow, uu_stats=True)
    io_j.load_state(ft, sj2, meanflow=mfj2)
    assert sj2.flow.dt == st.flow.dt and mfj2.t == mft.t
    sj2.sim_step(remeasure=False)
    st.sim_step(remeasure=False)
    assert st.pois_n[-2:] == list(sj2.pois_n[-2:])
    close_rel(st.flow.u, sj2.flow.u, 1e-10)
    assert math.isfinite(st.flow.p.abs().max().item())
