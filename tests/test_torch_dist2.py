"""What `DistSimulation` runs beside the multigrid sphere (ROADMAP [dist-2]),
on CPU meshes of four shards in float64: the distributed PCG solver, a
``udf`` (the Smagorinsky LES) on both engines, the flat engine with a body
that moves across the shard bounds, and forward-mode AD of a decomposed
step and of one decomposed `solve_mg_implicit`.

Each is held against the port's own single-device run, as the JAX package's
`tests/test_dist.py` holds its engines (`test_dist_pcg_solver`,
`test_flat_dist_les_udf`, `test_flat_dist_moving_body_remeasure`), and that
single-device run against the JAX package's on the same inputs, but the LES
on the 3d engine: the JAX 3d engine calls the udf without the halo ctx,
so its inside-u restriction acts at every shard edge and the decomposed run
departs from one device by ~1e-3 of max|u| (`waterlily_tpu/models/flow.py`
`_phase`, `waterlily_tpu/utils/les.py`).  The port calls it the same way;
that case is held against JAX's own decomposed 3d run, and the departure
from one device is stated, so that a change of the reference shows.

The jvps are in ν of a step one step into the sphere's run, each shard's
`torch.func.jvp` entered through `dist.shard_jvp`; the tangent must be
non-zero (a tangent lost across the shard threads comes back as zero, not as
an error) and every solve, primal and tangent, must take as many iterations
as on one device."""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.parallel.dist import DistSimulation as DistSimulationJ
from waterlily_tpu.parallel.dist import make_mesh as make_mesh_j
from waterlily_tpu.utils.les import sgs as sgs_j
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops.dist import shard_jvp
from waterlily_tpu_torch.ops.poisson import PoissonLevel
from waterlily_tpu_torch.parallel import DistSimulation, make_mesh
from waterlily_tpu_torch.utils import les

F64 = torch.float64
TIMEOUT = 60.0
DIMS = (32, 16, 16)
CTR = (12.0, 8.0, 8.0)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(shape):
    return make_mesh(shape, ["cpu"] * math.prod(shape))


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def sphere(moving=False, **kw):
    ctr = torch.tensor(CTR, dtype=F64)
    mp = (lambda x, t: x - torch.stack([t, 0 * t, 0 * t])) if moving else None
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - 4.0, mp)
    return Simulation(DIMS, (1.0, 0.0, 0.0), 4.0, nu=0.02, body=body, dtype=F64,
                      device="cpu", **kw)


@pytest.fixture(scope="module")
def body_j():
    """The JAX package's static sphere, one body for every JAX run (its
    measure compiled once)."""
    ctr = jnp.asarray(CTR, jnp.float64)
    return AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - ctr) ** 2)) - 4.0)


def jax_run(body, n, remeasure, udf=None, **kw):
    """``n`` steps of the JAX package's single-device `sphere`."""
    sim = SimulationJ(DIMS, (1.0, 0.0, 0.0), 4.0, nu=0.02, dtype=jnp.float64, body=body,
                      **kw)
    for _ in range(n):
        sim.sim_step(remeasure=remeasure, **({} if udf is None else {"udf": udf}))
    return sim


@pytest.fixture(scope="module")
def sphere_sim():
    """The port's static sphere, measured once (copies step)."""
    return sphere()


def run_pair(sim, shape, engine, n, **kw):
    """``n`` steps of ``sim`` on one device and of a copy on ``shape``."""
    d = DistSimulation(copy.deepcopy(sim), mesh(shape), engine=engine, timeout=TIMEOUT)
    for _ in range(n):
        sim.sim_step(**kw)
        d.step_once(**kw)
    return sim, d


# ------------------------------------------------------------ PCG
def test_pcg_3d_engine_4_equals_one_device(body_j):
    """`test_dist_pcg_solver` (two steps of its three: 750 outer
    iterations, 15,800 rendezvous): the Krylov iterates depend on the
    order of the dot products' sums, so the runs agree to the tolerance's
    scale, with equal iteration counts at ``tol=1e-7``; so do the port's and
    the JAX package's single-device runs."""
    kw = dict(psolver="pcg", tol=1e-7, itmx=2000)
    sim = sphere(**kw)
    with pytest.raises(ValueError, match="multigrid"):
        DistSimulation(sim, mesh((4,)), engine="flat")
    ref, d = run_pair(sim, (4,), "auto", 2, remeasure=False)
    assert d.engine == "3d" and [p.L.shape for p in d.levels[0]] == [(3, 10, 18, 18)]
    np.testing.assert_allclose(d.u, ref.flow.u.numpy(), rtol=0, atol=1e-7)
    np.testing.assert_allclose(d.p, ref.flow.p.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.sim.flow.dt, ref.flow.dt, rtol=0, atol=1e-9)
    assert d.pois_n == ref.pois_n
    assert all(len(s) == n + 1 for s, n in zip(d.solver_stats, d.pois_n[-2:]))
    j = jax_run(body_j, 2, False, **kw)
    np.testing.assert_allclose(ref.flow.u.numpy(), j.flow.u, rtol=0, atol=1e-7)
    np.testing.assert_allclose(ref.flow.p.numpy(), j.flow.p, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref.flow.dt, j.flow.dt, rtol=0, atol=1e-9)
    assert ref.pois_n == list(j.pois_n)


# ------------------------------------------------------------ a udf
def test_les_flat_engine_4_equals_one_device(sphere_sim, body_j):
    """`test_flat_dist_les_udf`: the udf's ``flat`` form keeps the x fluxes
    at the interior shard edges, so the decomposed flat run is the single
    device's, and that is the JAX package's single device's."""
    ref, d = run_pair(copy.deepcopy(sphere_sim), (4,), "flat", 2, remeasure=False,
                      udf=les.sgs())
    assert d.engine == "flat"
    assert rel(d.u, ref.flow.u.numpy()) <= 1e-11
    assert rel(d.p, ref.flow.p.numpy()) <= 1e-11
    np.testing.assert_allclose(d.sim.flow.dt, ref.flow.dt, rtol=0, atol=1e-12)
    assert d.pois_n == ref.pois_n
    j = jax_run(body_j, 2, False, udf=sgs_j())
    assert rel(ref.flow.u.numpy(), j.flow.u) <= 1e-11
    assert rel(ref.flow.p.numpy(), j.flow.p) <= 1e-11
    np.testing.assert_allclose(ref.flow.dt, j.flow.dt, rtol=0, atol=1e-12)
    assert ref.pois_n == list(j.pois_n)


def test_les_3d_engine_4_equals_jax_decomposed(sphere_sim, body_j):
    simj = SimulationJ(DIMS, (1.0, 0.0, 0.0), 4.0, nu=0.02, dtype=jnp.float64,
                       body=body_j)
    dj = DistSimulationJ(simj, make_mesh_j((4,)), engine="3d")
    # ν replicated, as every step returns it: one compile of the step
    dj.state = dataclasses.replace(
        dj.state, nu=jax.device_put(dj.state.nu, NamedSharding(dj.mesh, P())))
    ref, d = run_pair(copy.deepcopy(sphere_sim), (4,), "3d", 2, remeasure=False,
                      udf=les.sgs())
    udf_j = sgs_j()
    for _ in range(2):
        dj.step_once(remeasure=False, udf=udf_j)
    assert d.engine == "3d"
    assert rel(d.u, dj.u) <= 1e-10 and rel(d.p, dj.p) <= 1e-10
    np.testing.assert_allclose(d.sim.flow.dt, dj.sim.flow.dt, rtol=0, atol=1e-12)
    assert d.pois_n == list(dj.pois_n)
    # the reference's decomposed 3d LES departs from one device (module
    # docstring): 7.3e-4 of max|u| here
    assert 1e-4 < rel(dj.u, ref.flow.u.numpy()) < 1e-2


# ------------------------------------------------------------ a moving body
def test_flat_engine_moving_body_4_equals_one_device():
    """`test_flat_dist_moving_body_remeasure`: the sphere crosses the shard
    bounds at x = 8, 16, 24 and is re-measured every step on every shard;
    the port's single-device run is the JAX package's."""
    ref, d = run_pair(sphere(moving=True), (4,), "flat", 3, remeasure=True)
    assert d.engine == "flat"
    assert rel(d.u, ref.flow.u.numpy()) <= 1e-11
    assert rel(d.p, ref.flow.p.numpy()) <= 1e-11
    np.testing.assert_allclose(d.sim.flow.dt, ref.flow.dt, rtol=0, atol=1e-12)
    assert d.pois_n == ref.pois_n
    ctr = jnp.asarray(CTR, jnp.float64)
    j = jax_run(AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - ctr) ** 2)) - 4.0,
                          lambda x, t: x - jnp.stack([t, 0 * t, 0 * t])), 3, True)
    assert rel(ref.flow.u.numpy(), j.flow.u) <= 1e-11
    assert rel(ref.flow.p.numpy(), j.flow.p) <= 1e-11
    np.testing.assert_allclose(ref.flow.dt, j.flow.dt, rtol=0, atol=1e-12)
    assert ref.pois_n == list(j.pois_n)


# ------------------------------------------------------------ forward-mode AD
@pytest.fixture(scope="module")
def stepped(sphere_sim):
    """The sphere one step on, with its dt and time as 0-d tensors."""
    sim = copy.deepcopy(sphere_sim)
    sim.sim_step(remeasure=False)
    return (sim, torch.tensor(sim.flow.dt[-1], dtype=F64),
            torch.tensor(sim.time, dtype=F64))


def step_fn(cfg, state, levels, masks, dt, t0, **kw):
    def f(nu):
        st, dt_next, _, _ = fl.mom_step_impl(cfg, dataclasses.replace(state, nu=nu),
                                             levels, masks, dt, t0, **kw)
        return st.u, st.p, dt_next
    return f


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4", "2x2"])
def test_jvp_of_a_decomposed_step_equals_one_device(stepped, shape):
    sim, dt, t0 = stepped
    cfg, nu = sim.flow.cfg, sim.flow.state.nu
    with mg.iteration_log() as log1:
        prim1, tan1 = torch.func.jvp(
            step_fn(cfg, sim.flow.state, sim.levels, sim.masks, dt, t0),
            (nu,), (torch.ones_like(nu),))
    d = DistSimulation(copy.deepcopy(sim), mesh(shape), engine="3d", timeout=TIMEOUT)

    def one(rank):
        sh = d.shards[rank]
        f = step_fn(cfg, sh.state, sh.levels, d.masks, dt, t0, ctx=sh.ctx,
                    n_dist=d.n_dist)
        with mg.iteration_log() as log:
            out = shard_jvp(sh.ctx, f, (sh.state.nu,), (torch.ones_like(sh.state.nu),))
        return out, log

    res = d.pool.run(one)
    for k, lead in ((0, 1), (1, 0)):
        u = d._dense(lambda sh: res[sh.ctx.rank][0][0][k], lead)
        du = d._dense(lambda sh: res[sh.ctx.rank][0][1][k], lead)
        assert rel(u, prim1[k].numpy()) <= 1e-10
        assert np.abs(tan1[k].numpy()).max() > 1e-2
        assert rel(du, tan1[k].numpy()) <= 1e-10
    for (prim, tan), log in res:
        np.testing.assert_allclose(float(prim[2]), float(prim1[2]), rtol=1e-12)
        assert float(tan1[2]) != 0.0
        np.testing.assert_allclose(float(tan[2]), float(tan1[2]), rtol=1e-10)
        # primal then tangent, per projection
        assert log == log1 and len(log) == 4


def test_jvp_of_a_decomposed_solve_equals_one_device(sphere_sim):
    """One `solve_mg_implicit` on (4,) in a scale ``c = 1 + s`` of every
    level's coefficients and ``z·(1 + 2s)``: the fine level's tangent gives
    the ``Ȧ·x`` term (on the halo-refreshed solution), against one
    device."""
    sim = sphere_sim
    rng = np.random.default_rng(3)
    z = torch.zeros(sim.flow.cfg.shape, dtype=F64)
    z[1:-1, 1:-1, 1:-1] = torch.as_tensor(rng.standard_normal(DIMS))
    d = DistSimulation(copy.deepcopy(sim), mesh((4,)), engine="3d", timeout=TIMEOUT)
    zb = [d._block(z, 0, r) for r in range(4)]

    def solve_fn(levels, masks, zz, **kw):
        def f(s):
            c = 1.0 + s
            lv = tuple(PoissonLevel(p.L * c, p.D * c, p.iD / c,
                                    None if p.Ainv is None else p.Ainv / c)
                       for p in levels)
            res = mg.solve_mg_implicit(lv, masks, torch.zeros_like(zz),
                                       zz * (1.0 + 2.0 * s), tol=1e-6, **kw)
            return (res.x,)
        return f

    s0, ds = torch.zeros((), dtype=F64), torch.ones((), dtype=F64)
    with mg.iteration_log() as log1:
        (x1,), (dx1,) = torch.func.jvp(solve_fn(sim.levels, sim.masks, z), (s0,), (ds,))

    def one(rank):
        sh = d.shards[rank]
        with mg.iteration_log() as log:
            out = shard_jvp(sh.ctx, solve_fn(sh.levels, d.masks, zb[rank], ctx=sh.ctx,
                                             n_dist=d.n_dist), (s0,), (ds,))
        return out, log

    res = d.pool.run(one)
    x = d._dense(lambda sh: res[sh.ctx.rank][0][0][0], 0)
    dx = d._dense(lambda sh: res[sh.ctx.rank][0][1][0], 0)
    assert rel(x, x1.numpy()) <= 1e-10
    assert np.abs(dx1.numpy()).max() > 1e-2
    assert rel(dx, dx1.numpy()) <= 1e-10
    assert all(log == log1 and len(log) == 2 for _, log in res)
