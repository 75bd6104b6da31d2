"""The port's `DistSimulation` (`waterlily_tpu_torch.parallel.dist`) on CPU
meshes of at most four shards, float64, case for case with
`tests/test_dist.py` (PCG, the LES udf, the flat engine's moving body and
forward-mode AD under decomposition: `tests/test_torch_dist2.py`).

Against the JAX package's `DistSimulation` on its virtual CPU devices, 3
steps: the 32×16×16 sphere on a (2, 2) mesh with the 3d engine and on a (4,)
mesh with the flat engine, and a restart of the port from the JAX flat run's
blocked state (`interop.fields_from_blocked`, `restore_fields`) one step on.
Against the port's own single-device `Simulation`: the 2-D circle, the
periodic Taylor–Green vortex (a callable ``ubc``), the exit sphere on both
engines, a moving 2-D body re-measured every step, a periodic x on the flat
engine, `total_force`/`total_moment`, `sim_step_n` against a `step_once`
loop and a mesh of one shard.  Every comparison: u and p within 1e-10 of
max|·|, dt within 1e-12, equal `pois_n`; forces and moments within 1e-10
absolute."""
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
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.interop import fields_from_blocked
from waterlily_tpu_torch.parallel import DistSimulation, make_mesh
from waterlily_tpu_torch.utils import metrics as mt

F64 = torch.float64
TIMEOUT = 30.0
STEPS = 3
CTR = (12.0, 8.0, 8.0)
DIMS = (32, 16, 16)
X0 = (16.0, 8.0, 8.0)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh(shape):
    return make_mesh(shape, ["cpu"] * math.prod(shape))


def close(a, b, rtol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * max(np.abs(b).max(), 1e-300)


def close_force(a, b):
    """A force or moment: a sum of per-shard integrals against one integral
    over the grid, which cancel to ~1e-3 here; 1e-10 absolute, as
    `tests/test_dist.py` holds them."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-10)


def assert_match(ref, d):
    """``d`` (a port `DistSimulation`) against ``ref`` (dense u, p, dt,
    pois_n of the run it must equal)."""
    u, p, dts, pois = ref
    close(d.u, u)
    close(d.p, p)
    np.testing.assert_allclose(d.sim.flow.dt, dts, rtol=0, atol=1e-12)
    assert d.pois_n == pois


def dense(sim):
    return (sim.flow.u.numpy(), sim.flow.p.numpy(), list(sim.flow.dt),
            list(sim.pois_n))


def run(sim, n=STEPS, **kw):
    for _ in range(n):
        sim.sim_step(**kw)
    return sim


def dist(sim, shape, engine="auto", n=STEPS, **kw):
    d = DistSimulation(sim, mesh(shape), engine=engine, timeout=TIMEOUT)
    for _ in range(n):
        d.step_once(**kw)
    return d


def sphere_body(lib, dtype):
    ctr = lib.asarray(CTR, dtype=dtype) if lib is jnp else torch.tensor(CTR, dtype=dtype)
    body_cls = AutoBodyJ if lib is jnp else AutoBody
    return body_cls(lambda x, t: lib.sqrt(lib.sum((x - ctr) ** 2)) - 4.0)


# one JAX body for every JAX run: its measure is then compiled once
JAX_BODY = sphere_body(jnp, jnp.float64)


def sphere(lib, dtype, **kw):
    if lib is jnp:
        return SimulationJ(DIMS, (1.0, 0.0, 0.0), 4.0, nu=0.02, dtype=dtype,
                           body=JAX_BODY, **kw)
    return Simulation(DIMS, (1.0, 0.0, 0.0), 4.0, nu=0.02, dtype=dtype,
                      body=sphere_body(torch, dtype), device="cpu", **kw)


@pytest.fixture(scope="module")
def sphere_sim():
    """The port's sphere, measured once (copies step)."""
    return sphere(torch, F64)


@pytest.fixture(scope="module")
def sphere_ref(sphere_sim):
    """The port's single-device 3-step sphere run, with its force and
    moment."""
    s = run(copy.deepcopy(sphere_sim), remeasure=False)
    return dense(s), mt.total_force(s).numpy(), mt.total_moment(X0, s).numpy()


@pytest.fixture(scope="module")
def port_3d(sphere_sim):
    """The port's sphere on (2, 2), 3d engine, 3 steps."""
    return dist(copy.deepcopy(sphere_sim), (2, 2), "3d", remeasure=False)


@pytest.fixture(scope="module")
def port_flat(sphere_sim):
    """The port's sphere on (4,), flat engine, 3 steps."""
    return dist(copy.deepcopy(sphere_sim), (4,), "flat", remeasure=False)


# ------------------------------------------------------------ against JAX
def jax_run(mesh_shape, engine, n):
    d = DistSimulationJ(sphere(jnp, jnp.float64), make_mesh_j(mesh_shape), engine=engine)
    if engine == "3d":
        # ν replicated over the mesh, as every step returns it: the first
        # step then compiles the program the later steps run (an unplaced
        # ν compiles it twice, ~9 s); the same value, the same numbers
        d.state = dataclasses.replace(
            d.state, nu=jax.device_put(d.state.nu, NamedSharding(d.mesh, P())))
    out = []
    for _ in range(n):
        d.step_once(remeasure=False)
        out.append((np.asarray(d.u), np.asarray(d.p), list(d.sim.flow.dt),
                    list(d.pois_n)))
    return d, out


@pytest.fixture(scope="module")
def jax_flat():
    """The JAX flat engine on (4,), 4 steps, and its blocked state after
    step 3."""
    d, out = jax_run((4,), "flat", STEPS)
    blk = {"u": np.asarray(d.state.u), "p": np.asarray(d.state.p)}
    d.step_once(remeasure=False)
    out.append((np.asarray(d.u), np.asarray(d.p), list(d.sim.flow.dt), list(d.pois_n)))
    return out, blk


def test_sphere_3d_engine_2x2_equals_jax(port_3d):
    _, out = jax_run((2, 2), "3d", STEPS)
    assert port_3d.engine == "3d"
    assert_match(out[-1], port_3d)


def test_sphere_flat_engine_4_equals_jax(port_flat, jax_flat):
    assert port_flat.engine == "flat"
    assert_match(jax_flat[0][STEPS - 1], port_flat)


def test_restart_from_jax_blocked_state(sphere_sim, jax_flat):
    out, blk = jax_flat
    sim = copy.deepcopy(sphere_sim)
    sim.flow.dt = list(out[STEPS - 1][2])
    sim.flow.pois_n = list(out[STEPS - 1][3])
    d = DistSimulation(sim, mesh((4,)), engine="flat", timeout=TIMEOUT)
    f = fields_from_blocked(blk, (4, 1, 1), "cpu", F64)
    close(f["u"].numpy(), out[STEPS - 1][0], 0.0)
    d.restore_fields(f["u"], f["p"])
    close(d.u, out[STEPS - 1][0], 0.0)
    d.step_once(remeasure=False)
    assert_match(out[STEPS], d)


# ------------------------------------------------ against the port's own run
def test_sphere_force_moment_both_engines(port_3d, port_flat, sphere_ref):
    for d in (port_3d, port_flat):
        assert_match(sphere_ref[0], d)
        close_force(d.total_force().numpy(), sphere_ref[1])
        close_force(d.total_moment(X0).numpy(), sphere_ref[2])
    # the shared helpers route to the shards' state
    close_force(mt.total_force(port_flat).numpy(), sphere_ref[1])
    close_force(mt.total_moment(X0, port_flat).numpy(), sphere_ref[2])


def circle_sim(moving=False):
    sdf = lambda x, t: torch.sqrt(torch.sum((x - 8.0) ** 2)) - 4.0
    mp = (lambda x, t: x - torch.stack([t, torch.zeros_like(t)])) if moving else None
    return Simulation((32, 16), (1.0, 0.0), 4.0, nu=0.02, body=AutoBody(sdf, mp),
                      dtype=F64, device="cpu")


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_2d_circle_2x2(moving):
    sim = circle_sim(moving)
    ref = dense(run(copy.deepcopy(sim), remeasure=moving))
    assert_match(ref, dist(sim, (2, 2), remeasure=moving))


def test_periodic_tgv_callable_ubc_2x2():
    L = 32
    kappa = 2 * math.pi / L

    def tgv(i, xy, t):
        x, y = xy[0] * kappa, xy[1] * kappa
        if i == 0:
            return -torch.sin(x) * torch.cos(y)
        return torch.cos(x) * torch.sin(y)

    sim = Simulation((L, L), tgv, L, U=1, nu=1e-4, perdir=(0, 1), dtype=F64,
                     device="cpu")
    ref = dense(run(copy.deepcopy(sim), remeasure=False))
    assert_match(ref, dist(sim, (2, 2), remeasure=False))


@pytest.mark.parametrize("engine,shape", [("flat", (4,)), ("3d", (2, 2))])
def test_exit_sphere(engine, shape):
    sim = sphere(torch, F64, exit_bc=True)
    ref = dense(run(copy.deepcopy(sim), remeasure=False))
    assert_match(ref, dist(sim, shape, engine, remeasure=False))


def test_periodic_x_flat_engine():
    L = 16
    kappa = 2 * math.pi / L

    def u0(i, x):
        a, b = x[0] * kappa, x[1] * kappa
        if i == 0:
            return -torch.sin(a) * torch.cos(b)
        if i == 1:
            return torch.cos(a) * torch.sin(b)
        return 0.0 * a

    sim = Simulation((L, L, L), (0.0, 0.0, 0.0), L, U=1.0, nu=0.01, perdir=(0, 1, 2),
                     u0=u0, dtype=F64, device="cpu")
    ref = dense(run(copy.deepcopy(sim), remeasure=False))
    d = dist(sim, (4,), "flat", remeasure=False)
    assert d.engine == "flat"
    assert_match(ref, d)


def test_sim_step_n_equals_step_once_loop(sphere_sim):
    a = DistSimulation(copy.deepcopy(sphere_sim), mesh((2,)), engine="3d", timeout=TIMEOUT)
    b = DistSimulation(copy.deepcopy(sphere_sim), mesh((2,)), engine="3d", timeout=TIMEOUT)
    for _ in range(2):
        a.step_once(remeasure=False)
    b.sim_step_n(2)
    close(b.u, a.u, 0.0)
    close(b.p, a.p, 0.0)
    assert a.sim.flow.dt == b.sim.flow.dt and a.pois_n == b.pois_n


def test_mesh_of_one(sphere_sim, sphere_ref):
    d = dist(copy.deepcopy(sphere_sim), (1,), remeasure=False)
    assert d.engine == "3d" and d.comm.counts == {"ring": 0, "sum": 0, "max": 0,
                                                  "gather": 0}
    assert_match(sphere_ref[0], d)


def test_refused_configurations(sphere_sim):
    with pytest.raises(ValueError, match="not evenly divisible"):
        DistSimulation(Simulation((30, 16), (1.0, 0.0), 4.0, dtype=F64, device="cpu"),
                       mesh((4,)))
    with pytest.raises(ValueError, match="x mesh axis only"):
        DistSimulation(copy.deepcopy(sphere_sim), mesh((2, 2)), engine="flat")
