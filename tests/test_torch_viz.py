"""The port's host-side utilities: `utils.pathlines` (RK2 tracers against
the JAX package's in float64, respawn by its statistics), `utils.mesh`
(`tests/test_viz.py`'s marching-tetrahedra sphere and body mesh) and
`utils.viz` (`tests/test_viz.py`'s PNG and GIF cases at their sizes: every
entry point writes a non-empty file).  Every port object lives on
``device="cpu"``."""
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu.utils import mesh as mesh_j
from waterlily_tpu.utils import pathlines as pl_j
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.interop import particles_from_numpy
from waterlily_tpu_torch.utils import log, mesh, viz
from waterlily_tpu_torch.utils import pathlines as pl

mpl = pytest.importorskip("matplotlib")
mpl.use("Agg")

F64 = torch.float64


def fake_sim(u, dt):
    """What `update_particles` reads of a simulation."""
    shape = tuple(u.shape[1:])
    return types.SimpleNamespace(flow=types.SimpleNamespace(
        state=types.SimpleNamespace(u=u), cfg=types.SimpleNamespace(shape=shape),
        dt=[dt, dt]))


def test_particles_match_jax_without_respawn():
    """5 RK2 updates of 256 tracers (age 0, lifetime 1000) through a smooth
    2-D field (40×30), none leaving: positions and velocities equal JAX's
    to 1e-12."""
    shape = (42, 32)
    x = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"))
    u = np.stack([0.3 + 0.1 * np.sin(x[1] / 5.0), 0.1 * np.cos(x[0] / 7.0)])
    pj = pl_j.Particles.init(256, shape, life=1000, seed=2, dtype=jnp.float64)
    pj = pl_j.Particles(pos=pj.pos * 0.5 + 5.0, age=0 * pj.age, key=pj.key, life=1000)
    pt = particles_from_numpy({"pos": np.asarray(pj.pos), "age": np.asarray(pj.age)},
                              "cpu", F64, life=1000)
    sj, st = fake_sim(jnp.asarray(u), 0.7), fake_sim(torch.tensor(u), 0.7)
    for _ in range(5):
        pj, oldj, vj = pl_j.update_particles(pj, sj)
        pt, oldt, vt = pl.update_particles(pt, st)
        np.testing.assert_allclose(pt.pos.numpy(), np.asarray(pj.pos), rtol=0, atol=1e-12)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-12)
        assert torch.equal(oldt, torch.tensor(np.asarray(oldj)))
    assert torch.equal(pt.age, torch.tensor(np.asarray(pj.age)))
    assert (pt.age >= 5).all()


def test_particles_respawn_statistics():
    """Particles that age out respawn uniformly over the interior from the
    swarm's generator: the same seed gives the same swarm, another seed
    another."""
    shape = (66, 34)
    u = torch.zeros((2,) + shape, dtype=F64)
    a = pl.Particles.init(20000, shape, life=1, seed=1, dtype=F64, device="cpu")
    b = pl.Particles.init(20000, shape, life=1, seed=1, dtype=F64, device="cpu")
    c = pl.Particles.init(20000, shape, life=1, seed=2, dtype=F64, device="cpu")
    sim = fake_sim(u, 0.5)
    (a, _, _), (b, _, _), (c, _, _) = (pl.update_particles(q, sim) for q in (a, b, c))
    assert torch.equal(a.pos, b.pos) and not torch.equal(a.pos, c.pos)
    assert (a.age == 0).all()
    hi = torch.tensor([64.0, 32.0], dtype=F64)
    assert (a.pos >= 0).all() and (a.pos <= hi).all()
    assert torch.allclose(a.pos.mean(0) / hi, torch.full((2,), 0.5, dtype=F64), atol=0.01)
    assert torch.allclose(a.pos.std(0) / hi, torch.full((2,), 12 ** -0.5, dtype=F64),
                          atol=0.01)


def circle_sim():
    R = 4
    return Simulation((8 * R, 6 * R), (1.0, 0.0), R, nu=R / 100, device="cpu",
                      body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - 3 * R) ** 2)) - R))


def sphere_sim(R=4):
    ctr = torch.tensor([2.0 * R, 1.5 * R, 1.5 * R])
    return Simulation((4 * R, 3 * R, 3 * R), (1.0, 0.0, 0.0), R, nu=R / 100, device="cpu",
                      body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - R))


def test_marching_tetrahedra_sphere():
    """An analytic sphere: the right radius and area, watertight, and the
    same mesh as the JAX package's extractor."""
    n, R = 24, 7.0
    x, y, z = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    f = np.sqrt((x - 12.0) ** 2 + (y - 12.0) ** 2 + (z - 12.0) ** 2) - R
    v, fc = mesh.marching_tetrahedra(f)
    vj, fj = mesh_j.marching_tetrahedra(f)
    assert np.array_equal(v, vj) and np.array_equal(fc, fj)
    r = np.sqrt(np.sum((v - 12.0) ** 2, axis=1))
    assert np.max(np.abs(r - R)) < 0.3
    tri = v[fc]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]),
                                axis=1).sum()
    assert abs(area - 4 * np.pi * R ** 2) / (4 * np.pi * R ** 2) < 0.03
    e = np.sort(np.stack([fc[:, [0, 1]], fc[:, [1, 2]], fc[:, [2, 0]]]).reshape(-1, 2), axis=1)
    _, cnt = np.unique(e, axis=0, return_counts=True)
    assert np.all(cnt == 2)


def test_body_mesh_and_get_body_3d(tmp_path):
    sim = sphere_sim()
    v, f = mesh.body_mesh(sim)
    assert len(f) > 0
    r = np.sqrt(np.sum((v - np.array([8.0, 6.0, 6.0])) ** 2, axis=1))
    assert np.max(np.abs(r - 4.0)) < 0.3
    v2, _ = viz.get_body(sim)
    assert v2.shape == v.shape
    obj = mesh.write_obj(str(tmp_path / "body.obj"), v, f)
    assert os.path.getsize(obj) > 0


def test_flood_and_body_plot(tmp_path):
    import matplotlib.pyplot as plt

    sim = circle_sim()
    ax, _ = viz.flood(sim.flow.p)
    viz.body_plot(sim, ax=ax)
    viz.addbody([0, 1, 1], [0, 0, 1], ax=ax)
    out = tmp_path / "flood.png"
    ax.figure.savefig(out)
    plt.close("all")
    assert out.stat().st_size > 0
    s = viz.get_body(sim)
    assert s.shape == (32, 24) and s.min() < 0 < s.max()


def test_viz_png_2d_and_3d(tmp_path):
    sim = circle_sim()
    sim.sim_step()
    assert os.path.getsize(viz.viz(sim, fname=str(tmp_path / "frame.png"))) > 0
    assert os.path.getsize(viz.viz(sphere_sim(), fname=str(tmp_path / "f3.png"))) > 0


def test_sim_gif_and_plot_logger(tmp_path):
    sim = circle_sim()
    out = viz.sim_gif(sim, duration=0.2, step=0.1, plotbody=True,
                      fname=str(tmp_path / "flow.gif"), fps=5)
    assert os.path.getsize(out) > 0
    lg = log.SolverLogger(str(tmp_path / "WaterLily"))
    for _ in range(2):
        sim.sim_step()
        lg.log_step(sim)
    assert os.path.getsize(viz.plot_logger(lg.fname)) > 0


def test_pathlines_gif(tmp_path):
    sim = circle_sim()
    sim.sim_step()
    p = pl.Particles.init(64, sim.flow.cfg.shape, life=16, seed=1, device="cpu")
    p2, old, _ = pl.update_particles(p, sim)
    kept = p2.age > 0                    # not respawned: moved with the stream
    assert torch.isfinite(p2.pos).all() and (p2.pos[kept, 0] - old[kept, 0]).mean() > 0
    out = pl.pathlines_gif(sim, n=128, duration=0.2, step=0.1, life=16,
                           fname=str(tmp_path / "pl.gif"), fps=5)
    assert os.path.getsize(out) > 0


def test_viz3d_isosurface_png(tmp_path):
    sim = sphere_sim()
    sim.sim_step()
    assert os.path.getsize(mesh.viz3d(sim, fname=str(tmp_path / "iso.png"))) > 1000
    assert os.path.getsize(mesh.viz3d(sim, fname=str(tmp_path / "m.png"), mirror=2)) > 1000
