"""The port's mixed-precision smoother (``mp_smooth``) against the JAX
package's, on the CPU.  Inputs come from a numpy seed; every port object is
built with ``device="cpu"``.

(a) `stencil3d.gs_incr_plain(mp=True)` (0, 1, 4 colours) and
    `fused3d.incr_gs_plain(mp=True)` against `pallas_flat.gs_incr(mp=True)`
    and `incr_gs(mp=True)` in Pallas interpret mode, float32 at (12, 10, 7).
    The JAX tests ask bf16 resolution of them, 0.05·scale
    (`tests/test_pallas_kernels.py:239-245`).  Here: x to 1e-6·scale
    (reached: 0, the whole bf16 cascade agrees bit for bit), r to 0.02·scale
    (reached: 0.0063 = ω·2⁻⁷, 4.3e-3·scale, for `gs_incr`; 0.0125,
    1.2e-2·scale, for `incr_gs`): XLA on the CPU keeps the chain of bf16
    sums of ``A·e`` in float32 between operations
    (``xla_allow_excess_precision``, on by default), the port rounds each.
    With that flag off, in a process of its own, the two agree to float32
    rounding (r to 1e-6·scale; reached 0 and 4.8e-7).
(b) The solve: `mgflat.solve_mg_flat(mp=True)` reaches the dual-norm
    tolerance on the 18³ problem of `test_mp_solve_converges`, and agrees
    with the JAX solve in interpret mode.
(c) The slice: port ``Simulation(engine="flat", mp_smooth=True)`` against
    JAX ``Simulation(engine="flat", mp_smooth=True)`` with its kernels in
    interpret mode, float32, a 32³ sphere (R = 4), where the bf16-smoothed
    solves converge ([5, 2, 6, 3] iterations in both packages; at 16×12×12
    the first solve runs into ``itmx``).  After step 1: u to 1e-3·max|u|, p
    to 4e-3·max|p| (reached 3.4e-4 and 1.2e-3), both below what separates
    bf16 from float32 smoothing at that point (1.9e-3 and 1.35e-2, asserted
    beside them).  After step 2: equal `pois_n` ±1 and p to 5e-2·max|p|
    (reached 2.4e-2; bf16 against float32: 0.24); u (5.4e-3 against 9.4e-3)
    is not held there.  The two packages differ by the excess precision of
    (a), and a bf16 smoother amplifies such a difference: a 1e-7 relative
    perturbation of u grows to 1.3e-4·max|u| over one step with bf16
    smoothing and stays at 2.8e-7 with float32
    (`test_mp_smoothing_amplifies_rounding_noise`).
(d) Where ``mp_smooth`` applies: the level rule at 34³, 66³, 130³, 258³, and
    float64, ``engine="3d"`` and ``perdir`` ignore it."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.ops import bc as bc_j
from waterlily_tpu.ops import flat as fo
from waterlily_tpu.ops import mgflat as mgflat_j
from waterlily_tpu.ops import multigrid as mg_j
from waterlily_tpu.ops import pallas_flat as plf
from waterlily_tpu_torch import AutoBody, NoBody, Simulation
from waterlily_tpu_torch.interop import levels_from_numpy
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import mgflat
from waterlily_tpu_torch.ops import multigrid as mg
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector

SHAPE = (12, 10, 7)
GEOM = fo.geom_of(SHAPE)
F32 = torch.float32


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(plf, "_INTERPRET", True)


def fields(seed):
    """Random float32 fields at SHAPE: x, r and eps (both with zero ghosts)
    and a level (L > 0, D, iD) with its bf16 copies."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s + SHAPE), dtype=F32)
    inner = (slice(1, -1),) * 3
    r, eps = torch.zeros(SHAPE), torch.zeros(SHAPE)
    r[inner] = g()[inner]
    eps[inner] = 0.3 * g()[inner]
    L = torch.as_tensor(0.2 + rng.random((3,) + SHAPE), dtype=F32)
    return dict(x=g(), r=r, eps=eps, lev=ps.with_bf16(ps.make_level(L)))


def J(t):
    return fo.to_flat(jnp.asarray(t.numpy()), GEOM)


def close(t, j, tol=1e-6):
    b = np.asarray(fo.from_flat(j, GEOM))
    np.testing.assert_allclose(t.numpy(), b, atol=tol * max(1.0, np.abs(b).max()))


# ------------------------------------------------------------ (a) kernels
@pytest.mark.parametrize("it", [0, 1, 4])
def test_gs_incr_mp_vs_pallas(interpret, it):
    d = fields(0)
    lev = d["lev"]
    colors = [(1 - 3 - k0) % 2 for k0 in range(1, it + 1)]
    x_t, r_t = st.gs_incr_plain(d["x"], d["r"], *lev.bf, colors, 0.8, mp=True)
    x_j, r_j = plf.gs_incr(J(d["x"]), J(d["r"]), J(lev.L), J(lev.D), J(lev.iD),
                           colors, jnp.float32(0.8), GEOM, mp=True)
    close(x_t, x_j)
    close(r_t, r_j, 0.02)
    # and it is a bf16-resolution neighbour of the float32 smoother
    x32, r32 = st.gs_incr_plain(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.8)
    assert 0 < float((r_t - r32).abs().max()) < 0.05 * max(1.0, float(r32.abs().max()))
    assert float((x_t - x32).abs().max()) < 0.05 * max(1.0, float(x32.abs().max()))


@pytest.mark.parametrize("want_norms", [False, True], ids=["plain", "norms"])
def test_incr_gs_mp_vs_pallas(interpret, want_norms):
    d = fields(1)
    lev = d["lev"]
    colors = [(1 - 3 - k0) % 2 for k0 in range(1, 4)]
    got = fz.incr_gs_plain(d["x"], d["r"], d["eps"], *lev.bf, colors, 0.8,
                           want_norms, mp=True)
    want = plf.incr_gs(J(d["x"]), J(d["r"]), J(d["eps"]), J(lev.L), J(lev.D),
                       J(lev.iD), colors, jnp.float32(0.8), GEOM, mp=True,
                       want_norms=want_norms)
    close(got[0], want[0])
    close(got[1], want[1], 0.02)
    if want_norms:
        np.testing.assert_allclose(got[2].numpy(), [float(v) for v in want[2]],
                                   rtol=5e-3)


_EXACT = """
import sys
import numpy as np
sys.path.insert(0, {tests!r})
import test_torch_mp as T
T.plf._INTERPRET = True
d = T.fields(0)
lev, om = d["lev"], T.jnp.float32(0.8)
cols = [0, 1, 0, 1]
coef = [T.J(lev.L), T.J(lev.D), T.J(lev.iD)]
got = T.st.gs_incr_plain(d["x"], d["r"], *lev.bf, cols, 0.8, mp=True)
want = T.plf.gs_incr(T.J(d["x"]), T.J(d["r"]), *coef, cols, om, T.GEOM, mp=True)
got += T.fz.incr_gs_plain(d["x"], d["r"], d["eps"], *lev.bf, cols, 0.8, mp=True)
want += T.plf.incr_gs(T.J(d["x"]), T.J(d["r"]), T.J(d["eps"]), *coef, cols, om,
                      T.GEOM, mp=True)
for a, b in zip(got, want):
    T.close(a, b, 1e-6)
print("exact")
"""


def test_mp_plain_equals_jax_without_excess_precision():
    """With XLA rounding every bf16 operation, the plain versions and the
    JAX kernels agree to float32 rounding, r included."""
    import os
    import subprocess
    import sys

    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join([os.path.dirname(tests),
                                           os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _EXACT.format(tests=tests)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0 and out.stdout.strip().endswith("exact"), out.stderr


def test_mp_wrappers_on_cpu_take_the_plain_version():
    d = fields(2)
    lev = d["lev"]
    before = st.launch_counts()
    for cols in ([], [0, 1]):
        for a, b in zip(st.gs_incr_k(d["x"], d["r"], *lev.bf, cols, 0.8, mp=True),
                        st.gs_incr_plain(d["x"], d["r"], *lev.bf, cols, 0.8, mp=True)):
            assert torch.equal(a, b)
    for a, b in zip(fz.incr_gs_k(d["x"], d["r"], d["eps"], *lev.bf, [0, 1], 0.8,
                                 True, mp=True),
                    fz.incr_gs_plain(d["x"], d["r"], d["eps"], *lev.bf, [0, 1], 0.8,
                                     True, mp=True)):
        assert torch.equal(a, b)
    assert st.launch_counts() == before
    # float32 coefficients are refused, and so is the bare increment
    with pytest.raises(TypeError, match="bfloat16"):
        st.gs_incr_plain(d["x"], d["r"], lev.L, lev.D, lev.iD, [], 0.8, mp=True)
    with pytest.raises(ValueError, match="at least one colour"):
        fz.incr_gs_plain(d["x"], d["r"], d["eps"], *lev.bf, [], 0.8, mp=True)


# ------------------------------------------------------------ (b) the solve
def poisson_problem(n=18, seed=3):
    """The stack and a mean-free right-hand side of the n³ box problem of
    `test_pallas_kernels.test_mp_solve_converges`, as numpy."""
    shape = (n,) * 3
    mu0 = bc_j.bc_vector(jnp.ones((3,) + shape, jnp.float32), (0.0, 0.0, 0.0))
    masks = tuple(mg_j.level_shapes(shape)[1])
    levels_j = mg_j.update_mg(None, masks, mu0, ())
    z = np.zeros(shape, np.float32)
    z[1:-1, 1:-1, 1:-1] = np.random.default_rng(seed).standard_normal((n - 2,) * 3)
    z[1:-1, 1:-1, 1:-1] -= z[1:-1, 1:-1, 1:-1].mean()
    return shape, masks, levels_j, z


def test_mp_solve_converges_and_matches_jax(interpret):
    shape, masks, levels_j, z = poisson_problem()
    levels = mgflat.mp_levels(levels_from_numpy(
        [(np.asarray(l.L), np.asarray(l.D), np.asarray(l.iD),
          None if l.Ainv is None else np.asarray(l.Ainv)) for l in levels_j],
        "cpu", F32))
    assert levels[0].bf is not None and levels[1].bf is None
    zt = torch.as_tensor(z)
    res = mgflat.solve_mg_flat(levels, masks, torch.zeros_like(zt), zt, tol=2e-3,
                               itmx=32, smooth_it=3, mp=True)
    a = res.r.abs()
    assert float(a.max()) < 2e-3 and float(a.sum()) < 2e-4 * (shape[0] - 2) ** 3
    assert res.iters < 32
    g = fo.geom_of(shape)
    fmg = mgflat_j._flatten_stack(levels_j, g, masks)
    zj = fo.to_flat(jnp.asarray(z), g)
    res_j = mgflat_j.solve_mg_flat(fmg, masks, jnp.zeros_like(zj), zj, g, tol=2e-3,
                                   itmx=32, smooth_it=3, mp=True)
    assert abs(res.iters - int(res_j.iters)) <= 1
    xj = np.asarray(fo.from_flat(res_j.x, g))
    # two solves stopped at tol = 2e-3, not the same iterate
    np.testing.assert_allclose(res.x.numpy(), xj, atol=1e-2 * np.abs(xj).max())


def test_mp_solve_needs_the_bf16_levels():
    levels, masks = mg.make_mg(bc_vector(torch.ones((3, 18, 18, 18)), (0.0,) * 3))
    z = torch.zeros((18,) * 3)
    with pytest.raises(ValueError, match="mp_levels"):
        mgflat.solve_mg_flat(levels, masks, z, z, mp=True)
    # float64 and periodic solves ignore mp, as the JAX package does
    mgflat.solve_mg_flat(tuple(ps.PoissonLevel(*(t.double() for t in l[:3]),
                                               None if l.Ainv is None else l.Ainv.double())
                               for l in levels), masks, z.double(), z.double(), mp=True)


# ------------------------------------------------------------ (c) the slice
def _sphere(mp, dims=(32, 32, 32), R=4.0):
    ct = torch.tensor([dims[0] / 3, dims[1] / 2, dims[2] / 2])
    return Simulation(dims, (1.0, 0.0, 0.0), R, nu=R / 100, dtype=F32,
                      body=AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ct) ** 2)) - R),
                      engine="flat", smooth_it=2, mp_smooth=mp, device="cpu")


def _gap(a, b):
    """max|Δu|/max|u|, max|Δp|/max|p| of two port simulations."""
    return (float((a.flow.u - b.flow.u).abs().max() / b.flow.u.abs().max()),
            float((a.flow.p - b.flow.p).abs().max() / b.flow.p.abs().max()))


def test_flat_mp_trajectory_f32_vs_pallas(interpret):
    dims, R = (32, 32, 32), 4.0
    cj = jnp.asarray([dims[0] / 3, dims[1] / 2, dims[2] / 2], jnp.float32)
    sim_j = SimulationJ(dims, (1.0, 0.0, 0.0), R, nu=R / 100, dtype=jnp.float32,
                        body=AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - cj) ** 2)) - R),
                        engine="flat", smooth_it=2, mp_smooth=True)
    sim_t, sim_f = _sphere(True), _sphere(False)
    assert sim_j.flow.cfg.mp_smooth and sim_t.flow.cfg.mp_smooth
    assert sim_t.levels[0].bf is not None

    def step():
        for s in (sim_j, sim_t, sim_f):
            s.sim_step(remeasure=False)
        return np.asarray(sim_j.flow.u), np.asarray(sim_j.flow.p)

    uj, pj = step()
    np.testing.assert_allclose(sim_t.flow.u.numpy(), uj, atol=1e-3 * np.abs(uj).max())
    np.testing.assert_allclose(sim_t.flow.p.numpy(), pj, atol=4e-3 * np.abs(pj).max())
    # the limits lie below what bf16 smoothing itself changes
    gu, gp = _gap(sim_t, sim_f)
    assert gu > 1.5e-3 and gp > 1e-2
    uj, pj = step()
    assert len(sim_t.pois_n) == len(sim_j.pois_n) == 4
    assert all(abs(a - b) <= 1 for a, b in zip(sim_t.pois_n, sim_j.pois_n))
    assert max(sim_t.pois_n) < sim_t.flow.cfg.itmx
    np.testing.assert_allclose(sim_t.flow.p.numpy(), pj, atol=5e-2 * np.abs(pj).max())
    assert _gap(sim_t, sim_f)[1] > 0.1


def test_mp_smoothing_amplifies_rounding_noise():
    """Why two bf16-smoothed runs are held to each other only over one
    step: a perturbation of u at float32 rounding (1e-7 relative) flips
    bf16 roundings of the residual, each of which moves a correction by 2⁻⁸
    of itself.  Over one step it grows a hundredfold and more with bf16
    smoothing (reached 1.3e-4·max|u|) and not with float32 (2.8e-7), and
    stays below what separates the two smoothers (1.9e-3)."""
    sims = {(mp, k): _sphere(mp) for mp in (True, False) for k in (0, 1)}
    noise = 1 + 2e-7 * (torch.rand(sims[True, 0].flow.u.shape,
                                   generator=torch.Generator().manual_seed(0)) - 0.5)
    for mp in (True, False):
        sims[mp, 1].flow.state = dataclasses.replace(
            sims[mp, 1].flow.state, u=sims[mp, 1].flow.u * noise)
    for s in sims.values():
        s.sim_step(remeasure=False)
    d_mp, d_f32 = _gap(sims[True, 1], sims[True, 0])[0], _gap(sims[False, 1], sims[False, 0])[0]
    assert d_f32 < 2e-6
    assert 20 * d_f32 < d_mp < 5e-4 < 1.5e-3 < _gap(sims[True, 0], sims[False, 0])[0]


def test_plain_ops_only_names_the_mp_wrappers():
    """`plain_ops(only=...)` routes the named bf16 smoothers to their plain
    versions and leaves every other wrapper's gate as it was."""
    assert not st.plain_route("gs_incr_mp_k")
    with st.plain_ops(only=("gs_incr_mp_k",)):
        assert st.plain_route("gs_incr_mp_k")
        assert not st.plain_route("incr_gs_mp_k") and not st.plain_route()
    with st.plain_ops():
        assert st.plain_route() and st.plain_route("incr_gs_mp_k")
    assert not st.plain_route("gs_incr_mp_k")
    with pytest.raises(ValueError, match="only takes"):
        with st.plain_ops(only=("mult_k",)):
            pass


# ------------------------------------------------------------ (d) where it applies
@pytest.mark.parametrize("n,want", [(34, 1), (66, 1), (130, 2), (258, 3)])
def test_mp_level_rule(n, want):
    """The fine level always, then each level with at least 100,000 padded
    cells: at 258³ the levels 258³, 130³ and 66³ (`mgflat._n_flat`)."""
    shapes, _ = mg.level_shapes((n,) * 3, min_cells=mg.MIN_COARSE_CELLS)
    meta = lambda *s: torch.empty(s, device="meta")
    levels = mgflat.mp_levels([ps.PoissonLevel(meta(3, *s), meta(*s), meta(*s))
                               for s in shapes])
    assert [p.bf is not None for p in levels] == [l < want for l in range(len(shapes))]
    assert all(t.dtype == torch.bfloat16 for t in levels[0].bf)
    g = fo.geom_of((n,) * 3)
    assert want == mgflat_j._n_flat(g, tuple(mg_j.level_shapes(
        (n,) * 3, min_cells=mg.MIN_COARSE_CELLS)[1]))


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.float64, engine="flat"), dict(engine="3d"),
    dict(engine="flat", perdir=(2,)),
], ids=["float64", "engine3d", "perdir"])
def test_mp_smooth_ignored(kw):
    make = lambda **more: Simulation((16, 12, 12), (1.0, 0.0, 0.0), 4.0, nu=0.04,
                                     body=NoBody(), device="cpu", **kw, **more)
    a, b = make(mp_smooth=True), make()
    assert a.flow.cfg.mp_smooth and all(p.bf is None for p in a.levels)
    a.sim_step()
    b.sim_step()
    assert a.pois_n == b.pois_n
    assert torch.equal(a.flow.u, b.flow.u) and torch.equal(a.flow.p, b.flow.p)


def test_mp_smooth_changes_the_flat_f32_solve():
    make = lambda **more: Simulation((16, 12, 12), (1.0, 0.25, -0.5), 4.0, nu=0.04,
                                     body=NoBody(), engine="flat", device="cpu",
                                     u0=lambda i, x: torch.sin(0.4 * x[(i + 1) % 3]),
                                     **more)
    a, b = make(mp_smooth=True), make()
    assert a.levels[0].bf is not None and b.levels[0].bf is None
    a.sim_step()
    b.sim_step()
    du = float((a.flow.u - b.flow.u).abs().max())
    assert 0 < du < 1e-2 * float(b.flow.u.abs().max())
