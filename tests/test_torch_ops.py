"""The port's grid, BC, Poisson and multigrid ops against the JAX package.

Same numpy-seeded inputs through `waterlily_tpu.ops.*` and
`waterlily_tpu_torch.ops.*` in float64 on the CPU.  Tolerances: 1e-14 for
the index algebra and BCs (exact ops), 1e-12 for the Poisson ops, 1e-10 for
a whole multigrid solve (same iteration count required)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from waterlily_tpu.models import body as body_j
from waterlily_tpu.models.autobody import AutoBody as AutoBodyJ
from waterlily_tpu.ops import bc as bc_j
from waterlily_tpu.ops import grid as grid_j
from waterlily_tpu.ops import multigrid as mg_j
from waterlily_tpu.ops import poisson as ps_j
from waterlily_tpu_torch.ops import bc as bc_t
from waterlily_tpu_torch.ops import grid as grid_t
from waterlily_tpu_torch.ops import multigrid as mg_t
from waterlily_tpu_torch.ops import poisson as ps_t

F64 = torch.float64
SHAPES = [(12, 10), (10, 8, 6)]


def T(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def J(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def level_pair(shape, seed=0, dead=True):
    """Random positive face coefficients with zero boundary faces (the shape
    of a BDIM ``mu0``), optionally with one dead cell (all faces zero)."""
    rng = np.random.default_rng(seed)
    D = len(shape)
    L = 0.2 + rng.random((D,) + shape)
    if dead:
        c = tuple(n // 2 for n in shape)
        for i in range(D):
            L[(i,) + c] = 0.0
            up = list(c)
            up[i] += 1
            L[(i,) + tuple(up)] = 0.0
    Lj = bc_j.bc_vector(J(L), (0.0,) * D)
    Lt = bc_t.bc_vector(T(L), (0.0,) * D)
    return ps_j.make_level(Lj), ps_t.make_level(Lt)


def field(shape, seed, ghosts=True):
    a = np.random.default_rng(seed).standard_normal(shape)
    if not ghosts:
        a = np.pad(a[(slice(1, -1),) * len(shape)], 1)
    return a


@pytest.mark.parametrize("shape", SHAPES)
def test_shift(shape):
    a = field(shape, 1)
    for axis in range(len(shape)):
        for s in (-2, -1, 1, 2):
            close(grid_t.shift(T(a), axis, s), grid_j.shift(J(a), axis, s), 1e-14)


@pytest.mark.parametrize("shape", SHAPES)
def test_loc_grid(shape):
    for i in [None] + list(range(len(shape))):
        close(grid_t.loc_grid(i, shape, F64, "cpu"),
              grid_j.loc_grid(i, shape, jnp.float64), 1e-14)


@pytest.mark.parametrize("shape", SHAPES)
def test_index_sum_parity_and_inside(shape):
    assert np.array_equal(grid_t.index_sum_parity(shape, "cpu").numpy(),
                          np.asarray(grid_j.index_sum_parity(shape)))
    assert np.array_equal(grid_t.inside_mask(shape, "cpu").numpy(),
                          np.asarray(grid_j.inside_mask(shape)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("save_exit", [False, True])
def test_bc_vector(shape, save_exit):
    D = len(shape)
    u = field((D,) + shape, 2)
    ubc = (1.0, -0.5, 0.25)[:D]
    close(bc_t.bc_vector(T(u), ubc, save_exit=save_exit),
          bc_j.bc_vector(J(u), ubc, save_exit=save_exit), 1e-14)
    # periodic wrap in the last direction
    per = (D - 1,)
    close(bc_t.bc_vector(T(u), ubc, perdir=per),
          bc_j.bc_vector(J(u), ubc, perdir=per), 1e-14)
    close(bc_t.per_bc(T(u), per, lead=1), bc_j.per_bc(J(u), per, lead=1), 1e-14)


# the 2-D and 3-D fields of `tests/test_grid_bc.py::test_apply_scalar_vector`
# and `tests/test_metrics.py` (the hydrostatic pressures)
@pytest.mark.parametrize("case,shape", [("sum3", (4, 5)), ("y", (32, 32)),
                                        ("y", (32, 32, 32))])
def test_apply_scalar(case, shape):
    fns = {"sum3": lambda x: x[0] + x[1] + 3, "y": lambda x: x[1]}
    p = bc_t.apply_scalar(fns[case], shape, torch.float64, "cpu")
    assert p.shape == shape and p.dtype == torch.float64
    close(p, bc_j.apply_scalar(fns[case], shape, jnp.float64), 0.0)
    if case == "sum3":      # the Julia test: L2 over the inside is 187
        assert float(torch.sum(grid_t.interior(p) ** 2)) == pytest.approx(187.0)


def test_exit_bc():
    u = field((3, 10, 8, 6), 3)
    u_old = field((3, 10, 8, 6), 4)
    close(bc_t.exit_bc(T(u), T(u_old), 0.3), bc_j.exit_bc(J(u), J(u_old), 0.3),
          1e-14)


def test_unsupported_bc_raises():
    """`bc_vector` takes a callable spec (held against JAX in
    `tests/test_torch_forcing.py`); the fused BC kernels take a constant
    3-tuple and refuse anything else."""
    from waterlily_tpu_torch.ops import fused3d as fz

    u = bc_t.bc_vector(T(field((2, 6, 6), 0)), lambda i, x, t: 0.5 * t, t=2.0)
    assert torch.equal(u[0, 0], torch.ones(6, dtype=u.dtype))
    for bad in (lambda i, x, t: 0.0, (1.0, 0.0)):
        with pytest.raises(ValueError, match="constant 3-tuple"):
            fz._ubc3(bad)


@pytest.mark.parametrize("shape", SHAPES)
def test_set_diag(shape):
    pj, pt = level_pair(shape)
    close(pt.D, pj.D, 1e-12)
    close(pt.iD, pj.iD, 1e-12)
    assert (pt.iD == 0).sum() > 2 * len(shape) * 2    # ghosts + the dead cell


@pytest.mark.parametrize("shape", SHAPES)
def test_mult_residual_increment(shape):
    pj, pt = level_pair(shape)
    x, z, eps = field(shape, 5), field(shape, 6, ghosts=False), field(shape, 7)
    close(ps_t._mult_raw(pt, T(x)), ps_j._mult_raw(pj, J(x)), 1e-12)
    close(ps_t.residual(pt, T(x), T(z)), ps_j.residual(pj, J(x), J(z)), 1e-12)
    r = field(shape, 8, ghosts=False)
    for a, b in zip(ps_t.increment(pt, T(x), T(r), T(eps), 0.7),
                    ps_j.increment(pj, J(x), J(r), J(eps), 0.7)):
        close(a, b, 1e-12)
    for a, b in zip(ps_t.norms(T(r)), ps_j.norms(J(r))):
        close(a, b, 1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_jacobi(shape):
    pj, pt = level_pair(shape)
    x, r = field(shape, 9), field(shape, 10, ghosts=False)
    for a, b in zip(ps_t.jacobi(pt, T(x), T(r), it=2, omega=0.8),
                    ps_j.jacobi(pj, J(x), J(r), it=2, omega=0.8)):
        close(a, b, 1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("it", [1, 2, 4])
def test_gauss_seidel_rb(shape, it):
    pj, pt = level_pair(shape)
    x, r = field(shape, 11), field(shape, 12, ghosts=False)
    for a, b in zip(ps_t.gauss_seidel_rb(pt, T(x), T(r), it=it, omega=0.9),
                    ps_j.gauss_seidel_rb(pj, J(x), J(r), it=it, omega=0.9)):
        close(a, b, 1e-12)


@pytest.mark.parametrize("shape", [(10, 6), (6, 6, 4)])
def test_dense_pinv_and_coarse_solve(shape):
    pj, pt = level_pair(shape, dead=False)
    pj, pt = ps_j.dense_pinv(pj), ps_t.dense_pinv(pt)
    close(pt.Ainv, pj.Ainv, 1e-12)
    x, r = field(shape, 13), field(shape, 14, ghosts=False)
    for a, b in zip(ps_t.coarse_solve(pt, T(x), T(r)),
                    ps_j.coarse_solve(pj, J(x), J(r))):
        close(a, b, 1e-12)


@pytest.mark.parametrize("shape", [(18, 10), (10, 10, 6)])
def test_restrict_prolongate_restrict_L(shape):
    c = mg_j.coarsen_mask(shape)
    assert mg_t.coarsen_mask(shape) == c
    b = field(shape, 15)
    close(mg_t.restrict(T(b), c), mg_j.restrict(J(b), c), 1e-12)
    bc_ = field(mg_t.coarse_shape(shape, c), 16)
    close(mg_t.prolongate(T(bc_), c), mg_j.prolongate(J(bc_), c), 1e-12)
    pj, pt = level_pair(shape)
    close(mg_t.restrict_L(pt.L, c), mg_j.restrict_L(pj.L, c), 1e-12)


def test_level_shapes():
    for shape in [(50, 34, 34), (258, 258, 258), (34, 18), (66, 34, 18)]:
        for mc in (0, 64):
            assert mg_t.level_shapes(shape, min_cells=mc) == \
                mg_j.level_shapes(shape, min_cells=mc)


def _sphere_mu0(shape):
    """Face coefficients of a sphere (JAX measure, f64) as numpy."""
    ctr = jnp.asarray([s / 3 for s in shape], jnp.float64)
    body = AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - ctr) ** 2)) - 4.0)
    fill = jax.jit(body_j.measure_fill, static_argnums=(1, 3, 4))
    _, mu0, _, _ = fill(body, shape, 0.0, 1.0, jnp.float64)
    return np.asarray(mu0)


def test_update_mg_and_solve_mg():
    shape = (34, 18, 18)
    mu0 = _sphere_mu0(shape)
    masks = tuple(mg_j.level_shapes(shape, min_cells=64)[1])
    lev_j = jax.jit(mg_j.update_mg, static_argnums=(1,))(None, masks, J(mu0))
    lev_t, masks_t = mg_t.make_mg(T(mu0), min_cells=64)
    assert masks_t == masks and len(lev_t) == len(lev_j) == 3
    for a, b in zip(lev_t, lev_j):
        close(a.L, b.L, 1e-12)
        close(a.D, b.D, 1e-12)
        close(a.iD, b.iD, 1e-12, rtol=1e-12)
    close(lev_t[-1].Ainv, lev_j[-1].Ainv, 1e-12)
    z = field(shape, 17, ghosts=False)
    x0 = field(shape, 18) * 0.1
    rj = jax.jit(mg_j.solve_mg, static_argnums=(1,))(lev_j, masks, J(x0), J(z))
    rt = mg_t.solve_mg(lev_t, masks_t, T(x0), T(z))
    assert rt.iters == int(rj.iters) and rt.iters > 1
    close(rt.x, rj.x, 1e-10)
    close(rt.r, rj.r, 1e-10)
    stats_j = np.asarray(rj.stats)[: rt.iters + 1]
    np.testing.assert_allclose(np.array(rt.stats), stats_j, rtol=1e-9)
    close(mg_t.canonical_gauge(T(x0), lev_t[0].iD),
          mg_j.canonical_gauge(J(x0), lev_j[0].iD), 1e-12)
