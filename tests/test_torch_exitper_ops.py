"""The kernels and modules of the convective-outlet and periodic
configurations of the port against the JAX package, on the CPU (the slice
itself and the metrics: `tests/test_torch_exitper.py`).

(a) Plain versions against the TPU kernels they stand for, float32, the
    kernels in Pallas interpret mode: `fused3d.bc_plain` ↔ `bc_k` (K10),
    `div_plain` ↔ `div_k` (K11), `projbc_plain(save_exit=True)` ↔
    `projbc_k` (K9's exit mode) at (12, 10, 7) through the flat layout, atol
    2e-6 for the BC and divergence (the same additions) and 2e-5 for the
    projection (another rounding order, as in `tests/test_pallas_kernels.py`);
    `stencil3d.gauss_sweeps_plain` ↔ `pallas3d.gauss_sweeps3d` (K13) at
    (20, 20, 20) and (21, 18, 19), atol 1e-5.
(b) Module parity in float64 (the same numpy inputs through both packages):
    K12's periodic mode (`conv_diff_plain(perdir=)`), the periodic smoothers
    and residual to 1e-12, a whole periodic multigrid solve to 1e-10 with
    the same iteration count, the per-step `exit_bc` and `apply_vector` to
    1e-14."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu.models import flow as fl_j
from waterlily_tpu.ops import bc as bc_j
from waterlily_tpu.ops import flat as fo
from waterlily_tpu.ops import multigrid as mg_j
from waterlily_tpu.ops import pallas3d as pl3
from waterlily_tpu.ops import pallas_flat as plf
from waterlily_tpu.ops import poisson as ps_j
from waterlily_tpu_torch import Simulation
from waterlily_tpu_torch.ops import bc as bc_t
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import multigrid as mg_t
from waterlily_tpu_torch.ops import poisson as ps_t
from waterlily_tpu_torch.ops import stencil3d as st

F32, F64 = torch.float32, torch.float64
UBC = (1.0, 0.25, -0.5)       # all three non-zero: the BC! corners compose
PERDIRS = [(0, 1, 2), (2,), (0, 2)]


def T(a, dtype=F64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def Jx(t):
    return jnp.asarray(np.asarray(t))


def rel_close(t, j, rtol):
    """max |port − JAX| ≤ rtol · max |JAX|."""
    a, b = np.asarray(t), np.asarray(j)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= rtol * scale


# ------------------------------------------------------------ (a) kernels
SHAPE = (12, 10, 7)
GEOM = fo.geom_of(SHAPE)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(plf, "_INTERPRET", True)
    monkeypatch.setattr(pl3, "_INTERPRET", True)


def flat_fields(seed):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s + SHAPE), dtype=F32)
    L = torch.as_tensor(0.2 + rng.random((3,) + SHAPE), dtype=F32)
    return g(3), g(), L


def to_flat(t):
    return fo.to_flat(jnp.asarray(t.numpy()), GEOM)


def close_flat(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(fo.from_flat(j, GEOM)),
                               atol=atol)


@pytest.mark.parametrize("save_exit", [False, True], ids=["bc", "save_exit"])
def test_bc_plain_vs_bc_k(interpret, save_exit):
    u, _, _ = flat_fields(0)
    close_flat(fz.bc_plain(u, UBC, save_exit),
               plf.bc_k(to_flat(u), UBC, GEOM, save_exit), atol=2e-6)


def test_div_plain_vs_div_k(interpret):
    u, _, _ = flat_fields(1)
    close_flat(fz.div_plain(u), plf.div_k(to_flat(u), GEOM), atol=2e-6)


@pytest.mark.parametrize("want_cfl", [False, True], ids=["bc", "cfl"])
def test_projbc_save_exit_vs_projbc_k(interpret, want_cfl):
    u, x, L = flat_fields(2)
    got = fz.projbc_plain(u, x, L, UBC, want_cfl, save_exit=True)
    want = plf.projbc_k(to_flat(u), to_flat(x), to_flat(L), UBC, GEOM,
                        save_exit=True, want_cfl=want_cfl)
    if want_cfl:
        (got, s_t), (want, s_j) = got, want
        # the kernel's (8, 128) max partial holds max(s)
        np.testing.assert_allclose(float(s_t), float(jnp.max(s_j)), rtol=1e-6)
    close_flat(got, want, atol=2e-5)


@pytest.mark.parametrize("shape", [(20, 20, 20), (21, 18, 19)],
                         ids=["even", "odd"])
@pytest.mark.parametrize("perdir", [(0, 1, 2), (2,)], ids=["xyz", "z"])
def test_gauss_sweeps_plain_vs_pallas(interpret, shape, perdir):
    rng = np.random.default_rng(3)
    L = bc_t.bc_vector(T(0.2 + rng.random((3,) + shape), F32), (0.0,) * 3,
                       perdir=perdir)
    lev = ps_t.make_level(L)
    r = T(rng.standard_normal(shape), F32)
    eps = bc_t.per_bc(T(rng.standard_normal(shape), F32), perdir)
    colors = [0, 1, 0, 1]
    got = st.gauss_sweeps_plain(eps, r, lev.L, lev.iD, colors, perdir)
    want = pl3.gauss_sweeps3d(Jx(eps), Jx(r), Jx(lev.L), Jx(lev.iD), colors,
                              perdir)
    # the Pallas kernel resets the x ghost planes to their input values
    # after each sweep; both feed the increment, which refreshes the
    # periodic ghosts first: compare what it reads
    np.testing.assert_allclose(bc_t.per_bc(got, perdir).numpy(),
                               np.asarray(bc_j.per_bc(want, perdir)), atol=1e-5)


def test_new_wrappers_on_cpu_take_the_plain_version():
    u, x, L = flat_fields(4)
    lev = ps_t.make_level(L)
    before = st.launch_counts()
    assert torch.equal(fz.bc_k(u, UBC, True), fz.bc_plain(u, UBC, True))
    assert torch.equal(fz.div_k(u), fz.div_plain(u))
    for a, b in zip(fz.projbc_k(u, x, L, UBC, True, True),
                    fz.projbc_plain(u, x, L, UBC, True, True)):
        assert torch.equal(a, b)
    assert torch.equal(st.gauss_sweeps_k(x, u[0], L, lev.iD, [0, 1], (0, 2)),
                       st.gauss_sweeps_plain(x, u[0], L, lev.iD, [0, 1], (0, 2)))
    assert torch.equal(st.conv_diff_k(u, 0.1, 0, (1,)),
                       st.conv_diff_plain(u, 0.1, st.quick, (1,)))
    assert st.launch_counts() == before        # no kernel launched on the CPU


# ------------------------------------------------------------ (b) modules
@pytest.mark.parametrize("perdir", PERDIRS, ids=["xyz", "z", "xz"])
@pytest.mark.parametrize("scheme", ["quick", "vanleer", "cds"])
def test_conv_diff_periodic(perdir, scheme):
    """K12's periodic mode (ϕuP), every cell, ghosts included."""
    u = np.random.default_rng(5).standard_normal((3, 10, 8, 9))
    got = st.conv_diff_plain(T(u), 0.05, getattr(st, scheme), perdir)
    want = fl_j.conv_diff(jnp.asarray(u), getattr(fl_j, scheme), 0.05, perdir)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


def level_pair(shape, perdir, seed=6):
    L = 0.2 + np.random.default_rng(seed).random((3,) + shape)
    Lj = bc_j.bc_vector(jnp.asarray(L), (0.0,) * 3, perdir=perdir)
    Lt = bc_t.bc_vector(T(L), (0.0,) * 3, perdir=perdir)
    return ps_j.make_level(Lj), ps_t.make_level(Lt)


@pytest.mark.parametrize("perdir", PERDIRS, ids=["xyz", "z", "xz"])
def test_periodic_smoothers(perdir):
    shape = (9, 8, 7)
    pj, pt = level_pair(shape, perdir)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape)
    r = np.zeros(shape)
    r[1:-1, 1:-1, 1:-1] = rng.standard_normal(tuple(n - 2 for n in shape))
    for fn_t, fn_j in ((ps_t.jacobi, ps_j.jacobi),
                       (ps_t.gauss_seidel_rb, ps_j.gauss_seidel_rb)):
        got = fn_t(pt, T(x), T(r), perdir=perdir)
        want = fn_j(pj, jnp.asarray(x), jnp.asarray(r), perdir=perdir)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    np.testing.assert_allclose(
        ps_t.residual(pt, T(x), T(r), perdir).numpy(),
        np.asarray(ps_j.residual(pj, jnp.asarray(x), jnp.asarray(r), perdir)),
        atol=1e-12)


def test_periodic_mg_solve():
    """A fully periodic operator (the constant null space): level stack,
    dense pseudo-inverse and the whole solve."""
    shape, perdir = (10, 10, 10), (0, 1, 2)
    mu0 = np.ones((3,) + shape)
    lv_j, masks = mg_j.make_mg(bc_j.bc_vector(jnp.asarray(mu0), (0.0,) * 3,
                                              perdir=perdir), perdir, min_cells=64)
    lv_t = mg_t.update_mg(masks, bc_t.bc_vector(T(mu0), (0.0,) * 3, perdir=perdir),
                          perdir)
    for a, b in zip(lv_t, lv_j):
        np.testing.assert_allclose(a.L.numpy(), np.asarray(b.L), atol=1e-12)
        np.testing.assert_allclose(a.D.numpy(), np.asarray(b.D), atol=1e-12)
    np.testing.assert_allclose(lv_t[-1].Ainv.numpy(), np.asarray(lv_j[-1].Ainv),
                               atol=1e-10)
    z = np.zeros(shape)
    z[1:-1, 1:-1, 1:-1] = np.random.default_rng(8).standard_normal(
        tuple(n - 2 for n in shape))
    z[1:-1, 1:-1, 1:-1] -= z[1:-1, 1:-1, 1:-1].mean()
    res_t = mg_t.solve_mg(lv_t, masks, torch.zeros(shape, dtype=F64), T(z),
                          perdir=perdir)
    res_j = mg_j.solve_mg(lv_j, masks, jnp.zeros(shape), jnp.asarray(z),
                          perdir=perdir)
    assert res_t.iters == int(res_j.iters)
    rel_close(res_t.x, res_j.x, 1e-10)


def test_exit_bc_and_apply_vector():
    rng = np.random.default_rng(9)
    u, u_old = rng.standard_normal((2, 3, 10, 8, 7))
    np.testing.assert_allclose(
        bc_t.exit_bc(T(u), T(u_old), 0.3).numpy(),
        np.asarray(bc_j.exit_bc(jnp.asarray(u), jnp.asarray(u_old), 0.3)),
        atol=1e-14)
    ft = lambda i, x: torch.sin(x[0] * (i + 1)) * x[1] - x[2] ** 2
    fj = lambda i, x: jnp.sin(x[0] * (i + 1)) * x[1] - x[2] ** 2
    np.testing.assert_allclose(
        bc_t.apply_vector(ft, 3, (6, 5, 4), F64, "cpu").numpy(),
        np.asarray(bc_j.apply_vector(fj, 3, (6, 5, 4), jnp.float64)), atol=1e-14)


def test_callable_u0_checked():
    with pytest.raises(ValueError, match="scalar"):
        Simulation((16, 16, 16), (0.0,) * 3, 16.0, u0=lambda i, x: x,
                   perdir=(0, 1, 2), dtype=F64, device="cpu")
