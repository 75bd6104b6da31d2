"""Plain versions of the four CUDA kernels (`ops/stencil3d.py`) against the
JAX package, on the CPU.

(a) float64 against the JAX jnp callers (`flow.conv_diff` per scheme,
    `flow.bdim_update`, `poisson._mult_raw`, `jacobi`, `gauss_seidel_rb`),
    all cells, atol 1e-12.
(b) float32 against the same JAX callers with the TPU kernels of
    `ops/pallas3d.py` in Pallas interpret mode, at (20,20,20) and (26,18,18):
    interior cells only, rtol 1e-5 with an atol of 1e-5 × max|reference|.
    The Pallas route treats ghosts differently (it zeroes the x/y ghosts of
    the conv–diff RHS and the ghost rows of r), so ``r`` gets zero ghosts as
    in the solver.

The wrappers (`conv_diff_k`, ...) given CPU tensors return these plain
versions, which the last test checks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu.models import flow as fl_j
from waterlily_tpu.ops import pallas3d as pl3
from waterlily_tpu.ops import poisson as ps_j
from waterlily_tpu.ops.bc import bc_vector as bc_vector_j
from waterlily_tpu_torch.ops import poisson as ps_t
from waterlily_tpu_torch.ops import stencil3d as st

SCHEMES = [(fl_j.quick, st.quick), (fl_j.vanleer, st.vanleer),
           (fl_j.cds, st.cds)]
SCHEME_IDS = ["quick", "vanleer", "cds"]


def fields(shape, seed, np_dtype):
    """Random u, u0, f, V, mu0, mu1 and a level (L with zero boundary faces,
    D, iD) plus x, r (r with zero ghosts), all numpy."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal(s + shape).astype(np_dtype)
    L = np.asarray(bc_vector_j(jnp.asarray(0.2 + rng.random((3,) + shape)),
                               (0.0,) * 3))
    r = g()
    r = np.pad(r[1:-1, 1:-1, 1:-1], 1)
    return dict(u=g(3), u0=g(3), f=g(3), V=0.1 * g(3), mu0=np.abs(g(3)),
                mu1=0.3 * g(3, 3), L=L.astype(np_dtype), x=g(), r=r)


def jax_level(L):
    return ps_j.make_level(L)


def torch_level(L):
    return ps_t.make_level(L)


def compare(t, j, interior_only, atol=None, rtol=0.0):
    a, b = t.numpy(), np.asarray(j)
    if interior_only:
        ix = (Ellipsis,) + (slice(1, -1),) * 3
        a, b = a[ix], b[ix]
    if atol is None:
        atol = 1e-5 * np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def run_both(name, d, dtype_np, scheme_pair=None, it=4):
    """(torch result, JAX result) of one kernel's caller on the same inputs."""
    jdt = jnp.float64 if dtype_np == np.float64 else jnp.float32
    tdt = torch.float64 if dtype_np == np.float64 else torch.float32
    J = {k: jnp.asarray(v, jdt) for k, v in d.items()}
    T = {k: torch.as_tensor(v, dtype=tdt) for k, v in d.items()}
    nu, dt, om = 0.03, 0.3, 0.9
    if name == "conv_diff":
        sj, stc = scheme_pair
        return (st.conv_diff_plain(T["u"], torch.tensor(nu, dtype=tdt), stc),
                [fl_j.conv_diff(J["u"], sj, jnp.asarray(nu, jdt))])
    if name == "bdim":
        args = ("u", "u0", "f", "V", "mu0", "mu1")
        return (st.bdim_plain(*(T[k] for k in args), dt),
                [fl_j.bdim_update(*(J[k] for k in args), jnp.asarray(dt, jdt))])
    lj, lt = jax_level(J["L"]), torch_level(T["L"])
    if name == "mult":
        return st.mult_plain(T["x"], lt.L, lt.D), [ps_j._mult_raw(lj, J["x"])]
    if name == "jacobi":
        return (st.gs_incr_plain(T["x"], T["r"], lt.L, lt.D, lt.iD, [], om),
                ps_j.jacobi(lj, J["x"], J["r"], it=1, omega=om))
    colors = [(1 - 3 - k0) % 2 for k0 in range(1, it + 1)]
    return (st.gs_incr_plain(T["x"], T["r"], lt.L, lt.D, lt.iD, colors, om),
            ps_j.gauss_seidel_rb(lj, J["x"], J["r"], it=it, omega=om))


def _as_list(t):
    return list(t) if isinstance(t, tuple) else [t]


# ------------------------------------------------------------ (a) f64, jnp
@pytest.mark.parametrize("scheme", SCHEMES, ids=SCHEME_IDS)
def test_conv_diff_plain_vs_jnp(scheme):
    d = fields((12, 10, 8), 0, np.float64)
    got, want = run_both("conv_diff", d, np.float64, scheme)
    compare(got, want[0], False, atol=1e-12)


# the walled field, every direction periodic, and one periodic axis
JVP_PERDIRS = [(), (0, 1, 2), (1,)]


@pytest.mark.parametrize("perdir", JVP_PERDIRS, ids=["walls", "xyz", "y"])
@pytest.mark.parametrize("scheme", SCHEMES, ids=SCHEME_IDS)
def test_conv_diff_jvp_plain_vs_jax_jvp(scheme, perdir):
    """K12's tangent as the port defines it (`conv_diff_jvp_plain`, the
    forward derivative of `conv_diff_plain` that `conv_diff_jvp_k`
    computes) against `jax.jvp` of the JAX package's conv–diff (its jnp
    path in float64), tangents in u and nu, on the interior cells of a
    non-cubic field whose values include ties and zero upwind velocities."""
    import jax

    rng = np.random.default_rng(7)
    shape = (12, 10, 8)          # the shape of `test_conv_diff_plain_vs_jnp`
    u = rng.standard_normal((3,) + shape)
    pick = rng.random(u.shape) < 1 / 3
    u[pick] = 0.5 * rng.integers(-2, 3, u.shape)[pick]
    du = rng.standard_normal((3,) + shape)
    nu, dnu = 0.03, -0.7
    sj, stc = scheme
    got = st.conv_diff_jvp_plain(torch.as_tensor(u), torch.as_tensor(du), nu, dnu,
                                 stc, perdir)
    # the scheme jitted: one compile per operand shape instead of one per
    # operation (the same values in float64)
    sjit = jax.jit(sj)
    want = jax.jvp(lambda a, b: fl_j.conv_diff(a, sjit, b, perdir),
                   (jnp.asarray(u), jnp.asarray(nu)), (jnp.asarray(du), jnp.asarray(dnu)))[1]
    compare(got, want, True, atol=1e-12 * float(jnp.abs(want).max()))


@pytest.mark.parametrize("name", ["bdim", "mult", "jacobi"])
def test_plain_vs_jnp(name):
    d = fields((12, 10, 8), 1, np.float64)
    got, want = run_both(name, d, np.float64)
    for a, b in zip(_as_list(got), want):
        compare(a, b, False, atol=1e-12)


@pytest.mark.parametrize("it", [1, 2, 4])
def test_gs_incr_plain_vs_jnp(it):
    d = fields((12, 10, 8), 2, np.float64)
    got, want = run_both("gs", d, np.float64, it=it)
    for a, b in zip(got, want):
        compare(a, b, False, atol=1e-12)


# ------------------------------------------------------------ (b) f32, Pallas
@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl3, "_INTERPRET", True)


PALLAS_SHAPES = [(20, 20, 20), (26, 18, 18)]


@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("scheme", SCHEMES, ids=SCHEME_IDS)
def test_conv_diff_plain_vs_pallas(interpret, shape, scheme):
    d = fields(shape, 3, np.float32)
    got, want = run_both("conv_diff", d, np.float32, scheme)
    compare(got, want[0], True, rtol=1e-5)


@pytest.mark.parametrize("shape", PALLAS_SHAPES)
@pytest.mark.parametrize("name", ["bdim", "mult", "jacobi", "gs"])
def test_plain_vs_pallas(interpret, shape, name):
    assert pl3.use_pallas(jnp.zeros(shape, jnp.float32))
    d = fields(shape, 4, np.float32)
    got, want = run_both(name, d, np.float32)
    for a, b in zip(_as_list(got), want):
        compare(a, b, True, rtol=1e-5)


# ------------------------------------------------------------ wrappers
def test_wrappers_on_cpu_take_the_plain_version():
    d = fields((10, 8, 6), 5, np.float32)
    T = {k: torch.as_tensor(v) for k, v in d.items()}
    lt = torch_level(T["L"])
    nu = torch.tensor(0.03)
    before = st.launch_counts()
    for k, s in enumerate(st.SCHEMES):
        assert st.scheme_id(s) == k
        assert torch.equal(st.conv_diff_k(T["u"], nu, k),
                           st.conv_diff_plain(T["u"], nu, s))
    args = [T[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")]
    assert torch.equal(st.bdim_k(*args, 0.3), st.bdim_plain(*args, 0.3))
    assert torch.equal(st.mult_k(T["x"], lt.L, lt.D),
                       st.mult_plain(T["x"], lt.L, lt.D))
    for colors in ([], [0, 1, 0, 1], [1, 0]):
        for a, b in zip(st.gs_incr_k(T["x"], T["r"], lt.L, lt.D, lt.iD, colors, 0.9),
                        st.gs_incr_plain(T["x"], T["r"], lt.L, lt.D, lt.iD, colors, 0.9)):
            assert torch.equal(a, b)
    assert st.launch_counts() == before        # no kernel launched on the CPU
    assert not st.use_kernels(T["x"])           # CPU tensors take plain ops
    # a scheme without a kernel: None, and the callers take the plain route
    assert st.scheme_id(lambda u, c, d: c) is None
