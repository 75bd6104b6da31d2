"""The CUDA kernels of `ops/stencil3d.py` and `ops/fused3d.py` against their
plain versions on the card, at small shapes, and the routing of both engines.  No JAX: run it on a machine with an NVIDIA GPU
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository conftest imports JAX).  Elsewhere every test skips.

Tolerances (float32, max |kernel − plain| relative to max |plain|): 2e-5
for the conv–diff RHS (also fused with the far-field BDIM) and the BDIM
update, 1e-5 for A·x, the smoothers, the fused tail and its norms and the
projection + BC (and its CFL max), 1e-6 for BC + divergence (the same
additions in the same order).
The kernels and the plain versions round in a different order (fused
multiply-adds in the kernels), nothing more."""
import numpy as np
import pytest
import torch

import waterlily_tpu_torch as wt
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector

pytestmark = pytest.mark.cuda

SHAPES = [(18, 18, 18), (26, 18, 10), (10, 6, 6)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def inputs(shape, seed, dev):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s + shape),
                                   dtype=torch.float32, device=dev)
    L = bc_vector(torch.as_tensor(0.2 + rng.random((3,) + shape),
                                  dtype=torch.float32, device=dev), (0.0,) * 3)
    lev = ps.make_level(L)
    r = torch.zeros(shape, dtype=torch.float32, device=dev)
    r[1:-1, 1:-1, 1:-1] = g()[1:-1, 1:-1, 1:-1]
    eps = torch.zeros(shape, dtype=torch.float32, device=dev)
    eps[1:-1, 1:-1, 1:-1] = 0.3 * g()[1:-1, 1:-1, 1:-1]
    return dict(u=g(3), u0=g(3), f=g(3), V=0.1 * g(3), mu0=g(3).abs(),
                mu1=0.3 * g(3, 3), x=g(), r=r, eps=eps, lev=lev)


def rel_err(got, want):
    torch.cuda.synchronize()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
def test_conv_diff_k(dev, shape, sid):
    d = inputs(shape, 0, dev)
    nu = torch.tensor(0.03, device=dev)
    got = st.conv_diff_k(d["u"], nu, sid)
    assert rel_err(got, st.conv_diff_plain(d["u"], nu, st.SCHEMES[sid])) <= 2e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_bdim_k(dev, shape):
    d = inputs(shape, 1, dev)
    args = [d[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")]
    assert rel_err(st.bdim_k(*args, 0.3), st.bdim_plain(*args, 0.3)) <= 2e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_mult_k(dev, shape):
    d = inputs(shape, 2, dev)
    lev = d["lev"]
    assert rel_err(st.mult_k(d["x"], lev.L, lev.D),
                   st.mult_plain(d["x"], lev.L, lev.D)) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("colors", [[], [0, 1, 0, 1], [1, 0]],
                         ids=["jacobi", "rb4", "br2"])
def test_gs_incr_k(dev, shape, colors):
    d = inputs(shape, 3, dev)
    lev = d["lev"]
    got = st.gs_incr_k(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9)
    want = st.gs_incr_plain(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-5


def test_launch_counts_and_routing(dev):
    d = inputs((10, 8, 6), 4, dev)
    lev = d["lev"]
    st.reset_launch_counts()
    assert st.use_kernels(d["x"])
    ps.jacobi(lev, d["x"], d["r"])
    ps.gauss_seidel_rb(lev, d["x"], d["r"])
    ps.mult(lev, d["x"])
    with st.plain_ops():
        assert not st.use_kernels(d["x"])
        ps.mult(lev, d["x"])
    assert st.launch_counts() == {"conv_diff_k": 0, "bdim_k": 0, "mult_k": 1,
                                  "gs_incr_k": 2, "conv_diff_bdim_k": 0,
                                  "incr_gs_k": 0, "bc_div_k": 0, "projbc_k": 0}
    # float64 on the card takes the plain version; the wrapper refuses it
    assert not st.use_kernels(d["x"].double())
    with pytest.raises(TypeError):
        st.mult_k(d["x"].double(), lev.L.double(), lev.D.double())
    with pytest.raises(ValueError):
        st.mult_k(d["x"][:, :, :-1], lev.L, lev.D)


UBC = (1.0, 0.25, -0.5)     # all three non-zero: the BC! corners compose


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kb,scale", [(0.0, 1.0), (1.0, 0.5)],
                         ids=["predictor", "corrector"])
@pytest.mark.parametrize("slab", [False, True], ids=["full", "slab"])
def test_conv_diff_bdim_k(dev, shape, kb, scale, slab):
    d = inputs(shape, 5, dev)
    nu = torch.tensor(0.03, device=dev)
    rows = (shape[0] // 3, 2 * shape[0] // 3) if slab else (0, shape[0])
    u_k, f_k = fz.conv_diff_bdim_k(d["u"], d["u0"], nu, 0.3, kb, scale, 0,
                                   rows if slab else None)
    u_p, f_p = fz.conv_diff_bdim_plain(d["u"], d["u0"], nu, 0.3, kb, scale, st.quick)
    assert rel_err(u_k, u_p) <= 2e-5
    assert rel_err(f_k[:, slice(*rows)], f_p[:, slice(*rows)]) <= 2e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("colors", [[], [0, 1, 0, 1]], ids=["K6", "K7"])
def test_incr_gs_k(dev, shape, colors):
    d = inputs(shape, 6, dev)
    lev = d["lev"]
    args = (d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD, colors, 0.9)
    got = fz.incr_gs_k(*args, want_norms=True)
    want = fz.incr_gs_plain(*args, want_norms=True)
    for a, b in zip(got[:2], want[:2]):
        assert rel_err(a, b) <= 1e-5
    for k in range(2):
        assert rel_err(got[2][k], want[2][k]) <= 1e-5
    # the norms reduce in a fixed order: equal from call to call
    assert torch.equal(fz.incr_gs_k(*args, want_norms=True)[2], got[2])


@pytest.mark.parametrize("shape", SHAPES)
def test_bc_div_k(dev, shape):
    d = inputs(shape, 7, dev)
    for a, b in zip(fz.bc_div_k(d["u"], UBC), fz.bc_div_plain(d["u"], UBC)):
        assert rel_err(a, b) <= 1e-6


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("want_cfl", [False, True], ids=["bc", "cfl"])
def test_projbc_k(dev, shape, want_cfl):
    d = inputs(shape, 8, dev)
    got = fz.projbc_k(d["u"], d["x"], d["lev"].L, UBC, want_cfl)
    want = fz.projbc_plain(d["u"], d["x"], d["lev"].L, UBC, want_cfl)
    for a, b in zip(*((got, want) if want_cfl else ((got,), (want,)))):
        assert rel_err(a, b) <= 1e-5


def sphere(n, dev, body=True, **kw):
    ctr = torch.tensor([n / 3, n / 2, n / 2], device=dev)
    b = (wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - n / 8)
         if body else wt.NoBody())
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), n / 8, nu=n / 8e3, body=b,
                         device=dev, **kw)


def test_flat_engine_routing(dev):
    sim = sphere(32, dev)
    assert sim.engine == "flat" and sim.flow.cfg.band_x is not None
    assert sphere(32, dev, dtype=torch.float64).engine == "3d"
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    # a body band: K1 (no K12), K14 on the slab, and the flat solver's kernels
    assert n["conv_diff_k"] == 0 and n["conv_diff_bdim_k"] == 2
    assert n["bdim_k"] == 2 and n["bc_div_k"] == 2 and n["projbc_k"] == 2
    assert n["mult_k"] >= 2 and n["incr_gs_k"] >= 2 and n["gs_incr_k"] >= 2
    # no body, no band: K12 + K14 on the full field
    sim = sphere(32, dev, body=False, engine="flat")
    assert sim.flow.cfg.band_x is None
    st.reset_launch_counts()
    sim.sim_step()
    n = st.launch_counts()
    assert n["conv_diff_k"] == 2 and n["conv_diff_bdim_k"] == 0
    assert n["bdim_k"] == 2 and n["projbc_k"] == 2
    assert torch.isfinite(sim.flow.u).all() and torch.isfinite(sim.flow.p).all()
