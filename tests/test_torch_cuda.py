"""The CUDA kernels of `ops/stencil3d.py`, `ops/fused3d.py` and `ops/probe.py`
against their plain versions on the card, at small shapes, and the routing
of both engines.  No JAX: run it on a machine with an NVIDIA GPU
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository conftest imports JAX).  Elsewhere every test skips.

Tolerances (float32, max |kernel − plain| relative to max |plain|): 2e-5
for the conv–diff RHS (also fused with the far-field BDIM, also periodic)
and the BDIM update, 1e-5 for A·x, the smoothers and colour sweeps, the
fused tail and its norms and the projection + BC (and its CFL max, also
keeping the exit plane), 1e-6 for BC + divergence, BC alone and the
divergence alone (the same additions in the same order).
The kernels and the plain versions round in a different order (fused
multiply-adds in the kernels), nothing more.  The band-sparse BDIM: 2e-5.
The mixed-precision smoothers round every bf16 operation where torch does
and use no fused multiply-add, so x is held to 1e-5 and r to 2⁻⁸ (one bf16
rounding that flips), both expected to be met exactly; their norms 1e-5.
The copy probes: equal."""
import numpy as np
import pytest
import torch

import waterlily_tpu_torch as wt
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import probe
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector

pytestmark = pytest.mark.cuda

SHAPES = [(18, 18, 18), (26, 18, 10), (10, 6, 6)]
# with an odd interior extent: same-colour cells meet across a periodic face
PER_SHAPES = SHAPES + [(21, 18, 19)]
PERDIRS = [(0, 1, 2), (2,), (0, 2)]


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
    assert st.launch_counts() == dict.fromkeys(st.launch_counts(), 0) | {
        "mult_k": 1, "gs_incr_k": 2}
    assert len(st.launch_counts()) == 16
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


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
@pytest.mark.parametrize("perdir", PERDIRS, ids=["xyz", "z", "xz"])
def test_conv_diff_k_periodic(dev, shape, sid, perdir):
    d = inputs(shape, 9, dev)
    nu = torch.tensor(0.03, device=dev)
    got = st.conv_diff_k(d["u"], nu, sid, perdir)
    want = st.conv_diff_plain(d["u"], nu, st.SCHEMES[sid], perdir)
    assert rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("colors", [[0, 1, 0, 1], [1, 0]], ids=["rb4", "br2"])
@pytest.mark.parametrize("perdir", [(0, 1, 2), (2,), ()], ids=["xyz", "z", "none"])
def test_gauss_sweeps_k(dev, shape, colors, perdir):
    d = inputs(shape, 10, dev)
    lev = d["lev"]
    L = bc_vector(lev.L, (0.0,) * 3, perdir=perdir)
    iD = ps.make_level(L).iD
    eps = wt.bc.per_bc(d["x"], perdir)
    got = st.gauss_sweeps_k(eps, d["r"], L, iD, colors, perdir)
    assert rel_err(got, st.gauss_sweeps_plain(eps, d["r"], L, iD, colors,
                                              perdir)) <= 1e-5
    assert torch.equal(eps, wt.bc.per_bc(d["x"], perdir))   # input untouched


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("save_exit", [False, True], ids=["bc", "save_exit"])
def test_bc_k(dev, shape, save_exit):
    d = inputs(shape, 11, dev)
    assert rel_err(fz.bc_k(d["u"], UBC, save_exit),
                   fz.bc_plain(d["u"], UBC, save_exit)) <= 1e-6


@pytest.mark.parametrize("shape", PER_SHAPES)
def test_div_k(dev, shape):
    d = inputs(shape, 12, dev)
    assert rel_err(fz.div_k(d["u"]), fz.div_plain(d["u"])) <= 1e-6


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("want_cfl", [False, True], ids=["bc", "cfl"])
def test_projbc_k_save_exit(dev, shape, want_cfl):
    d = inputs(shape, 13, dev)
    got = fz.projbc_k(d["u"], d["x"], d["lev"].L, UBC, want_cfl, save_exit=True)
    want = fz.projbc_plain(d["u"], d["x"], d["lev"].L, UBC, want_cfl,
                           save_exit=True)
    for a, b in zip(*((got, want) if want_cfl else ((got,), (want,)))):
        assert rel_err(a, b) <= 1e-5


def tgv(n, dev, **kw):
    k = 2 * np.pi / n

    def u0(i, x):
        a, b, c = x[0] * k, x[1] * k, x[2] * k
        if i == 0:
            return torch.cos(a) * torch.sin(b) * torch.sin(c)
        if i == 1:
            return -torch.sin(a) * torch.cos(b) * torch.sin(c) / 2
        return -torch.sin(a) * torch.sin(b) * torch.cos(c) / 2
    return wt.Simulation((n, n, n), (0.0,) * 3, n, U=1, nu=1 / (k * 1600),
                         u0=u0, perdir=(0, 1, 2), device=dev, **kw)


def test_periodic_and_exit_routing(dev):
    # TGV, flat engine: periodic K12, K11, K13 and the K6 increments; no K1,
    # K8, K9, K10 or K15
    sim = tgv(32, dev)
    assert sim.engine == "flat"
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["conv_diff_k"] == 2 and n["div_k"] == 2 and n["bdim_k"] == 2
    assert n["gauss_sweeps_k"] > 0 and n["incr_gs_k"] > 0 and n["mult_k"] > 0
    assert n["conv_diff_bdim_k"] == n["bc_div_k"] == n["projbc_k"] == 0
    assert n["bc_k"] == n["gs_incr_k"] == 0
    # TGV, 3d engine: K13 and K16, no K15
    sim = tgv(32, dev, engine="3d")
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["conv_diff_k"] == 2 and n["gauss_sweeps_k"] > 0 and n["gs_incr_k"] == 0
    assert torch.isfinite(sim.flow.u).all() and torch.isfinite(sim.flow.p).all()
    # exit sphere, flat engine: K10, K11 and K9 (exit mode), no K8
    sim = sphere(32, dev, exit_bc=True)
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["bc_k"] == 2 and n["div_k"] == 2 and n["projbc_k"] == 2
    assert n["bc_div_k"] == 0 and n["conv_diff_bdim_k"] == 2
    u = sim.flow.u
    inflow = u[0, 1, 1:-1, 1:-1].mean()
    assert ((u[0, -1, 1:-1, 1:-1].mean() - inflow).abs() / inflow).item() <= 1e-5


# ------------------------------------------------------------ forced flows, mp
def bands(nx):
    return {"middle": (nx // 3, 2 * nx // 3), "row1": (1, nx // 2),
            "top": (nx // 2, nx - 1), "full": (1, nx - 1), "empty": (1, 1)}


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("band", ["middle", "row1", "top", "full", "empty"])
@pytest.mark.parametrize("perdir", [(), (2,), (0, 1, 2)], ids=["walls", "z", "xyz"])
def test_bdim_band_k(dev, shape, band, perdir):
    d = inputs(shape, 14, dev)
    args = [d[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")]
    b = bands(shape[0])[band]
    assert rel_err(st.bdim_band_k(*args, 0.3, b, perdir),
                   st.bdim_band_plain(*args, 0.3, b, perdir)) <= 2e-5
    with pytest.raises(ValueError):
        st.bdim_band_k(*args, 0.3, (0, 3))


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("colors", [[], [0, 1], [0, 1, 0, 1]],
                         ids=["jacobi", "rb2", "rb4"])
def test_gs_incr_mp_k(dev, shape, colors):
    d = inputs(shape, 15, dev)
    lev = ps.with_bf16(d["lev"])
    st.reset_launch_counts()
    got = st.gs_incr_k(d["x"], d["r"], *lev.bf, colors, 0.9, mp=True)
    want = st.gs_incr_plain(d["x"], d["r"], *lev.bf, colors, 0.9, mp=True)
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 2.0 ** -8
    n = st.launch_counts()
    assert n["gs_incr_mp_k"] == 1 and n["gs_incr_k"] == 0
    with pytest.raises(TypeError):
        st.gs_incr_k(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9, mp=True)


@pytest.mark.parametrize("shape", PER_SHAPES)
@pytest.mark.parametrize("want_norms", [False, True], ids=["plain", "norms"])
def test_incr_gs_mp_k(dev, shape, want_norms):
    d = inputs(shape, 16, dev)
    lev = ps.with_bf16(d["lev"])
    args = (d["x"], d["r"], d["eps"], *lev.bf, [0, 1, 0], 0.9, want_norms)
    st.reset_launch_counts()
    got = fz.incr_gs_k(*args, mp=True)
    want = fz.incr_gs_plain(*args, mp=True)
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 2.0 ** -8
    if want_norms:
        for k in range(2):
            assert rel_err(got[2][k], want[2][k]) <= 1e-5
    n = st.launch_counts()
    assert n["incr_gs_mp_k"] == 1 and n["incr_gs_k"] == 0
    with pytest.raises(ValueError):
        fz.incr_gs_k(d["x"], d["r"], d["eps"], *lev.bf, [], 0.9, mp=True)


@pytest.mark.parametrize("shape", [(18, 18, 18), (7, 5, 3), (8, 8, 8)])
@pytest.mark.parametrize("nf", [1, 6])
@pytest.mark.parametrize("block", [256, 1024])
def test_copy_scale_k(dev, shape, nf, block):
    rng = np.random.default_rng(17)
    a = [torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                         device=dev) for _ in range(nf)]
    st.reset_launch_counts()
    got = probe.copy_scale_k(a, block)
    torch.cuda.synchronize()
    for g, w in zip(got, probe.copy_scale_plain(a)):
        assert torch.equal(g, w)
    out = [torch.empty_like(t) for t in a]
    assert probe.copy_scale_k(a, block, out=out)[0] is out[0]
    assert st.launch_counts()["copy_scale_k" if nf == 1 else "copy_scale6_k"] == 2
    with pytest.raises(ValueError):
        probe.copy_scale_k(a[:1] * 2)
    with pytest.raises(ValueError):
        probe.copy_scale_k(a, 100)


def test_forced_and_mp_routing(dev):
    from waterlily_tpu_torch.utils import les

    # LES on the flat engine: K12 + K2 in place of K1, the fused BC kernels stay
    sim = sphere(32, dev)
    st.reset_launch_counts()
    sim.sim_step(remeasure=False, udf=les.sgs(les.smagorinsky(0.17)))
    n = st.launch_counts()
    assert n["conv_diff_k"] == 2 and n["bdim_band_k"] == 2
    assert n["conv_diff_bdim_k"] == n["bdim_k"] == 0
    assert n["bc_div_k"] == 2 and n["projbc_k"] == 2
    # a callable ubc and g: no K8, K9 or K10; K11 gives the divergence
    sim = sphere(32, dev, g=lambda i, x, t: 0.01 * t if i == 1 else 0.0)
    sim2 = wt.Simulation((32, 32, 32), lambda i, x, t: 1.0 - torch.exp(-t) if i == 0 else 0.0,
                         4.0, U=1.0, nu=4e-3, body=sim.body, device=dev)
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["bdim_band_k"] == 2 and n["bc_div_k"] == 2 and n["div_k"] == 0
    st.reset_launch_counts()
    sim2.sim_step(remeasure=False)
    n = st.launch_counts()
    assert sim2.engine == "flat" and n["bdim_band_k"] == 2 and n["div_k"] == 2
    assert n["bc_div_k"] == n["projbc_k"] == n["bc_k"] == 0
    assert torch.isfinite(sim2.flow.u).all() and torch.isfinite(sim2.flow.p).all()
    # mp_smooth: the fine level's smoothers are the bf16 instantiations
    sim = sphere(32, dev, smooth_it=2, mp_smooth=True)
    assert sim.levels[0].bf is not None and sim.levels[1].bf is None
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["incr_gs_mp_k"] >= 2 and n["gs_incr_mp_k"] >= 2
    assert n["gs_incr_k"] >= 2 and n["conv_diff_bdim_k"] == 2
    assert torch.isfinite(sim.flow.u).all() and torch.isfinite(sim.flow.p).all()
    # the 3d engine ignores it
    sim = sphere(32, dev, engine="3d", mp_smooth=True)
    st.reset_launch_counts()
    sim.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["incr_gs_mp_k"] == n["gs_incr_mp_k"] == 0 and n["gs_incr_k"] > 0


def test_mp_run_equals_the_run_with_only_its_smoothers_plain(dev):
    """`plain_ops(only=...)` routes the bf16 smoothers alone to their plain
    versions: every float32 kernel still launches, and the run equals the
    kernels' run bit for bit, since the bf16 kernels round where their plain
    versions round."""
    mp = ("gs_incr_mp_k", "incr_gs_mp_k")
    a, b = (sphere(32, dev, smooth_it=2, mp_smooth=True) for _ in range(2))
    for _ in range(3):
        a.sim_step(remeasure=False)
    st.reset_launch_counts()
    with st.plain_ops(only=mp):
        for _ in range(3):
            b.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["incr_gs_mp_k"] == n["gs_incr_mp_k"] == 0
    assert n["conv_diff_bdim_k"] == 6 and n["gs_incr_k"] > 0 and n["mult_k"] > 0
    assert a.pois_n == b.pois_n
    assert torch.equal(a.flow.u, b.flow.u) and torch.equal(a.flow.p, b.flow.p)
