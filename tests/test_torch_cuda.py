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
# the seven periodic masks of K12 (the eighth, no periodic direction, is
# `test_conv_diff_k`)
PERDIRS = [(0, 1, 2), (2,), (0, 2), (0,), (1,), (0, 1), (1, 2)]
PERDIR_IDS = ["xyz", "z", "xz", "x", "y", "xy", "yz"]
# shapes that stress the conv-diff tiles (8 x 32 cells in y, z, marched over
# chunks of 8 to 32 x rows): extents below one tile, one cell over a tile and a
# chunk, and the drag grid's aspect
TILE_SHAPES = [(6, 6, 6), (12, 10, 7), (34, 17, 33), (66, 18, 34), (82, 34, 34)]


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


@pytest.mark.parametrize("shape", SHAPES + TILE_SHAPES)
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


# K15's colour lists (Jacobi, lists that do not alternate, five colours:
# the per-colour route) and the routes each is held on: the one the shape
# gives (None) and each route that takes it
GS_COLORS = [[], [1], [1, 0], [0, 1, 0], [1, 1], [0, 1, 0, 1], [0, 0, 1, 1],
             [0, 1, 0, 1, 0]]
GS_CASES = [(c, route) for c in GS_COLORS
            for route in (None, st.PER_COLOUR, st.CASCADE)
            if route != st.CASCADE or 1 <= len(c) <= 4]
ROUTE_IDS = {None: "auto", st.PER_COLOUR: "per-colour", st.CASCADE: "cascade"}


@pytest.mark.parametrize("shape", PER_SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("colors,route", GS_CASES,
                         ids=[f"{''.join(map(str, c)) or 'jacobi'}-{ROUTE_IDS[r]}"
                              for c, r in GS_CASES])
def test_gs_incr_k(dev, shape, colors, route):
    d = inputs(shape, 3, dev)
    lev = d["lev"]
    args = (d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9)
    st.reset_launch_counts()
    got = st._gs_incr_launch(*args, mp=False, route=route)
    assert st.launch_counts()["gs_incr_k"] == 1
    for a, b in zip(got, st.gs_incr_plain(*args)):
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


def f_rows_of(nx, kind):
    """The x rows of K1's ``f`` for a case: the middle third, a slab that
    starts or ends on the edge of a 32-row chunk (where the field has one),
    one row, every interior row, or None for all rows."""
    return {"all": None, "slab": (nx // 3, 2 * nx // 3),
            "from_chunk": (min(32, nx - 2), nx - 1),
            "to_chunk": (1, min(32, nx - 1)),
            "one": (nx // 2, nx // 2 + 1), "interior": (1, nx - 1)}[kind]


@pytest.mark.parametrize("shape", SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("kb,scale", [(0.0, 1.0), (1.0, 0.5)],
                         ids=["predictor", "corrector"])
@pytest.mark.parametrize("rows", ["all", "slab", "from_chunk", "to_chunk", "one",
                                  "interior"])
def test_conv_diff_bdim_k(dev, shape, kb, scale, rows):
    d = inputs(shape, 5, dev)
    nu = torch.tensor(0.03, device=dev)
    f_rows = f_rows_of(shape[0], rows)
    lo, hi = f_rows or (0, shape[0])
    u_k, f_k = fz.conv_diff_bdim_k(d["u"], d["u0"], nu, 0.3, kb, scale, 0, f_rows)
    u_p, f_p = fz.conv_diff_bdim_plain(d["u"], d["u0"], nu, 0.3, kb, scale, st.quick)
    assert rel_err(u_k, u_p) <= 2e-5
    assert rel_err(f_k[:, lo:hi], f_p[:, lo:hi]) <= 2e-5
    # the entry point on a NaN-filled f: finite on the slab, untouched outside
    u_new = torch.empty_like(d["u"])
    f = torch.full_like(d["u"], float("nan"))
    err = fz._lib().wlt_conv_diff_bdim(
        fz._ptr(d["u"]), fz._ptr(d["u0"]), fz._ptr(nu), 0.3, kb, scale, lo, hi,
        fz._ptr(u_new), fz._ptr(f), *shape, 0, fz._stream(dev))
    torch.cuda.synchronize()
    assert err == 0
    assert torch.isfinite(f[:, lo:hi]).all() and torch.equal(u_new, u_k)
    assert torch.isnan(f[:, :lo]).all() and torch.isnan(f[:, hi:]).all()


@pytest.mark.parametrize("sid", [1, 2], ids=["vanleer", "cds"])
def test_conv_diff_bdim_k_schemes(dev, sid):
    d = inputs((34, 17, 33), 18, dev)
    nu = torch.tensor(0.03, device=dev)
    got = fz.conv_diff_bdim_k(d["u"], d["u0"], nu, 0.3, 1.0, 0.5, sid)
    want = fz.conv_diff_bdim_plain(d["u"], d["u0"], nu, 0.3, 1.0, 0.5, st.SCHEMES[sid])
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 2e-5


# K7's colour lists: none (K6), the tiled cascade with 1 to 4 colours, also
# lists that do not alternate, and five colours (the per-colour route)
INCR_COLORS = [[], [1], [1, 0], [0, 1, 0], [1, 1], [0, 1, 0, 1], [0, 1, 0, 1, 0]]
INCR_IDS = ["K6", "1", "10", "010", "11", "0101", "01010"]


@pytest.mark.parametrize("shape", SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("colors", INCR_COLORS, ids=INCR_IDS)
@pytest.mark.parametrize("want_norms", [True, False], ids=["norms", "plain"])
def test_incr_gs_k(dev, shape, colors, want_norms):
    d = inputs(shape, 6, dev)
    lev = d["lev"]
    args = (d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD, colors, 0.9)
    st.reset_launch_counts()
    got = fz.incr_gs_k(*args, want_norms=want_norms)
    want = fz.incr_gs_plain(*args, want_norms=want_norms)
    assert st.launch_counts()["incr_gs_k"] == 1
    for a, b in zip(got[:2], want[:2]):
        assert rel_err(a, b) <= 1e-5
    if want_norms:
        for k in range(2):
            assert rel_err(got[2][k], want[2][k]) <= 1e-5
        # the norms reduce in a fixed order: equal from call to call
        assert torch.equal(fz.incr_gs_k(*args, want_norms=True)[2], got[2])


@pytest.mark.parametrize("shape", SHAPES + TILE_SHAPES + [(258, 258, 258),
                                                          (322, 130, 130)])
@pytest.mark.parametrize("colors", INCR_COLORS, ids=INCR_IDS)
def test_incr_gs_partials_match_the_grid(dev, shape, colors):
    """`wlt_incr_gs_partials` gives the block count of the grid the route
    launches: the entry writes exactly that many sums and maxima into a
    NaN-filled buffer that is longer than they need, and the norms come
    out right."""
    d = inputs(shape, 19, dev) if max(shape) < 100 else dict(
        x=torch.zeros(shape, device=dev), r=torch.ones(shape, device=dev),
        eps=torch.zeros(shape, device=dev),
        lev=ps.make_level(bc_vector(torch.ones((3,) + shape, device=dev),
                                    (0.0,) * 3)))
    lev, lib = d["lev"], fz._lib()
    nb = lib.wlt_incr_gs_partials(*shape, len(colors), 0)
    assert nb > 0
    partials = torch.full((2 * nb + 64,), float("nan"), device=dev)
    nv = torch.empty(2, device=dev)
    x_out, r_out = torch.empty_like(d["x"]), torch.empty_like(d["r"])
    e = torch.empty_like(d["x"])
    carr = (fz.ctypes.c_int * max(1, len(colors)))(*colors)
    err = lib.wlt_incr_gs(
        fz._ptr(d["x"]), fz._ptr(d["r"]), fz._ptr(d["eps"]), fz._ptr(lev.L),
        fz._ptr(lev.D), fz._ptr(lev.iD), fz._ptr(e), fz._ptr(x_out),
        fz._ptr(r_out), carr, len(colors), fz.ctypes.c_float(0.9),
        fz._ptr(partials), fz._ptr(nv), *shape, fz._stream(dev))
    torch.cuda.synchronize()
    assert err == 0
    assert torch.isfinite(partials[:2 * nb]).all()
    assert torch.isnan(partials[2 * nb:]).all()
    want = fz.incr_gs_plain(d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD,
                            colors, 0.9, want_norms=True)[2]
    for k in range(2):
        assert rel_err(nv[k], want[k]) <= 1e-5


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


@pytest.mark.parametrize("shape", PER_SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
@pytest.mark.parametrize("perdir", PERDIRS, ids=PERDIR_IDS)
def test_conv_diff_k_periodic(dev, shape, sid, perdir):
    d = inputs(shape, 9, dev)
    nu = torch.tensor(0.03, device=dev)
    got = st.conv_diff_k(d["u"], nu, sid, perdir)
    want = st.conv_diff_plain(d["u"], nu, st.SCHEMES[sid], perdir)
    assert rel_err(got, want) <= 2e-5


def even_periodic(shape, perdir):
    """An even interior extent in every periodic direction: what K13's
    cascade needs."""
    return all((shape[j] - 2) % 2 == 0 for j in perdir)


SWEEP_COLORS = [[0, 1, 0, 1], [1, 0], [1], [0, 0, 1, 1]]
SWEEP_PERDIRS = [(0, 1, 2), (2,), (), (0,), (1, 2), (2, 0)]


@pytest.mark.parametrize("shape", PER_SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("colors", SWEEP_COLORS,
                         ids=lambda c: "".join(map(str, c)))
@pytest.mark.parametrize("perdir", SWEEP_PERDIRS,
                         ids=["xyz", "z", "none", "x", "yz", "zx"])
@pytest.mark.parametrize("route", [None, st.PER_COLOUR, st.CASCADE],
                         ids=["auto", "per-colour", "cascade"])
def test_gauss_sweeps_k(dev, shape, colors, perdir, route):
    """Every cell, the ghosts included, on both routes (the cascade where
    the periodic extents are even; `test_gauss_sweeps_k_odd_extent` holds
    the others to the per-colour route)."""
    if route == st.CASCADE and not even_periodic(shape, perdir):
        route = st.PER_COLOUR
    d = inputs(shape, 10, dev)
    lev = d["lev"]
    L = bc_vector(lev.L, (0.0,) * 3, perdir=perdir)
    iD = ps.make_level(L).iD
    eps = wt.bc.per_bc(d["x"], perdir)
    st.reset_launch_counts()
    got = st._gauss_sweeps_launch(eps, d["r"], L, iD, colors, perdir, route)
    assert st.launch_counts()["gauss_sweeps_k"] == 1
    assert rel_err(got, st.gauss_sweeps_plain(eps, d["r"], L, iD, colors,
                                              perdir)) <= 1e-5
    assert torch.equal(eps, wt.bc.per_bc(d["x"], perdir))   # input untouched


@pytest.mark.parametrize("perdir", [(0, 1, 2), (0,), (2,), (0, 2)],
                         ids=["xyz", "x", "z", "xz"])
def test_gauss_sweeps_k_odd_extent(dev, perdir):
    """(21, 18, 19) has odd interior extents in x and z: a periodic odd
    direction takes the per-colour launches, and the cascade refuses it."""
    shape = (21, 18, 19)
    lib = st._lib()
    for n in range(1, 5):
        assert lib.wlt_gauss_sweeps_route(*shape, n, sum(1 << j for j in perdir)) \
            == st.PER_COLOUR
    d = inputs(shape, 11, dev)
    L = bc_vector(d["lev"].L, (0.0,) * 3, perdir=perdir)
    iD = ps.make_level(L).iD
    with pytest.raises(RuntimeError):
        st._gauss_sweeps_launch(d["x"], d["r"], L, iD, [0, 1], perdir,
                                st.CASCADE)


# the route each level of the 258^3 and drag stacks takes with 4 colours,
# from both routes' device times at these levels (PERF.md section 6): K15
# (float32) takes the cascade from 500,000 cells, K13 (x, y, z or z alone
# periodic, even extents) at every size
LEVEL_ROUTES = {
    (258, 258, 258): st.CASCADE, (130, 130, 130): st.CASCADE,
    (66, 66, 66): st.PER_COLOUR, (34, 34, 34): st.PER_COLOUR,
    (18, 18, 18): st.PER_COLOUR,
    (322, 130, 130): st.CASCADE, (162, 66, 66): st.CASCADE,
    (82, 34, 34): st.PER_COLOUR,
}


@pytest.mark.parametrize("shape", list(LEVEL_ROUTES),
                         ids=lambda s: "x".join(map(str, s)))
def test_smoother_routes_by_level(dev, shape):
    lib = st._lib()
    assert lib.wlt_gs_incr_route(*shape, 4, 0) == LEVEL_ROUTES[shape]
    for per in (0b111, 0b100):
        assert lib.wlt_gauss_sweeps_route(*shape, 4, per) == st.CASCADE
    # Jacobi, five colours and bf16 always take the per-colour launches
    for n, mp in ((0, 0), (5, 0), (4, 1)):
        assert lib.wlt_gs_incr_route(*shape, n, mp) == st.PER_COLOUR
    for n in (0, 5):
        assert lib.wlt_gauss_sweeps_route(*shape, n, 0b111) == st.PER_COLOUR


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


@pytest.mark.parametrize("engine", ["flat", "3d"])
def test_custom_scheme_runs_plain(dev, engine):
    """A user's scheme has no kernel: the conv–diff runs as plain PyTorch on
    the card (no K12 or K1 launch), and a lambda that wraps `quick` follows
    the `quick` run, whose conv–diff is the kernel, to float32 rounding."""
    a = sphere(16, dev, engine=engine)
    b = sphere(16, dev, engine=engine, scheme=lambda u, c, d: st.quick(u, c, d))
    for _ in range(2):
        a.sim_step(remeasure=False)
    st.reset_launch_counts()
    for _ in range(2):
        b.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["conv_diff_k"] == n["conv_diff_bdim_k"] == 0 and n["mult_k"] > 0
    su = a.flow.u.abs().max()
    assert ((a.flow.u - b.flow.u).abs().max() <= 1e-6 * su).item()
    assert torch.isfinite(b.flow.p).all()
