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
The copy probes: equal.  Forward-mode AD: K12's tangent kernel
(`conv_diff_jvp_k`) and the rules of K12 and K14 against the derivative of
their plain versions, 2e-5 of max|plain tangent|; every wrapper without a
rule raises on a tangent, before it launches.  The force's normals measured
on the body's shell alone against the dense measure: 1e-6 of max."""
import contextlib

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import waterlily_tpu_torch as wt
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import probe
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector, per_bc

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
    assert len(st.launch_counts()) == 17
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
        d["u"].data_ptr(), d["u0"].data_ptr(), nu.data_ptr(), 0.3, kb, scale, lo,
        hi, u_new.data_ptr(), f.data_ptr(), *shape, 0, st._stream(d["u"]))
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
@pytest.mark.parametrize("route", [None, st.PER_COLOUR],
                         ids=["auto", "per-colour"])
def test_incr_gs_k(dev, shape, colors, want_norms, route):
    d = inputs(shape, 6, dev)
    lev = d["lev"]
    args = (d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD, colors, 0.9)
    st.reset_launch_counts()
    got = fz._incr_gs_launch(*args, want_norms=want_norms, route=route)
    want = fz.incr_gs_plain(*args, want_norms=want_norms)
    assert st.launch_counts()["incr_gs_k"] == 1
    for a, b in zip(got[:2], want[:2]):
        assert rel_err(a, b) <= 1e-5
    if want_norms:
        for k in range(2):
            assert rel_err(got[2][k], want[2][k]) <= 1e-5
        # the norms reduce in a fixed order: equal from call to call
        assert torch.equal(fz._incr_gs_launch(*args, want_norms=True,
                                              route=route)[2], got[2])


@pytest.mark.parametrize("shape", SHAPES + TILE_SHAPES + [(258, 258, 258),
                                                          (322, 130, 130)])
@pytest.mark.parametrize("colors", INCR_COLORS, ids=INCR_IDS)
@pytest.mark.parametrize("mp", [False, True], ids=["f32", "bf16"])
def test_incr_gs_partials_match_the_grid(dev, shape, colors, mp):
    """`wlt_incr_gs_partials` gives the block count of the grid the route
    and form launch, on the route the shape gives and on each route forced:
    the entry writes exactly that many sums and maxima into a NaN-filled
    buffer that is longer than they need, and the norms come out right."""
    if mp and not colors:
        pytest.skip("the increment alone (K6) has no bf16 form")
    d = inputs(shape, 19, dev) if max(shape) < 100 else dict(
        x=torch.zeros(shape, device=dev), r=torch.ones(shape, device=dev),
        eps=torch.zeros(shape, device=dev),
        lev=ps.make_level(bc_vector(torch.ones((3,) + shape, device=dev),
                                    (0.0,) * 3)))
    lev, lib = ps.with_bf16(d["lev"]), fz._lib()
    coef = lev.bf if mp else (lev.L, lev.D, lev.iD)
    auto = lib.wlt_incr_gs_route(*shape, len(colors), int(mp))
    routes = {auto, st.PER_COLOUR} | ({st.CASCADE} if 1 <= len(colors) <= 4
                                      else set())
    want = fz.incr_gs_plain(d["x"], d["r"], d["eps"], *coef, colors, 0.9,
                            want_norms=True, mp=mp)[2]
    for route in sorted(routes):
        nb = lib.wlt_incr_gs_partials(*shape, len(colors), int(mp), route)
        assert nb > 0
        partials = torch.full((2 * nb + 64,), float("nan"), device=dev)
        nv = torch.empty(2, device=dev)
        x_out, r_out = torch.empty_like(d["x"]), torch.empty_like(d["r"])
        e = torch.empty_like(d["x"], dtype=coef[0].dtype)
        carr, ncol = st._colours("incr_gs_k", colors)
        err = (lib.wlt_incr_gs_mp if mp else lib.wlt_incr_gs)(
            *(t.data_ptr() for t in (d["x"], d["r"], d["eps"], *coef, e, x_out,
                                     r_out)),
            carr, ncol, 0.9, partials.data_ptr(), nv.data_ptr(), route, *shape,
            st._stream(d["x"]))
        torch.cuda.synchronize()
        assert err == 0
        assert torch.isfinite(partials[:2 * nb]).all()
        assert torch.isnan(partials[2 * nb:]).all()
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


@pytest.mark.parametrize("speed", [0.5, 4.0])
def test_moving_body_box_measure(dev, speed):
    """A translating sphere re-measured every step on the card: the flat
    engine's box measure gives the run of the dense measure (μ0, μ1, V bit
    for bit; u within 1e-6 of max, where a widened box moves K1's band),
    launches the static sphere's kernels, and at speed 4 widens its box."""
    def make():
        ctr = torch.tensor([12.0, 16.0, 16.0], device=dev)
        body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - 4.0,
                           lambda x, t: x - torch.stack([speed * t, 0 * t, 0 * t]))
        return wt.Simulation((48, 32, 32), (1.0, 0.0, 0.0), 4.0, nu=0.004,
                             body=body, device=dev)
    box, dense = make(), make()
    dense.band_measure = False
    assert box.engine == "flat"
    rounds = []
    st.reset_launch_counts()
    for _ in range(4):
        box.sim_step()
        rounds.append(box.measure_rounds)
    n = st.launch_counts()
    assert n["conv_diff_bdim_k"] == 8 and n["bdim_k"] == 8 and n["projbc_k"] == 8
    for _ in range(4):
        dense.sim_step()
    for name in ("mu0", "mu1", "V"):
        assert torch.equal(getattr(box.flow.state, name), getattr(dense.flow.state, name))
    assert rel_err(box.flow.u, dense.flow.u) <= 1e-6
    assert (max(rounds) > 1) == (speed == 4.0), rounds


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
# the bf16 K5 and K7 with 2 and 4 colours, from both routes' device times
# (PERF.md section 6): K5 takes the cascade at every size, K7 from 1,000,000
# cells
MP_LEVEL_ROUTES = dict.fromkeys(LEVEL_ROUTES, st.CASCADE)
MP_INCR_ROUTES = {s: st.CASCADE if np.prod(s) >= 1_000_000 else st.PER_COLOUR
                  for s in LEVEL_ROUTES}


@pytest.mark.parametrize("shape", list(LEVEL_ROUTES),
                         ids=lambda s: "x".join(map(str, s)))
def test_smoother_routes_by_level(dev, shape):
    lib = st._lib()
    assert lib.wlt_gs_incr_route(*shape, 4, 0) == LEVEL_ROUTES[shape]
    for per in (0b111, 0b100):
        assert lib.wlt_gauss_sweeps_route(*shape, 4, per) == st.CASCADE
    for n in (2, 4):
        assert lib.wlt_gs_incr_route(*shape, n, 1) == MP_LEVEL_ROUTES[shape]
        assert lib.wlt_incr_gs_route(*shape, n, 0) == st.CASCADE
        assert lib.wlt_incr_gs_route(*shape, n, 1) == MP_INCR_ROUTES[shape]
    # Jacobi and five colours take the per-colour launches (K6 for K7)
    for n, mp in ((0, 0), (5, 0), (0, 1), (5, 1)):
        assert lib.wlt_gs_incr_route(*shape, n, mp) == st.PER_COLOUR
        assert lib.wlt_incr_gs_route(*shape, n, mp) == st.PER_COLOUR
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


def mp_check(got, want, norms=False):
    """The bf16 smoothers' limits (`chip_smoke._MP_TOL`): x to 1e-5 of
    max|plain|, r to 2⁻⁸ (one flipped bf16 rounding), the norms to 1e-5;
    all met bit for bit."""
    assert rel_err(got[0], want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 2.0 ** -8
    if norms:
        for k in range(2):
            assert rel_err(got[2][k], want[2][k]) <= 1e-5


@pytest.mark.parametrize("shape", PER_SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("colors,route", GS_CASES,
                         ids=[f"{''.join(map(str, c)) or 'jacobi'}-{ROUTE_IDS[r]}"
                              for c, r in GS_CASES])
def test_gs_incr_mp_k(dev, shape, colors, route):
    """K4/K5 with ``mp``: Jacobi, 1-4 colours (also lists that do not
    alternate) and five, on the route the shape gives and on each route
    forced."""
    d = inputs(shape, 15, dev)
    lev = ps.with_bf16(d["lev"])
    args = (d["x"], d["r"], *lev.bf, colors, 0.9)
    st.reset_launch_counts()
    got = st._gs_incr_launch(*args, mp=True, route=route)
    mp_check(got, st.gs_incr_plain(*args, mp=True))
    n = st.launch_counts()
    assert n["gs_incr_mp_k"] == 1 and n["gs_incr_k"] == 0
    with pytest.raises(TypeError):
        st.gs_incr_k(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9, mp=True)


MP_INCR_CASES = [(c, route) for c in INCR_COLORS[1:]
                 for route in (None, st.PER_COLOUR, st.CASCADE)
                 if route != st.CASCADE or len(c) <= 4]


@pytest.mark.parametrize("shape", PER_SHAPES + TILE_SHAPES)
@pytest.mark.parametrize("colors,route", MP_INCR_CASES,
                         ids=[f"{''.join(map(str, c))}-{ROUTE_IDS[r]}"
                              for c, r in MP_INCR_CASES])
@pytest.mark.parametrize("want_norms", [False, True], ids=["plain", "norms"])
def test_incr_gs_mp_k(dev, shape, colors, route, want_norms):
    """K7 with ``mp``: 1-4 colours (also lists that do not alternate) and
    five, with and without norms, on the route the shape gives and on each
    route forced."""
    d = inputs(shape, 16, dev)
    lev = ps.with_bf16(d["lev"])
    args = (d["x"], d["r"], d["eps"], *lev.bf, colors, 0.9, want_norms)
    st.reset_launch_counts()
    got = fz._incr_gs_launch(*args, mp=True, route=route)
    mp_check(got, fz.incr_gs_plain(*args, mp=True), want_norms)
    n = st.launch_counts()
    assert n["incr_gs_mp_k"] == 1 and n["incr_gs_k"] == 0
    with pytest.raises(ValueError):
        fz.incr_gs_k(d["x"], d["r"], d["eps"], *lev.bf, [], 0.9, mp=True)


def level_inputs(shape, seed, dev):
    """x, r, eps (zero ghosts) and a level with its bf16 copies, made on the
    card (a level-sized field from numpy would take seconds)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = lambda *s: torch.randn(s + shape, generator=gen, device=dev)
    inner = (slice(1, -1),) * 3
    r, eps = torch.zeros(shape, device=dev), torch.zeros(shape, device=dev)
    r[inner], eps[inner] = g()[inner], 0.3 * g()[inner]
    L = bc_vector(0.2 + torch.rand((3,) + shape, generator=gen, device=dev),
                  (0.0,) * 3)
    return g(), r, eps, ps.with_bf16(ps.make_level(L))


# the levels the bf16 smoothers run on (the 258^3 sphere's 258^3, 130^3 and
# 66^3, the drag sphere's 322 x 130 x 130 and 162 x 66 x 66) and ragged
# tiles at the size of a level (z not a multiple of the tile, nz odd)
MP_LEVELS = [(258, 258, 258), (130, 130, 130), (66, 66, 66), (322, 130, 130),
             (162, 66, 66), (67, 45, 71)]


@pytest.mark.parametrize("shape", MP_LEVELS, ids=lambda s: "x".join(map(str, s)))
def test_mp_smoothers_at_level_sizes(dev, shape):
    """Both routes of the bf16 K5 and K7 (with norms) with 2 and 4 colours
    at the sizes the solvers run them."""
    x, r, eps, lev = level_inputs(shape, 21, dev)
    for colors in ([1, 0], [1, 0, 1, 0], [0, 1, 0]):
        want = st.gs_incr_plain(x, r, *lev.bf, colors, 0.9, mp=True)
        for route in (st.PER_COLOUR, st.CASCADE):
            mp_check(st._gs_incr_launch(x, r, *lev.bf, colors, 0.9, True, route),
                     want)
        args = (x, r, eps, *lev.bf, colors, 0.9, True)
        want = fz.incr_gs_plain(*args, mp=True)
        for route in (st.PER_COLOUR, st.CASCADE):
            mp_check(fz._incr_gs_launch(*args, mp=True, route=route), want, True)


# the solver's fine level, the tiny chain's field, n % 4 = 1, 2 and n < 4
@pytest.mark.parametrize("shape", [(18, 18, 18), (7, 5, 3), (8, 8, 8),
                                   (258, 258, 258), (2, 3, 5), (1, 1, 3),
                                   (1, 1, 1)])
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


def test_copy_scale_loop(dev):
    """The C loop of the launch floor: ``count`` copies back and forth, the
    last one into ``b`` for an odd count."""
    a0 = torch.rand((8, 8, 8), device=dev)
    a, b = a0.clone(), torch.empty_like(a0)
    lib = st._lib()
    assert lib.wlt_copy_scale_loop(a.data_ptr(), b.data_ptr(), a.numel(), 256,
                                   3, st._stream(a)) == 0
    torch.cuda.synchronize()
    want = a0
    for _ in range(3):
        want = probe.copy_scale_plain([want])[0]
    assert torch.equal(b, want)


def wrapper_thunks(dev, s=None):
    """Every wrapper, with its modes and both routes of the smoothers, as a
    thunk on an 18^3 level that returns a tuple of tensors.  ``s``: a 0-d
    tensor every input field is multiplied by (under forward-mode AD, so
    that each carries a tangent)."""
    d = inputs((18, 18, 18), 23, dev)
    if s is not None:
        d = {k: v * s if isinstance(v, torch.Tensor) else v for k, v in d.items()}
        d["lev"] = ps.make_level(d["lev"].L * s)
    lev = ps.with_bf16(d["lev"])
    u, x, r, eps, L, D, iD = d["u"], d["x"], d["r"], d["eps"], lev.L, lev.D, lev.iD
    mom = [d[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")]
    nu = torch.tensor(0.03, device=dev)
    Lp = bc_vector(L, (0.0,) * 3, perdir=(0, 1, 2))
    iDp = ps.make_level(Lp).iD
    eps_p = per_bc(eps, (0, 1, 2))
    six = [x.clone() for _ in range(6)]
    gs = (x, r, L, D, iD)
    PC, CA = st.PER_COLOUR, st.CASCADE
    return {
        "conv_diff_k": lambda: (st.conv_diff_k(u, nu, 0),),
        "conv_diff_k per=012": lambda: (st.conv_diff_k(u, nu, 1, (0, 1, 2)),),
        # f is defined on its rows (6, 12) alone
        "conv_diff_bdim_k": lambda: (lambda un, f: (un, f[:, 6:12]))(
            *fz.conv_diff_bdim_k(u, d["u0"], nu, 0.3, 1.0, 0.5, 0, (6, 12))),
        "bdim_k": lambda: (st.bdim_k(*mom, 0.3),),
        "bdim_band_k": lambda: (st.bdim_band_k(*mom, 0.3, (6, 12), (2,)),),
        "mult_k": lambda: (st.mult_k(x, L, D),),
        "gs_incr_k jacobi": lambda: st.gs_incr_k(*gs, [], 0.9),
        "gs_incr_k 0101 per-colour": lambda: st._gs_incr_launch(
            *gs, [0, 1, 0, 1], 0.9, False, PC),
        "gs_incr_k 10 cascade": lambda: st._gs_incr_launch(*gs, [1, 0], 0.9,
                                                           False, CA),
        "gs_incr_mp_k jacobi": lambda: st.gs_incr_k(x, r, *lev.bf, [], 0.9, True),
        "gs_incr_mp_k 0101 per-colour": lambda: st._gs_incr_launch(
            x, r, *lev.bf, [0, 1, 0, 1], 0.9, True, PC),
        "gs_incr_mp_k 10 cascade": lambda: st._gs_incr_launch(
            x, r, *lev.bf, [1, 0], 0.9, True, CA),
        "incr_gs_k K6 norms": lambda: fz.incr_gs_k(x, r, eps, L, D, iD, [], 0.9,
                                                   True),
        "incr_gs_k 0101 norms cascade": lambda: fz._incr_gs_launch(
            x, r, eps, L, D, iD, [0, 1, 0, 1], 0.9, True, route=CA),
        "incr_gs_k 010 per-colour": lambda: fz._incr_gs_launch(
            x, r, eps, L, D, iD, [0, 1, 0], 0.9, route=PC),
        "incr_gs_mp_k 0101 norms per-colour": lambda: fz._incr_gs_launch(
            x, r, eps, *lev.bf, [0, 1, 0, 1], 0.9, True, True, PC),
        "incr_gs_mp_k 10 cascade": lambda: fz._incr_gs_launch(
            x, r, eps, *lev.bf, [1, 0], 0.9, False, True, CA),
        "gauss_sweeps_k xyz cascade": lambda: (st._gauss_sweeps_launch(
            eps_p, r, Lp, iDp, [0, 1, 0, 1], (0, 1, 2), CA),),
        "gauss_sweeps_k z per-colour": lambda: (st._gauss_sweeps_launch(
            eps_p, r, Lp, iDp, [1, 0], (2,), PC),),
        "bc_div_k": lambda: fz.bc_div_k(u, UBC),
        "projbc_k cfl exit": lambda: fz.projbc_k(u, x, L, UBC, True, True),
        "bc_k": lambda: (fz.bc_k(u, UBC),),
        "div_k": lambda: (fz.div_k(u),),
        "copy_scale_k": lambda: tuple(probe.copy_scale_k([x], 1024)),
        "copy_scale6_k": lambda: tuple(probe.copy_scale_k(six)),
        "conv_diff_jvp_k": lambda: (st.conv_diff_jvp_k(u, d["u0"], nu, nu, 0),),
    }


WRAPPER_CASES = ["conv_diff_k", "conv_diff_k per=012", "conv_diff_bdim_k",
                 "bdim_k", "bdim_band_k", "mult_k", "gs_incr_k jacobi",
                 "gs_incr_k 0101 per-colour", "gs_incr_k 10 cascade",
                 "gs_incr_mp_k jacobi", "gs_incr_mp_k 0101 per-colour",
                 "gs_incr_mp_k 10 cascade", "incr_gs_k K6 norms",
                 "incr_gs_k 0101 norms cascade", "incr_gs_k 010 per-colour",
                 "incr_gs_mp_k 0101 norms per-colour", "incr_gs_mp_k 10 cascade",
                 "gauss_sweeps_k xyz cascade", "gauss_sweeps_k z per-colour",
                 "bc_div_k", "projbc_k cfl exit", "bc_k", "div_k", "copy_scale_k",
                 "copy_scale6_k", "conv_diff_jvp_k"]


@pytest.mark.parametrize("case", WRAPPER_CASES)
def test_wrapper_follows_the_current_stream(dev, case):
    """Each wrapper launches on PyTorch's current stream: called inside
    ``torch.cuda.stream(s)`` on a side stream, and captured inside
    ``torch.cuda.graph(g)`` (whose capture stream a launch elsewhere would
    break) and replayed, it gives the eager result bit for bit."""
    fn = wrapper_thunks(dev)[case]
    want = fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = fn()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cap = fn()
    for t in cap:
        t.fill_(float("nan"))
    g.replay()
    torch.cuda.synchronize()
    assert len(cap) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(cap, want))


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


@pytest.mark.parametrize("size", [32, 128])
def test_mp_run_equals_the_run_with_only_its_smoothers_plain(dev, size):
    """`plain_ops(only=...)` routes the bf16 smoothers alone to their plain
    versions: every float32 kernel still launches, and the run equals the
    kernels' run bit for bit, since the bf16 kernels round where their plain
    versions round.  At 32³ the bf16 K7 launches per colour; at 128³ it is
    the cascade (130³ fine level) and so is the bf16 K5 (on 66³)."""
    mp = ("gs_incr_mp_k", "incr_gs_mp_k")
    a, b = (sphere(size, dev, smooth_it=2, mp_smooth=True) for _ in range(2))
    st.reset_launch_counts()
    for _ in range(3):
        a.sim_step(remeasure=False)
    n = st.launch_counts()
    assert n["incr_gs_mp_k"] > 0 and n["gs_incr_mp_k"] > 0
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


# ---------------------------------------------------------------- forward-mode AD
def ad_fields(shape, seed, dev):
    """u and its tangent du, float32 on the card, made there."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((3,) + shape, generator=gen, device=dev),
            torch.randn((3,) + shape, generator=gen, device=dev))


def plain_jvp_of_conv_diff(u, du, nu, dnu, scheme, perdir):
    return torch.func.jvp(lambda a, b: st.conv_diff_plain(a, b, scheme, perdir),
                          (u, nu), (du, dnu))[1]


# every periodic mask K12 takes, the walled one first
ALL_PERDIRS = [()] + PERDIRS
ALL_PERDIR_IDS = ["walls"] + PERDIR_IDS


@pytest.mark.parametrize("shape", PER_SHAPES + TILE_SHAPES
                         + [(258, 258, 258), (322, 130, 130)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
@pytest.mark.parametrize("perdir", ALL_PERDIRS, ids=ALL_PERDIR_IDS)
def test_conv_diff_jvp_k(dev, shape, sid, perdir):
    """K12's tangent kernel against `torch.func.jvp` of `conv_diff_plain`,
    tangents in u and nu, at the test shapes, the tile shapes (ragged tiles,
    fields below one tile, short x chunks), the 258³ fine level and the drag
    grid."""
    u, du = ad_fields(shape, 31 + sid, dev)
    nu, dnu = torch.tensor(0.03, device=dev), torch.tensor(-0.4, device=dev)
    st.reset_launch_counts()
    got = st.conv_diff_jvp_k(u, du, nu, dnu, sid, perdir)
    assert st.launch_counts()["conv_diff_jvp_k"] == 1
    want = plain_jvp_of_conv_diff(u, du, nu, dnu, st.SCHEMES[sid], perdir)
    assert rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
def test_conv_diff_jvp_k_uniform_stream(dev, sid):
    """A uniform stream with a perturbed tangent: every median3 is a tie
    (½ split) and every cross-stream upwind velocity is 0."""
    shape = (34, 18, 18)
    u = torch.zeros((3,) + shape, device=dev)
    u[0] = 1.0
    _, du = ad_fields(shape, 5, dev)
    nu, dnu = torch.tensor(0.01, device=dev), torch.tensor(0.2, device=dev)
    got = st.conv_diff_jvp_k(u, du, nu, dnu, sid)
    assert rel_err(got, plain_jvp_of_conv_diff(u, du, nu, dnu, st.SCHEMES[sid], ())) <= 2e-5


@pytest.mark.parametrize("mode", ["func", "forward_ad"])
@pytest.mark.parametrize("perdir", [(), (0, 1, 2)], ids=["walls", "xyz"])
def test_conv_diff_k_rule(dev, mode, perdir):
    """`conv_diff_k` under AD: K12 for the primal, `conv_diff_jvp_k` for the
    tangent (one launch each), against the plain version's derivative."""
    shape = (26, 18, 10)
    u, du = ad_fields(shape, 41, dev)
    nu, dnu = torch.tensor(0.03, device=dev), torch.tensor(0.5, device=dev)
    st.reset_launch_counts()
    if mode == "func":
        out, tan = torch.func.jvp(lambda a, b: st.conv_diff_k(a, b, 0, perdir),
                                  (u, nu), (du, dnu))
    else:
        with fwAD.dual_level():
            res = st.conv_diff_k(fwAD.make_dual(u, du), fwAD.make_dual(nu, dnu), 0, perdir)
            out, tan = fwAD.unpack_dual(res)
    n = st.launch_counts()
    assert n["conv_diff_k"] == 1 and n["conv_diff_jvp_k"] == 1
    want = torch.func.jvp(lambda a, b: st.conv_diff_plain(a, b, st.quick, perdir),
                          (u, nu), (du, dnu))
    assert rel_err(out, want[0]) <= 2e-5 and rel_err(tan, want[1]) <= 2e-5


def bdim_ad_inputs(shape, dev):
    d = inputs(shape, 43, dev)
    e = inputs(shape, 44, dev)
    prim = [d[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")] + [
        torch.tensor(0.3, device=dev)]
    tans = [e[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")] + [
        torch.tensor(0.7, device=dev)]
    return prim, tans


@pytest.mark.parametrize("shape", SHAPES + [(258, 258, 258)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("moments", [True, False], ids=["mu-tangent", "fields-only"])
def test_bdim_k_rule(dev, shape, moments):
    """K14's rule (K14 on the tangents, and again for the moments' tangents)
    against `torch.func.jvp` of `bdim_plain`, dt's tangent included."""
    prim, tans = bdim_ad_inputs(shape, dev)
    if not moments:
        tans[4], tans[5] = torch.zeros_like(tans[4]), torch.zeros_like(tans[5])
    st.reset_launch_counts()
    out, tan = torch.func.jvp(st.bdim_k, tuple(prim), tuple(tans))
    assert st.launch_counts()["bdim_k"] == 3
    want = torch.func.jvp(st.bdim_plain, tuple(prim), tuple(tans))
    assert rel_err(out, want[0]) <= 2e-5 and rel_err(tan, want[1]) <= 2e-5
    with fwAD.dual_level():
        res = st.bdim_k(*(fwAD.make_dual(p, t) for p, t in zip(prim, tans)))
        assert rel_err(fwAD.unpack_dual(res).tangent, want[1]) <= 2e-5


NO_RULE = [c for c in WRAPPER_CASES if c.split()[0] not in ("conv_diff_k", "bdim_k")]


@pytest.mark.parametrize("mode", ["func", "forward_ad"])
@pytest.mark.parametrize("case", NO_RULE)
def test_wrapper_without_rule_raises_on_a_tangent(dev, case, mode):
    """Every wrapper without a forward-mode rule refuses a tangent with the
    [ad] message, before it launches (a launch would drop the tangent)."""
    one = torch.tensor(1.0, device=dev)
    if mode == "func":
        thunk = lambda s: wrapper_thunks(dev, s)[case]()[0]
        st.reset_launch_counts()
        with pytest.raises(RuntimeError, match=r"\[ad\]"):
            torch.func.jvp(thunk, (one,), (one,))
    else:
        with fwAD.dual_level():
            thunks = wrapper_thunks(dev, fwAD.make_dual(one, one))
            st.reset_launch_counts()
            with pytest.raises(RuntimeError, match=r"\[ad\]"):
                thunks[case]()
    assert sum(st.launch_counts().values()) == 0


def test_step_jvp_runs_on_the_kernels(dev):
    """d(u, p)/dν through `mom_step_impl` on the 3d engine in float32: the
    kernels' run (K12 and its tangent, K14, K15, K16 launched, none
    plain) against `plain_ops()`, 1e-3 of the tangents' max; and
    `torch.func.jacfwd` of the same step on the kernels (every rule and
    tangent once per batch entry, `stencil3d._loop_vmap`) against the
    kernels' jvp, 1e-6 of the tangents' max, with equal iteration counts
    (a batched run may sum in another order, so not bit for bit)."""
    from waterlily_tpu_torch.ops import multigrid as mg

    sim = sphere(32, dev, engine="3d")
    cfg, st0 = sim.flow.cfg, sim.flow.state
    nu0, one = st0.nu.clone(), torch.ones((), device=dev)

    def step(nu):
        import dataclasses
        from waterlily_tpu_torch.models import flow as fl
        s = dataclasses.replace(st0, nu=nu)
        s, dt, _, _ = fl.mom_step_impl(cfg, s, sim.levels, sim.masks,
                                       torch.tensor(0.25, device=dev),
                                       torch.tensor(0.0, device=dev))
        return s.u, s.p, dt

    st.reset_launch_counts()
    with mg.iteration_log() as jlog:
        got = torch.func.jvp(step, (nu0,), (one,))
    n = st.launch_counts()
    for k in ("conv_diff_k", "conv_diff_jvp_k", "bdim_k", "gs_incr_k", "mult_k"):
        assert n[k] > 0, (k, n)
    with st.plain_ops():
        want = torch.func.jvp(step, (nu0,), (one,))
    assert sum(st.launch_counts().values()) == sum(n.values())
    for a, b in zip(got[1][:2], want[1][:2]):
        assert rel_err(a, b) <= 1e-3
    st.reset_launch_counts()
    with mg.iteration_log() as flog:
        jac = torch.func.jacfwd(step)(nu0)
    m = st.launch_counts()
    for k in ("conv_diff_k", "conv_diff_jvp_k", "bdim_k", "gs_incr_k", "mult_k"):
        assert m[k] > 0, (k, m)
    assert list(flog) == list(jlog)
    for a, b in zip(jac, got[1]):
        assert rel_err(a, b) <= 1e-6


# ---------------------------------------------------------- domain decomposition
def dist_sphere(n, dev):
    """`chip_smoke.sphere_sim` at n³ in float32 on the flat engine."""
    radius = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], dtype=torch.float32, device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - radius)
    return wt.Simulation((n, n, n), (1.0, 0.0, 0.0), radius, nu=radius / 1e3,
                         body=body, dtype=torch.float32, device=dev, engine="flat")


class _IncrGsTally:
    """Count K6 (``incr_gs_k`` with no colours) and K7 calls apart, from
    every shard (one runs at a time)."""

    def __init__(self):
        import collections
        self.counts = collections.Counter()

    def __enter__(self):
        self._launch = fz._incr_gs_launch

        def tallied(x, r, eps, L, D, iD, colors, omega, want_norms=False, mp=False,
                    route=None):
            self.counts["K7" if len(colors) else "K6"] += 1
            return self._launch(x, r, eps, L, D, iD, colors, omega, want_norms, mp,
                                route)
        fz._incr_gs_launch = tallied
        return self.counts

    def __exit__(self, *exc):
        fz._incr_gs_launch = self._launch


@pytest.mark.parametrize("n", [32, 64], ids=["34^3", "66^3"])
def test_dist_flat_step_kernels_vs_plain(dev, n):
    """A step of the x-decomposed flat engine on two shards of the card:
    the kernels (K14, K11, K16, K6 on every shard) against the same step
    under `plain_ops()`, to the phase-5 limits of `chip_smoke.py`; K14 and
    K11 launch once per half step and shard, K1, K7, K8, K9, K12 and K15
    never, and the plain step launches nothing."""
    import copy

    base = dist_sphere(n, dev)
    mesh = wt.make_mesh((2,), [dev] * 2)
    k = wt.DistSimulation(copy.deepcopy(base), mesh, engine="flat", timeout=60)
    p = wt.DistSimulation(base, mesh, engine="flat", timeout=60)
    st.reset_launch_counts()
    with _IncrGsTally() as tally:
        k.step_once(remeasure=False)
    counts = st.launch_counts()
    with st.plain_ops():
        p.step_once(remeasure=False)
    assert st.launch_counts() == counts
    assert counts["bdim_k"] == 4 and counts["div_k"] == 4
    assert counts["mult_k"] > 0 and tally["K6"] == counts["incr_gs_k"] > 0
    assert tally["K7"] == 0
    for name in ("conv_diff_bdim_k", "bc_div_k", "projbc_k", "conv_diff_k", "gs_incr_k",
                 "bdim_band_k", "bc_k", "gauss_sweeps_k"):
        assert counts[name] == 0, name
    assert rel_err(torch.as_tensor(k.u), torch.as_tensor(p.u)) <= 1e-4
    assert rel_err(torch.as_tensor(k.p), torch.as_tensor(p.p)) <= 1e-3
    assert all(abs(a - b) <= 1 for a, b in zip(k.pois_n, p.pois_n))
    k.close()
    p.close()


def test_dist_shards_on_their_own_streams(dev):
    """Two shards each on a stream of its own exchange through events: two
    steps equal the same steps on the current stream bit for bit."""
    import copy

    base = dist_sphere(32, dev)
    mesh = wt.make_mesh((2,), [dev] * 2)
    a = wt.DistSimulation(copy.deepcopy(base), mesh, engine="flat", timeout=60)
    b = wt.DistSimulation(base, mesh, engine="flat", timeout=60)
    b.pool.streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for _ in range(2):
        a.step_once(remeasure=False)
        b.step_once(remeasure=False)
    assert np.array_equal(a.u, b.u) and np.array_equal(a.p, b.p)
    assert a.pois_n == b.pois_n and a.sim.flow.dt == b.sim.flow.dt
    a.close()
    b.close()


def test_dist_pcg_direction_k16_vs_plain(dev):
    """K16 on a CG search direction of an inner shard of (4,) on the card
    (66×258×258, both x ghosts from the ring by `sync_scalar`) against
    `mult_plain` at 1e-5; then two CG iterations of `poisson.pcg` under
    the shard ctx on every shard, which launch K16 once per iteration and
    shard (the launch counts are the process's: summed over the shards),
    against the same iterations under `plain_ops()`."""
    from waterlily_tpu_torch.ops import dist as dd

    k, n = 4, 256
    shape = (n // k + 2, n + 2, n + 2)
    comm = dd.Communicator((k,), wt.make_mesh((k,), [dev] * k).devices, 60)
    pool = dd.ShardPool(comm)
    data = [inputs(shape, 40 + r, dev) for r in range(k)]

    def one(rank):
        ctx = dd.make_ctx(("x", None, None), (k, 1, 1), shape, comm, rank)
        d = data[rank]
        lev = d["lev"]
        epsb = dd.sync_scalar(d["eps"], ctx)
        got, want = st.mult_k(epsb, lev.L, lev.D), st.mult_plain(epsb, lev.L, lev.D)
        xk, rk = ps.pcg(lev, d["x"], d["r"], it=2, ctx=ctx)
        with st.plain_ops():
            xp, rp = ps.pcg(lev, d["x"], d["r"], it=2, ctx=ctx)
        return rel_err(got, want), rel_err(xk, xp), rel_err(rk, rp)

    st.reset_launch_counts()
    res = pool.run(one)
    pool.close()
    counts = st.launch_counts()
    assert res[1][0] <= 1e-5
    # one direct launch and one per CG iteration on every shard, no other
    assert counts["mult_k"] == k * (1 + 2) and sum(counts.values()) == counts["mult_k"]
    assert all(r[1] <= 1e-5 and r[2] <= 1e-4 for r in res), res


def flat_sphere(n, dev):
    """The flat engine's n³ static sphere (R = n/8, Re_D 2,000), stepped
    once so that every shape it launches on is warm."""
    R = n // 8
    ctr = torch.tensor([n / 3, n / 2, n / 2], device=dev)
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - R)
    sim = wt.Simulation((n, n, n), (1.0, 0.0, 0.0), R, nu=R / 1e3, body=body,
                        engine="flat", device=dev)
    sim.step_once(remeasure=False)
    torch.cuda.synchronize()
    return sim


def step_cells(sim, iters):
    """The padded cells each kernel key of `stencil3d._launch` counts over a
    flat step of a static body, from the level stack and the iterations:
    K1, K14 on the body's slab, K8, K9 twice; per solve one K16 (the entry
    residual); per iteration the fused fine tail (K7), on every level but
    the coarsest the Jacobi pre-smooth (K15, no colours) and on every level
    below the fine one its coarse smooth (K15, 4 colours; the coarsest:
    its dense solve's increment, K16) and, but the coarsest, K6."""
    import collections
    import math

    cfg, cells = sim.flow.cfg, [p.D.numel() for p in sim.levels]
    full, (lo, hi), n = math.prod(cfg.shape), cfg.band_x, sum(iters)
    want = collections.Counter({
        "cells.conv_diff_bdim_k": 2 * full, "cells.bc_div_k": 2 * full,
        "cells.projbc_k": 2 * full,
        "cells.bdim_k": 2 * (hi - lo + 2) * cfg.shape[1] * cfg.shape[2],
        "cells.mult_k": len(iters) * cells[0], "cells.incr_gs_k.cascade": n * cells[0]})
    for l, p in enumerate(sim.levels[1:], 1):
        want["cells.gs_incr_k.jacobi"] += n * cells[l - 1]
        if p.Ainv is not None:
            want["cells.mult_k"] += n * cells[l]
            continue
        want["cells.incr_gs_k.increment"] += n * cells[l]
        route = st._rule("wlt_gs_incr_route", *p.D.shape, cfg.smooth_it, 0)
        want[f"cells.gs_incr_k.{('per_colour', 'cascade')[route]}"] += n * cells[l]
    return dict(want)


def test_cells_counter_of_a_flat_sphere_step(dev):
    """While recording, each launch adds its padded cells under its wrapper
    and, for the smoothers, its route: a 64³ sphere step counts each
    level's cells times its calls per key, and `launch_counts()` counts the
    same calls as with recording off."""
    from waterlily_tpu_torch import tracing

    sim = flat_sphere(64, dev)
    counts = []
    for on in (False, True):
        st.reset_launch_counts()
        k0 = len(sim.pois_n)
        with tracing.tracing() if on else contextlib.nullcontext():
            sim.step_once(remeasure=False)
        counts.append((st.launch_counts(), sim.pois_n[k0:]))
    (off, iters_off), (on, iters) = counts
    if iters == iters_off:
        assert on == off
    got = tracing.session().counters
    assert got == step_cells(sim, iters)
    assert {k.split(".")[1] for k in got} == {k for k, v in on.items() if v}


def test_kernels_start_after_the_span_that_launched_them(dev):
    """In a profiled flat step every kernel launched inside a ``wlt.*``
    span starts on the device after that span started on the host: the
    spans and the device intervals share the profiler's clock."""
    from torch.profiler import ProfilerActivity, profile

    from waterlily_tpu_torch import tracing

    sim = flat_sphere(64, dev)
    st.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.step_once(remeasure=False)
        torch.cuda.synchronize()
    s = tracing.session()
    (step,) = s.named("wlt.step")
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.profiler.kineto_results.events())
    assert not [e for e in evs if e.name().startswith("wlt.")]
    launches = {e.correlation_id(): e for e in evs
                if e.device_type() != cuda and "LaunchKernel" in e.name()}
    assert launches and all(step.start <= e.start_ns() <= step.end
                            for e in launches.values())
    spans = [x for x in s.spans if x.end is not None]
    checked = 0
    for k in evs:
        h = launches.get(k.correlation_id()) if k.device_type() == cuda else None
        if h is None:
            continue
        inner = max((x for x in spans if x.start <= h.start_ns() <= x.end),
                    key=lambda x: x.start)
        assert k.start_ns() >= inner.start, (k.name(), inner.name)
        checked += 1
    # every call of a hand kernel's wrapper, and torch's kernels besides
    assert checked > sum(st.launch_counts().values()) > 0


class _Dense(wt.Body):
    """A port body behind a type of its own: `metrics.nds_field` measures it
    at every cell, as it measured every body before the shell."""

    def __init__(self, body):
        self.body = body

    def measure_at(self, x, t, fastd2=float("inf")):
        return self.body.measure_at(x, t, fastd2)


def test_force_on_the_bodys_shell(dev):
    """The 128³ sphere's normals measured on the body's shell alone
    (`nds_field`'s path for the port's bodies) against the dense measure of
    the same body: the field and `total_force` within 1e-6 of max, float32,
    at under 1 % of the cells."""
    from waterlily_tpu_torch import tracing

    sim = flat_sphere(128, dev)
    body, shape = sim.body, tuple(sim.flow.p.shape)
    with tracing.tracing():
        got = wt.metrics.nds_field(body, shape, sim.time, torch.float32, dev)
        counts = dict(tracing.session().counters)
    want = wt.metrics.nds_field(_Dense(body), shape, sim.time, torch.float32, dev)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert rel_err(got, want) <= 1e-6
    force = wt.metrics.total_force(sim)
    sim.body = _Dense(body)
    assert rel_err(force, wt.metrics.total_force(sim)) <= 1e-6
    assert counts["nds.points"] == 128 ** 3
    assert 0 < counts["nds.measured"] < 128 ** 3 // 100
