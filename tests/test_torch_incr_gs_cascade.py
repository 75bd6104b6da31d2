"""The schedule of the tiled red-black cascade (`csrc/rb_cascade.cuh`),
emulated in plain PyTorch on the CPU and held bit for bit against the plain
versions of its three forms: K7 (`incr_gs_tile_kernel`,
`fused3d.incr_gs_plain`), K15 (`gs_incr_tile_kernel`,
`stencil3d.gs_incr_plain`) and K13 (`gauss_sweeps_tile_kernel`,
`stencil3d.gauss_sweeps_plain`), and the bf16 forms of K7 and K15 (K5 with
``mp``) against ``incr_gs_plain(mp=True)`` and ``gs_incr_plain(mp=True)``,
with one case each of K15, K13 and the two bf16 forms against the Pallas
kernels in interpret mode.

K7 computes, on interior cells, ``r₁ = r − ω·A·eps``, ``e₀ = r₁·iD``, one
red-black sweep of ``e`` per colour, ``x′ = x + ω(eps + e)`` and
``r′ = r₁ − ω·A·e``; ghosts keep x and r.  K15 starts from ``e₀ = r·iD``
and ends with ``x′ = x + ω·e``, ``r′ = r − ω·A·e``; K13 starts from the
given eps (every cell) and returns the swept ``e``.  The kernel does it in
one pass: tiles of (TY × TZ) interior (y, z) cells (the first and last tiles
of a row of tiles also own the ghost cells beside them) march over chunks
of xc interior x rows (the first and last chunks also own the ghost
planes).  A block's region is its tile grown by ``H = it + 1`` cells; each
thread owns a pair of z-adjacent cells of the region.  At march step t a
thread runs, in this order:

* stage k = 1 … it: the sweep of ``colors[k−1]`` on plane ``t − k``, in place;
* the tail: x′, r′ and the norms (K13: eps′) on plane ``t − it − 1`` at the
  cells its block owns;
* stage 0: e₀ and the r ring (K7: r₁) on plane ``t + 1``, and its cells' L
  and iD into rings;

then one barrier.  e, L0, L1 and L2 live in rings of ``it + 3`` planes, r₁
and iD in rings of ``it + 2``, K7's eps in one of 4 (filled three planes
ahead of stage 0); the sweeps read only the rings.  A stage reads its own
cells' x-neighbours (written by the same thread earlier) and the in-plane
neighbours on its plane (e, L1(+y), L2(+z)) as they were at the last barrier
(written by other threads).  The emulation reads them so: in-plane from a
snapshot taken at the step's start, x-neighbours and r₁ from the live rings,
and it checks that no slot a stage writes in a step is one another stage
reads across threads in that step.

Stage k runs on its dependency cone in x (``[xa − H + k, xb + H − k)``) and
in y (the tile grown by ``H − k`` rows), and on every column of the region.
A value outside the cone is wrong or stale, and must never reach a value
inside it: the rings start as NaN and the region's border ring stays NaN
(the kernel's is zero), so a read outside the cone poisons the result.
K13's periodic directions read every cell at its source, its image in the
interior; stages 1 … it−1 sweep the cells whose source is interior, the
last stage the real interior only, so that a periodic ghost of the output
keeps its partner's value from before the last colour.  Small tiles and
chunks (4 × 8 cells, 5 rows, and smaller) exercise ragged tiles, tiles wider
than the field, ragged chunks, lead-ins that leave the field and, periodic,
lead-ins and halos that wrap."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waterlily_tpu.ops import bc as bc_j
from waterlily_tpu.ops import pallas3d as pl3
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import per_bc

SHAPES = [(12, 10, 7), (18, 18, 18), (19, 13, 22)]
COLORS = [[1], [1, 0], [0, 1, 0], [0, 1, 0, 1], [1, 1], [0, 0, 1, 1]]
OMEGA = 0.9


def _tiles(n, t):
    """Tiles of t interior cells over n: each tile's first interior cell and
    the range of cells it owns (ghosts to the first and last tile)."""
    k = max(1, math.ceil((n - 2) / t))
    lo = 1 + t * torch.arange(k)
    a = torch.where(torch.arange(k) == 0, 0, lo)
    b = torch.where(torch.arange(k) == k - 1, n, lo + t)
    return lo, a, b


def cascade(form, x, r, eps, L, D, iD, colors, omega, ty=4, tz=8, xc=5,
            perdir=()):
    """One form of the tiled cascade by its schedule: ``"incr_gs"`` (K7 with
    norms), ``"gs_incr"`` (K15) or ``"sweeps"`` (K13, periodic in the
    directions of ``perdir``).  Returns ``(x′, r′, [Σ|r′|, max|r′|], number
    of blocks)``; K13 returns eps′ as x′ and leaves r′ and the norms out.

    bf16 ``L``, ``D``, ``iD`` (float32 x, r, eps) give the MP forms: the e,
    L and iD rings hold bf16, the r ring (K7: r₁) float32, and each operation
    on bf16 tensors is torch's bf16 operation, the float32 operation rounded
    once to bf16, as the kernel's `fmulb`, `faddb`, `fsubb`: the sweeps read
    a bf16 rounding of r₁, A·e is accumulated in bf16, K7's r₁ is float32
    from the float32 eps and the bf16 coefficients, and the updates and the
    norms are float32."""
    it = len(colors)
    cdt = L.dtype                           # the coefficients' and e's dtype
    h = it + 1
    ne, nr = it + 3, it + 2                 # e and r₁ ring planes
    nx, ny, nz = x.shape
    dims = (nx, ny, nz)
    per = [j in perdir for j in range(3)]
    hr, wr = ty + 2 * h, tz + 2 * h         # the region
    ni = max(1, nx - 2)
    xc = min(xc, ni)
    nch = math.ceil(ni / xc)
    ylo, ya, yb = _tiles(ny, ty)
    zlo, za, zb = _tiles(nz, tz)
    ia = 1 + xc * torch.arange(nch)
    xa = torch.where(torch.arange(nch) == 0, 0, ia)
    xb = torch.where(torch.arange(nch) == nch - 1, nx, ia + xc)
    iy, iz, ix = torch.meshgrid(torch.arange(len(ylo)), torch.arange(len(zlo)),
                                torch.arange(nch), indexing="ij")
    iy, iz, ix = iy.reshape(-1), iz.reshape(-1), ix.reshape(-1)
    y0, z0 = ylo[iy], zlo[iz]
    ya, yb, za, zb, xa, xb = ya[iy], yb[iy], za[iz], zb[iz], xa[ix], xb[ix]
    nb = y0.numel()
    t0 = xa - h - 1                         # step 0's plane, per block
    nsteps = xb - xa + 2 * it + 3
    # global (y, z) of the ring cells: the region grown by one: [nb, hr+2, wr+2]
    yy = (y0 - h - 1)[:, None, None] + torch.arange(hr + 2)[None, :, None]
    zz = (z0 - h - 1)[:, None, None] + torch.arange(wr + 2)[None, None, :]
    yy, zz = yy.expand(nb, hr + 2, wr + 2), zz.expand(nb, hr + 2, wr + 2)

    def source(c, j, wrap=True):
        """The source of coordinate c in direction j (its periodic image in
        the interior, or itself) and whether it lies in the field."""
        n = dims[j]
        if per[j] and wrap:
            return 1 + torch.remainder(c - 1, n - 2), torch.ones_like(c, dtype=bool)
        return c.clamp(0, n - 1), (c >= 0) & (c < n)

    fields = {"x": x, "r": r, "eps": eps, "D": D, "iD": iD,
              "L0": L[0], "L1": L[1], "L2": L[2]}

    def at(name, p, dx=0, dy=0, dz=0, wrap=True):
        """``name`` at plane p (+dx) of each block over the ring plane, read
        at the sources of the cells, zero outside the field."""
        (sx_, okx), (sy_, oky), (sz_, okz) = (
            source(p + dx, 0, wrap), source(yy + dy, 1, wrap),
            source(zz + dz, 2, wrap))
        v = fields[name][sx_[:, None, None], sy_, sz_]
        return torch.where(okx[:, None, None] & oky & okz, v, 0.0)

    def inner(a):
        return a[:, 1:-1, 1:-1]

    def interior(p, wrap=True):
        """The cells (their sources, or themselves) interior."""
        (sx_, okx), (sy_, oky), (sz_, okz) = (
            source(p, 0, wrap), source(yy, 1, wrap), source(zz, 2, wrap))
        return ((okx & (sx_ >= 1) & (sx_ <= nx - 2))[:, None, None]
                & oky & (sy_ >= 1) & (sy_ <= ny - 2)
                & okz & (sz_ >= 1) & (sz_ <= nz - 2))

    def nbr(a, dy, dz):                     # a's in-plane neighbour of inner
        return a[:, 1 + dy:a.shape[1] - 1 + dy, 1 + dz:a.shape[2] - 1 + dz]

    nan = float("nan")
    E = torch.full((nb, ne, hr + 2, wr + 2), nan, dtype=cdt)
    R1 = torch.full((nb, nr, hr + 2, wr + 2), nan, dtype=x.dtype)
    EPS = torch.full((nb, 4, hr + 2, wr + 2), nan, dtype=x.dtype)
    A0, A1, A2 = (torch.full((nb, ne, hr + 2, wr + 2), nan, dtype=cdt)
                  for _ in range(3))
    AI = torch.full((nb, nr, hr + 2, wr + 2), nan, dtype=cdt)
    if form == "incr_gs":
        for k in range(3):                  # planes t0, t0 + 1, t0 + 2
            EPS[:, k] = at("eps", t0 + k)
    x_out, r_out = x.clone(), r.clone()
    written = torch.zeros(x.shape, dtype=torch.int64)
    part_s = torch.zeros(nb, dtype=x.dtype)
    part_m = torch.zeros(nb, dtype=x.dtype)
    own = (inner(yy) >= ya[:, None, None]) & (inner(yy) < yb[:, None, None]) \
        & (inner(zz) >= za[:, None, None]) & (inner(zz) < zb[:, None, None])
    for s in range(int(nsteps.max())):
        t = t0 + s
        live = s < nsteps
        # slots written this step are not read across threads in it
        plane_reads = {(s - k) % ne for k in range(1, it + 2)}
        assert (s + 1) % ne not in plane_reads
        Es = E.clone()                      # the ring at the last barrier
        # ---- stages 1 … it: colors[k−1] on plane t−k, in place; K13's last
        # stage sweeps the real interior, the others the cells whose source
        # is interior
        for k, c in enumerate(colors, start=1):
            p = t - k
            last = form == "sweeps" and k == it
            xin = (p >= 1) & (p <= nx - 2)
            if per[0] and not last:
                xin = torch.ones_like(xin)
            act = live & (p >= xa - h + k) & (p <= xb + h - k - 1) & xin
            if not bool(act.any()):
                continue
            es = Es[:, (s - k) % ne]
            a1, a2 = A1[:, (s - k) % ne], A2[:, (s - k) % ne]
            g = inner(R1[:, (s - k) % nr]).to(cdt)
            g = g - (inner(E[:, (s - k - 1) % ne]) * inner(A0[:, (s - k) % ne])
                     + inner(E[:, (s - k + 1) % ne])
                     * inner(A0[:, (s - k + 1) % ne]))
            g = g - (nbr(es, -1, 0) * inner(a1) + nbr(es, 1, 0) * nbr(a1, 1, 0))
            g = g - (nbr(es, 0, -1) * inner(a2) + nbr(es, 0, 1) * nbr(a2, 0, 1))
            new = g * inner(AI[:, (s - k) % nr])
            par = (p[:, None, None] + yy + zz) % 2 == c
            rows = torch.arange(hr)         # the cone's rows: k from the edge
            cone = (torch.minimum(rows, hr - 1 - rows) >= k)[None, :, None]
            m = inner(interior(p, wrap=not last) & par) & act[:, None, None] & cone
            inner(E[:, (s - k) % ne])[m] = new[m]
        # ---- the tail on plane q: eps′ (K13), or x′, r′ and the norms
        q = t - it - 1
        act = live & (q >= xa) & (q < xb)
        if bool(act.any()):
            ec = inner(E[:, (s - it - 1) % ne])
            ok = own & act[:, None, None]
            qq = q[:, None, None].expand(ok.shape)
            ix_ = (qq[ok], inner(yy)[ok], inner(zz)[ok])
            written[ix_] += 1
            if form == "sweeps":
                x_out[ix_] = ec[ok]
            else:
                es = Es[:, (s - it - 1) % ne]
                a = ec * inner(at("D", q))
                a1, a2 = A1[:, (s - it - 1) % ne], A2[:, (s - it - 1) % ne]
                a = a + inner(E[:, (s - it - 2) % ne]) * inner(A0[:, (s - it - 1) % ne])
                a = a + inner(E[:, (s - it) % ne]) * inner(A0[:, (s - it) % ne])
                a = a + nbr(es, -1, 0) * inner(a1)
                a = a + nbr(es, 1, 0) * nbr(a1, 1, 0)
                a = a + nbr(es, 0, -1) * inner(a2)
                a = a + nbr(es, 0, 1) * nbr(a2, 0, 1)
                m = inner(interior(q))
                xv, rv = inner(at("x", q)), inner(at("r", q))
                e_x = ec.to(x.dtype)
                if form == "incr_gs":
                    e_x = inner(at("eps", q)) + e_x
                xn = torch.where(m, xv + omega * e_x, xv)
                rn = torch.where(m, inner(R1[:, (s - it - 1) % nr])
                                 - omega * a.to(x.dtype), rv)
                part_s += torch.where(ok, rn.abs(), 0.0).sum((1, 2))
                part_m = torch.maximum(part_m,
                                       torch.where(ok, rn.abs(), 0.0).amax((1, 2)))
                x_out[ix_], r_out[ix_] = xn[ok], rn[ok]
        # ---- stage 0 on plane t+1, at its source
        p0 = t + 1
        act = live & source(p0, 0)[1] & (p0 <= xb + it)
        m = inner(interior(p0))
        if form == "incr_gs":
            pm, pc, pp = EPS[:, s % 4], EPS[:, (s + 1) % 4], EPS[:, (s + 2) % 4]
            a = inner(pc) * inner(at("D", p0))
            a = a + inner(pm) * inner(at("L0", p0))
            a = a + inner(pp) * inner(at("L0", p0, 1))
            a = a + nbr(pc, -1, 0) * inner(at("L1", p0))
            a = a + nbr(pc, 1, 0) * inner(at("L1", p0, 0, 1))
            a = a + nbr(pc, 0, -1) * inner(at("L2", p0))
            a = a + nbr(pc, 0, 1) * inner(at("L2", p0, 0, 0, 1))
            r1 = torch.where(m, inner(at("r", p0)) - omega * a, 0.0)
            e0 = torch.where(m, r1.to(cdt) * inner(at("iD", p0)), 0.0)
        else:
            r1 = torch.where(m, inner(at("r", p0)), 0.0)
            e0 = (inner(at("eps", p0)) if form == "sweeps"
                  else torch.where(m, r1.to(cdt) * inner(at("iD", p0)), 0.0))
        sel = act[:, None, None].expand(e0.shape)
        inner(E[:, (s + 1) % ne])[sel] = e0[sel]
        inner(R1[:, (s + 1) % nr])[sel] = r1[sel]
        for ring, name in ((A0, "L0"), (A1, "L1"), (A2, "L2")):
            inner(ring[:, (s + 1) % ne])[sel] = inner(at(name, p0))[sel]
        inner(AI[:, (s + 1) % nr])[sel] = torch.where(
            m, inner(at("iD", p0)), 0.0)[sel]
        # ---- eps plane t+3, visible after the barrier
        if form == "incr_gs":
            EPS[:, (s + 3) % 4] = at("eps", t + 3)
    assert bool((written == 1).all()), "a cell was written by no tail or twice"
    return x_out, r_out, torch.stack([part_s.sum(), part_m.max()]), nb


def inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s + shape), dtype=dtype)
    # no zero boundary faces: L(+e_d) at the ghosts must be read as it is
    L = torch.as_tensor(0.2 + rng.random((3,) + shape), dtype=dtype)
    lev = ps.make_level(L)
    r = torch.zeros(shape, dtype=dtype)
    r[1:-1, 1:-1, 1:-1] = g()[1:-1, 1:-1, 1:-1]
    eps = torch.zeros(shape, dtype=dtype)
    eps[1:-1, 1:-1, 1:-1] = 0.3 * g()[1:-1, 1:-1, 1:-1]
    return g(), r, eps, lev


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("colors", COLORS, ids=lambda c: "".join(map(str, c)))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cascade_schedule_equals_incr_gs_plain(shape, colors, dtype):
    x, r, eps, lev = inputs(shape, 20 + len(colors), dtype)
    args = (x, r, eps, lev.L, lev.D, lev.iD, colors, OMEGA)
    xg, rg, ng, _ = cascade("incr_gs", *args)
    xw, rw, nw = fz.incr_gs_plain(*args, want_norms=True)
    assert torch.equal(xg, xw)
    assert torch.equal(rg, rw)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(ng, nw, rtol=tol, atol=0.0)


@pytest.mark.parametrize("tiles", [(2, 4, 3), (16, 32, 64)],
                         ids=["tiny", "wider-than-field"])
def test_cascade_schedule_other_tilings(tiles):
    x, r, eps, lev = inputs((19, 13, 22), 30, torch.float64)
    args = (x, r, eps, lev.L, lev.D, lev.iD, [1, 0, 1, 0], OMEGA)
    xg, rg, _, nb = cascade("incr_gs", *args, *tiles)
    xw, rw = fz.incr_gs_plain(*args)
    assert torch.equal(xg, xw) and torch.equal(rg, rw)
    ty, tz, xc = tiles
    assert nb == math.ceil(11 / ty) * math.ceil(20 / tz) * math.ceil(17 / min(xc, 17))


# ------------------------------------------------------------ K15 and K13
# the colour lists of the smoothers' callers and two that do not alternate
GS_COLORS = [[1, 0, 1, 0], [0, 1], [1], [0, 0, 1, 1]]
# periodic directions and a shape with even interior extents in them
PERIODIC = [((0, 1, 2), (12, 10, 8)), ((2,), (13, 11, 10)), ((), (19, 13, 22))]


def sweep_inputs(shape, perdir, seed):
    """eps, r (every cell, ghosts included), L with its ghost planes equal
    to their partners' in the periodic directions (`per_bc` of each
    component, what `bc_vector` with ``perdir`` does there) and non-zero
    faces elsewhere, iD of that level."""
    rng = np.random.default_rng(seed)
    L = per_bc(torch.as_tensor(0.2 + rng.random((3,) + shape)), perdir, lead=1)
    lev = ps.make_level(L)
    eps = torch.as_tensor(0.3 * rng.standard_normal(shape))
    r = torch.as_tensor(rng.standard_normal(shape))
    return eps, r, lev


def cascade_gs_incr(x, r, lev, colors, omega=OMEGA, **kw):
    xg, rg, _, _ = cascade("gs_incr", x, r, torch.zeros_like(x), lev.L, lev.D,
                           lev.iD, colors, omega, **kw)
    return xg, rg


def cascade_sweeps(eps, r, lev, colors, perdir, **kw):
    z = torch.zeros_like(eps)
    return cascade("sweeps", z, r, eps, lev.L, None, lev.iD, colors, 0.0,
                   perdir=perdir, **kw)[0]


@pytest.mark.parametrize("colors", GS_COLORS, ids=lambda c: "".join(map(str, c)))
@pytest.mark.parametrize("shape", [(12, 10, 7), (19, 13, 22)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gs_incr_schedule_equals_gs_incr_plain(shape, colors):
    x, r, _, lev = inputs(shape, 40 + len(colors), torch.float64)
    xg, rg = cascade_gs_incr(x, r, lev, colors)
    xw, rw = st.gs_incr_plain(x, r, lev.L, lev.D, lev.iD, colors, OMEGA)
    assert torch.equal(xg, xw) and torch.equal(rg, rw)


@pytest.mark.parametrize("colors", GS_COLORS, ids=lambda c: "".join(map(str, c)))
@pytest.mark.parametrize("perdir,shape", PERIODIC, ids=["xyz", "z", "none"])
def test_sweeps_schedule_equals_gauss_sweeps_plain(perdir, shape, colors):
    """Every cell, the ghosts included: a periodic ghost holds its partner's
    value from before the last colour, a wall ghost the input's."""
    eps, r, lev = sweep_inputs(shape, perdir, 50 + len(colors))
    got = cascade_sweeps(eps, r, lev, colors, perdir)
    want = st.gauss_sweeps_plain(eps, r, lev.L, lev.iD, colors, perdir)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    ("tiny", (0, 1, 2), (12, 10, 8), (2, 4, 3)),
    ("wider-than-field", (0, 1, 2), (12, 10, 8), (16, 32, 64)),
    ("wraps-twice", (0, 1, 2), (8, 4, 6), (2, 4, 1)),
    ("z-tiny", (2,), (13, 11, 10), (2, 4, 2)),
], ids=lambda c: c[0])
def test_sweeps_schedule_other_tilings(case):
    """Ragged tiles and chunks, tiles wider than the field, and lead-ins and
    halos that wrap more than once round an interior of two cells."""
    _, perdir, shape, tiles = case
    eps, r, lev = sweep_inputs(shape, perdir, 60)
    for colors in ([0, 1, 0, 1], [1]):
        got = cascade_sweeps(eps, r, lev, colors, perdir, ty=tiles[0],
                             tz=tiles[1], xc=tiles[2])
        assert torch.equal(got, st.gauss_sweeps_plain(eps, r, lev.L, lev.iD,
                                                      colors, perdir))


def test_gs_incr_schedule_tiny_tiles():
    x, r, _, lev = inputs((19, 13, 22), 70, torch.float64)
    xg, rg = cascade_gs_incr(x, r, lev, [0, 1, 0, 1], ty=2, tz=4, xc=3)
    xw, rw = st.gs_incr_plain(x, r, lev.L, lev.D, lev.iD, [0, 1, 0, 1], OMEGA)
    assert torch.equal(xg, xw) and torch.equal(rg, rw)


# ------------------------------------------------------------ bf16 forms
# K7's callers run 2 and 4 colours; one list that does not alternate
MP_INCR_COLORS = [[1, 0], [0, 1, 0, 1], [0, 0, 1, 1]]
# K5 with 1-4 colours and one list that does not alternate
MP_GS_COLORS = [[1], [0, 1], [0, 1, 0], [1, 0, 1, 0], [1, 1]]


def mp_inputs(shape, seed):
    """float32 x, r, eps and the bf16 coefficients of their level."""
    x, r, eps, lev = inputs(shape, seed, torch.float32)
    return x, r, eps, ps.with_bf16(lev).bf


@pytest.mark.parametrize("colors", MP_INCR_COLORS,
                         ids=lambda c: "".join(map(str, c)))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_mp_cascade_schedule_equals_incr_gs_plain(shape, colors):
    """K7's bf16 form (`incr_gs_tile_kernel<IT, NORMS, true>`) by its
    schedule against `incr_gs_plain(mp=True)`: x′ and r′ bit for bit, the
    norms to float32 summation order."""
    x, r, eps, bf = mp_inputs(shape, 100 + len(colors))
    args = (x, r, eps, *bf, colors, OMEGA)
    xg, rg, ng, _ = cascade("incr_gs", *args)
    xw, rw, nw = fz.incr_gs_plain(*args, want_norms=True, mp=True)
    assert torch.equal(xg, xw) and torch.equal(rg, rw)
    torch.testing.assert_close(ng, nw, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("colors", MP_GS_COLORS,
                         ids=lambda c: "".join(map(str, c)))
@pytest.mark.parametrize("shape", [(12, 10, 7), (19, 13, 22)],
                         ids=lambda s: "x".join(map(str, s)))
def test_mp_gs_incr_schedule_equals_gs_incr_plain(shape, colors):
    """K5's bf16 form (`gs_incr_tile_kernel<IT, true>`) by its schedule
    against `gs_incr_plain(mp=True)`, bit for bit."""
    x, r, _, bf = mp_inputs(shape, 110 + len(colors))
    xg, rg, _, _ = cascade("gs_incr", x, r, torch.zeros_like(x), *bf, colors,
                           OMEGA)
    xw, rw = st.gs_incr_plain(x, r, *bf, colors, OMEGA, mp=True)
    assert torch.equal(xg, xw) and torch.equal(rg, rw)


@pytest.mark.parametrize("form", ["incr_gs", "gs_incr"])
@pytest.mark.parametrize("tiles", [(2, 4, 3), (16, 32, 64)],
                         ids=["tiny", "wider-than-field"])
def test_mp_schedule_other_tilings(form, tiles):
    x, r, eps, bf = mp_inputs((19, 13, 22), 120)
    colors = [1, 0, 1, 0]
    if form == "incr_gs":
        got = cascade(form, x, r, eps, *bf, colors, OMEGA, *tiles)[:2]
        want = fz.incr_gs_plain(x, r, eps, *bf, colors, OMEGA, mp=True)
    else:
        got = cascade(form, x, r, torch.zeros_like(x), *bf, colors, OMEGA,
                      *tiles)[:2]
        want = st.gs_incr_plain(x, r, *bf, colors, OMEGA, mp=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ vs Pallas
@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl3, "_INTERPRET", True)


def test_gs_incr_schedule_vs_pallas(interpret):
    """K15's schedule in float32 against `pallas3d.gs_incr3d` in interpret
    mode, 1e-5 of max (another rounding order)."""
    x, r, _, lev = inputs((20, 20, 20), 80, torch.float32)
    colors = [1, 0, 1, 0]
    got = cascade_gs_incr(x, r, lev, colors)
    want = pl3.gs_incr3d(*(jnp.asarray(t.numpy())
                           for t in (x, r, lev.L, lev.D, lev.iD)), colors, OMEGA)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()


def test_sweeps_schedule_vs_pallas(interpret):
    """K13's schedule in float32 against `pallas3d.gauss_sweeps3d` in
    interpret mode, from a periodic-synced eps and compared after a periodic
    ghost refresh as `tests/test_torch_exitper_ops.py` does (the Pallas
    kernel resets the x ghost planes to their inputs), 1e-5."""
    perdir = (0, 1, 2)
    eps, r, lev = sweep_inputs((20, 20, 20), perdir, 90)
    eps, r = per_bc(eps, perdir).float(), r.float()
    lev = ps.make_level(lev.L.float())
    colors = [0, 1, 0, 1]
    got = cascade_sweeps(eps, r, lev, colors, perdir)
    want = pl3.gauss_sweeps3d(*(jnp.asarray(t.numpy())
                                for t in (eps, r, lev.L, lev.iD)), colors, perdir)
    np.testing.assert_allclose(per_bc(got, perdir).numpy(),
                               np.asarray(bc_j.per_bc(want, perdir)), atol=1e-5)


@pytest.mark.parametrize("body", [False, True], ids=["vortex", "sphere"])
def test_periodic_levels_hold_the_sweeps_precondition(body):
    """K13's cascade reads one L per ring cell, as a periodic ghost's and as
    its source's: every level the solvers smooth with ``perdir`` must hold
    its partners' values in the periodic ghost planes of L (and have even
    interior extents there, or take the per-colour route)."""
    from waterlily_tpu_torch import AutoBody, Simulation

    perdir = (0, 2)
    kw = {}
    if body:
        ctr = torch.tensor([8.0, 6.0, 8.0], dtype=torch.float64)
        kw["body"] = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - 3.0)
    sim = Simulation((16, 12, 16), (1.0, 0.0, 0.0), 4.0, nu=0.01, perdir=perdir,
                     dtype=torch.float64, device="cpu", **kw)
    assert len(sim.levels) > 1
    for lev in sim.levels:
        assert torch.equal(per_bc(lev.L, perdir, lead=1), lev.L)


@pytest.mark.parametrize("form", ["incr_gs", "gs_incr"])
def test_mp_schedule_vs_pallas(monkeypatch, form):
    """The bf16 forms' schedules against `pallas_flat.incr_gs(mp=True)` and
    `gs_incr(mp=True)` in interpret mode, under the limits
    `tests/test_torch_mp.py` gives the plain versions: x to 1e-6 of max,
    r to 0.02 (XLA on the CPU keeps the chain of bf16 sums of A·e in float32
    between operations; the port rounds each)."""
    from waterlily_tpu.ops import flat as fo
    from waterlily_tpu.ops import pallas_flat as plf

    monkeypatch.setattr(plf, "_INTERPRET", True)
    shape = (12, 10, 7)
    geom = fo.geom_of(shape)
    x, r, eps, bf = mp_inputs(shape, 130)
    colors = [0, 1, 0, 1]
    J = lambda t: fo.to_flat(jnp.asarray(t.float().numpy()), geom)
    coef = [J(t) for t in bf]
    if form == "incr_gs":
        got = cascade(form, x, r, eps, *bf, colors, 0.8)[:2]
        want = plf.incr_gs(J(x), J(r), J(eps), *coef, colors, jnp.float32(0.8),
                           geom, mp=True)
    else:
        got = cascade(form, x, r, torch.zeros_like(x), *bf, colors, 0.8)[:2]
        want = plf.gs_incr(J(x), J(r), *coef, colors, jnp.float32(0.8), geom,
                           mp=True)
    for a, b, tol in zip(got, want, (1e-6, 0.02)):
        b = np.asarray(fo.from_flat(b, geom))
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=tol * max(1.0, np.abs(b).max()))
