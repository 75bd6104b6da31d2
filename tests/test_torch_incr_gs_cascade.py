"""The schedule of the tiled K7 kernel (`incr_gs_tile_kernel` in
`csrc/fused3d.cu`), emulated in plain PyTorch on the CPU and held bit for bit
against `fused3d.incr_gs_plain`.

K7 computes, on interior cells, ``r₁ = r − ω·A·eps``, ``e₀ = r₁·iD``, one
red-black sweep of ``e`` per colour, ``x′ = x + ω(eps + e)`` and
``r′ = r₁ − ω·A·e``; ghosts keep x and r.  The kernel does it in one pass:
tiles of (TY × TZ) interior (y, z) cells (the first and last tiles of a row
of tiles also own the ghost cells beside them) march over chunks of xc
interior x rows (the first and last chunks also own the ghost planes).  A
block's region is its tile grown by ``H = it + 1`` cells; each thread owns a
pair of z-adjacent cells of the region.  At march step t a thread runs, in
this order:

* stage k = 1 … it: the sweep of ``colors[k−1]`` on plane ``t − k``, in place;
* the tail: x′, r′ and the norms on plane ``t − it − 1`` at the cells its
  block owns;
* stage 0: r₁ and e₀ on plane ``t + 1``, and its cells' L and iD into
  rings;

then one barrier.  e, L0, L1 and L2 live in rings of ``it + 3`` planes, r₁
and iD in rings of ``it + 2``, eps in one of 4 (filled three planes ahead of
stage 0); the sweeps read only the rings.  A stage reads its own cells'
x-neighbours (written by the same thread earlier) and the in-plane
neighbours on its plane (e, L1(+y), L2(+z)) as they were at the last barrier
(written by other threads).  The emulation reads them so: in-plane from a
snapshot taken at the step's start, x-neighbours and r₁ from the live rings,
and it checks that no slot a stage writes in a step is one another stage
reads across threads in that step.

Stage k runs on its dependency cone in x (``[xa − H + k, xb + H − k)``) and
in y (the tile grown by ``H − k`` rows), and on every column of the region.
A value outside the cone is wrong or stale, and must never reach a value
inside it: the rings start as NaN and the region's border ring stays NaN
(the kernel's is zero), so a read outside the cone poisons the result.  Small tiles and chunks (4 × 8 cells, 5 rows)
exercise ragged tiles, tiles wider than the field, ragged chunks and
lead-ins that leave the field."""
import math

import numpy as np
import pytest
import torch

from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import poisson as ps

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


def cascade_incr_gs(x, r, eps, L, D, iD, colors, omega, ty=4, tz=8, xc=5):
    """K7 with norms by the tiled kernel's schedule.  Returns
    ``(x′, r′, [Σ|r′|, max|r′|], number of blocks)``."""
    it = len(colors)
    h = it + 1
    ne, nr = it + 3, it + 2                 # e and r₁ ring planes
    nx, ny, nz = x.shape
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
    px, py, pz = h + 4, ty + h + 3, tz + h + 3

    def pad(f):
        return torch.nn.functional.pad(f, (pz, pz, py, py, px, px))

    fields = {"x": x, "r": r, "eps": eps, "D": D, "iD": iD,
              "L0": L[0], "L1": L[1], "L2": L[2]}
    padded = {k: pad(v) for k, v in fields.items()}

    def at(name, p, dx=0, dy=0, dz=0):
        """``name`` at plane p (+dx) of each block over the ring plane, zero
        outside the field."""
        ix_ = torch.clamp(p + dx + px, 0, nx + 2 * px - 1)
        return padded[name][ix_[:, None, None], yy + dy + py, zz + dz + pz]

    def inner(a):
        return a[:, 1:-1, 1:-1]

    def in_field(p):
        return ((p[:, None, None] >= 0) & (p[:, None, None] < nx)
                & (yy >= 0) & (yy < ny) & (zz >= 0) & (zz < nz))

    def interior(p):
        return ((p[:, None, None] >= 1) & (p[:, None, None] <= nx - 2)
                & (yy >= 1) & (yy <= ny - 2) & (zz >= 1) & (zz <= nz - 2))

    def nbr(a, dy, dz):                     # a's in-plane neighbour of inner
        return a[:, 1 + dy:a.shape[1] - 1 + dy, 1 + dz:a.shape[2] - 1 + dz]

    nan = float("nan")
    E = torch.full((nb, ne, hr + 2, wr + 2), nan, dtype=x.dtype)
    R1 = torch.full((nb, nr, hr + 2, wr + 2), nan, dtype=x.dtype)
    EPS = torch.full((nb, 4, hr + 2, wr + 2), nan, dtype=x.dtype)
    A0, A1, A2 = (torch.full((nb, ne, hr + 2, wr + 2), nan, dtype=x.dtype)
                  for _ in range(3))
    AI = torch.full((nb, nr, hr + 2, wr + 2), nan, dtype=x.dtype)
    for k in range(3):                      # planes t0, t0 + 1, t0 + 2
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
        # ---- stages 1 … it: colors[k−1] on plane t−k, in place
        for k, c in enumerate(colors, start=1):
            p = t - k
            act = (live & (p >= torch.clamp(xa - h + k, min=1))
                   & (p <= torch.clamp(xb + h - k - 1, max=nx - 2)))
            if not bool(act.any()):
                continue
            es = Es[:, (s - k) % ne]
            a1, a2 = A1[:, (s - k) % ne], A2[:, (s - k) % ne]
            g = inner(R1[:, (s - k) % nr])
            g = g - (inner(E[:, (s - k - 1) % ne]) * inner(A0[:, (s - k) % ne])
                     + inner(E[:, (s - k + 1) % ne])
                     * inner(A0[:, (s - k + 1) % ne]))
            g = g - (nbr(es, -1, 0) * inner(a1) + nbr(es, 1, 0) * nbr(a1, 1, 0))
            g = g - (nbr(es, 0, -1) * inner(a2) + nbr(es, 0, 1) * nbr(a2, 0, 1))
            new = g * inner(AI[:, (s - k) % nr])
            par = (p[:, None, None] + yy + zz) % 2 == c
            rows = torch.arange(hr)         # the cone's rows: k from the edge
            cone = (torch.minimum(rows, hr - 1 - rows) >= k)[None, :, None]
            m = inner(interior(p) & par) & act[:, None, None] & cone
            inner(E[:, (s - k) % ne])[m] = new[m]
        # ---- the tail on plane q
        q = t - it - 1
        act = live & (q >= xa) & (q < xb)
        if bool(act.any()):
            es = Es[:, (s - it - 1) % ne]
            ec = inner(E[:, (s - it - 1) % ne])
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
            xn = torch.where(m, xv + omega * (inner(at("eps", q)) + ec), xv)
            rn = torch.where(m, inner(R1[:, (s - it - 1) % nr]) - omega * a, rv)
            ok = own & act[:, None, None]
            part_s += torch.where(ok, rn.abs(), 0.0).sum((1, 2))
            part_m = torch.maximum(part_m,
                                   torch.where(ok, rn.abs(), 0.0).amax((1, 2)))
            qq = q[:, None, None].expand(ok.shape)
            ix_ = (qq[ok], inner(yy)[ok], inner(zz)[ok])
            x_out[ix_], r_out[ix_] = xn[ok], rn[ok]
            written[ix_] += 1
        # ---- stage 0 on plane t+1
        p0 = t + 1
        act = live & (p0 >= 0) & (p0 < nx) & (p0 <= xb + it)
        pm, pc, pp = EPS[:, s % 4], EPS[:, (s + 1) % 4], EPS[:, (s + 2) % 4]
        a = inner(pc) * inner(at("D", p0))
        a = a + inner(pm) * inner(at("L0", p0))
        a = a + inner(pp) * inner(at("L0", p0, 1))
        a = a + nbr(pc, -1, 0) * inner(at("L1", p0))
        a = a + nbr(pc, 1, 0) * inner(at("L1", p0, 0, 1))
        a = a + nbr(pc, 0, -1) * inner(at("L2", p0))
        a = a + nbr(pc, 0, 1) * inner(at("L2", p0, 0, 0, 1))
        m = inner(interior(p0))
        r1 = torch.where(m, inner(at("r", p0)) - omega * a, 0.0)
        e0 = torch.where(m, r1 * inner(at("iD", p0)), 0.0)
        sel = act[:, None, None].expand(e0.shape)
        inner(E[:, (s + 1) % ne])[sel] = e0[sel]
        inner(R1[:, (s + 1) % nr])[sel] = r1[sel]
        f = inner(in_field(p0))
        for ring, name in ((A0, "L0"), (A1, "L1"), (A2, "L2")):
            inner(ring[:, (s + 1) % ne])[sel] = torch.where(
                f, inner(at(name, p0)), 0.0)[sel]
        inner(AI[:, (s + 1) % nr])[sel] = torch.where(
            m, inner(at("iD", p0)), 0.0)[sel]
        # ---- eps plane t+3, visible after the barrier
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
    xg, rg, ng, _ = cascade_incr_gs(*args)
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
    xg, rg, _, nb = cascade_incr_gs(*args, *tiles)
    xw, rw = fz.incr_gs_plain(*args)
    assert torch.equal(xg, xw) and torch.equal(rg, rw)
    ty, tz, xc = tiles
    assert nb == math.ceil(11 / ty) * math.ceil(20 / tz) * math.ceil(17 / min(xc, 17))
