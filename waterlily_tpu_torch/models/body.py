"""Immersed-body framework: BDIM kernel moments, CSG set bodies and the
field measure.

PyTorch counterpart of `waterlily_tpu/models/body.py` (the port of
`src/Body.jl`).  `measure_fill` evaluates the body at every interior cell
and face, or only on a box around the body (``band_box``), with
`torch.func.vmap` over the points, in chunks that bound the device memory
of the batched autodiff.  The JAX package's gather-sparse measure
(``sparse_k``, off by default there as a measured loss) is not ported.
"""
from __future__ import annotations

import math

import torch
from torch.func import vmap

from ..ops.bc import bc_vector
from ..ops.grid import grow, loc_grid

__all__ = ["Body", "NoBody", "SetBody", "kern", "kern0", "kern1", "mu0_kernel",
           "mu1_kernel", "measure_fill", "measure_sdf", "MEASURE_CHUNK"]

INF = float("inf")

# points per vmapped measure batch: bounds the batched autodiff temporaries
# (a (chunk, 3, 3) Jacobian and friends) at a few hundred MB in float32
MEASURE_CHUNK = 1 << 21


class Body:
    """Body protocol (`AbstractBody`, `Body.jl:13`): subtypes implement
    ``d, n, V = body.measure_at(x, t, fastd2)`` for one point ``x`` of shape
    ``(D,)``, written with torch ops so that `torch.func` can batch it."""

    def measure_at(self, x, t, fastd2=INF):  # pragma: no cover - interface
        raise NotImplementedError

    def sdf_at(self, x, t):
        """Distance only (`sdf`, `Body.jl:66-68`)."""
        return self.measure_at(x, t, fastd2=0.0)[0]

    # CSG operators (`SetBody` lazy constructors, `Body.jl:91-108`)
    def __add__(self, other):
        """CSG union: the smaller distance (`∪`/`+`); also ``a | b`` and
        ``a.union(b)``."""
        return SetBody("min", self, other)

    __or__ = __add__
    union = __add__

    def __and__(self, other):
        """CSG intersection: the larger distance (`∩`/`&`); also
        ``a.intersect(b)``."""
        return SetBody("max", self, other)

    intersect = __and__

    def __neg__(self):
        return SetBody("neg", self, NoBody())

    def __sub__(self, other):
        return self & (-other)


class NoBody(Body):
    """Fluid-only placeholder (`NoBody`, `Body.jl:81-83`)."""

    def measure_at(self, x, t, fastd2=INF):
        return (torch.full((), INF, dtype=x.dtype, device=x.device),
                torch.zeros_like(x), torch.zeros_like(x))


class SetBody(Body):
    """Lazy CSG composition (`SetBody`, `Body.jl:91-108`): union takes the
    smaller distance, intersection the larger (ties go to ``a``), the
    complement flips the distance and the normal."""

    def __init__(self, op: str, a: Body, b: Body):
        if op not in ("min", "max", "neg"):
            raise ValueError(f"SetBody op must be 'min', 'max' or 'neg', got {op!r}")
        self.op, self.a, self.b = op, a, b

    def sdf_at(self, x, t):
        """Distance only, from the children's `sdf_at`: ``measure_at(x, t,
        0.0)[0]`` without the children's normals and velocities."""
        da = self.a.sdf_at(x, t)
        if self.op == "neg":
            return -da
        db = self.b.sdf_at(x, t)
        pick_a = (da <= db) if self.op == "min" else (da >= db)
        return torch.where(pick_a, da, db)

    def measure_at(self, x, t, fastd2=INF):
        da, na, Va = self.a.measure_at(x, t, fastd2)
        if self.op == "neg":
            return -da, -na, Va
        db, nb, Vb = self.b.measure_at(x, t, fastd2)
        pick_a = (da <= db) if self.op == "min" else (da >= db)
        return (torch.where(pick_a, da, db), torch.where(pick_a, na, nb),
                torch.where(pick_a, Va, Vb))


def kern(d):
    """Immersion kernel (`Body.jl:54`)."""
    return (1 + torch.cos(math.pi * d)) / 2


def kern0(d):
    """Zeroth kernel moment (`Body.jl:55`)."""
    return (1 + d + torch.sin(math.pi * d) / math.pi) / 2


def kern1(d):
    """First kernel moment (`Body.jl:56`)."""
    return ((1 - d**2) / 4
            - (d * torch.sin(math.pi * d) + (1 + torch.cos(math.pi * d)) / math.pi)
            / (2 * math.pi))


def mu0_kernel(d, eps_k):
    """Clamped zeroth moment, cut at -1+sqrt(eps) to bound 1/mu0 in the
    fluid (`Body.jl:59`)."""
    s = d / eps_k
    cut = -1 + math.sqrt(torch.finfo(d.dtype).eps)
    return torch.where(s < cut, 0.0, kern0(torch.clamp(s, max=1.0)))


def mu1_kernel(d, eps_k):
    """Clamped first moment (`Body.jl:60`)."""
    return eps_k * kern1(torch.clamp(d / eps_k, -1.0, 1.0))


def _measure_points(body: Body, pts: torch.Tensor, t, fastd2: float):
    """``vmap(body.measure_at)`` over the rows of ``pts``, in chunks."""
    fn = vmap(lambda x: body.measure_at(x, t, fastd2))
    outs = [fn(pts[k:k + MEASURE_CHUNK])
            for k in range(0, pts.shape[0], MEASURE_CHUNK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _interior_points(i, shape, dtype, device, sl=None, offset=None) -> torch.Tensor:
    """The points of component ``i`` (None: cell centres) on the interior,
    or on the padded-index slices ``sl`` of it, one row each; ``offset``
    maps a shard's local indices to global coordinates."""
    D = len(shape)
    sl = (slice(1, -1),) * D if sl is None else sl
    coords = loc_grid(i, shape, dtype, device, offset)[(slice(None),) + tuple(sl)]
    return coords.reshape(D, -1).T


def _box_slices(shape: tuple[int, ...], band_box):
    """``band_box`` clamped to the interior as padded-index slices, or None
    when no box is given or it spans the whole interior in every dim."""
    if band_box is None:
        return None
    sl, narrow = [], False
    for d, n in enumerate(shape):
        bd = band_box[d] if d < len(band_box) else None
        a, b = (1, n - 1) if bd is None else (max(1, int(bd[0])),
                                               min(n - 1, int(bd[1])))
        narrow = narrow or b - a < n - 2
        sl.append(slice(a, b))
    return tuple(sl) if narrow else None


def measure_sdf(body: Body, shape: tuple[int, ...], t=0.0,
                dtype=torch.float32, device="cuda",
                fastd2: float = 0.0) -> torch.Tensor:
    """Signed distance at every cell center, ghosts zero (`measure_sdf!`,
    `Body.jl:74`)."""
    inner = tuple(n - 2 for n in shape)
    t = torch.as_tensor(t, dtype=dtype, device=device)
    d = _measure_points(body, _interior_points(None, shape, dtype, device), t,
                        fastd2)[0]
    return grow(d.reshape(inner).to(dtype))


def measure_fill(body: Body, shape: tuple[int, ...], t=0.0, eps_k: float = 1.0,
                 dtype=torch.float32, device="cuda",
                 perdir: tuple[int, ...] = (), exit_bc: bool = False,
                 band_box=None, ctx=None):
    """Fill the BDIM arrays ``(V, mu0, mu1, sdf)`` from the body geometry
    (`measure!`, `Body.jl:28-51`).

    Per face direction the body is measured at the face; the distance sign is
    made consistent with the cell-center sdf outside |d| <= 0.5, the kernel
    moments are evaluated, and everything is selected against the band
    ``sdf² < (2+eps)²`` (mu0 = 0 deep inside the body, 1 in the fluid).
    Ghosts: the zero-velocity vector BC on mu0 and V, periodic in
    ``perdir``, and on V keeping the exit plane with ``exit_bc``
    (`body.py:313-314`).

    ``band_box = ((lo, hi), ...)``, one padded-index pair (or None: the
    whole extent) per dim, runs the sdf/AD sweep on that interior box only
    and pastes it into the exact far field (μ0 = 1, μ1 = 0, V = 0 before
    the BC fill, σ = √((2+eps)²) + 1), as the JAX package's
    `measure_fill(band_box=)` does (`body.py:168-325`).  The result equals
    the dense measure when the box covers every cell whose moments deviate
    from the far field; `Simulation.measure` widens the box until it
    does.

    Under domain decomposition (``ctx``) ``shape`` is the shard's local
    padded shape: the body is measured at global coordinates, the BCs of μ0
    and V take ring halos between shards, and the box is not used (as in
    the JAX package, `body.py:218`)."""
    from ..ops.dist import offsets

    D = len(shape)
    inner = tuple(n - 2 for n in shape)
    band2 = float((2.0 + eps_k) ** 2)
    t = torch.as_tensor(t, dtype=dtype, device=device)
    off = None if ctx is None else offsets(ctx, shape)
    box = None if ctx is not None else _box_slices(shape, band_box)
    sl = tuple(slice(1, n - 1) for n in shape) if box is None else box
    inner_b = tuple(s.stop - s.start for s in sl)
    paste = None if box is None else tuple(slice(s.start - 1, s.stop - 1)
                                           for s in box)
    sig = _measure_points(body, _interior_points(None, shape, dtype, device, sl, off),
                          t, band2)[0].reshape(inner_b).to(dtype)
    in_band = sig**2 < band2
    mu0_c, mu1_c, V_c = [], [], []
    for i in range(D):
        d, n, v = _measure_points(body, _interior_points(i, shape, dtype, device, sl,
                                                         off), t, band2)
        d = d.reshape(inner_b)
        n = n.T.reshape((D,) + inner_b)
        v = v.T.reshape((D,) + inner_b)
        d = torch.where(torch.abs(d) <= 0.5, d, torch.copysign(d, sig))
        m0 = torch.where(in_band, mu0_kernel(d, eps_k),
                         torch.where(sig < 0, 0.0, 1.0))
        m1 = torch.where(in_band, mu1_kernel(d, eps_k) * n, 0.0)
        vv = torch.where(in_band, v[i], 0.0)
        if paste is not None:   # the measured box into the exact far field
            m0 = _paste(torch.ones(inner, dtype=m0.dtype, device=device), paste, m0)
            m1 = _paste(torch.zeros((D,) + inner, dtype=m1.dtype, device=device),
                        (slice(None),) + paste, m1)
            vv = _paste(torch.zeros(inner, dtype=vv.dtype, device=device), paste, vv)
        mu0_c.append(grow(m0, fill=1.0))
        mu1_c.append(torch.stack([grow(m1[j]) for j in range(D)]))
        V_c.append(grow(vv))
    zeros = (0.0,) * D
    mu0 = bc_vector(torch.stack(mu0_c).to(dtype), zeros, perdir=perdir, ctx=ctx)
    mu1 = torch.stack(mu1_c).to(dtype)
    V = bc_vector(torch.stack(V_c).to(dtype), zeros, save_exit=exit_bc,
                  perdir=perdir, ctx=ctx)
    if paste is not None:   # far field: a positive out-of-band distance
        sig = _paste(torch.full(inner, band2**0.5 + 1.0, dtype=dtype, device=device),
                     paste, sig)
    return V, mu0, mu1, grow(sig)


def _paste(far: torch.Tensor, where, box: torch.Tensor) -> torch.Tensor:
    far[where] = box
    return far
