"""Immersed-body framework: BDIM kernel moments and the dense field measure.

PyTorch counterpart of `waterlily_tpu/models/body.py` (the port of
`src/Body.jl`).  `measure_fill` evaluates the body at every interior cell
and face with `torch.func.vmap` over the points, in chunks that bound the
device memory of the batched autodiff.  CSG bodies, the box-banded and the
gather-sparse measure are not ported yet (ROADMAP queue 1, items 5 and 9).
"""
from __future__ import annotations

import math

import torch
from torch.func import vmap

from ..ops.bc import bc_vector
from ..ops.grid import grow, loc_grid

__all__ = ["Body", "NoBody", "kern", "kern0", "kern1", "mu0_kernel",
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


class NoBody(Body):
    """Fluid-only placeholder (`NoBody`, `Body.jl:81-83`)."""

    def measure_at(self, x, t, fastd2=INF):
        return (torch.full((), INF, dtype=x.dtype, device=x.device),
                torch.zeros_like(x), torch.zeros_like(x))


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


def _interior_points(i, shape, dtype, device) -> torch.Tensor:
    D = len(shape)
    coords = loc_grid(i, shape, dtype, device)[(slice(None),) + (slice(1, -1),) * D]
    return coords.reshape(D, -1).T


def measure_sdf(body: Body, shape: tuple[int, ...], t=0.0,
                dtype=torch.float32, device="cuda",
                fastd2: float = 0.0) -> torch.Tensor:
    """Signed distance at every cell center, ghosts zero (`measure_sdf!`,
    `Body.jl:74`)."""
    inner = tuple(n - 2 for n in shape)
    t = torch.tensor(t, dtype=dtype, device=device)
    d = _measure_points(body, _interior_points(None, shape, dtype, device), t,
                        fastd2)[0]
    return grow(d.reshape(inner).to(dtype))


def measure_fill(body: Body, shape: tuple[int, ...], t=0.0, eps_k: float = 1.0,
                 dtype=torch.float32, device="cuda",
                 perdir: tuple[int, ...] = (), exit_bc: bool = False):
    """Fill the BDIM arrays ``(V, mu0, mu1, sdf)`` from the body geometry
    (`measure!`, `Body.jl:28-51`), dense over the interior.

    Per face direction the body is measured at the face; the distance sign is
    made consistent with the cell-center sdf outside |d| <= 0.5, the kernel
    moments are evaluated, and everything is selected against the band
    ``sdf² < (2+eps)²`` (mu0 = 0 deep inside the body, 1 in the fluid).
    Ghosts: the zero-velocity vector BC on mu0 and V, periodic in
    ``perdir``, and on V keeping the exit plane with ``exit_bc``
    (`body.py:313-314`)."""
    D = len(shape)
    inner = tuple(n - 2 for n in shape)
    band2 = float((2.0 + eps_k) ** 2)
    t = torch.tensor(t, dtype=dtype, device=device)
    sig = _measure_points(body, _interior_points(None, shape, dtype, device),
                          t, band2)[0].reshape(inner).to(dtype)
    in_band = sig**2 < band2
    mu0_c, mu1_c, V_c = [], [], []
    for i in range(D):
        d, n, v = _measure_points(body, _interior_points(i, shape, dtype, device),
                                  t, band2)
        d = d.reshape(inner)
        n = n.T.reshape((D,) + inner)
        v = v.T.reshape((D,) + inner)
        d = torch.where(torch.abs(d) <= 0.5, d, torch.copysign(d, sig))
        m0 = torch.where(in_band, mu0_kernel(d, eps_k),
                         torch.where(sig < 0, 0.0, 1.0))
        m1 = torch.where(in_band, mu1_kernel(d, eps_k) * n, 0.0)
        vv = torch.where(in_band, v[i], 0.0)
        mu0_c.append(grow(m0, fill=1.0))
        mu1_c.append(torch.stack([grow(m1[j]) for j in range(D)]))
        V_c.append(grow(vv))
    zeros = (0.0,) * D
    mu0 = bc_vector(torch.stack(mu0_c).to(dtype), zeros, perdir=perdir)
    mu1 = torch.stack(mu1_c).to(dtype)
    V = bc_vector(torch.stack(V_c).to(dtype), zeros, save_exit=exit_bc,
                  perdir=perdir)
    return V, mu0, mu1, grow(sig)
