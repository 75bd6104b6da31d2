"""Flow diagnostics: vorticity, strain, vortex criteria, body forces and
moments, running means.

PyTorch counterpart of `waterlily_tpu/utils/metrics.py` (the port of
`src/Metrics.jl`).  Pointwise metrics are whole-tensor shift expressions;
the surface integrals evaluate the body normal with vmapped sweeps
(`models.body` chunks them), on the port's own bodies only where the
distance is within one cell (`nds_field`), and sum in float64 on either
device, as the reference does (`Metrics.jl:127`).  The JAX package sums in
float32 with a Neumaier-compensated scan on the TPU only because the TPU has
no fast float64; the card has it.  `lambda2_field` takes the eigenvalues of
``LAMBDA2_CHUNK`` cells' 3×3 matrices per batched `eigvalsh` call.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from .. import tracing
from ..models.autobody import AutoBody
from ..models.body import (MEASURE_CHUNK, Body, NoBody, SetBody, _interior_points,
                           _measure_points, kern)
from ..ops.dist import offsets, psum_all
from ..ops.grid import grow, loc_grid, shift

__all__ = [
    "dudx", "ke_field", "lambda2_field", "curl_edge", "omega_field",
    "omega_mag_field", "omega_theta_field", "helicity_field", "strain_field",
    "vorticity",
    "nds_field", "pressure_force", "viscous_force", "total_force",
    "pressure_moment", "viscous_moment", "total_moment", "MeanFlow",
    "LAMBDA2_CHUNK", "SDF_CHUNK",
]

# points per vmapped distance batch of `nds_field`'s shell pass: the
# distance alone keeps no autodiff temporaries, so four times
# `MEASURE_CHUNK` fit the memory of one measure batch
SDF_CHUNK = 4 * MEASURE_CHUNK

# cells per batched `eigvalsh` call of `lambda2_field`: cuSOLVER's batched
# symmetric solver refuses 32,768 3×3 matrices and more in one call
# (CUSOLVER_STATUS_INVALID_VALUE on an H100 with CUDA 12.8)
LAMBDA2_CHUNK = 1 << 14


def dudx(i: int, j: int, u: torch.Tensor) -> torch.Tensor:
    """∂u_i/∂x_j at cell centres (`∂(i,j,I,u)`, `Metrics.jl:42-44`): the
    staggered difference for i == j, a 4-point average for cross terms."""
    if i == j:
        return shift(u[i], i, 1) - u[i]
    a = shift(u[i], j, 1)
    b = shift(u[i], j, -1)
    return (a + shift(a, i, 1) - b - shift(b, i, 1)) / 4


def ke_field(u: torch.Tensor, U=None) -> torch.Tensor:
    """½|u − U|² at cell centres (`ke`, `Metrics.jl:33-35`)."""
    s = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    for i in range(u.shape[0]):
        Ui = 0.0 if U is None else U[i]
        s = s + (u[i] + shift(u[i], i, 1) - 2 * Ui) ** 2
    return 0.125 * s


def _jacobian_field(u: torch.Tensor) -> torch.Tensor:
    D = u.shape[0]
    return torch.stack([torch.stack([dudx(i, j, u) for j in range(D)])
                        for i in range(D)])


def lambda2_field(u: torch.Tensor) -> torch.Tensor:
    """λ₂ vortex criterion (`λ₂`, `Metrics.jl:54-58`): the middle eigenvalue
    of S² + Ω² at every cell, by batched `eigvalsh` in chunks of
    `LAMBDA2_CHUNK` cells."""
    J = _jacobian_field(u)                       # (3, 3, *sp)
    Jt = J.transpose(0, 1)
    S, O = (J + Jt) / 2, (J - Jt) / 2
    A = (torch.einsum("ik...,kj...->ij...", S, S)
         + torch.einsum("ik...,kj...->ij...", O, O))
    sp = A.shape[2:]
    Ab = A.reshape(3, 3, -1).permute(2, 0, 1)
    out = torch.empty(Ab.shape[0], dtype=u.dtype, device=u.device)
    for k in range(0, Ab.shape[0], LAMBDA2_CHUNK):
        out[k:k + LAMBDA2_CHUNK] = torch.linalg.eigvalsh(
            Ab[k:k + LAMBDA2_CHUNK])[:, 1]       # ascending
    return out.reshape(sp)


def _cyclic(i: int):
    return (i + 1) % 3, (i + 2) % 3


def curl_edge(i: int, u: torch.Tensor) -> torch.Tensor:
    """Component i of ∇×u at the cell edge (`curl`, `Metrics.jl:68-72`)."""
    j, k = _cyclic(i)
    return (u[k] - shift(u[k], j, -1)) - (u[j] - shift(u[j], k, -1))


def omega_field(u: torch.Tensor) -> torch.Tensor:
    """∇×u at cell centres (`ω`, `Metrics.jl:77-79`)."""
    comps = []
    for i in range(3):
        j, k = _cyclic(i)
        comps.append(dudx(k, j, u) - dudx(j, k, u))
    return torch.stack(comps)


def omega_mag_field(u: torch.Tensor) -> torch.Tensor:
    """|∇×u| (`ω_mag`, `Metrics.jl:84-86`)."""
    return torch.sqrt(torch.sum(omega_field(u) ** 2, dim=0))


def omega_theta_field(u: torch.Tensor, z, center) -> torch.Tensor:
    """Azimuthal vorticity ω·θ̂ about the axis ``z`` through ``center``
    (`ω_θ`, `Metrics.jl:91-97`); zero on the axis."""
    sp = tuple(u.shape[1:])
    x = loc_grid(None, sp, u.dtype, u.device)
    view = (3, 1, 1, 1)
    rel = x - torch.as_tensor(center, dtype=u.dtype, device=u.device).reshape(view)
    zz = torch.as_tensor(z, dtype=u.dtype, device=u.device).reshape(view)
    theta = torch.linalg.cross(zz.expand(rel.shape), rel, dim=0)
    n = torch.sqrt(torch.sum(theta ** 2, dim=0))
    dot = torch.sum(theta * omega_field(u), dim=0)
    return torch.where(n <= torch.finfo(u.dtype).eps, 0.0,
                       dot / torch.where(n == 0, 1.0, n))


def helicity_field(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Helicity density at the cells from a velocity and a vorticity field
    (`helicity`, `Metrics.jl:99-109`)."""
    s = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    for d in range(3):
        d1, d2 = _cyclic(d)
        umid = u[d] + shift(u[d], d, 1)
        acc = torch.zeros_like(s)
        for i1 in (0, 1):
            for i2 in (0, 1):
                acc = acc + shift(shift(w[d], d1, i1), d2, i2)
        s = s + umid * acc
    return s / 8


def vorticity(u: torch.Tensor) -> torch.Tensor:
    """2-D: ∂v/∂x − ∂u/∂y at cell centres; 3-D: |∇×u|."""
    if u.shape[0] == 2:
        return dudx(1, 0, u) - dudx(0, 1, u)
    return omega_mag_field(u)


def strain_field(u: torch.Tensor) -> torch.Tensor:
    """Rate-of-strain tensor S at cell centres (`S`, `Metrics.jl:140`)."""
    D = u.shape[0]
    return torch.stack([torch.stack([(dudx(i, j, u) + dudx(j, i, u)) / 2
                                     for j in range(D)]) for i in range(D)])


def _grid_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum of ``(D, *grid)`` over the grid axes, accumulated in float64."""
    return torch.sum(a.to(torch.float64), dim=tuple(range(1, a.dim())))


def _shell_body(body: Body) -> bool:
    """Whether `nds_field` may measure ``body`` on its shell ``sdf_at² ≤ 1``
    alone: an `AutoBody`, a `NoBody`, or a `SetBody` of them."""
    if type(body) is SetBody:
        return _shell_body(body.a) and _shell_body(body.b)
    return type(body) in (AutoBody, NoBody)


def nds_field(body: Body, shape: tuple[int, ...], t=0.0, dtype=torch.float32,
              device="cuda", offset=None) -> torch.Tensor:
    """BDIM-masked surface normal n·K(d) at every interior cell centre
    (`nds`, `Metrics.jl:116-119`); ghosts zero.  Shape ``(D, *shape)``.
    ``offset`` shifts a shard's local indices to global coordinates under
    domain decomposition.

    The port's own bodies (`AutoBody`, `NoBody` and `SetBody`s of them) are
    measured only where ``sdf_at² ≤ 1`` (or the distance is NaN), found by a
    distance-only pass and one device→host read (``wlt.read``, ``nds``);
    every other cell is zero, as in the dense measure.  Why that is exact:
    n·K(d) is nonzero only where the returned |d| < 1, since K(±1) = 0.  An
    `AutoBody` returns its raw distance wherever d² > ``fastd2`` = 1, so
    sdf > 1 gives d > 1 and sdf < −1 gives d < −1; a `SetBody`'s min, max and
    negation keep both implications.  Any other `Body` may not follow that
    rule and is measured at every cell.  The counters ``nds.points`` and
    ``nds.measured`` count the interior cells and the cells measured."""
    with tracing.span("wlt.nds_field"):
        D = len(shape)
        t = torch.as_tensor(t, dtype=dtype, device=device)
        pts = _interior_points(None, shape, dtype, device, offset=offset)
        N = pts.shape[0]
        tracing.count("nds.points", N)
        idx = None
        if _shell_body(body):
            sdf = vmap(lambda x: body.sdf_at(x, t))
            # the cells that `measure_at(…, fastd2=1.0)` does not skip
            near = torch.cat([~(d * d > 1.0) for d in map(sdf, pts.split(SDF_CHUNK))])
            with tracing.span("wlt.read", what="nds"):
                idx = torch.nonzero(near).squeeze(1)
            # gathered in the dense sweep's layout (rows of a (D, N) block):
            # a map's batched matmul then takes the same BLAS path, same bits
            pts = pts.T[:, idx].T
        tracing.count("nds.measured", pts.shape[0])
        if pts.shape[0] == 0:
            return torch.zeros((D,) + tuple(shape), dtype=dtype, device=device)
        d, n, _ = _measure_points(body, pts, t, 1.0)
        vals = n * kern(torch.clamp(d, -1.0, 1.0))[:, None]
        if idx is not None:
            vals = torch.zeros((N, D), dtype=vals.dtype, device=device).index_put(
                (idx,), vals)
        vals = vals.T.reshape((D,) + tuple(k - 2 for k in shape)).to(dtype)
        return torch.stack([grow(vals[i]) for i in range(D)])


def _offset(ctx, shape):
    """A shard's global index offset (`dist.offsets`); None on one device."""
    return None if ctx is None else offsets(ctx, tuple(shape))


def pressure_force(p: torch.Tensor, body: Body, t=0.0, ctx=None) -> torch.Tensor:
    """∮ p n dS over the body (`pressure_force`, `Metrics.jl:126-133`), a
    float64 ``(D,)`` tensor on ``p``'s device; under ``ctx`` each shard's
    integral at global coordinates, summed over the shards."""
    nds = nds_field(body, tuple(p.shape), t, p.dtype, p.device, _offset(ctx, p.shape))
    return psum_all(_grid_sum(p[None] * nds), ctx)


def viscous_force(u: torch.Tensor, nu, body: Body, t=0.0, ctx=None) -> torch.Tensor:
    """−∮ 2ν S·n dS (`viscous_force`, `Metrics.jl:147-154`), a float64
    ``(D,)`` tensor on ``u``'s device; under decomposition ``u``'s ghosts
    must hold halo values (a stepped state's do)."""
    nds = nds_field(body, tuple(u.shape[1:]), t, u.dtype, u.device,
                    _offset(ctx, u.shape[1:]))
    df = -2.0 * nu * torch.einsum("ij...,j...->i...", strain_field(u), nds)
    return psum_all(_grid_sum(df), ctx)


def total_force(sim) -> torch.Tensor:
    """Pressure + viscous force on the body of a `Simulation`
    (`total_force`, `Metrics.jl:160`); a `DistSimulation` sums its shards'
    (`DistSimulation.total_force`)."""
    with tracing.span("wlt.force"):
        if hasattr(sim, "shards"):
            return sim.total_force()
        st = sim.flow.state
        return (pressure_force(st.p, sim.body, sim.time)
                + viscous_force(st.u, st.nu, sim.body, sim.time))


def _cross_field(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of ``(D, *sp)`` fields: a ``(1, *sp)`` scalar in 2-D,
    a vector in 3-D."""
    if a.shape[0] == 2:
        return (a[0] * b[1] - a[1] * b[0])[None]
    return torch.linalg.cross(a, b, dim=0)


def _rel_coords(shape, x0, dtype, device, offset=None) -> torch.Tensor:
    D = len(shape)
    x = loc_grid(None, tuple(shape), dtype, device, offset)
    return x - torch.as_tensor(x0, dtype=dtype, device=device).reshape((D,) + (1,) * D)


def pressure_moment(x0, p: torch.Tensor, body: Body, t=0.0, ctx=None) -> torch.Tensor:
    """∮ p (x − x0)×n dS (`pressure_moment`, `Metrics.jl:166-173`), a
    float64 tensor on ``p``'s device: ``(1,)`` in 2-D, ``(3,)`` in 3-D."""
    offset = _offset(ctx, p.shape)
    nds = nds_field(body, tuple(p.shape), t, p.dtype, p.device, offset)
    rel = _rel_coords(p.shape, x0, p.dtype, p.device, offset)
    return psum_all(_grid_sum(p[None] * _cross_field(rel, nds)), ctx)


def viscous_moment(x0, u: torch.Tensor, nu, body: Body, t=0.0,
                   ctx=None) -> torch.Tensor:
    """−∮ 2ν (x − x0)×(S·n) dS (`viscous_moment`, `Metrics.jl:179-190`), a
    float64 tensor on ``u``'s device."""
    sp = tuple(u.shape[1:])
    offset = _offset(ctx, sp)
    nds = nds_field(body, sp, t, u.dtype, u.device, offset)
    Sn = torch.einsum("ij...,j...->i...", strain_field(u), nds)
    rel = _rel_coords(sp, x0, u.dtype, u.device, offset)
    return psum_all(_grid_sum(-2.0 * nu * _cross_field(rel, Sn)), ctx)


def total_moment(x0, sim) -> torch.Tensor:
    """Pressure + viscous moment about ``x0`` on the body of a `Simulation`
    (`total_moment`, `Metrics.jl:195-197`); a `DistSimulation` sums its
    shards'."""
    if hasattr(sim, "shards"):
        return sim.total_moment(x0)
    st = sim.flow.state
    return (pressure_moment(x0, st.p, sim.body, sim.time)
            + viscous_moment(x0, st.u, st.nu, sim.body, sim.time))


class MeanFlow:
    """Running averages of P, U (and, with ``uu_stats``, of u⊗u) over the
    flow's history (`MeanFlow`, `Metrics.jl:205-257`).  Built from a
    ``flow`` (its state's shapes, dtype, device and time) or from interior
    ``shape``, ``D``, ``dtype`` and ``device``."""

    def __init__(self, shape=None, D=None, flow=None, t_init=0.0,
                 uu_stats: bool = False, dtype=torch.float32, device="cuda"):
        if flow is not None:
            st = flow.state
            D, dtype, t_init = flow.cfg.D, flow.cfg.dtype, flow.time
            self.P = torch.zeros_like(st.p)
            self.U = torch.zeros_like(st.u)
            shape, device = tuple(st.p.shape), st.p.device
        else:
            shape = tuple(n + 2 for n in shape)   # interior dims, as the reference
            D = D or len(shape)
            self.P = torch.zeros(shape, dtype=dtype, device=device)
            self.U = torch.zeros((D,) + shape, dtype=dtype, device=device)
        self.UU = (torch.zeros((D, D) + shape, dtype=dtype, device=device)
                   if uu_stats else None)
        self.t = [float(t_init)]
        self.uu_stats = uu_stats

    @property
    def time(self) -> float:
        return self.t[-1] - self.t[0]

    def reset(self, t_init: float = 0.0):
        """Zero the averages and restart the window (`reset!`,
        `Metrics.jl:234-241`)."""
        self.P = torch.zeros_like(self.P)
        self.U = torch.zeros_like(self.U)
        if self.UU is not None:
            self.UU = torch.zeros_like(self.UU)
        self.t = [float(t_init)]

    def update(self, flow):
        """Blend in the flow's present fields with the weight dt/(dt + the
        window) (`update!`, `Metrics.jl:228-243`); the first update takes
        them whole."""
        dt = flow.time - self.t[-1]
        eps_w = dt / (dt + self.time + float(torch.finfo(self.P.dtype).eps))
        if len(self.t) == 1:
            eps_w = 1.0
        u, p = flow.state.u, flow.state.p
        self.P = eps_w * p + (1 - eps_w) * self.P
        self.U = eps_w * u + (1 - eps_w) * self.U
        if self.uu_stats:
            uu_now = torch.einsum("i...,j...->ij...", u, u)
            self.UU = eps_w * uu_now + (1 - eps_w) * self.UU
        self.t.append(self.t[-1] + dt)

    def uu(self) -> torch.Tensor:
        """Reynolds stresses ⟨u⊗u⟩ − Ū⊗Ū (`uu`, `Metrics.jl:246-253`)."""
        return self.UU - torch.einsum("i...,j...->ij...", self.U, self.U)
