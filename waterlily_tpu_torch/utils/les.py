"""Sub-grid-scale LES forcing through the udf hook.

PyTorch counterpart of `waterlily_tpu/utils/les.py` (the port of `sgs!`,
`src/util.jl:45-76`): the Boussinesq SGS stress −2·νt·S̄ is added to the
momentum RHS as a flux-difference body force, evaluated on the phase's
advecting velocity (u0 in the predictor, the projected u in the corrector).

The port's fields are dense on both engines, so the one implementation
serves both on one device; its ``udf.flat`` form (the JAX package's twin
for its ``(x, y·z)`` lane layout) differs only on a shard of the flat
engine decomposed over x, where it takes the halo ctx.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.dist import edge_hi, edge_lo, fetch_hi, sharded
from ..ops.grid import shift
from .metrics import strain_field

__all__ = ["smagorinsky", "sgs"]


def smagorinsky(Cs: float = 0.17, delta: float = 1.0) -> Callable:
    """Standard Smagorinsky-Lilly eddy viscosity νt = (Cs·Δ)²·√(S:S)
    (`util.jl:57-63`)."""

    def nu_t(S):
        return (Cs * delta) ** 2 * torch.sqrt(torch.sum(S**2, dim=(0, 1)))

    return nu_t


def sgs(nu_t_fn: Optional[Callable] = None):
    """Build a udf adding the SGS stress divergence to the RHS (`sgs!`,
    `util.jl:66-76`).  Use as ``sim.sim_step(..., udf=sgs(...))``.

    The udf carries a ``flat`` form, ``udf.flat(f, state, u_adv, t, ctx)``,
    that the flat engine calls on a shard of a flow decomposed over x (the
    JAX ``udf_flat`` under ``ctx``, `les.py:56-96`): the inside-u
    restriction of the x fluxes holds at the physical x boundaries only, an
    interior shard edge keeps its first-slab flux, and the ghost-slab flux
    is the right neighbour's first-slab flux (one ring exchange for the
    three components).  With ``ctx=None`` it is the udf itself.  The 3d
    engine calls the udf without the ctx, as the JAX package's does, so
    there the restriction also acts at every shard edge."""
    nu_t_fn = nu_t_fn or smagorinsky()

    def forcing(f, u_adv, ctx):
        D = f.shape[0]
        nu_t = nu_t_fn(strain_field(u_adv))

        def index(j, n):
            view = [1] * D
            view[j] = n
            return torch.arange(n, device=f.device).reshape(view)

        def flux_of(i, j):
            return -nu_t * (u_adv[i] - shift(u_adv[i], j, -1))

        xflux = None
        if ctx is not None and sharded(ctx, 0):
            n = f.shape[1]
            idx = index(0, n)
            keep = (idx <= n - 2) & (idx >= (2 if edge_lo(ctx, 0) else 1))
            xflux = torch.stack([torch.where(keep, flux_of(i, 0), 0.0)
                                 for i in range(D)])
            ghost = fetch_hi(ctx, xflux, 1, 0, 1)
            if edge_hi(ctx, 0):
                ghost = torch.zeros_like(ghost)
            xflux = torch.where(idx == n - 1, ghost, xflux)
        out = []
        for i in range(D):
            fi = f[i]
            for j in range(D):
                if j == 0 and xflux is not None:
                    flux = xflux[i]
                else:
                    flux = flux_of(i, j)
                    # restrict the flux to the reference's inside_u(N, j)
                    # range: zero at the first interior and ghost slabs of j
                    n = flux.shape[j]
                    idx = index(j, n)
                    flux = torch.where((idx >= 2) & (idx <= n - 2), flux, 0.0)
                fi = fi + (flux - shift(flux, j, 1))
            out.append(fi)
        return torch.stack(out)

    def udf(f, state, u_adv, t):
        return forcing(f, u_adv, None)

    def udf_flat(f, state, u_adv, t, ctx=None):
        return forcing(f, u_adv, ctx)

    udf.flat = udf_flat
    return udf
