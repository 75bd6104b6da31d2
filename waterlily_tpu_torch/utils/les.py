"""Sub-grid-scale LES forcing through the udf hook.

PyTorch counterpart of `waterlily_tpu/utils/les.py` (the port of `sgs!`,
`src/util.jl:45-76`): the Boussinesq SGS stress −2·νt·S̄ is added to the
momentum RHS as a flux-difference body force, evaluated on the phase's
advecting velocity (u0 in the predictor, the projected u in the corrector).

The port's fields are dense on both engines, so the one implementation
serves both; the JAX package's second, ``udf.flat`` twin exists only for its
``(x, y·z)`` lane layout.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

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
    `util.jl:66-76`).  Use as ``sim.sim_step(..., udf=sgs(...))``."""
    nu_t_fn = nu_t_fn or smagorinsky()

    def udf(f, state, u_adv, t):
        D = f.shape[0]
        nu_t = nu_t_fn(strain_field(u_adv))
        out = []
        for i in range(D):
            fi = f[i]
            for j in range(D):
                flux = -nu_t * (u_adv[i] - shift(u_adv[i], j, -1))
                # restrict the flux to the reference's inside_u(N, j) range:
                # zero at the first interior and ghost slabs of dim j
                n = flux.shape[j]
                view = [1] * D
                view[j] = n
                idx = torch.arange(n, device=flux.device).reshape(view)
                flux = torch.where((idx >= 2) & (idx <= n - 2), flux, 0.0)
                fi = fi + (flux - shift(flux, j, 1))
            out.append(fi)
        return torch.stack(out)

    return udf
