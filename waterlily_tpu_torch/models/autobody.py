"""Implicit geometry from signed-distance functions, differentiated with
`torch.func`.

PyTorch counterpart of `waterlily_tpu/models/autobody.py` (the port of
`src/AutoBody.jl`).  The normal, the map Jacobian and the map's time
derivative are `torch.func.grad`, `jacfwd` and `jvp` of the user's
closures, which must be written with torch ops on a ``(D,)`` point ``x`` and
a 0-d time ``t``; `models.body.measure_fill` batches them with `vmap`.
Parameterised maps (`RigidMap`) are not ported yet (ROADMAP queue 1,
item 5).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad, jacfwd, jvp

from .body import INF, Body

__all__ = ["AutoBody", "FnMap"]


class FnMap:
    """A plain ``map(x, t)`` callable."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, x, t):
        return self.fn(x, t)


def _identity_map(x, t):
    return x


class AutoBody(Body):
    """`AutoBody(sdf, map)` (`AutoBody.jl:1-13`): the distance is
    ``sdf(map(x, t), t)``."""

    def __init__(self, sdf: Callable, map: Optional[Callable] = None):
        self.sdf = sdf
        self.map = FnMap(_identity_map if map is None else map)

    def sdf_at(self, x, t):
        """`sdf(body,x,t) = body.sdf(body.map(x,t),t)` (`AutoBody.jl:19`)."""
        return self.sdf(self.map(x, t), t)

    def measure_at(self, x, t, fastd2=INF):
        """Distance, normal, velocity (`measure`, `AutoBody.jl:29-37`):
        n = ∇sdf in the body frame pulled back by Jᵀ (J = ∂map/∂x), the
        pseudo-sdf fix d /= |Jᵀn|, V = -J⁻¹ ∂map/∂t.  A NaN normal, a zero
        normal or d² > fastd2 returns ``(d, 0, 0)``, as selects."""
        xi = self.map(x, t)
        d = self.sdf(xi, t)
        n_b = grad(lambda z: self.sdf(z, t))(xi)
        nan = torch.any(torch.isnan(n_b))
        n_b = torch.where(torch.isnan(n_b), 0.0, n_b)
        J = jacfwd(lambda z: self.map(z, t))(x)
        dmdt = jvp(lambda tt: self.map(x, tt), (t,), (torch.ones_like(t),))[1]
        n = J.T @ n_b
        m = torch.sqrt(torch.sum(n**2))
        msafe = torch.where(m > 0, m, 1.0)
        V = -torch.linalg.solve(J, dmdt)
        skip = (d * d > fastd2) | nan | (m == 0)
        return (torch.where(skip, d, d / msafe),
                torch.where(skip, torch.zeros_like(n), n / msafe),
                torch.where(skip, torch.zeros_like(V), V))
