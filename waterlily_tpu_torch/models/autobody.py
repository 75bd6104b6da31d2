"""Implicit geometry from signed-distance functions, differentiated with
`torch.func`.

PyTorch counterpart of `waterlily_tpu/models/autobody.py` (the port of
`src/AutoBody.jl`).  The normal, the map Jacobian and the map's time
derivative are `torch.func.grad`, `jacfwd` and `jvp` of the user's
closures, which must be written with torch ops on a ``(D,)`` point ``x`` and
a 0-d time ``t``; `models.body.measure_fill` batches them with `vmap`.
A map with an explicit ``map_jacobian``/``map_velocity`` (`RigidMap`,
`models.rigidmap`) gives them itself, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import grad, jacfwd, jvp

from .body import INF, Body

__all__ = ["AutoBody", "FnMap", "curvature"]


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
    ``sdf(map(x, t), t)``.  ``map`` is a callable ``map(x, t)``, or a map
    object with ``map_jacobian``/``map_velocity`` (`RigidMap`), kept as it
    is."""

    def __init__(self, sdf: Callable, map: Optional[Callable] = None):
        self.sdf = sdf
        if map is None:
            map = FnMap(_identity_map)
        elif not isinstance(map, FnMap) and not hasattr(map, "map_velocity"):
            map = FnMap(map)
        self.map = map

    def sdf_at(self, x, t):
        """`sdf(body,x,t) = body.sdf(body.map(x,t),t)` (`AutoBody.jl:19`)."""
        return self.sdf(self.map(x, t), t)

    def measure_at(self, x, t, fastd2=INF):
        """Distance, normal, velocity (`measure`, `AutoBody.jl:29-37`):
        n = ∇sdf in the body frame pulled back by Jᵀ (J = ∂map/∂x), the
        pseudo-sdf fix d /= |Jᵀn|, V = -J⁻¹ ∂map/∂t; J and ∂map/∂t come
        from the map's ``map_jacobian``/``map_velocity`` where it has them
        (`autobody.py:71-76` of the JAX package).  A NaN normal, a zero
        normal or d² > fastd2 returns ``(d, 0, 0)``, as selects."""
        xi = self.map(x, t)
        d = self.sdf(xi, t)
        n_b = grad(lambda z: self.sdf(z, t))(xi)
        nan = torch.any(torch.isnan(n_b))
        n_b = torch.where(torch.isnan(n_b), 0.0, n_b)
        if hasattr(self.map, "map_jacobian"):
            J = self.map.map_jacobian(x, t)
            dmdt = self.map.map_velocity(x, t)
        else:
            J = jacfwd(lambda z: self.map(z, t))(x)
            # forward mode gives a float64 tangent to a 0-d float32 map
            # (a 2-D map built of scalars times Python floats): cast back
            dmdt = jvp(lambda tt: self.map(x, tt), (t,),
                       (torch.ones_like(t),))[1].to(J.dtype)
        n = J.T @ n_b
        m = torch.sqrt(torch.sum(n**2))
        msafe = torch.where(m > 0, m, 1.0)
        V = -torch.linalg.solve(J, dmdt)
        skip = (d * d > fastd2) | nan | (m == 0)
        return (torch.where(skip, d, d / msafe),
                torch.where(skip, torch.zeros_like(n), n / msafe),
                torch.where(skip, torch.zeros_like(V), V))


def curvature(A: torch.Tensor):
    """Mean and Gaussian curvature ``(H, K)`` from the sdf Hessian ``A``
    (`curvature`, `AutoBody.jl:46-52`); K is 0 in 2-D."""
    H = 0.5 * torch.trace(A)
    if A.shape == (3, 3):
        K = (A[0, 0] * A[1, 1] + A[0, 0] * A[2, 2] + A[1, 1] * A[2, 2]
             - A[0, 1] ** 2 - A[0, 2] ** 2 - A[1, 2] ** 2)
    else:
        K = torch.zeros_like(H)
    return H, K
