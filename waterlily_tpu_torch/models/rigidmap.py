"""Rigid-body motion maps with an explicit velocity and Jacobian.

PyTorch counterpart of `waterlily_tpu/models/rigidmap.py` (the port of
`src/RigidMap.jl`).  `AutoBody.measure_at` takes ∂map/∂x and ∂map/∂t from
the map's `map_jacobian` and `map_velocity` instead of differentiating the
map.  The motion parameters are tensors; a `RigidMap` is immutable and
`setmap` builds the body anew with new parameters (nothing recompiles in
PyTorch, so the map needs no pytree).
"""
from __future__ import annotations

import torch

from .autobody import AutoBody
from .body import Body, NoBody, SetBody

__all__ = ["RigidMap", "rotation", "setmap", "cross2"]


def rotation(theta: torch.Tensor) -> torch.Tensor:
    """Rotation matrix: one angle in 2-D, x/y/z Euler angles in 3-D
    (`rotation`, `RigidMap.jl:47-50`)."""
    theta = torch.as_tensor(theta)
    if theta.dim() == 0:
        c, s = torch.cos(theta), torch.sin(theta)
        return torch.stack([torch.stack([c, s]), torch.stack([-s, c])])
    c1, s1 = torch.cos(theta[0]), torch.sin(theta[0])
    c2, s2 = torch.cos(theta[1]), torch.sin(theta[1])
    c3, s3 = torch.cos(theta[2]), torch.sin(theta[2])
    return torch.stack([
        torch.stack([c3 * c2, c3 * s2 * s1 + s3 * c1, -c3 * s2 * c1 + s3 * s1]),
        torch.stack([-s3 * c2, -s3 * s2 * s1 + c3 * c1, s3 * s2 * c1 + c3 * s1]),
        torch.stack([s2, -c2 * s1, c2 * c1]),
    ])


def cross2(a, b):
    """2-D scalar × vector cross product (`×`, `RigidMap.jl:46`)."""
    return a * torch.stack([-b[1], b[0]])


class RigidMap:
    """`RigidMap(x0, theta; xp, V, omega)` (`RigidMap.jl:28-38`)::

        map(x, t) = R (x − x0 − xp) + xp
        velocity  = −R (V + ω × (x − x0 − xp))
        jacobian  = R

    The parameters are tensors on the body's device (``xp``, ``V`` default
    to zeros like ``x0``, ``omega`` to zeros like ``theta``).  Drive it from
    the host and push new parameters with `setmap` each step
    (`RigidMap.jl:13-26`)."""

    def __init__(self, x0, theta, xp=None, V=None, omega=None, R=None):
        self.x0 = torch.as_tensor(x0)
        self.theta = torch.as_tensor(theta)
        self.xp = torch.zeros_like(self.x0) if xp is None else torch.as_tensor(xp)
        self.V = torch.zeros_like(self.x0) if V is None else torch.as_tensor(V)
        self.omega = (torch.zeros_like(self.theta) if omega is None
                      else torch.as_tensor(omega))
        self.R = rotation(self.theta) if R is None else R

    def __call__(self, x, t=0.0):
        return self.R @ (x - self.x0 - self.xp) + self.xp

    def map_jacobian(self, x, t):
        """∂map/∂x: the rotation matrix (`RigidMap.jl:39`)."""
        return self.R

    def map_velocity(self, x, t):
        """∂map/∂t = −R (V + ω × (x − x0 − xp)) (`RigidMap.jl:40-42`)."""
        r = x - self.x0 - self.xp
        w = (cross2(self.omega, r) if self.theta.dim() == 0
             else torch.linalg.cross(self.omega.expand_as(r), r))
        return -self.R @ (self.V + w)

    def replace(self, **kw) -> "RigidMap":
        """A copy with some parameters replaced; R follows theta
        (`constructorof`, `RigidMap.jl:53`)."""
        fields = dict(x0=self.x0, theta=self.theta, xp=self.xp, V=self.V,
                      omega=self.omega)
        fields.update(kw)
        return RigidMap(**fields)


def setmap(body: Body, **kwargs) -> Body:
    """Update the motion parameters of every `RigidMap` in a body tree
    (`setmap`, `RigidMap.jl:54-56`)."""
    if isinstance(body, SetBody):
        return SetBody(body.op, setmap(body.a, **kwargs), setmap(body.b, **kwargs))
    if isinstance(body, NoBody):
        return body
    if isinstance(body, AutoBody) and isinstance(body.map, RigidMap):
        return AutoBody(body.sdf, body.map.replace(**kwargs))
    return body
