"""Utilities of the port: diagnostics (`metrics`), sampling (`interp`),
the LES closure (`les`), solver logs (`log`), checkpoints and VTK (`io`),
tracer particles (`pathlines`), isosurfaces (`mesh`) and plots (`viz`).
The plotting functions import matplotlib only when called."""
from . import interp, io, les, log, mesh, metrics, pathlines, viz  # noqa: F401
from .interp import interp_scalar, interp_vector, spread, squeeze  # noqa: F401
from .mesh import body_mesh, marching_tetrahedra, viz3d  # noqa: F401
from .metrics import (MeanFlow, ke_field, lambda2_field, omega_field,  # noqa: F401
                      omega_mag_field, pressure_force, pressure_moment,
                      total_force, total_moment, viscous_force, viscous_moment,
                      vorticity)
