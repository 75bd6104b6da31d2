"""waterlily_tpu_torch — the PyTorch + CUDA port of `waterlily_tpu`.

The single-device flow past a static immersed body with the multigrid
pressure solver, on dense ``(D, Nx, Ny, Nz)`` tensors.  The hot 3-D stencils
run as hand-written CUDA kernels on the card (`ops.stencil3d`); the JAX
package stays the reference every part is tested against.  This package
imports torch and numpy, never JAX.
"""
from .models import (AutoBody, Body, Flow, FlowCfg, FlowState,  # noqa: F401
                     NoBody, cds, measure_fill, measure_sdf, quick, vanleer)
from .ops import bc, grid, multigrid, poisson, stencil3d  # noqa: F401
from .ops.stencil3d import launch_counts, plain_ops, use_kernels  # noqa: F401
from .simulation import Simulation  # noqa: F401

__version__ = "0.1.0"
