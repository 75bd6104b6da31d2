"""waterlily_tpu_torch — the PyTorch + CUDA port of `waterlily_tpu`.

The single-device flow past a static immersed body with the multigrid
pressure solver, on dense ``(D, Nx, Ny, Nz)`` tensors, with periodic
directions, the convective outlet, a callable initial or boundary velocity,
a body force, the ``udf`` forcing hook (`utils.les` is the Smagorinsky LES)
and mixed-precision smoothing, stepped by the generic engine (`models.flow`,
``engine="3d"``) or the fused flat engine (`models.flowflat`,
``engine="flat"``, what ``"auto"`` picks on CUDA), and the force and
vorticity metrics of `utils.metrics`.  The hot 3-D stencils run as
hand-written CUDA kernels on the card (`ops.stencil3d`, `ops.fused3d`;
`ops.probe` holds the bandwidth probes); the JAX package stays the
reference every part is tested against.  Entry points run on the card unless the caller passes
``device="cpu"``.  This package imports torch and numpy, never JAX.
"""
from .models import (AutoBody, Body, Flow, FlowCfg, FlowState,  # noqa: F401
                     NoBody, cds, flowflat, measure_fill, measure_sdf, quick,
                     vanleer)
from .ops import (bc, fused3d, grid, mgflat, multigrid, poisson,  # noqa: F401
                  probe, stencil3d)
from .ops.stencil3d import launch_counts, plain_ops, use_kernels  # noqa: F401
from .simulation import Simulation  # noqa: F401
from .utils import les, metrics  # noqa: F401

__version__ = "0.1.0"
