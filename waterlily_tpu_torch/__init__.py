"""waterlily_tpu_torch — the PyTorch + CUDA port of `waterlily_tpu`.

2-D and 3-D flow past static or moving immersed bodies (`AutoBody` with a
map callable or a `RigidMap`, CSG `SetBody`, re-measured on a box around the
body) on dense ``(D, Nx, Ny[, Nz])`` tensors, with the multigrid pressure
solver or the injected PCG solver (``psolver="pcg"``), an injected flow
class (``flow_ctor``), periodic directions, the convective outlet, a
callable initial or boundary velocity, a body force, the ``udf`` forcing
hook (`utils.les` is the Smagorinsky LES) and mixed-precision smoothing,
stepped by the generic engine (`models.flow`, ``engine="3d"``) or the fused
flat engine (`models.flowflat`, ``engine="flat"``, what ``"auto"`` picks on
CUDA in 3-D), on one device or decomposed over a mesh of shards
(`parallel.DistSimulation`, one worker thread a shard and ring halo
exchanges; four shards may share one card).  `utils` holds the metrics
(forces, moments, vorticity, λ₂, running means), sampling, solver logs,
npz and VTK checkpoints, tracer particles, isosurfaces and plots.  The hot 3-D stencils run as
hand-written CUDA kernels on the card (`ops.stencil3d`, `ops.fused3d`;
`ops.probe` holds the bandwidth probes); the JAX package stays the
reference every part is tested against.  Entry points run on the card
unless the caller passes ``device="cpu"``.  This package imports torch and
numpy (and matplotlib inside the plotting functions), never JAX.
"""
from .models import (AutoBody, Body, Flow, FlowCfg, FlowState,  # noqa: F401
                     NoBody, RigidMap, SetBody, cds, curvature, flowflat,
                     measure_fill, measure_sdf, quick, rotation, setmap,
                     vanleer)
from .ops import (bc, dist, fused3d, grid, mgflat, multigrid,  # noqa: F401
                  poisson, probe, stencil3d)
from .ops.stencil3d import launch_counts, plain_ops, use_kernels  # noqa: F401
from .parallel import DistSimulation, make_mesh  # noqa: F401
from .simulation import Simulation, pcg_solve_fn  # noqa: F401
from .utils import interp, io, les, log, mesh, metrics, pathlines, viz  # noqa: F401

__version__ = "0.1.0"
