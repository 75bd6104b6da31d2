"""Multi-device domain decomposition: `DistSimulation`.

PyTorch counterpart of `waterlily_tpu/parallel/dist.py`:

* the interior grid is split evenly over a mesh with axes ('x', 'y', 'z')
  mapped to the leading spatial dims;
* every shard stores its block in the same 1-ghost-padded layout as a
  single-device field, so the numerics run unchanged per shard
  (`flow.mom_step_impl` or `flowflat.mom_step_flat_impl` with a
  `dist.DistCtx`);
* ghost contents come from ring exchanges, one per stencil sweep, per
  smoother colour and per multigrid level; global reductions (CFL, residual
  norms, exit flux, gauge) are sums and maxima over the shards; multigrid
  levels too coarse to split are gathered and solved replicated.

As in the JAX package, one controller drives the mesh: a mesh is a list of
torch devices (`make_mesh`; repeats allowed, e.g. ``["cuda:0"] * 4``), one
persistent worker thread per shard runs the per-shard code (the body of the
JAX `shard_map`) and the collectives are rendezvous points of the in-process
`ops.dist.Communicator`.  A process-group communicator (one process per
card) is not in the JAX package and not here (ROADMAP).

``engine="auto"`` picks the x-decomposed flat engine where the JAX package
would (a 3-D multigrid flow split over x only, `flowflat.flat_supported`)
on CUDA float32 shards, and the 3d engine elsewhere, as `Simulation` does on
one device.  On the flat engine four kernels run on every shard after the
halo refresh: K14 `bdim_k`, K11 `div_k`, K16 `mult_k` and K6
(`fused3d.incr_gs_k` with no colours), with a ``udf`` too (the LES `sgs`
takes the halo ctx there: `utils/les.py`); the 3d engine is plain PyTorch
under decomposition, as the JAX gate `pallas3d.use_pallas(a, ctx)` has it,
but for ``psolver="pcg"``, whose solve (`ops/poisson.py` `solve` with the
shard's ctx, on the fine level alone, as the JAX package injects it) runs
K16 for every A·x of the conjugate gradient on every shard.

Forward-mode AD of a decomposed step is `torch.func.jvp` of each shard's
`flow.mom_step_impl(ctx=, n_dist=)` through ``pool.run``, entered with
`ops.dist.shard_jvp` (which keeps the shards' forward-mode levels nested);
the collectives carry the tangents (`ops/dist.py`) and the pressure solves
are `multigrid.solve_mg_implicit(ctx=, n_dist=)`.

The "blocked" host layout concatenates the padded local blocks, so a global
blocked array has ``k·(N/k + 2)`` cells per sharded dim; `to_blocked` and
`from_blocked` convert to and from the dense single-device layout (numpy,
the JAX functions' arithmetic).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..models import flow as fl
from ..models import flowflat as ff
from ..models.body import NoBody, measure_fill
from ..ops import _build
from ..ops import multigrid as mg
from ..ops.dist import DEFAULT_TIMEOUT, Communicator, ShardPool, make_ctx
from ..simulation import ENGINES, Simulation, _as_dtype, pcg_solve_fn
from ..utils import metrics as mt

__all__ = ["Mesh", "make_mesh", "to_blocked", "from_blocked", "DistSimulation"]

_NAMES = ("x", "y", "z")


class Mesh(NamedTuple):
    """A mesh of shards: its extent per axis, the axis names and the device
    of each shard in row-major order (repeats allowed)."""
    shape: tuple
    axis_names: tuple
    devices: tuple


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: Optional[Sequence[int]] = None, devices=None) -> Mesh:
    """A mesh with axes ('x', 'y', 'z')[:len(shape)] over ``devices`` (the
    first ``prod(shape)`` of them).  ``devices`` defaults to every visible
    CUDA device; with none the call raises (there is no CPU fallback: pass
    ``devices=["cpu"] * k`` for a CPU mesh).  ``shape`` defaults to
    ``(len(devices),)``."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                               "(e.g. ['cpu'] * 4) for a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    shape = (len(devices),) if shape is None else tuple(int(k) for k in shape)
    if not 1 <= len(shape) <= 3 or min(shape) < 1:
        raise ValueError(f"make_mesh: a mesh has 1 to 3 axes of extent >= 1, got {shape}")
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(f"make_mesh: {len(devices)} devices for a mesh of {n}")
    return Mesh(shape, _NAMES[:len(shape)], tuple(devices[:n]))


# ------------------------------------------------------------- blocked layout
def to_blocked(a, sizes: Sequence[int], lead: int = 0) -> np.ndarray:
    """Dense padded global array → blocked layout: per sharded dim the
    interior is split into ``k`` chunks and each chunk carries its own ghost
    layer (neighbour interior values, or the physical ghosts at the
    ends)."""
    a = np.asarray(a)
    for d, k in enumerate(sizes):
        if k == 1:
            continue
        ax = lead + d
        nl = (a.shape[ax] - 2) // k
        chunks = []
        for s in range(k):
            sl = [slice(None)] * a.ndim
            sl[ax] = slice(s * nl, s * nl + nl + 2)
            chunks.append(a[tuple(sl)])
        a = np.concatenate(chunks, axis=ax)
    return a


def from_blocked(a, sizes: Sequence[int], lead: int = 0) -> np.ndarray:
    """Inverse of `to_blocked` (drops the duplicate halo layers)."""
    a = np.asarray(a)
    for d, k in enumerate(sizes):
        if k == 1:
            continue
        ax = lead + d
        nl = a.shape[ax] // k          # local padded length
        parts = []
        for s in range(k):
            sl = [slice(None)] * a.ndim
            sl[ax] = slice(s * nl + (0 if s == 0 else 1),
                           (s + 1) * nl - (0 if s == k - 1 else 1))
            parts.append(a[tuple(sl)])
        a = np.concatenate(parts, axis=ax)
    return a


# the tensor axes that lead the spatial ones, per FlowState field
_LEAD = {"u": 1, "u0": 1, "p": 0, "V": 1, "mu0": 1, "mu1": 2}


@dataclasses.dataclass
class Shard:
    """One shard: its ctx, device, local `FlowState` and level stack."""
    ctx: object
    device: torch.device
    state: Optional[fl.FlowState] = None
    levels: tuple = ()


class DistSimulation:
    """Domain-decomposed drop-in for `Simulation`.

    Build a regular `Simulation` (dense, one device) and hand it over::

        sim = Simulation((256, 256, 256), (1, 0, 0), 32, body=sphere)
        dsim = DistSimulation(sim, make_mesh((4,), devices=["cuda:0"] * 4))
        dsim.sim_step_n(10)                   # or step_once / sim_step(t_end)
        u, p = dsim.u, dsim.p                 # dense layout (numpy)

    Every sharded interior dim must split evenly with >= 2 cells a shard,
    and at least the finest multigrid level must stay distributable.
    ``engine`` is "auto", "flat" (a 3-D flow split over x only) or "3d".
    ``timeout`` is the seconds a shard waits at a rendezvous before it
    raises.  ``psolver="pcg"`` runs on the 3d engine only, as in the JAX
    package.  The wrapped ``sim`` keeps the time-step and iteration
    history; its fields are the ones it was built with.  ``pool.streams``
    (one CUDA stream a shard) runs each shard's work on a stream of its
    own."""

    def __init__(self, sim: Simulation, mesh: Mesh, engine: str = "auto",
                 timeout: float = DEFAULT_TIMEOUT):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        cfg = sim.flow.cfg
        D = cfg.D
        if len(mesh.shape) > D:
            raise ValueError(f"a mesh of {len(mesh.shape)} axes for a {D}-D flow")
        self.mesh = mesh
        self.sizes = tuple(mesh.shape[d] if d < len(mesh.shape) else 1 for d in range(D))
        self.axes = tuple(_NAMES[d] if self.sizes[d] > 1 else None for d in range(D))
        for d, k in enumerate(self.sizes):
            n = cfg.shape[d] - 2
            if k > 1 and (n % k != 0 or n // k < 2):
                raise ValueError(f"dim {d}: interior {n} not evenly divisible over "
                                 f"{k} shards")
        self.pcg = sim.psolver == "pcg"
        if self.pcg:
            # the fine level alone, distributed (JAX `parallel/dist.py:182-186`)
            self.masks, self.n_dist = (), 1
        else:
            _, masks, n_dist = mg.dist_n_levels(cfg.shape, self.sizes,
                                                min_cells=sim._min_coarse)
            if n_dist < 1:
                raise ValueError("grid too small to distribute over this mesh")
            self.masks, self.n_dist = tuple(masks), n_dist
        flat_ok = (D == 3 and self.sizes[0] > 1 and all(k == 1 for k in self.sizes[1:])
                   and not self.pcg and ff.flat_supported(cfg))
        if engine == "flat" and not flat_ok:
            raise ValueError("the flat dist engine needs a 3-D multigrid flow "
                             "decomposed over the x mesh axis only")
        cuda32 = (all(d.type == "cuda" for d in mesh.devices)
                  and cfg.dtype == torch.float32)
        self.engine = ("flat" if engine == "flat" or (engine == "auto" and flat_ok
                                                      and cuda32) else "3d")
        self.sim, self.cfg = sim, cfg
        if any(d.type == "cuda" for d in mesh.devices):
            _build.load()      # build the kernels once, here, not in every worker
        self.comm = Communicator(mesh.shape, mesh.devices, timeout)
        self.pool = ShardPool(self.comm)
        weakref.finalize(self, self.pool.close)
        self.local_shape = tuple((n - 2) // k + 2 for n, k in zip(cfg.shape, self.sizes))
        self.shards = [Shard(make_ctx(self.axes, self.sizes, self.local_shape,
                                      self.comm, r), mesh.devices[r])
                       for r in range(self.comm.n)]
        self.solver_stats = None
        self._put_state(sim.flow.state)
        self.pool.run(self._build_levels)

    # ------------------------------------------------------------ layout
    def _block(self, a: torch.Tensor, lead: int, rank: int) -> torch.Tensor:
        """Shard ``rank``'s padded block of a dense padded field."""
        ctx = self.shards[rank].ctx
        for d, k in enumerate(self.sizes):
            if k > 1:
                nl = (a.shape[lead + d] - 2) // k
                a = a.narrow(lead + d, ctx.coords[d] * nl, nl + 2)
        return a.to(self.shards[rank].device).clone(memory_format=torch.contiguous_format)

    def _put_state(self, state: fl.FlowState) -> None:
        for r, sh in enumerate(self.shards):
            sh.state = fl.FlowState(
                **{k: self._block(getattr(state, k), lead, r) for k, lead in _LEAD.items()},
                nu=state.nu.to(sh.device))

    def _build_levels(self, rank: int) -> None:
        sh = self.shards[rank]
        sh.levels = mg.make_mg_dist(sh.state.mu0, sh.ctx, self.masks, self.n_dist,
                                    self.cfg.perdir)

    def _dense(self, get, lead: int) -> np.ndarray:
        """A field in the dense single-device layout, from every shard's
        block (``get(shard)``)."""
        blocks = [get(sh).detach().cpu().numpy() for sh in self.shards]
        shape = self.comm.mesh_shape

        def cat(axis, prefix):
            if axis == len(shape):
                r = 0
                for c, k in zip(prefix, shape):
                    r = r * k + c
                return blocks[r]
            return np.concatenate([cat(axis + 1, prefix + (c,)) for c in range(shape[axis])],
                                  axis=lead + axis)
        return from_blocked(cat(0, ()), self.sizes, lead)

    # ------------------------------------------------------------ accessors
    @property
    def flow(self):
        return self.sim.flow

    @property
    def time(self) -> float:
        return self.sim.flow.time

    @property
    def sim_time(self) -> float:
        return self.time * self.sim.U / self.sim.L

    @property
    def pois_n(self):
        return self.sim.flow.pois_n

    @property
    def U(self):
        return self.sim.U

    @property
    def L(self):
        return self.sim.L

    @property
    def eps(self):
        return self.sim.eps

    @property
    def body(self):
        return self.sim.body

    @property
    def state(self) -> list:
        """Every shard's local `FlowState` (padded blocks), in rank order."""
        return [sh.state for sh in self.shards]

    @property
    def levels(self) -> list:
        """Every shard's level stack: local blocks below ``n_dist``, the
        replicated tail after."""
        return [sh.levels for sh in self.shards]

    @property
    def u(self) -> np.ndarray:
        """Velocity in the dense single-device layout."""
        return self._dense(lambda sh: sh.state.u, 1)

    @property
    def p(self) -> np.ndarray:
        """Pressure in the dense single-device layout."""
        return self._dense(lambda sh: sh.state.p, 0)

    def sdf_field(self, t: Optional[float] = None) -> torch.Tensor:
        """Dense-layout signed distance of the body (the wrapped sim's: the
        geometry is replicated, nothing to gather)."""
        return self.sim.sdf_field(self.time if t is None else t)

    def restore_fields(self, u, p) -> None:
        """Load dense single-device-layout ``u`` and ``p`` (e.g. from a
        checkpoint) into every shard's state, ``u0`` as ``u``."""
        dtype = self.cfg.dtype
        u = torch.as_tensor(np.asarray(u), dtype=dtype)
        p = torch.as_tensor(np.asarray(p), dtype=dtype)
        for r, sh in enumerate(self.shards):
            ub = self._block(u, 1, r)
            sh.state = dataclasses.replace(sh.state, u=ub, u0=ub.clone(),
                                           p=self._block(p, 0, r))

    def close(self) -> None:
        """Stop the shards' worker threads (also done when collected)."""
        self.pool.close()

    # ------------------------------------------------------------ stepping
    def measure(self, t: Optional[float] = None) -> None:
        """Re-measure the body on every shard at global coordinates and
        rebuild the level stacks (`measure!` + `update!`,
        `WaterLily.jl:146-149`); each shard evaluates the sdf on its own
        block only."""
        if isinstance(self.sim.body, NoBody):
            return
        cfg = self.cfg
        if t is None:
            t = self.time + self.sim.flow.dt[-1]
        t = _as_dtype(t, cfg.dtype)

        def one(rank):
            sh = self.shards[rank]
            V, mu0, mu1, _ = measure_fill(self.sim.body, self.local_shape, t,
                                          float(self.sim.eps), cfg.dtype, sh.device,
                                          cfg.perdir, cfg.exit_bc, ctx=sh.ctx)
            sh.state = dataclasses.replace(sh.state, V=V, mu0=mu0, mu1=mu1)
            self._build_levels(rank)
        self.pool.run(one)

    def step_once(self, remeasure: bool = True, udf=None):
        """One CFL-limited time step of the decomposed flow (the distributed
        `mom_step!`); appends dt and the solver iterations to the wrapped
        sim's history like `Simulation.step_once`.  ``udf(f, state, u_adv,
        t)`` runs on every shard's block, as on the JAX package's engines:
        the 3d engine calls it as on one device, the flat engine hands a
        udf with a ``flat`` form (`utils.les.sgs`) the shard's ctx.  The
        shards' spans nest in this step's ``wlt.step``."""
        with tracing.span("wlt.step", step=len(self.sim.flow.dt), engine=self.engine):
            if remeasure:
                self.measure()
            cfg = self.cfg
            dt = _as_dtype(self.sim.flow.dt[-1], cfg.dtype)
            t0 = _as_dtype(self.time, cfg.dtype)
            flat = self.engine == "flat"

            def one(rank):
                sh = self.shards[rank]
                if flat:
                    out = ff.mom_step_flat_impl(cfg, sh.state, sh.levels, self.masks,
                                                dt, t0, udf, ctx=sh.ctx,
                                                n_dist=self.n_dist)
                else:
                    # the distributed PCG with this shard's ctx, or the multigrid
                    solve_fn = (functools.partial(pcg_solve_fn, ctx=sh.ctx)
                                if self.pcg else None)
                    out = fl.mom_step_impl(cfg, sh.state, sh.levels, self.masks, dt,
                                           t0, udf, solve_fn, ctx=sh.ctx,
                                           n_dist=self.n_dist)
                sh.state = out[0]
                with tracing.span("wlt.read", what="dt"):
                    dt_next = out[1].item()
                return dt_next, out[2], out[3]
            res = self.pool.run(one)
            dt_next, iters, stats = res[0]
            if any(r[0] != dt_next or r[1] != iters for r in res):
                raise RuntimeError(f"DistSimulation: the shards disagree on dt or the "
                                   f"iterations: {[r[:2] for r in res]}")
            self.sim.flow.dt.append(dt_next)
            self.sim.flow.pois_n += iters
            self.solver_stats = stats
        return self

    def sim_step_n(self, n: int, *, udf=None, remeasure: bool = False):
        """``n`` CFL steps: a host loop over `step_once` (as
        `Simulation.sim_step_n`)."""
        for _ in range(n):
            self.step_once(remeasure=remeasure, udf=udf)
        return self

    def sim_step(self, t_end: Optional[float] = None, *, remeasure: bool = True,
                 max_steps: int = 10**9, verbose: bool = False, udf=None):
        """Advance to ``t_end`` in convective units (`sim_step!`,
        `WaterLily.jl:128-139`), or one step when ``t_end`` is None."""
        if t_end is None:
            return self.step_once(remeasure, udf)
        steps = 0
        while self.sim_time < t_end and steps < max_steps:
            self.step_once(remeasure, udf)
            steps += 1
            if verbose:
                print(f"tU/L={self.sim_time:.4f}, dt={self.sim.flow.dt[-1]:.3f}")
        return self

    # ------------------------------------------------------------ metrics
    def _force_moment(self, x0=None):
        t = self.time

        def one(rank):
            sh = self.shards[rank]
            st, ctx = sh.state, sh.ctx
            body = self.sim.body
            f = (mt.pressure_force(st.p, body, t, ctx)
                 + mt.viscous_force(st.u, st.nu, body, t, ctx))
            if x0 is None:
                return f
            return (mt.pressure_moment(x0, st.p, body, t, ctx)
                    + mt.viscous_moment(x0, st.u, st.nu, body, t, ctx))
        return self.pool.run(one)[0]

    def total_force(self) -> torch.Tensor:
        """∮(p n − 2ν S·n) dS without gathering the fields: each shard's
        surface integral at global coordinates, summed over the shards
        (`total_force`, `Metrics.jl:160`)."""
        return self._force_moment()

    def total_moment(self, x0) -> torch.Tensor:
        """Pressure + viscous moment about ``x0``, summed over the shards
        (`total_moment`, `Metrics.jl:195-197`)."""
        return self._force_moment(tuple(float(v) for v in x0))
