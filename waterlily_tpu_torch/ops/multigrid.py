"""Geometric multigrid with semi-coarsening for the pressure Poisson equation.

PyTorch counterpart of `waterlily_tpu/ops/multigrid.py` (the port of
`src/MultiLevelPoisson.jl`).  The level stack is a tuple of `PoissonLevel`s
whose shapes and coarsening masks are plain Python data; restriction and
prolongation are pair sums and `repeat_interleave` on the interior.

The outer iteration (`MultiLevelPoisson.jl:108-128`) is a host loop: each
iteration reads ``(L1, Linf)`` of the residual back once, tests the
dual-norm stop and updates the adaptive relaxation ω on the host in the
working dtype, exactly as the JAX `lax.while_loop` does on the device.
Periodic directions (``perdir``) reach every level: the coarse coefficients
take the periodic zero-velocity BC (so each level's diagonal sees the wrap
face), the smoothers and increments refresh periodic ghosts, the dense
coarse pseudo-inverse is that of the periodic operator, and the solution's
periodic ghosts are refreshed after the gauge.

Distributed (``ctx``, ``n_dist``; `ops/dist.py`): the levels below
``n_dist`` hold each shard's local block (`make_mg_dist`, ghosts from the
ring BC) and smooth with halo-refreshed ghosts; at level ``n_dist − 1`` the
V-cycle gathers the residual, runs the coarser levels replicated on every
shard with the single-device code, and slices the correction back
(`v_cycle`); the norms, means and the gauge are sums over the shards.
`dist_n_levels` decides where the split stops.

`solve_mg_implicit` is `solve_mg` with the exact implicit forward-mode rule
of the JAX package (`multigrid.py:365-417`): under `torch.func.jvp`,
`jacfwd` or `torch.autograd.forward_ad` the tangent of ``A(L) x = z`` is
the solve of ``A ẋ = ż − Ȧ(L̇, Ḋ)·x`` with the same multigrid and
tolerance, warm-started from the warm start's tangent.  Differentiating
through the host loop instead would give lagged tangents (the loop stops
when the primal converges, `multigrid.py:371-376` of the JAX package).
Both solves run inside `torch.autograd.Function` forwards, on plain tensors,
so that on the card they launch the kernels (K15, K16, K13); `iteration_log`
collects the iteration counts of the primal and tangent solves.  On a shard
of a decomposed flow (``ctx``, ``n_dist``) the rule is the same with the
distributed solves (a jvp of a decomposed step: `dist.shard_jvp`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from .bc import bc_vector
from .dist import gather_scalar, psum_all, slice_local, sync_scalar
from .grid import grow, interior
from .poisson import (PoissonLevel, _inside_ones, _mult_raw, coarse_solve,
                      dense_pinv, gauss_seidel_rb, increment, jacobi,
                      make_level, norms, residual, stop_tolerances)
from .stencil3d import _loop_vmap, ad_active

__all__ = [
    "divisible", "coarsen_mask", "coarse_shape", "level_shapes",
    "restrict", "prolongate", "restrict_L", "make_mg", "update_mg",
    "dist_n_levels", "make_mg_dist", "v_cycle", "solve_loop", "solve_mg",
    "solve_mg_implicit", "iteration_log", "canonical_gauge", "MGSolveResult", "MIN_COARSE_CELLS",
]

# interior-cell floor of the coarse levels on the flow path (the JAX
# package's `_MIN_COARSE_CELLS` default)
MIN_COARSE_CELLS = 64


def divisible(n: int) -> bool:
    """A padded dimension can be coarsened if even and > 4
    (`MultiLevelPoisson.jl:52`)."""
    return n % 2 == 0 and n > 4


def coarsen_mask(shape: tuple[int, ...]) -> tuple[bool, ...]:
    """Per-direction semi-coarsening decision (`MultiLevelPoisson.jl:29-31`)."""
    return tuple(divisible(n) for n in shape)


def coarse_shape(shape: tuple[int, ...], c: tuple[bool, ...]) -> tuple[int, ...]:
    """Padded shape one level down (`MultiLevelPoisson.jl:52-54`)."""
    return tuple(1 + n // 2 if ci else n for n, ci in zip(shape, c))


def level_shapes(shape: tuple[int, ...], maxlevels: int = 10,
                 min_cells: int = 0):
    """Shapes and per-transition coarsening masks of the level stack
    (`MultiLevelPoisson.jl:68-77`); ``min_cells > 0`` stops before a level
    would drop below that interior-cell count once three levels exist."""
    shapes, masks = [tuple(shape)], []
    while any(coarsen_mask(shapes[-1])) and len(shapes) <= maxlevels:
        c = coarsen_mask(shapes[-1])
        nxt = coarse_shape(shapes[-1], c)
        if len(shapes) >= 3 and math.prod(n - 2 for n in nxt) < min_cells:
            break
        masks.append(c)
        shapes.append(nxt)
    if len(shapes) <= 2:
        raise ValueError("MultiLevelPoisson requires size=a2^n, where n>2")
    return shapes, masks


def _pair_sum(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum adjacent pairs along ``axis`` (even length)."""
    n = a.shape[axis]
    lo = (slice(None),) * axis + (slice(0, n, 2),)
    hi = (slice(None),) * axis + (slice(1, n, 2),)
    return a[lo] + a[hi]


def restrict(b: torch.Tensor, c: tuple[bool, ...]) -> torch.Tensor:
    """Residual restriction: sum the fine children of each coarse cell
    (`restrict`, `MultiLevelPoisson.jl:16-19,49`)."""
    a = interior(b)
    for d, ci in enumerate(c):
        if ci:
            a = _pair_sum(a, d)
    return grow(a)


def prolongate(b: torch.Tensor, c: tuple[bool, ...]) -> torch.Tensor:
    """Injection prolongation: each fine interior cell copies its coarse
    parent, ghosts zero (`MultiLevelPoisson.jl:8,50`)."""
    a = interior(b)
    for d, ci in enumerate(c):
        if ci:
            a = torch.repeat_interleave(a, 2, dim=d)
    return grow(a)


def restrict_L(Lf: torch.Tensor, c: tuple[bool, ...],
               perdir: tuple[int, ...] = (), ctx=None) -> torch.Tensor:
    """Restrict face coefficients (`restrictL`, `MultiLevelPoisson.jl:10-26,
    42-47`): the face-normal direction keeps the fine face at the pair start
    and is halved when coarsened; tangential coarsened directions pair-sum;
    boundary faces come from the zero-velocity vector BC (periodic in
    ``perdir``; ring halos between shards under ``ctx``)."""
    D = Lf.shape[0]
    comps = []
    for i in range(D):
        a = interior(Lf[i])
        for d, ci in enumerate(c):
            if not ci:
                continue
            if d == i:
                n = a.shape[d]
                a = a[(slice(None),) * d + (slice(0, n, 2),)]
            else:
                a = _pair_sum(a, d)
        if c[i]:
            a = a / 2
        comps.append(grow(a))
    return bc_vector(torch.stack(comps), (0.0,) * D, perdir=perdir, ctx=ctx)


def make_mg(mu0: torch.Tensor, maxlevels: int = 10, min_cells: int = 0,
            perdir: tuple[int, ...] = ()):
    """Level stack from the fine face coefficients; returns
    ``(levels, masks)`` with ``masks`` plain Python data."""
    _, masks = level_shapes(tuple(mu0.shape[1:]), maxlevels, min_cells)
    return update_mg(tuple(masks), mu0, perdir), tuple(masks)


def update_mg(masks, mu0: torch.Tensor, perdir: tuple[int, ...] = ()):
    """Re-restrict the coefficients down every level (`update!`,
    `MultiLevelPoisson.jl:79-86`) and attach the coarsest level's dense
    pseudo-inverse."""
    new = [make_level(mu0)]
    L = mu0
    for c in masks:
        L = restrict_L(L, c, perdir)
        new.append(make_level(L))
    new[-1] = dense_pinv(new[-1], perdir)
    return tuple(new)


def dist_n_levels(global_shape: tuple[int, ...], sizes: tuple[int, ...],
                  maxlevels: int = 10, min_cells: int = 0):
    """Level shapes and masks plus the length of the distributed prefix: a
    level stays distributed while every split dim keeps an even split with
    at least 2 interior cells a shard; the coarser levels, and always the
    coarsest (its dense solve must see the global grid, as on one device),
    are replicated (the coarse-grid gather)."""
    shapes, masks = level_shapes(global_shape, maxlevels, min_cells)

    def dist_ok(shape):
        for d, k in enumerate(sizes):
            if k > 1:
                n = shape[d] - 2
                if n % k != 0 or n // k < 2:
                    return False
        return True

    n_dist = 0
    for sh in shapes:
        if not dist_ok(sh):
            break
        n_dist += 1
    return shapes, masks, min(n_dist, len(shapes) - 1)


def make_mg_dist(mu0_local: torch.Tensor, ctx, masks, n_dist: int,
                 perdir: tuple[int, ...] = ()):
    """The level stack of one shard from its local-block ``mu0``: the levels
    below ``n_dist`` are local blocks (ghosts from the ring zero-velocity
    BC), the tail is built from the gathered global coefficients with the
    single-device code and replicated on every shard, the coarsest with its
    dense pseudo-inverse (`update!`, `MultiLevelPoisson.jl:79-86`)."""
    D = mu0_local.shape[0]
    levels = [make_level(mu0_local)]
    L = mu0_local
    distributed = True
    for idx, c in enumerate(masks):
        if distributed and idx + 1 >= n_dist:
            # the transition: gather the fine coefficients and restore the
            # global ghost convention
            Lg = torch.stack([gather_scalar(L[i], ctx) for i in range(D)])
            L = bc_vector(Lg, (0.0,) * D, perdir=perdir)
            distributed = False
        L = restrict_L(L, c, perdir, ctx if distributed else None)
        levels.append(make_level(L))
    if not distributed:
        levels[-1] = dense_pinv(levels[-1], perdir)
    return tuple(levels)


def v_cycle(levels, masks, x: torch.Tensor, r: torch.Tensor, omega,
            l: int = 0, smooth_it: int = 4, presmooth: bool = True,
            perdir: tuple[int, ...] = (), ctx=None, n_dist: int = 0):
    """One V-cycle (`Vcycle!`, `MultiLevelPoisson.jl:88-101`): Jacobi
    pre-smooth, restrict the residual, recurse, coarse solve, prolongate and
    increment.

    Distributed (``ctx``): the levels below ``n_dist`` are local blocks
    smoothed with halo refreshes; at level ``n_dist − 1`` the residual is
    gathered, the coarser levels run replicated with the single-device code
    and the correction is sliced back (the JAX transition always smooths
    first, `multigrid.py:189-201`)."""
    fine, coarse = levels[l], levels[l + 1]
    c = masks[l]
    if ctx is not None and l == n_dist - 1:
        x, r = jacobi(fine, x, r, it=1, omega=1.0, perdir=perdir, ctx=ctx)
        eps = gathered_correction(levels, masks, r, omega, l, smooth_it, perdir, ctx)
        return increment(fine, x, r, eps, omega, perdir, ctx)
    here = ctx if l < n_dist else None
    if presmooth or l > 0:
        x, r = jacobi(fine, x, r, it=1, omega=1.0, perdir=perdir, ctx=here)
    rc = restrict(r, c)
    xc = torch.zeros_like(rc)
    if l + 1 < len(levels) - 1:
        xc, rc = v_cycle(levels, masks, xc, rc, omega, l + 1, smooth_it,
                         perdir=perdir, ctx=ctx, n_dist=n_dist)
    xc, rc = coarse_solve(coarse, xc, rc, it=smooth_it, omega=omega,
                          perdir=perdir,
                          ctx=ctx if l + 1 < n_dist else None)
    eps = prolongate(xc, c)
    return increment(fine, x, r, eps, omega, perdir, here)


def gathered_correction(levels, masks, r: torch.Tensor, omega, l: int,
                        smooth_it: int, perdir: tuple[int, ...], ctx) -> torch.Tensor:
    """The coarse-grid gather at the last distributed level ``l``: the
    residual gathered and restricted, the coarser levels (replicated on
    every shard) smoothed with the single-device code, and this shard's
    block of the prolongated correction."""
    c = masks[l]
    rc = restrict(gather_scalar(r, ctx), c)
    xc = torch.zeros_like(rc)
    if l + 1 < len(levels) - 1:
        xc, rc = v_cycle(levels, masks, xc, rc, omega, l + 1, smooth_it,
                         perdir=perdir)
    xc, rc = coarse_solve(levels[l + 1], xc, rc, it=smooth_it, omega=omega,
                          perdir=perdir)
    return slice_local(prolongate(xc, c), ctx)


class MGSolveResult(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    iters: int
    stats: list          # per iteration (r_inf, r_1, omega), row 0 = entry


def solve_loop(p, x: torch.Tensor, z: torch.Tensor, tol: float, itmx: int,
               iterate, perdir: tuple[int, ...] = (), ctx=None,
               resid=residual) -> MGSolveResult:
    """The outer iteration of `solver!` (`MultiLevelPoisson.jl:108-128`): a
    do-while of ``iterate(x, r, omega) -> (x, r, norms)`` (``norms`` the
    device 2-vector ``(L1, Linf)`` of the new residual, read back once per
    iteration), adaptive ω ∈ [0.2, 1] (×0.9 when the L1 norm did not drop,
    ×1.02 when it did) and the dual-norm stop ``L1 < tol/10·N`` ∧
    ``Linf < tol``, then `canonical_gauge` on the fine level ``p`` and the
    periodic ghost refresh of the solution.  ``resid(p, x, z, perdir,
    ctx)`` is the entry residual.  Under ``ctx`` the norms are global and
    the same on every shard, bit for bit, so every shard takes the same
    path; the solution's ghosts are halo-refreshed."""
    with tracing.span("wlt.solve") as sp:
        npdt = np.dtype(str(x.dtype).replace("torch.", ""))
        r1tol, rinf_tol = stop_tolerances(x, tol, ctx)
        r = resid(p, x, z, perdir, ctx)
        nv = torch.stack(norms(r, ctx))
        with tracing.span("wlt.read", what="norms"):
            r1, rinf = nv.tolist()     # one device→host read
        omega = npdt.type(1.0)
        stats = [(rinf, r1, float(omega))]
        n = 0
        while n < itmx and (n == 0 or not (r1 < r1tol and rinf < rinf_tol)):
            x, r, nv = iterate(x, r, float(omega))
            with tracing.span("wlt.read", what="norms"):
                rnew, rinf = nv.tolist()
            if rnew >= r1:
                omega = max(npdt.type(0.2), npdt.type(0.9) * omega)
            else:
                omega = min(npdt.type(1.0), npdt.type(1.02) * omega)
            r1 = rnew
            n += 1
            stats.append((rinf, r1, float(omega)))
        x = sync_scalar(canonical_gauge(x, p.iD, ctx), ctx, perdir)
        sp.set(iters=n)
    return MGSolveResult(x, r, n, stats)


def solve_mg(levels, masks, x: torch.Tensor, z: torch.Tensor,
             tol: float = 2e-3, itmx: int = 32, smooth_it: int = 4,
             fine_smooth_it: int = 0, fine_presmooth: bool = True,
             perdir: tuple[int, ...] = (), ctx=None,
             n_dist: int = 0) -> MGSolveResult:
    """Multigrid pressure solve (`solver!`, `MultiLevelPoisson.jl:108-128`):
    `solve_loop` over a V-cycle plus the fine red-black smooth; distributed
    with ``ctx`` and ``n_dist >= 1`` (`v_cycle`)."""
    p = levels[0]
    fine_ctx = ctx if n_dist > 0 else None

    def iterate(x, r, omega):
        x, r = v_cycle(levels, masks, x, r, omega, 0, smooth_it,
                       presmooth=fine_presmooth, perdir=perdir, ctx=ctx,
                       n_dist=n_dist)
        x, r = gauss_seidel_rb(p, x, r, it=fine_smooth_it or smooth_it,
                               omega=omega, perdir=perdir, ctx=fine_ctx)
        return x, r, torch.stack(norms(r, fine_ctx))

    return solve_loop(p, x, z, tol, itmx, iterate, perdir, fine_ctx)


def canonical_gauge(x: torch.Tensor, iD: torch.Tensor, ctx=None) -> torch.Tensor:
    """Pin the pressure representative (JAX `canonical_gauge`): active
    interior cells (iD ≠ 0) get zero mean, dead interior cells get zero,
    ghosts keep their values; the mean is global under ``ctx``."""
    inside = _inside_ones(x)
    act = torch.where(iD != 0, inside, 0.0)
    n_act = psum_all(torch.sum(act), ctx)
    m = psum_all(torch.sum(x * act), ctx) / torch.clamp(n_act, min=1.0)
    return torch.where(act > 0, x - m, x * (1.0 - inside))


# ---------------------------------------------------------------- implicit JVP
# the list that `iteration_log` collects into, or None
_ITER_LOG = contextvars.ContextVar("waterlily_tpu_torch_mg_iteration_log",
                                   default=None)


@contextlib.contextmanager
def iteration_log():
    """Collect the iteration count of every solve of `solve_mg_implicit`
    inside the block, in call order: under forward-mode AD each call adds
    its primal solve's count, then its tangent solve's (one per tangent
    under `jacfwd`); without AD the primal's alone."""
    log: list[int] = []
    token = _ITER_LOG.set(log)
    try:
        yield log
    finally:
        _ITER_LOG.reset(token)


def _record(n: int) -> None:
    log = _ITER_LOG.get()
    if log is not None:
        log.append(n)


class _Spec:
    """The non-tensor part of a `solve_mg_implicit` call: the coarsening
    masks, the solver options, the layout of the flattened level stack, and
    the primal solve's iterations and statistics once it has run."""

    def __init__(self, masks, opts, layout):
        self.masks, self.opts, self.layout = masks, opts, layout
        self.iters, self.stats = 0, []


def _flatten(levels) -> tuple[list, tuple]:
    """The tensors of a level stack as one list (``L, D, iD`` a level, then
    ``Ainv`` and the bf16 copies where a level has them) and its layout.
    `torch.autograd.Function` unwraps only tensors passed as arguments of
    their own: one left inside a `PoissonLevel` would stay wrapped under
    `torch.func` and reach a kernel's ``data_ptr()``."""
    flat, layout = [], []
    for p in levels:
        flat += [p.L, p.D, p.iD]
        if p.Ainv is not None:
            flat.append(p.Ainv)
        if p.bf is not None:
            flat += list(p.bf)
        layout.append((p.Ainv is not None, p.bf is not None))
    return flat, tuple(layout)


def _unflatten(flat, layout):
    levels, k = [], 0
    for has_ainv, has_bf in layout:
        L, D, iD = flat[k:k + 3]
        k += 3
        ainv = bf = None
        if has_ainv:
            ainv, k = flat[k], k + 1
        if has_bf:
            bf, k = tuple(flat[k:k + 3]), k + 3
        levels.append(PoissonLevel(L, D, iD, ainv, bf))
    return tuple(levels)


class _ImplicitSolve(torch.autograd.Function):
    """`solve_mg` (forward) with the implicit rule (`jvp`): the tangent solve
    `_TangentSolve`, a Function of its own so that it, too, runs on plain
    tensors under `torch.func`."""

    @staticmethod
    def forward(x, z, spec, *flat):
        res = solve_mg(_unflatten(flat, spec.layout), spec.masks, x, z, **spec.opts)
        spec.iters, spec.stats = res.iters, res.stats
        _record(res.iters)
        return res.x, res.r

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, ctx.spec, *flat = inputs
        # coefficients without a tangent come as None (not zeros): no Ȧx
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(output[0], *flat)

    @staticmethod
    def jvp(ctx, dx0, dz, _spec, *dflat):
        xs, *flat = ctx.saved_tensors
        # the fine level's coefficient tangents; the coarse levels only
        # precondition, so theirs do not enter
        return _TangentSolve.apply(xs, dx0, dz, dflat[0], dflat[1], ctx.spec, *flat)


_ImplicitSolve.vmap = _loop_vmap(_ImplicitSolve)


class _TangentSolve(torch.autograd.Function):
    """``A ẋ = ż − Ȧ(L̇, Ḋ)·x`` by `solve_mg` from the warm start ``ẋ0``;
    ``None`` tangents are zeros.  ``A`` is linear in ``(L, D)``, so ``Ȧ·x``
    is the operator of ``(L̇, Ḋ)`` applied to the solution (`_mult_raw`:
    K16 on the card; on a shard the solution's halo refreshed first and
    plain PyTorch).  Ends in `canonical_gauge`, as the primal solve."""

    @staticmethod
    def forward(xs, dx0, dz, dL, dD, spec, *flat):
        rhs = torch.zeros_like(xs) if dz is None else dz.contiguous()
        if dL is not None or dD is not None:
            dL = torch.zeros((xs.dim(),) + xs.shape, dtype=xs.dtype,
                             device=xs.device) if dL is None else dL.contiguous()
            dD = torch.zeros_like(xs) if dD is None else dD.contiguous()
            ctx = spec.opts["ctx"] if spec.opts["n_dist"] > 0 else None
            if ctx is not None:
                xs = sync_scalar(xs, ctx, spec.opts["perdir"])
            rhs = rhs - _mult_raw(PoissonLevel(dL, dD, None), xs, ctx)
        x0 = torch.zeros_like(xs) if dx0 is None else dx0.contiguous()
        res = solve_mg(_unflatten(flat, spec.layout), spec.masks, x0, rhs, **spec.opts)
        _record(res.iters)
        return res.x, res.r

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


_TangentSolve.vmap = _loop_vmap(_TangentSolve)


def solve_mg_implicit(levels, masks, x: torch.Tensor, z: torch.Tensor,
                      tol: float = 2e-3, itmx: int = 32, smooth_it: int = 4,
                      fine_smooth_it: int = 0, fine_presmooth: bool = True,
                      perdir: tuple[int, ...] = (), ctx=None,
                      n_dist: int = 0) -> MGSolveResult:
    """`solve_mg` with implicit forward-mode differentiation (the JAX
    `solve_mg_implicit`, `multigrid.py:365-417`).  For ``A(L) x = z`` the
    tangent is the exact implicit one, ``A ẋ = ż − Ȧ(L̇, Ḋ)·x``, solved with
    the same multigrid, tolerance and options (`_TangentSolve`); the warm
    start's tangent warm-starts it without biasing the result.  Without
    forward-mode AD active this is `solve_mg` itself.  The result's
    ``iters`` and ``stats`` are the primal solve's.  On a shard (``ctx``,
    ``n_dist``) both solves are the distributed `solve_mg` and the
    solution is halo-refreshed before ``Ȧ·x`` (the JAX `solve_mg_implicit`
    with ``ctx``); every shard's tangent solve stops where the others'
    does, its norms being sums over the shards."""
    opts = dict(tol=tol, itmx=itmx, smooth_it=smooth_it,
                fine_smooth_it=fine_smooth_it, fine_presmooth=fine_presmooth,
                perdir=perdir, ctx=ctx, n_dist=n_dist)
    if not ad_active():
        res = solve_mg(levels, masks, x, z, **opts)
        _record(res.iters)
        return res
    flat, layout = _flatten(levels)
    spec = _Spec(tuple(masks), opts, layout)
    xs, r = _ImplicitSolve.apply(x, z, spec, *flat)
    return MGSolveResult(xs, r, spec.iters, spec.stats)
