"""The flat engine's momentum step (`engine="flat"`) on dense tensors.

PyTorch counterpart of `waterlily_tpu/models/flowflat.py` (`flat_supported`,
`_half_step`, `_project_flat`, `mom_step_flat_impl`) without its layout
half: the same numerics as `models/flow.py` `mom_step_impl` (`mom_step!`,
`Flow.jl:156-167`) with the flat engine's fused passes, each a kernel of
`ops/fused3d.py` for 3-D float32 CUDA fields.  The passes follow the JAX
conditions (`_kernel_bc_ok`, ``plain`` in `_half_step`, `fuse_tail`):

* a "plain" half step (no ``udf``, no ``g``, a constant ``ubc``, no
  periodic direction) with ``cfg.band_x`` set is one K1 pass (conv–diff
  with the far-field BDIM and the interior scale fused in) plus K14
  (`bdim_k`) on the body's x slab ``[lo−1, hi+1)``; with no band (no body)
  it is K12 + K14 on the full field;
* every other half step is K12 with the flat engine's zero-ghost rule, the
  ``udf`` hook, `accelerate` (``g`` and ∂ubc/∂t), the predictor's interior
  zeroing, then the band-sparse BDIM K2 (`bdim_band_k`) with ``cfg.band_x``
  (K14 on the full field when there is no band) and the interior scale;
* with a constant ``ubc``, no periodic direction and no exit, `BC!` and the
  divergence of the BC'd field are one K8 pass; with the convective exit
  (``exit_bc``) `BC!` keeping the exit plane is K10, the predictor's
  `exitBC!` follows, and the divergence is K11;
* the projection is `ops/mgflat.py`'s solve (K6, K7 with the norms; with
  ``cfg.mp_smooth`` their bf16 instantiations) and one K9 pass for the
  correction and `BC!` (keeping the exit plane with ``exit_bc``); the
  corrector's K9 also yields the CFL max, and ``dt = min(10, 1/(max + 5ν))``
  stays on the device;
* with periodic directions (``perdir``) or a callable ``ubc`` there is no
  K8, K9 or K10 (`_kernel_bc_ok`): `BC!` is the plain `bc_vector` at
  ``t1``, the divergence K11, the correction the plain `proj_correct` +
  `bc_vector` and the CFL the plain `cfl_max`; with ``perdir`` the solve is
  `mgflat`'s periodic branch (K6, K13, no fused tail).

Distributed over x (``ctx``, ``n_dist``: the per-shard step of
`parallel.dist.DistSimulation`'s flat engine, `flowflat.py:71-345` of the
JAX package under ``ctx``): no K1, K2, K8, K9 or K10 and no body band.  The
conv–diff is the plain ring variant (`flow.conv_diff` with ``ctx``) with
the flat ghost rule, a udf's ``flat`` form gets the ctx,
`accelerate` takes global coordinates, ``f``'s x
ghosts are ring-refreshed (edge ghosts kept) and K14 runs on the whole
shard; `BC!` is the plain ring `bc_vector` (and the predictor's
distributed `exitBC!`), the divergence K11, the solve `mgflat`'s
distributed branch (K6, K16), the correction the plain `proj_correct` with
the ring `bc_vector`, and the CFL a maximum over the shards.  The kernels
read the ghost planes as given: the periodic x wrap is the ring's.

Supported: D = 3 with what `models/flow.py` supports.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import tracing
from ..ops import fused3d as fz
from ..ops import stencil3d as st
from ..ops.bc import bc_vector, exit_bc
from ..ops.dist import pmax_all, sync_scalar
from ..ops.grid import zero_ghost
from ..ops.mgflat import solve_mg_flat
from .flow import (FlowCfg, FlowState, accelerate, bdim_update, conv_diff,
                   scale_interior)

__all__ = ["flat_supported", "conv_diff_bdim", "bdim_band",
           "mom_step_flat_impl"]


def flat_supported(cfg: FlowCfg) -> bool:
    """The flat engine takes every 3-D configuration that `models/flow.py`
    supports: periodic directions, the convective exit, a callable ``u0``
    or ``ubc``, a body force ``g`` and the ``udf`` hook."""
    return cfg.D == 3


def _kernel_bc_ok(cfg: FlowCfg, ctx=None) -> bool:
    """The fused BC kernels (K8, K9, K10) cover a constant ``ubc`` with no
    periodic direction, on one device (`flowflat.py:178-183`)."""
    return not cfg.perdir and not callable(cfg.ubc) and ctx is None


def conv_diff_bdim(u, u0, nu, dt: float, keep_base: float, scale: float,
                   scheme, f_rows: Optional[tuple[int, int]] = None):
    """Conv–diff RHS with the far-field BDIM and interior scale fused in
    (`fused3d.conv_diff_bdim_plain`); the K1 kernel for 3-D float32 CUDA
    fields and a scheme the kernel covers (a user's scheme runs as plain
    PyTorch).  Returns ``(u_new, f)``."""
    sid = st.scheme_id(scheme)
    if sid is not None and st.use_kernels(u[0]):
        return fz.conv_diff_bdim_k(u, u0, nu, dt, keep_base, scale, sid,
                                   f_rows)
    return fz.conv_diff_bdim_plain(u, u0, nu, dt, keep_base, scale, scheme)


def bdim_band(u, u0, f, V, mu0, mu1, dt, band, perdir=()) -> torch.Tensor:
    """Band-sparse BDIM (`stencil3d.bdim_band_plain`); the K2 kernel for 3-D
    float32 CUDA fields."""
    if st.use_kernels(u[0]):
        return st.bdim_band_k(u, u0, f, V, mu0, mu1, dt, band, perdir)
    return st.bdim_band_plain(u, u0, f, V, mu0, mu1, dt, band, perdir)


def _half_step(u_adv, state: FlowState, cfg: FlowCfg, dt: float, f_t: float,
               keep_base: float, scale: float, udf=None, ctx=None):
    """One momentum phase (`mom_predict!`/`mom_correct!`,
    `Flow.jl:190-210`): conv–diff → udf → accelerate (at time ``f_t``) →
    BDIM → interior scale.  Both phases advect the field they update
    (``u_adv`` is also the base field)."""
    u0 = state.u0
    plain = (udf is None and cfg.g is None and not callable(cfg.ubc)
             and not cfg.perdir and ctx is None)
    if not plain:
        # the flat engine's RHS is zero on ghosts (`conv_diff_flat`); the
        # udf and `accelerate` may write there, the BDIM does not update
        # ghosts
        f = zero_ghost(conv_diff(u_adv, cfg.scheme, state.nu, cfg.perdir, ctx), 3)
        u = u_adv if keep_base else scale_interior(u_adv, 0.0)
        if udf is not None:
            # `udf!` (`Flow.jl:255-257`); on a shard, a udf's ``flat`` form
            # takes the halo ctx (the JAX `_apply_udf_flat`); any other udf
            # runs on the shard's block, the same decomposed only when it
            # does not depend on position, as in the JAX package
            st_u = dataclasses.replace(state, u=u)
            f = (udf.flat(f, st_u, u_adv, f_t, ctx)
                 if ctx is not None and hasattr(udf, "flat") else udf(f, st_u, u_adv, f_t))
        f = accelerate(f, f_t, cfg.g, cfg.ubc, cfg.dtype, ctx)
        if ctx is not None:
            # K14 on the whole shard reads f's x ghosts: the ring's (the
            # edge ghosts keep their own values)
            f = sync_scalar(f, ctx, perdir=(0,) if 0 in cfg.perdir else (),
                            lead=1, edge_zero=False)
            u = bdim_update(u, u0, f, state.V, state.mu0, state.mu1, dt)
        elif cfg.band_x is not None:
            u = bdim_band(u, u0, f, state.V, state.mu0, state.mu1, dt,
                          cfg.band_x, cfg.perdir)
        else:
            u = bdim_update(u, u0, f, state.V, state.mu0, state.mu1, dt)
        return u if scale == 1.0 else scale_interior(u, scale)
    if cfg.band_x is not None:
        lo, hi = cfg.band_x
        # one slab bound drives both the f write range and the slab read
        # below: rows outside the written range are uninitialized memory
        slab_lo, slab_hi = lo - 1, hi + 1
        # a slab that reaches a ghost row takes f in full (its ghosts zero)
        f_rows = ((slab_lo, slab_hi)
                  if 1 <= slab_lo < slab_hi <= cfg.shape[0] - 1 else None)
        u, f = conv_diff_bdim(u_adv, u0, state.nu, dt, keep_base, scale,
                              cfg.scheme, f_rows)
        if hi > lo:
            sl = slice(slab_lo, slab_hi)
            u_pre = u_adv[:, sl] if keep_base else scale_interior(u_adv[:, sl], 0.0)
            slab = bdim_update(*(t.contiguous() for t in (
                u_pre, u0[:, sl], f[:, sl], state.V[:, sl], state.mu0[:, sl],
                state.mu1[:, :, sl])), dt)
            if scale != 1.0:
                slab = scale_interior(slab, scale)
            u[:, lo:hi] = slab[:, 1:-1]
        return u
    u = u_adv if keep_base else scale_interior(u_adv, 0.0)
    u = bdim_update(u, u0, conv_diff(u_adv, cfg.scheme, state.nu), state.V,
                    state.mu0, state.mu1, dt)
    return u if scale == 1.0 else scale_interior(u, scale)


def _bc_div(u, u0, dt: float, t1: float, cfg: FlowCfg, predictor: bool,
            ctx=None):
    """`BC!` at time ``t1`` and the projection RHS: one K8 pass, or with the
    exit, periodic directions, a callable ``ubc`` or ``ctx`` `BC!` (K10, or
    the plain `bc_vector`), the predictor's `exitBC!`, then K11
    (`flowflat.py:316-330`).  Returns ``(u, z)``."""
    kern = st.use_kernels(u[0])
    if _kernel_bc_ok(cfg, ctx) and not cfg.exit_bc:
        return fz.bc_div_k(u, cfg.ubc) if kern else fz.bc_div_plain(u, cfg.ubc)
    if not _kernel_bc_ok(cfg, ctx):
        u = bc_vector(u, cfg.ubc, t1, save_exit=cfg.exit_bc, perdir=cfg.perdir,
                      ctx=ctx)
    else:
        u = (fz.bc_k if kern else fz.bc_plain)(u, cfg.ubc, save_exit=True)
    if cfg.exit_bc and predictor:
        u = exit_bc(u, u0, dt, ctx)
    return u, (fz.div_k(u) if kern else fz.div_plain(u))


def _project_flat(u, p, z, levels, masks, dt_w: float, t1: float,
                  cfg: FlowCfg, want_cfl: bool = False, ctx=None, n_dist: int = 0):
    """`mom_project!` (`Flow.jl:223-232`) with the divergence ``z`` from
    `_bc_div`: the `solve_mg_flat` solve warm-started from ``p·dt_w``, then
    the correction + `BC!` (K9, with the CFL max when ``want_cfl``; plain
    ops at time ``t1`` with ``perdir``, a callable ``ubc`` or ``ctx``, the
    CFL max over the shards).  Returns ``(u, p, iters, stats, smax)``."""
    res = solve_mg_flat(levels, masks, p * dt_w, z, tol=cfg.tol,
                        itmx=cfg.itmx, smooth_it=cfg.smooth_it,
                        fine_smooth_it=cfg.fine_smooth_it,
                        fine_presmooth=cfg.fine_presmooth, perdir=cfg.perdir,
                        mp=cfg.mp_smooth, ctx=ctx, n_dist=n_dist)
    L = levels[0].L
    if not _kernel_bc_ok(cfg, ctx):
        u = bc_vector(fz.proj_correct(u, res.x, L), cfg.ubc, t1,
                      save_exit=cfg.exit_bc, perdir=cfg.perdir, ctx=ctx)
        out = (u, pmax_all(fz.cfl_max(u), ctx)) if want_cfl else u
    elif st.use_kernels(u[0]):
        out = fz.projbc_k(u, res.x, L, cfg.ubc, want_cfl, cfg.exit_bc)
    else:
        out = fz.projbc_plain(u, res.x, L, cfg.ubc, want_cfl, cfg.exit_bc)
    u, smax = out if want_cfl else (out, None)
    return u, res.x / dt_w, res.iters, res.stats, smax


def mom_step_flat_impl(cfg: FlowCfg, state: FlowState, levels, masks,
                       dt: float, t0: float = 0.0, udf=None, ctx=None,
                       n_dist: int = 0):
    """One time step (`mom_step!`, `Flow.jl:156-167`) on the flat engine's
    fused passes; same contract as `flow.mom_step_impl`: ``dt`` and ``t0``
    host floats rounded to ``cfg.dtype``, ``udf`` the forcing hook, returns
    ``(state', dt_next (0-d tensor), [iters1, iters2], [stats1, stats2])``.
    ``ctx``/``n_dist``: the step of one shard of a flow decomposed over x
    (a ``udf`` with a ``flat`` form gets the ctx)."""
    t1 = t0 + dt
    state = dataclasses.replace(state, u0=state.u)
    with tracing.span("wlt.predict"):      # `Flow.jl:157-161`
        u = _half_step(state.u0, state, cfg, dt, t0, 0.0, 1.0, udf, ctx)
        u, z = _bc_div(u, state.u0, dt, t1, cfg, True, ctx)
        u, p, n1, s1, _ = _project_flat(u, state.p, z, levels, masks, dt, t1,
                                        cfg, ctx=ctx, n_dist=n_dist)
    with tracing.span("wlt.correct"):      # `Flow.jl:163-165`
        u = _half_step(u, state, cfg, dt, t1, 1.0, 0.5, udf, ctx)
        u, z = _bc_div(u, state.u0, dt, t1, cfg, False, ctx)
        u, p, n2, s2, smax = _project_flat(u, p, z, levels, masks, 0.5 * dt, t1,
                                           cfg, want_cfl=True, ctx=ctx,
                                           n_dist=n_dist)
        dt_next = torch.clamp(1.0 / (smax + 5 * state.nu), max=10.0)
    return dataclasses.replace(state, u=u, p=p), dt_next, [n1, n2], [s1, s2]
