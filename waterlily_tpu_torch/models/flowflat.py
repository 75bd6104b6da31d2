"""The flat engine's momentum step (`engine="flat"`) on dense tensors.

PyTorch counterpart of `waterlily_tpu/models/flowflat.py` (`flat_supported`,
`_half_step`, `_project_flat`, `mom_step_flat_impl`) without its layout
half: the same numerics as `models/flow.py` `mom_step_impl` (`mom_step!`,
`Flow.jl:156-167`) with the flat engine's fused passes, each a kernel of
`ops/fused3d.py` for 3-D float32 CUDA fields:

* a half step with ``cfg.band_x`` set is one K1 pass (conv–diff with the
  far-field BDIM and the interior scale fused in) plus K14 (`bdim_k`) on the
  body's x slab ``[lo−1, hi+1)``; with no band (no body) it is K12 + K14 on
  the full field;
* `BC!` and the divergence of the BC'd field are one K8 pass;
* the projection is `ops/mgflat.py`'s solve (K6, K7 with the norms) and one
  K9 pass for the correction and `BC!`; the corrector's K9 also yields the
  CFL max, and ``dt = min(10, 1/(max + 5ν))`` stays on the device.

Supported: D = 3, constant tuple ``ubc``, no body force, no udf,
non-periodic, no convective exit (what `models/flow.py` supports); the
`Flow` constructor and `Simulation.step_once` raise for the rest, naming the
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import fused3d as fz
from ..ops import stencil3d as st
from ..ops.mgflat import solve_mg_flat
from .flow import (FlowCfg, FlowState, bdim_update, conv_diff,
                   scale_interior)

__all__ = ["flat_supported", "conv_diff_bdim", "mom_step_flat_impl"]


def flat_supported(cfg: FlowCfg) -> bool:
    """The flat engine takes every 3-D configuration the port supports."""
    return cfg.D == 3


def conv_diff_bdim(u, u0, nu, dt: float, keep_base: float, scale: float,
                   scheme, f_rows: Optional[tuple[int, int]] = None):
    """Conv–diff RHS with the far-field BDIM and interior scale fused in
    (`fused3d.conv_diff_bdim_plain`); the K1 kernel for 3-D float32 CUDA
    fields.  Returns ``(u_new, f)``."""
    if st.use_kernels(u[0]):
        return fz.conv_diff_bdim_k(u, u0, nu, dt, keep_base, scale,
                                   st.scheme_id(scheme), f_rows)
    return fz.conv_diff_bdim_plain(u, u0, nu, dt, keep_base, scale, scheme)


def _half_step(u_adv, state: FlowState, cfg: FlowCfg, dt: float,
               keep_base: float, scale: float):
    """One momentum phase (`mom_predict!`/`mom_correct!`,
    `Flow.jl:190-210`): conv–diff → BDIM → interior scale.  Both phases
    advect the field they update (``u_adv`` is also the base field)."""
    u0 = state.u0
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


def _bc_div(u, cfg: FlowCfg):
    """`BC!` and the projection RHS (K8)."""
    if st.use_kernels(u[0]):
        return fz.bc_div_k(u, cfg.ubc)
    return fz.bc_div_plain(u, cfg.ubc)


def _project_flat(u, p, z, levels, masks, dt_w: float, cfg: FlowCfg,
                  want_cfl: bool = False):
    """`mom_project!` (`Flow.jl:223-232`) with the divergence ``z`` from
    `_bc_div`: the `solve_mg_flat` solve warm-started from ``p·dt_w``, then
    the correction + `BC!` (K9, with the CFL max when ``want_cfl``).
    Returns ``(u, p, iters, stats, smax)``."""
    res = solve_mg_flat(levels, masks, p * dt_w, z, tol=cfg.tol,
                        itmx=cfg.itmx, smooth_it=cfg.smooth_it,
                        fine_smooth_it=cfg.fine_smooth_it,
                        fine_presmooth=cfg.fine_presmooth)
    L = levels[0].L
    if st.use_kernels(u[0]):
        out = fz.projbc_k(u, res.x, L, cfg.ubc, want_cfl)
    else:
        out = fz.projbc_plain(u, res.x, L, cfg.ubc, want_cfl)
    u, smax = out if want_cfl else (out, None)
    return u, res.x / dt_w, res.iters, res.stats, smax


def mom_step_flat_impl(cfg: FlowCfg, state: FlowState, levels, masks,
                       dt: float, t0: float = 0.0):
    """One time step (`mom_step!`, `Flow.jl:156-167`) on the flat engine's
    fused passes; same contract as `flow.mom_step_impl`: ``dt`` a host float
    rounded to ``cfg.dtype``, returns ``(state', dt_next (0-d tensor),
    [iters1, iters2], [stats1, stats2])``."""
    state = dataclasses.replace(state, u0=state.u)
    # predictor (`Flow.jl:157-161`)
    u = _half_step(state.u0, state, cfg, dt, 0.0, 1.0)
    u, z = _bc_div(u, cfg)
    u, p, n1, s1, _ = _project_flat(u, state.p, z, levels, masks, dt, cfg)
    # corrector (`Flow.jl:163-165`)
    u = _half_step(u, state, cfg, dt, 1.0, 0.5)
    u, z = _bc_div(u, cfg)
    u, p, n2, s2, smax = _project_flat(u, p, z, levels, masks, 0.5 * dt, cfg,
                                       want_cfl=True)
    dt_next = torch.clamp(1.0 / (smax + 5 * state.nu), max=10.0)
    return dataclasses.replace(state, u=u, p=p), dt_next, [n1, n2], [s1, s2]
