"""Hand-written CUDA kernels of the flat engine, on the dense layout, with
their plain PyTorch versions.

Counterpart of `waterlily_tpu/ops/pallas_flat.py` for `engine="flat"`
(`models/flowflat.py`, `ops/mgflat.py`).  The TPU kernels fuse passes over
its ``(x, y·z)`` lane layout; the port keeps dense ``(Nx, Ny, Nz)`` tensors
and fuses the same passes (sources in `csrc/fused3d.cu`, built with the
kernels of `ops/stencil3d.py`, see `ops/_build.py`):

====================  ================================================
wrapper               replaces (TPU)
====================  ================================================
`conv_diff_bdim_k`    `pallas_flat.py:376` `conv_diff_k`, fused mode (K1)
`incr_gs_k`           `pallas_flat.py:896` `incr_gs` (K7), also with
                      ``mp=True``; with no colours `:1307` `increment_k`
                      (K6)
`bc_div_k`            `pallas_flat.py:1143` `bc_div_k` (K8)
`projbc_k`            `pallas_flat.py:1201` `projbc_k` (K9), also with
                      ``save_exit``
`bc_k`                `pallas_flat.py:1076` `bc_k` (K10)
`div_k`               `pallas_flat.py:1279` `div_k` (K11)
====================  ================================================

As in `ops/stencil3d.py`, each kernel has a plain version (``*_plain``)
beside it; a wrapper given a CPU tensor, or called inside
`stencil3d.plain_ops()`, returns the plain version, and given a CUDA tensor
launches the kernel or raises.  The call sites route through
`stencil3d.use_kernels`.  Each launch adds one to the wrapper's entry in the
shared `stencil3d.launch_counts()`.

Ghost rule: the flat engine's conv–diff RHS is zero on ghost cells
(`flowflat.py:81`), where K12 defines it with roll-wrap reads.  The slab
BDIM reads ``f*`` at ghosts next to the body, so the flat engine and the 3d
engine may differ next to a face where μ1 ≠ 0; that is the JAX packages'
own difference, not a fault.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from .bc import bc_vector
from .grid import inside_mask, interior, shift, zero_ghost
from .poisson import norms
from .stencil3d import (BF16, SCHEMES, _bf16, _check, _launch, _lead,
                        _lib, _mp_mult, _mp_sweeps, _ptr, _rb_sweeps, _stream,
                        conv_diff_plain, mult_plain, plain_route)

__all__ = [
    "conv_diff_bdim_plain", "incr_gs_plain", "bc_div_plain", "projbc_plain",
    "bc_plain", "div_plain",
    "conv_diff_bdim_k", "incr_gs_k", "bc_div_k", "projbc_k", "bc_k", "div_k",
    "div_field", "proj_correct", "cfl_max",
]


# ---------------------------------------------------------------- plain
def div_field(u: torch.Tensor) -> torch.Tensor:
    """Cell-centered divergence (`div`, `Flow.jl:17-23`); ghost entries 0."""
    s = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    for i in range(u.shape[0]):
        s = s + (shift(u[i], i, 1) - u[i])
    return zero_ghost(s)


def proj_correct(u: torch.Tensor, x: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Projection velocity correction ``u_i −= L_i ∂_i x`` on the interior
    (`mom_project!`, `Flow.jl:227-231`)."""
    return torch.stack([u[i] - zero_ghost(L[i] * (x - shift(x, i, -1)))
                        for i in range(u.shape[0])])


def cfl_max(u: torch.Tensor) -> torch.Tensor:
    """Max over the interior of the CFL summand
    ``Σ_i max(0, u_i(+e_i)) + max(0, −u_i)`` (`CFL`, `Flow.jl:234-244`), a
    0-d tensor."""
    s = torch.zeros(u.shape[1:], dtype=u.dtype, device=u.device)
    for i in range(u.shape[0]):
        s = s + torch.clamp(shift(u[i], i, 1), min=0.0) + torch.clamp(-u[i], min=0.0)
    return torch.max(interior(s))


def _face_one(shape: tuple[int, ...], i: int, dtype, device) -> torch.Tensor:
    """1 off the plane at index 1 of direction ``i``, 0 on it (broadcasts)."""
    view = [1] * len(shape)
    view[i] = shape[i]
    idx = torch.arange(shape[i], device=device).reshape(view)
    return (idx != 1).to(dtype)


def conv_diff_bdim_plain(u, u0, nu, dt, keep_base: float, scale: float,
                         scheme: Callable):
    """Conv–diff RHS with the far-field BDIM fused in (`conv_diff_k` with
    ``cheap=(u0, dt, keep_base, scale)``, `pallas_flat.py:389-400`):
    ``f = conv_diff`` on interior cells, 0 on ghosts (the flat ghost rule),
    and ``u_new_i = scale·(keep_base·u_i + mm_i·(u0_i + dt·f_i))`` on
    interior cells, ``u_i`` on ghosts, with ``mm_i`` zero on component i's
    face-1 plane.  Returns ``(u_new, f)``, ``f`` defined everywhere."""
    f = zero_ghost(conv_diff_plain(u, nu, scheme), u.dim() - 1)
    shape = tuple(u.shape[1:])
    upd = torch.stack([
        scale * (keep_base * u[i] + _face_one(shape, i, u.dtype, u.device)
                 * (u0[i] + dt * f[i])) for i in range(u.shape[0])])
    return torch.where(inside_mask(shape, u.device), upd, u), f


def incr_gs_plain(x, r, eps, L, D, iD, colors: Sequence[int], omega,
                  want_norms: bool = False, mp: bool = False):
    """Coarse-correction increment fused with the fine red-black smooth
    (`incr_gs`, `pallas_flat.py:896-916`; `increment!` then
    `GaussSeidelRB!`, `MultiLevelPoisson.jl:100,115`):

        r₁ = r − ω·A·eps;  e = RB(r₁);  x′ = x + ω·(eps + e);  r′ = r₁ − ω·A·e

    on the interior.  With no colours there is no smooth: the increment
    alone (`increment_k`, `pallas_flat.py:1307`), ``x + ω·eps``,
    ``r − ω·A·eps``.  ``want_norms`` also returns ``(Σ|r′|, max|r′|)`` as a
    2-vector on the device.

    ``mp`` (`pallas_flat.py:944-1004`): ``L``, ``D``, ``iD`` are bf16;
    ``A·eps`` is formed in float32 from the float32 ``eps`` and the bf16
    coefficients, so ``r₁`` is float32; ``e`` comes from the bf16 cascade on
    a bf16 rounding of ``r₁`` and ``A·e`` is accumulated in bf16
    (`stencil3d._mp_sweeps`, `_mp_mult`); the two updates and the norms are
    float32.  The increment alone has no mixed-precision form."""
    if mp:
        if not colors:
            raise ValueError("incr_gs: mp=True needs at least one colour "
                             "(the increment alone is float32)")
        _bf16("incr_gs_plain", L=L, D=D, iD=iD)
        a = eps * D
        for d in range(L.shape[0]):
            a = a + shift(eps, d, -1) * L[d] + shift(eps, d, 1) * shift(L[d], d, 1)
        r1 = r - omega * zero_ghost(a)
        e = _mp_sweeps(r1, L, iD, colors)
        x = x + omega * zero_ghost(eps + e.float())
        r = r1 - omega * _mp_mult(e, L, D)
        return (x, r, torch.stack(norms(r))) if want_norms else (x, r)
    if colors:
        r1 = r - omega * mult_plain(eps, L, D)
        e = _rb_sweeps(r1, L, iD, colors)
        x = x + omega * zero_ghost(eps + e)
        r = r1 - omega * mult_plain(e, L, D)
    else:
        x = x + omega * zero_ghost(eps)
        r = r - omega * mult_plain(eps, L, D)
    return (x, r, torch.stack(norms(r))) if want_norms else (x, r)


def bc_div_plain(u: torch.Tensor, ubc):
    """`BC!` then the divergence of the BC'd field (`bc_div_k`,
    `pallas_flat.py:1143`).  Returns ``(u_bc, div)``."""
    u = bc_vector(u, ubc)
    return u, div_field(u)


def projbc_plain(u, x, L, ubc, want_cfl: bool = False, save_exit: bool = False):
    """Projection correction, then `BC!` (``save_exit`` keeps the exit plane
    of ``u_0``), then optionally the CFL max (`projbc_k`,
    `pallas_flat.py:1201`).  Returns ``u_new`` or ``(u_new, smax)``."""
    u = bc_vector(proj_correct(u, x, L), ubc, save_exit=save_exit)
    return (u, cfl_max(u)) if want_cfl else u


def bc_plain(u: torch.Tensor, ubc, save_exit: bool = False) -> torch.Tensor:
    """`BC!` alone (`bc_k`, `pallas_flat.py:1076`): `bc_vector` with
    ``save_exit``."""
    return bc_vector(u, ubc, save_exit=save_exit)


# the divergence alone (`div_k`, `pallas_flat.py:1279`)
div_plain = div_field


# ---------------------------------------------------------------- wrappers
def _ubc3(ubc) -> list[ctypes.c_float]:
    if callable(ubc) or len(ubc) != 3:
        raise ValueError(f"the kernels take a constant 3-tuple ubc, got {ubc!r}")
    return [ctypes.c_float(float(v)) for v in ubc]


def conv_diff_bdim_k(u, u0, nu, dt: float, keep_base: float, scale: float,
                     scheme_id: int,
                     f_rows: Optional[tuple[int, int]] = None):
    """K1: `conv_diff_bdim_plain` in one pass.  ``f`` is written only on the
    x rows ``[lo, hi)`` of ``f_rows`` (all rows when None); the other rows
    of ``f`` are undefined (`torch.empty`), the caller reads the slab
    alone.  ``nu`` is a 0-d tensor read on the card or a float.  Returns
    ``(u_new, f)``."""
    if not u.is_cuda or plain_route():
        return conv_diff_bdim_plain(u, u0, nu, dt, keep_base, scale,
                                    SCHEMES[scheme_id])
    shape = tuple(u.shape[1:])
    _check("conv_diff_bdim_k", shape, u.device, u=u, u0=u0)
    _lead("conv_diff_bdim_k", "u", u, (3,))
    _lead("conv_diff_bdim_k", "u0", u0, (3,))
    if not 0 <= scheme_id < len(SCHEMES):
        raise ValueError(f"conv_diff_bdim_k: unknown scheme id {scheme_id}")
    lo, hi = (0, shape[0]) if f_rows is None else (int(f_rows[0]), int(f_rows[1]))
    if not 0 <= lo < hi <= shape[0]:
        raise ValueError(f"conv_diff_bdim_k: f_rows {f_rows} outside [0, {shape[0]}]")
    nu = torch.as_tensor(nu, dtype=torch.float32, device=u.device)
    if nu.numel() != 1:
        raise ValueError("conv_diff_bdim_k: nu must be a scalar")
    u_new, f = torch.empty_like(u), torch.empty_like(u)
    _launch("conv_diff_bdim_k", _lib().wlt_conv_diff_bdim, _ptr(u), _ptr(u0),
            _ptr(nu), ctypes.c_float(float(dt)), ctypes.c_float(float(keep_base)),
            ctypes.c_float(float(scale)), lo, hi, _ptr(u_new), _ptr(f), *shape,
            scheme_id, _stream(u.device))
    return u_new, f


def incr_gs_k(x, r, eps, L, D, iD, colors: Sequence[int], omega: float,
              want_norms: bool = False, mp: bool = False):
    """K7 (K6 with no colours): `incr_gs_plain` as one kernel entry (a head
    pass, a sweep per colour, a tail pass, and with ``want_norms`` the fold
    of the per-block norm partials).  ``mp`` launches the mixed-precision
    instantiation on bf16 ``L``, ``D``, ``iD`` with a bf16 scratch.  Returns
    ``(x′, r′)`` or ``(x′, r′, norms)`` with ``norms = [Σ|r′|, max|r′|]`` on
    the card."""
    if not x.is_cuda or plain_route("incr_gs_mp_k" if mp else "incr_gs_k"):
        return incr_gs_plain(x, r, eps, L, D, iD, colors, omega, want_norms, mp)
    shape = tuple(x.shape)
    name = "incr_gs_mp_k" if mp else "incr_gs_k"
    cdt = BF16 if mp else torch.float32
    _check(name, shape, x.device, x=x, r=r, eps=eps)
    _check(name, shape, x.device, cdt, L=L, D=D, iD=iD)
    for arg, t in (("x", x), ("r", r), ("eps", eps), ("D", D), ("iD", iD)):
        _lead(name, arg, t, ())
    _lead(name, "L", L, (3,))
    cols = [int(c) for c in colors]
    if any(c not in (0, 1) for c in cols):
        raise ValueError(f"{name}: colours must be 0 or 1, got {cols}")
    if mp and not cols:
        raise ValueError("incr_gs_k: mp=True needs at least one colour (the "
                         "increment alone is float32)")
    carr = (ctypes.c_int * max(1, len(cols)))(*cols)
    lib = _lib()
    e = torch.empty_like(x, dtype=cdt) if cols else x   # no scratch without sweeps
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    partials = nv = None
    if want_norms:
        partials = torch.empty(2 * lib.wlt_reduce_blocks(*shape),
                               dtype=torch.float32, device=x.device)
        nv = torch.empty(2, dtype=torch.float32, device=x.device)
    _launch(name, lib.wlt_incr_gs_mp if mp else lib.wlt_incr_gs, _ptr(x),
            _ptr(r), _ptr(eps), _ptr(L),
            _ptr(D), _ptr(iD), _ptr(e), _ptr(x_out), _ptr(r_out), carr, len(cols),
            ctypes.c_float(float(omega)),
            None if partials is None else _ptr(partials),
            None if nv is None else _ptr(nv), *shape, _stream(x.device))
    return (x_out, r_out, nv) if want_norms else (x_out, r_out)


def bc_div_k(u, ubc):
    """K8: `bc_div_plain` in one pass.  Returns ``(u_bc, div)``."""
    if not u.is_cuda or plain_route():
        return bc_div_plain(u, ubc)
    shape = tuple(u.shape[1:])
    _check("bc_div_k", shape, u.device, u=u)
    _lead("bc_div_k", "u", u, (3,))
    ub = _ubc3(ubc)
    u_bc, div = torch.empty_like(u), torch.empty(shape, dtype=u.dtype, device=u.device)
    _launch("bc_div_k", _lib().wlt_bc_div, _ptr(u), *ub, _ptr(u_bc), _ptr(div),
            *shape, _stream(u.device))
    return u_bc, div


def projbc_k(u, x, L, ubc, want_cfl: bool = False, save_exit: bool = False):
    """K9: `projbc_plain` in one pass; with ``want_cfl`` the CFL max comes
    back as a 0-d tensor on the card.  Returns ``u_new`` or
    ``(u_new, smax)``."""
    if not u.is_cuda or plain_route():
        return projbc_plain(u, x, L, ubc, want_cfl, save_exit)
    shape = tuple(u.shape[1:])
    _check("projbc_k", shape, u.device, u=u, x=x, L=L)
    _lead("projbc_k", "u", u, (3,))
    _lead("projbc_k", "x", x, ())
    _lead("projbc_k", "L", L, (3,))
    ub = _ubc3(ubc)
    u_out = torch.empty_like(u)
    smax = torch.empty((), dtype=torch.float32, device=u.device) if want_cfl else None
    _launch("projbc_k", _lib().wlt_projbc, _ptr(u), _ptr(x), _ptr(L), *ub,
            int(save_exit), _ptr(u_out), None if smax is None else _ptr(smax),
            *shape, _stream(u.device))
    return (u_out, smax) if want_cfl else u_out


def bc_k(u, ubc, save_exit: bool = False):
    """K10: `bc_plain` in one pass."""
    if not u.is_cuda or plain_route():
        return bc_plain(u, ubc, save_exit)
    shape = tuple(u.shape[1:])
    _check("bc_k", shape, u.device, u=u)
    _lead("bc_k", "u", u, (3,))
    ub = _ubc3(ubc)
    u_bc = torch.empty_like(u)
    _launch("bc_k", _lib().wlt_bc, _ptr(u), *ub, int(save_exit), _ptr(u_bc),
            *shape, _stream(u.device))
    return u_bc


def div_k(u):
    """K11: `div_plain` in one pass."""
    if not u.is_cuda or plain_route():
        return div_plain(u)
    shape = tuple(u.shape[1:])
    _check("div_k", shape, u.device, u=u)
    _lead("div_k", "u", u, (3,))
    div = torch.empty(shape, dtype=u.dtype, device=u.device)
    _launch("div_k", _lib().wlt_div, _ptr(u), _ptr(div), *shape,
            _stream(u.device))
    return div
