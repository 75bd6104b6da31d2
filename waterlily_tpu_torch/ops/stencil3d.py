"""Hand-written CUDA stencil kernels for the dense layout, with their plain
PyTorch versions.

Counterpart of `waterlily_tpu/ops/pallas3d.py`, with the band-sparse BDIM
and the mixed-precision smoother of `waterlily_tpu/ops/pallas_flat.py`.  Six
kernels (sources in `csrc/stencil3d.cu`, built with `nvcc` for `sm_90a` on
first use, see `ops/_build.py`):

================  ===========================================  ==================
wrapper           replaces (TPU)                               JAX caller
================  ===========================================  ==================
`conv_diff_k`     `pallas3d.py:274` `conv_diff3d_generic`      `flow.conv_diff`
`bdim_k`          `pallas3d.py:372` `bdim3d`                   `flow.bdim_update`
`mult_k`          `pallas3d.py:504` `mult3d`                   `poisson._mult_raw`
`gs_incr_k`       `pallas3d.py:416,497` `gs_incr3d`,           `poisson.jacobi`,
                  `jacobi_incr3d`                              `poisson.gauss_seidel_rb`
`gauss_sweeps_k`  `pallas3d.py:312,366` `gauss_sweeps3d`,      `poisson.gauss_seidel_rb`
                  `gauss_sweep3d`                              with ``perdir``
`bdim_band_k`     `pallas_flat.py:665` `bdim_band`             `flowflat.bdim_flat`
`gs_incr_k(mp)`   `pallas_flat.py:759,891` `gs_incr`,          `flat.jacobi_flat`,
                  `jacobi_incr` with ``mp=True``               `flat.gauss_seidel_rb_flat`
================  ===========================================  ==================

`conv_diff_k` takes the periodic directions (``perdir``) as a mode: there
the boundary-slab fluxes are the periodic ϕuP ones (`_phi_slabs`).  It runs
on the shared-memory tiles of `csrc/convdiff_tile.cuh` (one thread per cell,
each face flux computed once), the core it shares with
`fused3d.conv_diff_bdim_k`.  The kernels cover the schemes of `SCHEMES`
(`quick`, `vanleer`, `cds`), each compiled into its template instantiation;
a user's ``scheme(u, c, d)`` cannot be compiled into the CUDA kernel, so
`scheme_id` gives None for it and the callers (`flow.conv_diff`,
`flowflat.conv_diff_bdim`) run it as plain PyTorch (`conv_diff_plain`), on
the card too, chosen by the argument.

`gs_incr_k` (float32, 1–4 colours) and `gauss_sweeps_k` (1–4 colours, even
interior extents in the periodic directions) run on large levels as one
launch of the red-black cascade of `csrc/rb_cascade.cuh`, the core they
share with `fused3d.incr_gs_k`; smaller levels, Jacobi, longer colour lists,
bf16 and odd periodic extents take one launch per colour.  The C side picks
the route from the shape and the arguments (`wlt_gs_incr_route`,
`wlt_gauss_sweeps_route`), never from a failure.

Beside each kernel sits its plain version (``*_plain``): the jnp body of the
JAX caller written in torch, general in the number of dims.  A wrapper given
a CPU tensor returns the plain version; given a CUDA tensor it launches the
kernel or raises.  The call sites route through `use_kernels`: a CUDA,
float32, 3-D tensor takes the kernel (f64 or CPU tensors take the plain
version, a routing by dtype and device as in the JAX `use_pallas`).
`plain_ops()` forces the plain route on the card so both can be compared.

Each wrapper adds one to its entry in `launch_counts()` per call that
launches on the card, and nowhere else; the count also holds the kernels of
`ops/fused3d.py` and `ops/probe.py`.  The mixed-precision instantiations
count under their own names (``gs_incr_mp_k``, ``incr_gs_mp_k``).

Mixed precision (``mp=True``): ``L``, ``D``, ``iD`` are `torch.bfloat16`
copies (`poisson.with_bf16` makes them once per level), the correction and
every product, sum and difference of the colour sweeps and of ``A·e`` are
bf16, each operation rounded on its own in the order of the JAX body
(`pallas_flat.py:814-861`); ``x`` and ``r`` stay float32.

Unlike the Pallas path, the kernels write every cell with the plain formula:
`conv_diff_k` defines the ghost rows of ``f`` (read by the BDIM gradient at
the domain faces) and `gs_incr_k` leaves the ghosts of ``x`` and ``r`` as
the plain increment leaves them.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Callable, Optional, Sequence

import torch

from .bc import per_bc
from .grid import index_sum_parity, inside_mask, shift, zero_ghost

__all__ = [
    "use_kernels", "plain_route", "plain_ops", "launch_counts", "reset_launch_counts",
    "median3", "quick", "cds", "vanleer", "SCHEMES", "scheme_id",
    "conv_diff_plain", "bdim_plain", "bdim_band_plain", "mult_plain",
    "gs_incr_plain", "gauss_sweeps_plain",
    "conv_diff_k", "bdim_k", "bdim_band_k", "mult_k", "gs_incr_k",
    "gauss_sweeps_k",
]

# the wrappers routed to their plain versions: all of them inside
# `plain_ops()` (True), or the named ones inside `plain_ops(only=...)`
_PLAIN = contextvars.ContextVar("waterlily_tpu_torch_plain_ops", default=False)
# launches per wrapper, of this module's kernels and of `ops/fused3d.py`'s
_LAUNCHES = {"conv_diff_k": 0, "bdim_k": 0, "mult_k": 0, "gs_incr_k": 0,
             "gauss_sweeps_k": 0, "conv_diff_bdim_k": 0, "incr_gs_k": 0,
             "bc_div_k": 0, "projbc_k": 0, "bc_k": 0, "div_k": 0,
             "bdim_band_k": 0, "gs_incr_mp_k": 0, "incr_gs_mp_k": 0,
             "copy_scale_k": 0, "copy_scale6_k": 0}
# the wrappers whose call sites pass their name to the gate
_MP_NAMES = frozenset({"gs_incr_mp_k", "incr_gs_mp_k"})


def plain_route(name: Optional[str] = None) -> bool:
    """Whether the wrapper counted as ``name`` takes its plain version on
    the card: inside `plain_ops()` every one, inside `plain_ops(only=...)`
    the named ones."""
    plain = _PLAIN.get()
    return plain is True or (plain is not False and name in plain)


def use_kernels(t: torch.Tensor, name: Optional[str] = None) -> bool:
    """Kernel gate: a CUDA, float32, 3-D tensor, outside `plain_ops()`
    (``name``: the wrapper's entry in `launch_counts()`, for
    `plain_ops(only=...)`).  Mirrors `pallas3d.use_pallas`
    (`pallas3d.py:41-60`) without its TPU tiling floor of 18 cells."""
    return (t.is_cuda and t.dtype == torch.float32 and t.dim() == 3
            and not plain_route(name))


@contextlib.contextmanager
def plain_ops(only: Optional[Sequence[str]] = None):
    """Route every call site to the plain PyTorch versions inside the block
    (used to compare the kernels with them on the card).  ``only`` names the
    mixed-precision smoothers (``gs_incr_mp_k``, ``incr_gs_mp_k``) to route
    them alone, with every float32 kernel left in place: a run that then
    differs from the kernels' run differs by those kernels."""
    if only is not None and not set(only) <= _MP_NAMES:
        raise ValueError(f"plain_ops: only takes names of {sorted(_MP_NAMES)}, "
                         f"got {tuple(only)}")
    token = _PLAIN.set(True if only is None else frozenset(only))
    try:
        yield
    finally:
        _PLAIN.reset(token)


def launch_counts() -> dict[str, int]:
    """Calls of each wrapper (of this module and of `ops/fused3d.py`) that
    launched its kernel on the card."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


# ---------------------------------------------------------------- schemes
def median3(a, b, c):
    """Elementwise median of three (`median`, `Flow.jl:28-37`)."""
    return torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))


def quick(u, c, d):
    """Median-limited QUICK (`Flow.jl:4`): u=upstream, c=center, d=downstream."""
    return median3((5 * c + 2 * d - u) / 6, c, median3(10 * c - 9 * u, c, d))


def cds(u, c, d):
    """Central difference (`Flow.jl:6`)."""
    return (c + d) / 2


def vanleer(u, c, d):
    """van Leer limiter (`Flow.jl:5`) with a divide-safe guard."""
    denom = d - u
    safe = torch.where(denom == 0, 1.0, denom)
    lim = c + (d - c) * (c - u) / safe
    revert = (c <= torch.minimum(u, d)) | (c >= torch.maximum(u, d))
    return torch.where(revert, c, lim)


# kernel template index of each scheme (`SCHEME` in csrc/stencil3d.cu)
SCHEMES: tuple[Callable, ...] = (quick, vanleer, cds)


def scheme_id(scheme: Callable) -> Optional[int]:
    """Template index of a convection scheme, or None for a scheme that has
    no kernel (a user's callable: the callers then take the plain
    conv–diff)."""
    for k, s in enumerate(SCHEMES):
        if s is scheme:
            return k
    return None


# ---------------------------------------------------------------- plain
def _slab_ix(axis: int, idx: int):
    return (slice(None),) * axis + (slice(idx, idx + 1),)


def _phi_slabs(u, f, i, j, scheme, nu, perdir=()):
    """Fixed fluxes of pair (i, j) at the first interior slab and at the top
    ghost slab (`Flow.jl:56-62`; the JAX `_phi_slabs` without ``ctx``):
    one-sided `ϕuL`/`ϕuR` in a non-periodic direction; in a periodic one
    (`ϕuP`) the first-slab flux is the generic formula with its second-upwind
    value read from the periodic partner n−3 (not the roll-wrap n−1), and
    the top-ghost flux is that same flux."""
    n = f.shape[j]
    lo, hi = _slab_ix(j, 1), _slab_ix(j, n - 1)

    def uadv_slab(sl):
        if i == j:
            idx = sl[j].start
            return 0.5 * (u[j][sl] + u[j][_slab_ix(j, idx - 1)])
        return 0.5 * (u[j][sl] + shift(u[j][sl], i, -1))

    f0, f1, f2 = f[_slab_ix(j, 0)], f[lo], f[_slab_ix(j, 2)]
    ua = uadv_slab(lo)
    if j in perdir:
        phi_lo = (ua * torch.where(ua > 0, scheme(f[_slab_ix(j, n - 3)], f0, f1),
                                   scheme(f2, f1, f0))
                  - nu * (f1 - f0))
        return phi_lo, phi_lo
    phi_lo = (ua * torch.where(ua > 0, 0.5 * (f1 + f0), scheme(f2, f1, f0))
              - nu * (f1 - f0))
    fm1, fm2, fm3 = f[hi], f[_slab_ix(j, n - 2)], f[_slab_ix(j, n - 3)]
    ua_h = uadv_slab(hi)
    phi_hi = (ua_h * torch.where(ua_h < 0, 0.5 * (fm1 + fm2), scheme(fm3, fm2, fm1))
              - nu * (fm1 - fm2))
    return phi_lo, phi_hi


def conv_diff_plain(u: torch.Tensor, nu, scheme: Callable,
                    perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """Convective + diffusive momentum RHS (`conv_diff!`, `Flow.jl:38-62`):
    the jnp body of the JAX `conv_diff`.

    Per (component i, direction j) the flux
    ``Φ = uadv·λ(upwind stencil of u_i) − ν ∂u_i/∂x_j`` is evaluated with
    roll shifts, fixed at the first interior slab and at the top ghost slab
    (`_phi_slabs`: ϕuL/ϕuR, or ϕuP in the directions of ``perdir``);
    ``r_i = Σ_j Φ − Φ(+e_j)``.  Every cell is defined, ghosts included, with
    roll-wrap reads."""
    D = u.shape[0]
    out = []
    for i in range(D):
        f = u[i]
        ri = torch.zeros_like(f)
        for j in range(D):
            n = f.shape[j]
            uadv = 0.5 * (u[j] + shift(u[j], i, -1))
            up = scheme(shift(f, j, -2), shift(f, j, -1), f)
            dn = scheme(shift(f, j, 1), f, shift(f, j, -1))
            phi = uadv * torch.where(uadv > 0, up, dn) - nu * (f - shift(f, j, -1))
            phi_lo, phi_hi = _phi_slabs(u, f, i, j, scheme, nu, perdir)
            phi[_slab_ix(j, 1)] = phi_lo
            phi[_slab_ix(j, n - 1)] = phi_hi
            ri = ri + (phi - shift(phi, j, 1))
        out.append(ri)
    return torch.stack(out)


def bdim_plain(u, u0, f, V, mu0, mu1, dt) -> torch.Tensor:
    """BDIM update (`BDIM!`, `Flow.jl:176-180`): ``f* = u0 + dt·f − V``, then
    ``u_i += ½Σ_j μ1[i,j](f*_i(+e_j) − f*_i(−e_j)) + V_i + μ0_i·f*_i`` on
    interior faces; ghosts keep ``u``."""
    D = u.shape[0]
    fp = u0 + dt * f - V
    terms = []
    for i in range(D):
        mu_ddn = torch.zeros_like(fp[i])
        for j in range(D):
            mu_ddn = mu_ddn + mu1[i, j] * (shift(fp[i], j, 1) - shift(fp[i], j, -1))
        terms.append(0.5 * mu_ddn + V[i] + mu0[i] * fp[i])
    return u + zero_ghost(torch.stack(terms), D)


def _far_field_mask(shape: tuple[int, ...], i: int, perdir, device) -> torch.Tensor:
    """Interior cells minus component ``i``'s face-1 plane, which the
    measure-time BC fill zeroes in μ0 unless direction ``i`` is periodic."""
    m = inside_mask(shape, device)
    if i in perdir:
        return m
    view = [1] * len(shape)
    view[i] = shape[i]
    return m & (torch.arange(shape[i], device=device).reshape(view) != 1)


def bdim_band_plain(u, u0, f, V, mu0, mu1, dt, band: tuple[int, int],
                    perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """Band-sparse BDIM (`bdim_band`, `pallas_flat.py:665-703`).  ``band =
    (lo, hi)`` is the x-row range outside which the moments are the far
    field (μ1 = 0, V = 0, μ0 = 1 but the face-1 planes), so

        rows ∉ [lo, hi):  u_i + inside_i·(u0_i + dt·f_i)
        rows ∈ [lo, hi):  `bdim_plain` on the slab ``[lo−1, hi+1)``

    with ``inside_i`` of `_far_field_mask`; V, μ0 and μ1 are never read
    outside the slab.  ``hi <= lo`` is the far-field formula everywhere."""
    lo, hi = band
    shape = tuple(u.shape[1:])
    mm = torch.stack([_far_field_mask(shape, i, perdir, u.device)
                      for i in range(u.shape[0])])
    out = u + torch.where(mm, u0 + dt * f, 0.0)
    if hi <= lo:
        return out
    sl = slice(lo - 1, hi + 1)
    slab = bdim_plain(u[:, sl], u0[:, sl], f[:, sl], V[:, sl], mu0[:, sl],
                      mu1[:, :, sl], dt)
    out[:, lo:hi] = slab[:, 1:-1]
    return out


def mult_plain(x: torch.Tensor, L: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """A·x = D·x + Σ_d (L_d·x(−e_d) + L_d(+e_d)·x(+e_d)) on the interior,
    zero ghosts (`mult`, `Poisson.jl:70-76`)."""
    s = x * D
    for i in range(L.shape[0]):
        s = s + shift(x, i, -1) * L[i] + shift(x, i, 1) * shift(L[i], i, 1)
    return zero_ghost(s)


def _gauss(r, eps, L, iD):
    """Gauss-Seidel update value (`gauss`, `Poisson.jl:116-123`)."""
    s = r
    for i in range(L.shape[0]):
        s = s - (shift(eps, i, -1) * L[i] + shift(eps, i, 1) * shift(L[i], i, 1))
    return s * iD


def gauss_sweeps_plain(eps, r, L, iD, colors: Sequence[int],
                       perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """Red-black colour sweeps (`gauss`/`gauss_rb`, `Poisson.jl:116-132`;
    the jnp loop of the JAX `gauss_seidel_rb`): per colour, the periodic
    ghosts of ``eps`` are refreshed (`per_bc`), then the interior cells of
    index-sum parity ``colour`` take `_gauss(eps)`; every other cell keeps
    its value."""
    if colors:
        parity = index_sum_parity(r.shape, r.device)
        inside = inside_mask(r.shape, r.device)
        for c in colors:
            eps = per_bc(eps, perdir)
            eps = torch.where((parity == c) & inside, _gauss(r, eps, L, iD), eps)
    return eps


def _rb_sweeps(r, L, iD, colors: Sequence[int]) -> torch.Tensor:
    """``eps = r·iD`` with zero ghosts, then the colour sweeps."""
    return gauss_sweeps_plain(zero_ghost(r * iD), r, L, iD, colors)


BF16 = torch.bfloat16


def _mp_sweeps(r1, L16, iD16, colors: Sequence[int]) -> torch.Tensor:
    """The bf16 correction of the mixed-precision smoother
    (`pallas_flat.py:814-846`): the cascade reads a bf16 rounding of the
    float32 residual ``r1``; ``e = r·iD`` with zero ghosts, then per colour
    ``s = r − Σ_d (e(−e_d)·L_d + e(+e_d)·L_d(+e_d))``, ``e = s·iD`` on the
    colour's interior cells, every operation a bf16 operation."""
    inside = inside_mask(r1.shape, r1.device)
    rv = r1.to(BF16)
    e = torch.where(inside, rv * iD16, 0.0)
    if colors:
        parity = index_sum_parity(r1.shape, r1.device)
        for c in colors:
            s = rv
            for d in range(L16.shape[0]):
                s = s - (shift(e, d, -1) * L16[d]
                         + shift(e, d, 1) * shift(L16[d], d, 1))
            e = torch.where((parity == c) & inside, s * iD16, e)
    return e


def _mp_mult(e, L16, D16) -> torch.Tensor:
    """``A·e`` accumulated in bf16 in the order of `pallas_flat.py:850-857`:
    ``e·D``, then per direction ``(acc + e(−e_d)·L_d) + e(+e_d)·L_d(+e_d)``;
    float32 on return, ghosts zero."""
    s = e * D16
    for d in range(L16.shape[0]):
        s = s + shift(e, d, -1) * L16[d] + shift(e, d, 1) * shift(L16[d], d, 1)
    return zero_ghost(s.float())


def _bf16(name: str, **tensors):
    for arg, t in tensors.items():
        if t.dtype != BF16:
            raise TypeError(f"{name}: with mp=True {arg} must be torch.bfloat16 "
                            f"(`poisson.with_bf16`), got {t.dtype}")


def gs_incr_plain(x, r, L, D, iD, colors: Sequence[int], omega,
                  mp: bool = False):
    """Red-black smoother + increment (`GaussSeidelRB!` + `increment!`,
    `Poisson.jl:100-148`, non-periodic): `_rb_sweeps`, then ``x += ω·eps``
    and ``r −= ω·A·eps``.  ``colors=[]`` is the Jacobi smoother (`Jacobi!`,
    `Poisson.jl:111-114`).  ``mp``: ``L``, ``D``, ``iD`` are bf16 and the
    correction and ``A·eps`` are formed in bf16 (`_mp_sweeps`, `_mp_mult`);
    the two updates stay float32."""
    if mp:
        _bf16("gs_incr_plain", L=L, D=D, iD=iD)
        e = _mp_sweeps(r, L, iD, colors)
        return x + omega * e.float(), r - omega * _mp_mult(e, L, D)
    eps = _rb_sweeps(r, L, iD, colors)
    r = r - omega * mult_plain(eps, L, D)
    x = x + omega * zero_ghost(eps)
    return x, r


# ---------------------------------------------------------------- wrappers
def _lib():
    from . import _build

    return _build.load()


def _check(name: str, shape: tuple[int, ...], device: torch.device,
           dtype: torch.dtype = torch.float32, /, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if tuple(t.shape[-3:]) != shape or t.dim() < 3:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected trailing {shape}")


def _lead(name: str, arg: str, t: torch.Tensor, lead: tuple[int, ...]) -> None:
    if tuple(t.shape[:-3]) != lead:
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected leading {lead}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({_lib().wlt_error_string(err).decode()})")
    _LAUNCHES[name] += 1


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _dirs(name: str, perdir) -> list[int]:
    dirs = [int(j) for j in perdir]
    if any(j not in (0, 1, 2) for j in dirs) or len(set(dirs)) != len(dirs):
        raise ValueError(f"{name}: perdir must hold distinct directions 0-2, "
                         f"got {tuple(perdir)}")
    return dirs


def conv_diff_k(u: torch.Tensor, nu, scheme_id: int,
                perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """K12: conv–diff RHS of all three components, ``(3, Nx, Ny, Nz)`` f32,
    every cell written with the plain formula (`conv_diff_plain`), periodic
    in the directions of ``perdir``.  ``nu`` is a 0-d tensor read on the
    card (no host sync) or a float."""
    if not u.is_cuda:
        return conv_diff_plain(u, nu, SCHEMES[scheme_id], perdir)
    shape = tuple(u.shape[1:])
    _check("conv_diff_k", shape, u.device, u=u)
    _lead("conv_diff_k", "u", u, (3,))
    if not 0 <= scheme_id < len(SCHEMES):
        raise ValueError(f"conv_diff_k: unknown scheme id {scheme_id}")
    per = sum(1 << j for j in _dirs("conv_diff_k", perdir))
    nu = torch.as_tensor(nu, dtype=torch.float32, device=u.device)
    if nu.numel() != 1:
        raise ValueError("conv_diff_k: nu must be a scalar")
    out = torch.empty_like(u)
    lib = _lib()
    _launch("conv_diff_k", lib.wlt_conv_diff, _ptr(u), _ptr(nu), _ptr(out),
            *shape, scheme_id, per, _stream(u.device))
    return out


def bdim_band_k(u, u0, f, V, mu0, mu1, dt: float, band: tuple[int, int],
                perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """K2: `bdim_band_plain` in one launch over the whole field: the
    far-field update on the rows outside ``band``, K14's update on the rows
    inside, which reads ``f*`` at neighbours in the rows next to it."""
    if not u.is_cuda:
        return bdim_band_plain(u, u0, f, V, mu0, mu1, dt, band, perdir)
    shape = tuple(u.shape[1:])
    _check("bdim_band_k", shape, u.device, u=u, u0=u0, f=f, V=V, mu0=mu0, mu1=mu1)
    for arg, t in (("u", u), ("u0", u0), ("f", f), ("V", V), ("mu0", mu0)):
        _lead("bdim_band_k", arg, t, (3,))
    _lead("bdim_band_k", "mu1", mu1, (3, 3))
    lo, hi = int(band[0]), int(band[1])
    if hi > lo and not 1 <= lo < hi <= shape[0] - 1:
        raise ValueError(f"bdim_band_k: band {band} outside [1, {shape[0] - 1}]")
    per = sum(1 << j for j in _dirs("bdim_band_k", perdir))
    out = torch.empty_like(u)
    _launch("bdim_band_k", _lib().wlt_bdim_band, _ptr(u), _ptr(u0), _ptr(f),
            _ptr(V), _ptr(mu0), _ptr(mu1), ctypes.c_float(float(dt)), lo, hi,
            per, _ptr(out), *shape, _stream(u.device))
    return out


def bdim_k(u, u0, f, V, mu0, mu1, dt: float) -> torch.Tensor:
    """K14: BDIM update with ``f* = u0 + dt·f − V`` fused in (`bdim_plain`);
    ghosts keep ``u``."""
    if not u.is_cuda:
        return bdim_plain(u, u0, f, V, mu0, mu1, dt)
    shape = tuple(u.shape[1:])
    _check("bdim_k", shape, u.device, u=u, u0=u0, f=f, V=V, mu0=mu0, mu1=mu1)
    for arg, t in (("u", u), ("u0", u0), ("f", f), ("V", V), ("mu0", mu0)):
        _lead("bdim_k", arg, t, (3,))
    _lead("bdim_k", "mu1", mu1, (3, 3))
    out = torch.empty_like(u)
    lib = _lib()
    _launch("bdim_k", lib.wlt_bdim, _ptr(u), _ptr(u0), _ptr(f), _ptr(V),
            _ptr(mu0), _ptr(mu1), ctypes.c_float(float(dt)), _ptr(out),
            *shape, _stream(u.device))
    return out


def mult_k(x: torch.Tensor, L: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """K16: A·x with zero ghosts (`mult_plain`)."""
    if not x.is_cuda:
        return mult_plain(x, L, D)
    shape = tuple(x.shape)
    _check("mult_k", shape, x.device, x=x, L=L, D=D)
    _lead("mult_k", "x", x, ())
    _lead("mult_k", "L", L, (3,))
    _lead("mult_k", "D", D, ())
    out = torch.empty_like(x)
    lib = _lib()
    _launch("mult_k", lib.wlt_mult, _ptr(x), _ptr(L), _ptr(D), _ptr(out),
            *shape, _stream(x.device))
    return out


# the routes of `gs_incr_k` and `gauss_sweeps_k`, as the C side names them
PER_COLOUR, CASCADE = 0, 1


def _colors(name: str, colors: Sequence[int]) -> list[int]:
    cols = [int(c) for c in colors]
    if any(c not in (0, 1) for c in cols):
        raise ValueError(f"{name}: colours must be 0 or 1, got {cols}")
    return cols


def gs_incr_k(x, r, L, D, iD, colors: Sequence[int], omega: float,
              mp: bool = False):
    """K15: red-black sweeps + increment (`gs_incr_plain`); ``colors=[]``
    is the Jacobi smoother.  ``mp`` launches the mixed-precision
    instantiation (K4/K5 with ``mp=True``) on bf16 ``L``, ``D``, ``iD`` with
    a bf16 scratch.  Float32 with 1–4 colours on a large level is one launch
    of the tiled cascade, the rest a launch per colour: the C side picks the
    route from the shape and the arguments (`wlt_gs_incr_route`).  Returns
    new ``(x, r)``."""
    if not x.is_cuda:
        return gs_incr_plain(x, r, L, D, iD, colors, omega, mp)
    return _gs_incr_launch(x, r, L, D, iD, colors, omega, mp)


def _gs_incr_launch(x, r, L, D, iD, colors, omega, mp, route=None):
    """`gs_incr_k` on the card, on the route the shape gives (``route`` None)
    or on the one named (`PER_COLOUR`, `CASCADE`), which the kernel tests
    use to hold both routes at any shape."""
    shape = tuple(x.shape)
    name = "gs_incr_mp_k" if mp else "gs_incr_k"
    cdt = BF16 if mp else torch.float32
    _check(name, shape, x.device, x=x, r=r)
    _check(name, shape, x.device, cdt, L=L, D=D, iD=iD)
    for arg, t in (("x", x), ("r", r), ("D", D), ("iD", iD)):
        _lead(name, arg, t, ())
    _lead(name, "L", L, (3,))
    cols = _colors(name, colors)
    lib = _lib()
    if route is None:
        route = lib.wlt_gs_incr_route(*shape, len(cols), int(mp))
    carr = (ctypes.c_int * max(1, len(cols)))(*cols)
    # the per-colour sweeps need a scratch field (none for Jacobi)
    eps = torch.empty_like(x, dtype=cdt) if cols and route == PER_COLOUR else x
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    _launch(name, lib.wlt_gs_incr_mp if mp else lib.wlt_gs_incr, _ptr(x),
            _ptr(r), _ptr(L), _ptr(D), _ptr(iD), _ptr(eps), _ptr(x_out),
            _ptr(r_out), carr, len(cols), ctypes.c_float(float(omega)), route,
            *shape, _stream(x.device))
    return x_out, r_out


def gauss_sweeps_k(eps, r, L, iD, colors: Sequence[int],
                   perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """K13: `gauss_sweeps_plain` (a periodic ghost refresh of ``eps`` and
    one colour sweep per colour) in one kernel entry; returns the new
    ``eps``, the input is not modified.  1–4 colours on a large level with
    an even interior extent in every periodic direction are one launch of
    the tiled cascade, the rest a launch per colour and direction
    (`wlt_gauss_sweeps_route`).  In a periodic direction ``L``'s ghost
    planes must hold their partners' values, as `bc.bc_vector` with
    ``perdir`` leaves them."""
    if not eps.is_cuda:
        return gauss_sweeps_plain(eps, r, L, iD, colors, perdir)
    return _gauss_sweeps_launch(eps, r, L, iD, colors, perdir)


def _gauss_sweeps_launch(eps, r, L, iD, colors, perdir, route=None):
    """`gauss_sweeps_k` on the card, on the route the shape gives
    (``route`` None) or on the one named."""
    shape = tuple(eps.shape)
    _check("gauss_sweeps_k", shape, eps.device, eps=eps, r=r, L=L, iD=iD)
    for arg, t in (("eps", eps), ("r", r), ("iD", iD)):
        _lead("gauss_sweeps_k", arg, t, ())
    _lead("gauss_sweeps_k", "L", L, (3,))
    cols = _colors("gauss_sweeps_k", colors)
    dirs = _dirs("gauss_sweeps_k", perdir)
    lib = _lib()
    if route is None:
        route = lib.wlt_gauss_sweeps_route(*shape, len(cols),
                                           sum(1 << j for j in dirs))
    carr = (ctypes.c_int * max(1, len(cols)))(*cols)
    parr = (ctypes.c_int * max(1, len(dirs)))(*dirs)
    out = torch.empty_like(eps)        # every cell is written on either route
    _launch("gauss_sweeps_k", lib.wlt_gauss_sweeps, _ptr(eps), _ptr(out),
            _ptr(r), _ptr(L), _ptr(iD), carr, len(cols), parr, len(dirs),
            route, *shape, _stream(eps.device))
    return out
