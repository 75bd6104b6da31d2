"""Hand-written CUDA stencil kernels for the dense layout, with their plain
PyTorch versions.

Counterpart of `waterlily_tpu/ops/pallas3d.py`.  Four kernels carry the hot
stencils of the static-body main path (sources in `csrc/stencil3d.cu`, built
with `nvcc` for `sm_90a` on first use, see `ops/_build.py`):

=============  ===========================================  ==================
wrapper        replaces (TPU)                               JAX caller
=============  ===========================================  ==================
`conv_diff_k`  `pallas3d.py:274` `conv_diff3d_generic`      `flow.conv_diff`
`bdim_k`       `pallas3d.py:372` `bdim3d`                   `flow.bdim_update`
`mult_k`       `pallas3d.py:504` `mult3d`                   `poisson._mult_raw`
`gs_incr_k`    `pallas3d.py:416,497` `gs_incr3d`,           `poisson.jacobi`,
               `jacobi_incr3d`                              `poisson.gauss_seidel_rb`
=============  ===========================================  ==================

Beside each kernel sits its plain version (``*_plain``): the jnp body of the
JAX caller written in torch, general in the number of dims.  A wrapper given
a CPU tensor returns the plain version; given a CUDA tensor it launches the
kernel or raises.  The call sites route through `use_kernels`: a CUDA,
float32, 3-D tensor takes the kernel (f64 or CPU tensors take the plain
version, a routing by dtype and device as in the JAX `use_pallas`).
`plain_ops()` forces the plain route on the card so both can be compared.

Each wrapper adds one to its entry in `launch_counts()` per call that
launches on the card, and nowhere else; the count also holds the four
kernels of `ops/fused3d.py`.

Unlike the Pallas path, the kernels write every cell with the plain formula:
`conv_diff_k` defines the ghost rows of ``f`` (read by the BDIM gradient at
the domain faces) and `gs_incr_k` leaves the ghosts of ``x`` and ``r`` as
the plain increment leaves them.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Callable, Sequence

import torch

from .grid import index_sum_parity, inside_mask, shift, zero_ghost

__all__ = [
    "use_kernels", "plain_ops", "launch_counts", "reset_launch_counts",
    "median3", "quick", "cds", "vanleer", "SCHEMES", "scheme_id",
    "conv_diff_plain", "bdim_plain", "mult_plain", "gs_incr_plain",
    "conv_diff_k", "bdim_k", "mult_k", "gs_incr_k",
]

_PLAIN = contextvars.ContextVar("waterlily_tpu_torch_plain_ops", default=False)
# launches per wrapper, of this module's kernels and of `ops/fused3d.py`'s
_LAUNCHES = {"conv_diff_k": 0, "bdim_k": 0, "mult_k": 0, "gs_incr_k": 0,
             "conv_diff_bdim_k": 0, "incr_gs_k": 0, "bc_div_k": 0,
             "projbc_k": 0}


def use_kernels(t: torch.Tensor) -> bool:
    """Kernel gate: a CUDA, float32, 3-D tensor, outside `plain_ops()`.
    Mirrors `pallas3d.use_pallas` (`pallas3d.py:41-60`) without its TPU
    tiling floor of 18 cells."""
    return (t.is_cuda and t.dtype == torch.float32 and t.dim() == 3
            and not _PLAIN.get())


@contextlib.contextmanager
def plain_ops():
    """Route every call site to the plain PyTorch versions inside the block
    (used to compare the kernels with them on the card)."""
    token = _PLAIN.set(True)
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


def scheme_id(scheme: Callable) -> int:
    """Template index of a convection scheme; raises for a scheme that has
    no kernel."""
    for k, s in enumerate(SCHEMES):
        if s is scheme:
            return k
    raise NotImplementedError(
        f"scheme {getattr(scheme, '__name__', scheme)!r} has no CUDA kernel; "
        "the kernel covers quick, vanleer and cds")


# ---------------------------------------------------------------- plain
def _slab_ix(axis: int, idx: int):
    return (slice(None),) * axis + (slice(idx, idx + 1),)


def _phi_slabs(u, f, i, j, scheme, nu):
    """Fixed fluxes of pair (i, j) at the first interior slab (`ϕuL`) and at
    the top ghost slab (`ϕuR`) of a non-periodic direction (`Flow.jl:56-62`;
    the JAX `_phi_slabs` without ``ctx``)."""
    n = f.shape[j]
    lo, hi = _slab_ix(j, 1), _slab_ix(j, n - 1)

    def uadv_slab(sl):
        if i == j:
            idx = sl[j].start
            return 0.5 * (u[j][sl] + u[j][_slab_ix(j, idx - 1)])
        return 0.5 * (u[j][sl] + shift(u[j][sl], i, -1))

    f0, f1, f2 = f[_slab_ix(j, 0)], f[lo], f[_slab_ix(j, 2)]
    ua = uadv_slab(lo)
    phi_lo = (ua * torch.where(ua > 0, 0.5 * (f1 + f0), scheme(f2, f1, f0))
              - nu * (f1 - f0))
    fm1, fm2, fm3 = f[hi], f[_slab_ix(j, n - 2)], f[_slab_ix(j, n - 3)]
    ua_h = uadv_slab(hi)
    phi_hi = (ua_h * torch.where(ua_h < 0, 0.5 * (fm1 + fm2), scheme(fm3, fm2, fm1))
              - nu * (fm1 - fm2))
    return phi_lo, phi_hi


def conv_diff_plain(u: torch.Tensor, nu, scheme: Callable) -> torch.Tensor:
    """Convective + diffusive momentum RHS (`conv_diff!`, `Flow.jl:38-62`):
    the jnp body of the JAX `conv_diff` for non-periodic directions.

    Per (component i, direction j) the flux
    ``Φ = uadv·λ(upwind stencil of u_i) − ν ∂u_i/∂x_j`` is evaluated with
    roll shifts, fixed at the first interior slab (ϕuL) and at the top ghost
    slab (ϕuR); ``r_i = Σ_j Φ − Φ(+e_j)``.  Every cell is defined, ghosts
    included, with roll-wrap reads."""
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
            phi_lo, phi_hi = _phi_slabs(u, f, i, j, scheme, nu)
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


def _rb_sweeps(r, L, iD, colors: Sequence[int]) -> torch.Tensor:
    """``eps = r·iD`` with zero ghosts; then per colour, the interior cells
    of index-sum parity ``colour`` take `_gauss(eps)`."""
    eps = zero_ghost(r * iD)
    if colors:
        parity = index_sum_parity(r.shape, r.device)
        inside = inside_mask(r.shape, r.device)
        for c in colors:
            eps = torch.where((parity == c) & inside, _gauss(r, eps, L, iD), eps)
    return eps


def gs_incr_plain(x, r, L, D, iD, colors: Sequence[int], omega):
    """Red-black smoother + increment (`GaussSeidelRB!` + `increment!`,
    `Poisson.jl:100-148`, non-periodic): `_rb_sweeps`, then ``x += ω·eps``
    and ``r −= ω·A·eps``.  ``colors=[]`` is the Jacobi smoother (`Jacobi!`,
    `Poisson.jl:111-114`)."""
    eps = _rb_sweeps(r, L, iD, colors)
    r = r - omega * mult_plain(eps, L, D)
    x = x + omega * zero_ghost(eps)
    return x, r


# ---------------------------------------------------------------- wrappers
def _lib():
    from . import _build

    return _build.load()


def _check(name: str, shape: tuple[int, ...], device: torch.device,
           **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes float32")
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


def conv_diff_k(u: torch.Tensor, nu, scheme_id: int) -> torch.Tensor:
    """K12: conv–diff RHS of all three components, ``(3, Nx, Ny, Nz)`` f32,
    every cell written with the plain formula (`conv_diff_plain`).  ``nu``
    is a 0-d tensor read on the card (no host sync) or a float."""
    if not u.is_cuda:
        return conv_diff_plain(u, nu, SCHEMES[scheme_id])
    shape = tuple(u.shape[1:])
    _check("conv_diff_k", shape, u.device, u=u)
    _lead("conv_diff_k", "u", u, (3,))
    if not 0 <= scheme_id < len(SCHEMES):
        raise ValueError(f"conv_diff_k: unknown scheme id {scheme_id}")
    nu = torch.as_tensor(nu, dtype=torch.float32, device=u.device)
    if nu.numel() != 1:
        raise ValueError("conv_diff_k: nu must be a scalar")
    out = torch.empty_like(u)
    lib = _lib()
    _launch("conv_diff_k", lib.wlt_conv_diff, _ptr(u), _ptr(nu), _ptr(out),
            *shape, scheme_id, _stream(u.device))
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


def gs_incr_k(x, r, L, D, iD, colors: Sequence[int], omega: float):
    """K15: red-black sweeps + increment (`gs_incr_plain`); ``colors=[]``
    is the Jacobi smoother.  Returns new ``(x, r)``."""
    if not x.is_cuda:
        return gs_incr_plain(x, r, L, D, iD, colors, omega)
    shape = tuple(x.shape)
    _check("gs_incr_k", shape, x.device, x=x, r=r, L=L, D=D, iD=iD)
    for arg, t in (("x", x), ("r", r), ("D", D), ("iD", iD)):
        _lead("gs_incr_k", arg, t, ())
    _lead("gs_incr_k", "L", L, (3,))
    cols = [int(c) for c in colors]
    if any(c not in (0, 1) for c in cols):
        raise ValueError(f"gs_incr_k: colours must be 0 or 1, got {cols}")
    carr = (ctypes.c_int * max(1, len(cols)))(*cols)
    eps = torch.empty_like(x) if cols else x   # no scratch for Jacobi
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    lib = _lib()
    _launch("gs_incr_k", lib.wlt_gs_incr, _ptr(x), _ptr(r), _ptr(L), _ptr(D),
            _ptr(iD), _ptr(eps), _ptr(x_out), _ptr(r_out), carr, len(cols),
            ctypes.c_float(float(omega)), *shape, _stream(x.device))
    return x_out, r_out
