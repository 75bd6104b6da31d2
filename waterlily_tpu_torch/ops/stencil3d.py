"""Hand-written CUDA stencil kernels for the dense layout, with their plain
PyTorch versions.

Counterpart of `waterlily_tpu/ops/pallas3d.py`, with the band-sparse BDIM
and the mixed-precision smoother of `waterlily_tpu/ops/pallas_flat.py`, and
K12's forward-mode derivative.  Seven kernels (sources in `csrc/stencil3d.cu`
and, for `conv_diff_jvp_k`, `csrc/convdiff_jvp.cu`, built with `nvcc` for
`sm_90a` on first use, see `ops/_build.py`):

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
`conv_diff_jvp_k` the forward-mode derivative of K12 (JAX      `jax.jvp` of
                  differentiates `conv_diff3d_generic`)        `flow.conv_diff`
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

Forward-mode AD (`torch.func.jvp`, `jacfwd`, `torch.autograd.forward_ad`):
on the card K12 and K14 have rules, `torch.autograd.Function` classes whose
forward launches the kernel on the primal tensors and whose tangent is a
kernel too (`conv_diff_jvp_k`; for K14, two launches of K14 itself, which is
linear in its fields).  Each tangent is a Function of its own, so that under
`torch.func` it, too, receives plain tensors that a kernel can read.  Under
`vmap` (`jacfwd` batches the tangents) every rule and tangent runs once per
batch entry (`_loop_vmap`), each run on plain tensors.  The
pressure solve's rule (`multigrid.solve_mg_implicit`) launches K15, K16 and
K13 on primal tensors only.  Every other wrapper raises when an argument
carries a tangent (`_no_tangent`): a kernel would drop it.  The test is one
check of whether any forward-AD level or functorch transform is active,
before any tensor is looked at.  On the CPU the wrappers return the plain
versions, which PyTorch differentiates itself.

Unlike the Pallas path, the kernels write every cell with the plain formula:
`conv_diff_k` defines the ghost rows of ``f`` (read by the BDIM gradient at
the domain faces) and `gs_incr_k` leaves the ghosts of ``x`` and ``r`` as
the plain increment leaves them.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import math
from typing import Callable, Optional, Sequence

import torch
from torch.autograd import forward_ad as _fwad

from .. import tracing
from . import _build
from .bc import per_bc
from .grid import index_sum_parity, inside_mask, shift, zero_ghost

__all__ = [
    "use_kernels", "plain_route", "plain_ops", "launch_counts", "reset_launch_counts",
    "median3", "quick", "cds", "vanleer", "SCHEMES", "scheme_id",
    "conv_diff_plain", "conv_diff_jvp_plain", "bdim_plain", "bdim_band_plain",
    "mult_plain", "gs_incr_plain", "gauss_sweeps_plain",
    "conv_diff_k", "conv_diff_jvp_k", "bdim_k", "bdim_band_k", "mult_k",
    "gs_incr_k", "gauss_sweeps_k", "ad_active",
]

# the wrappers routed to their plain versions: all of them inside
# `plain_ops()` (True), or the named ones inside `plain_ops(only=...)`
_PLAIN = contextvars.ContextVar("waterlily_tpu_torch_plain_ops", default=False)
# launches per wrapper, of this module's kernels and of `ops/fused3d.py`'s
_LAUNCHES = {"conv_diff_k": 0, "bdim_k": 0, "mult_k": 0, "gs_incr_k": 0,
             "gauss_sweeps_k": 0, "conv_diff_bdim_k": 0, "incr_gs_k": 0,
             "bc_div_k": 0, "projbc_k": 0, "bc_k": 0, "div_k": 0,
             "bdim_band_k": 0, "gs_incr_mp_k": 0, "incr_gs_mp_k": 0,
             "copy_scale_k": 0, "copy_scale6_k": 0, "conv_diff_jvp_k": 0}
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
                    perdir: tuple[int, ...] = (), slabs=None) -> torch.Tensor:
    """Convective + diffusive momentum RHS (`conv_diff!`, `Flow.jl:38-62`):
    the jnp body of the JAX `conv_diff`.

    Per (component i, direction j) the flux
    ``Φ = uadv·λ(upwind stencil of u_i) − ν ∂u_i/∂x_j`` is evaluated with
    roll shifts, fixed at the first interior slab and at the top ghost slab
    (`_phi_slabs`: ϕuL/ϕuR, or ϕuP in the directions of ``perdir``; the
    pairs that ``slabs`` maps to their two fluxes take those: a shard's
    ring variant, `flow._ring_slabs`); ``r_i = Σ_j Φ − Φ(+e_j)``.  Every
    cell is defined, ghosts included, with roll-wrap reads."""
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
            phi_lo, phi_hi = ((slabs or {}).get((i, j))
                              or _phi_slabs(u, f, i, j, scheme, nu, perdir))
            phi[_slab_ix(j, 1)] = phi_lo
            phi[_slab_ix(j, n - 1)] = phi_hi
            ri = ri + (phi - shift(phi, j, 1))
        out.append(ri)
    return torch.stack(out)


def conv_diff_jvp_plain(u, du, nu, dnu, scheme: Callable,
                        perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """The forward-mode derivative of `conv_diff_plain` in ``(u, nu)`` along
    ``(du, dnu)``: ``J_conv(u)·du + ν·Δdu + dν·Δu`` with the plain version's
    selections and PyTorch's ½ split of min/max at ties (`torch.func.jvp`;
    the JAX package takes `jax.jvp` of its conv–diff)."""
    nu = torch.as_tensor(nu, dtype=u.dtype, device=u.device)
    dnu = torch.as_tensor(dnu, dtype=u.dtype, device=u.device)
    return torch.func.jvp(lambda a, b: conv_diff_plain(a, b, scheme, perdir),
                          (u, nu), (du, dnu))[1]


def bdim_plain(u, u0, f, V, mu0, mu1, dt) -> torch.Tensor:
    """BDIM update (`BDIM!`, `Flow.jl:176-180`): ``f* = u0 + dt·f − V``, then
    ``u_i += ½Σ_j μ1[i,j](f*_i(+e_j) − f*_i(−e_j)) + V_i + μ0_i·f*_i`` on
    interior faces; ghosts keep ``u``."""
    return bdim_apply(u, u0 + dt * f - V, V, mu0, mu1)


def bdim_apply(u, fp, V, mu0, mu1) -> torch.Tensor:
    """The BDIM update of `bdim_plain` from a given ``f* = fp``."""
    D = u.shape[0]
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
# The launch path of every wrapper (here, in `ops/fused3d.py` and in
# `ops/probe.py`), built for the host cost of a launch: `_fits` checks each
# tensor in one comparison and `_invalid` builds the message only when that
# fails; the pure functions of the shape and arguments (`_rule`'s routes and
# norm-partial counts, `_colours`' and `_perdir`'s ctypes arrays) are asked
# once and kept in dicts; pointers reach ctypes as `data_ptr()` ints (the
# argtypes `_build` declares pass them as 64-bit pointers); PyTorch's current
# stream is read at every call (`_stream`).
F32 = torch.float32


def _lib():
    return _build.load()


def _fits(dev: torch.device, dtype: torch.dtype, shape, *ts: torch.Tensor) -> bool:
    """Whether every tensor of ``ts`` lies on ``dev``, has ``dtype`` and the
    full shape ``shape`` and is contiguous: what `_invalid` checks, in one
    comparison a tensor."""
    for t in ts:
        if not (t.shape == shape and t.dtype is dtype and t.is_contiguous()
                and t.device == dev):
            return False
    return True


def _invalid(name: str, shape: tuple[int, ...], device: torch.device, *specs):
    """Raise for the arguments `_fits` refused.  ``specs`` are ``(arg,
    tensor, dtype, lead)``, each tensor expected on ``device`` with the full
    shape ``lead + shape``: device, dtype, contiguity and the trailing shape
    of every argument are checked before the leading shapes."""
    for arg, t, dtype, _ in specs:
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if tuple(t.shape[-3:]) != shape or t.dim() < 3:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected trailing {shape}")
    for arg, t, _, lead in specs:
        if tuple(t.shape[:-3]) != lead:
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected leading {lead}")
    # every condition of `_fits` is one above: never reached for its refusal
    raise ValueError(f"{name}: invalid arguments")


# the handle of PyTorch's current stream on a device; absent from CPU builds
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on the device of ``t``, read at every call
    (never cached), so that a launch follows `torch.cuda.stream` blocks and
    CUDA graph capture."""
    return _raw_stream(t.get_device())


# forward-mode AD: the functorch transform stack (None when no transform
# is active) and the test of a functorch wrapper (a tensor under
# `torch.func.jvp`, `jacfwd` or `vmap`, which has no storage)
_peek = torch._C._functorch.peek_interpreter_stack
_wrapped = torch._C._functorch.is_functorch_wrapped_tensor


def ad_active() -> bool:
    """Whether a functorch transform or a `torch.autograd.forward_ad` level is
    active: the one check a wrapper makes before it looks at any tensor for
    a tangent (`_no_tangent`).  Inside a rule's forward, under
    `torch.func`, no transform is active and the tensors are plain.  The
    wrappers write the test out: a call would cost them more than it."""
    return _peek() is not None or _fwad._current_level >= 0


def _no_tangent(name: str, *ts) -> None:
    """Raise if a tensor of ``ts`` carries a forward-mode tangent, which the
    kernel ``name`` would drop.  Called only when `ad_active`."""
    level = _fwad._current_level
    for t in ts:
        if isinstance(t, torch.Tensor) and (
                _wrapped(t) or (level >= 0 and _fwad.unpack_dual(t).tangent is not None)):
            raise RuntimeError(
                f"{name}: an argument carries a forward-mode tangent "
                "(torch.func.jvp/jacfwd/vmap or torch.autograd.forward_ad), and this "
                "kernel has no forward-mode rule ([ad]): a launch would drop it. "
                "Differentiate the generic engine (models.flow.mom_step_impl, whose "
                "conv-diff, BDIM and multigrid solve have rules, engine='3d'), or "
                "the plain versions on the CPU; the flat engine is not differentiable")


def _launch(name: str, err: int, shape, route: Optional[int] = None,
            ncol: int = 1) -> None:
    """Count a launch of the wrapper ``name`` whose entry returned ``err``,
    or raise.  While `tracing` records, also add the call's padded cells
    (the product of ``shape``) to the session counter ``cells.<name>``, or
    for a smoother (``route``, ``ncol`` given) ``cells.<name>.<form>``:
    ``cascade``, ``per_colour``, or with no colours ``increment`` (K6) and
    ``jacobi`` (K15)."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"({_lib().wlt_error_string(err).decode()})")
    _LAUNCHES[name] += 1
    if tracing.recording:
        form = ("" if route is None else "." + (
            _ROUTES[route] if ncol else _NO_COLOURS.get(name, "no_colours")))
        tracing.count(f"cells.{name}{form}", math.prod(shape))


# the forms of the smoothers' cell counters: by route, and with no colours
_ROUTES = ("per_colour", "cascade")
_NO_COLOURS = {"incr_gs_k": "increment", "gs_incr_k": "jacobi",
               "gs_incr_mp_k": "jacobi"}


# the C rules asked once per arguments: (entry, *its int arguments) -> value
_RULES: dict[tuple, int] = {}


def _rule(entry: str, *args: int) -> int:
    """The value of the C rule ``entry`` of the library (a route or a norm
    partials count: a pure function of its integer arguments, the shape
    among them), asked once for each set of arguments.  A negative value
    (an error) is not kept."""
    key = (entry, *args)
    v = _RULES.get(key)
    if v is None:
        v = getattr(_lib(), entry)(*args)
        if v >= 0:
            _RULES[key] = v
    return v


# colour lists and periodic-direction lists -> their ctypes arrays
_COLOURS: dict[tuple, tuple] = {}
_PERDIRS: dict[tuple, tuple] = {}


def _colours(name: str, colors: Sequence[int]) -> tuple:
    """``(ctypes int array, count)`` of a colour list (each 0 or 1), made
    once per list.  The entries read the array on the host during the
    call, so one array serves every call."""
    key = tuple(colors)
    got = _COLOURS.get(key)
    if got is None:
        cols = [int(c) for c in key]
        if any(c not in (0, 1) for c in cols):
            raise ValueError(f"{name}: colours must be 0 or 1, got {cols}")
        got = ((ctypes.c_int * max(1, len(cols)))(*cols), len(cols))
        if all(type(c) is int for c in key):
            _COLOURS[key] = got
    return got


def _perdir(name: str, perdir: Sequence[int]) -> tuple:
    """``(bit mask, ctypes int array, count)`` of the periodic directions
    ``perdir`` (distinct, each 0-2), made once per list."""
    key = tuple(perdir)
    got = _PERDIRS.get(key)
    if got is None:
        dirs = [int(j) for j in key]
        if any(j not in (0, 1, 2) for j in dirs) or len(set(dirs)) != len(dirs):
            raise ValueError(f"{name}: perdir must hold distinct directions 0-2, "
                             f"got {tuple(perdir)}")
        got = (sum(1 << j for j in dirs),
               (ctypes.c_int * max(1, len(dirs)))(*dirs), len(dirs))
        if all(type(j) is int for j in key):
            _PERDIRS[key] = got
    return got


def conv_diff_k(u: torch.Tensor, nu, scheme_id: int,
                perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """K12: conv–diff RHS of all three components, ``(3, Nx, Ny, Nz)`` f32,
    every cell written with the plain formula (`conv_diff_plain`), periodic
    in the directions of ``perdir``.  ``nu`` is a 0-d tensor read on the
    card (no host sync) or a float.  Under forward-mode AD the launch goes
    through `_ConvDiffRule`: the tangent in ``u`` and ``nu`` is
    `conv_diff_jvp_k`."""
    if not u.is_cuda:
        return conv_diff_plain(u, nu, SCHEMES[scheme_id], perdir)
    if _peek() is not None or _fwad._current_level >= 0:
        return _ConvDiffRule.apply(u, _scalar("conv_diff_k", nu, u.device),
                                   scheme_id, perdir)
    return _conv_diff_launch(u, nu, scheme_id, perdir)


def _scalar(name: str, nu, dev) -> torch.Tensor:
    """``nu`` as a float32 0-d tensor on ``dev`` (read there by the kernel)."""
    nu = torch.as_tensor(nu, dtype=torch.float32, device=dev)
    if nu.numel() != 1:
        raise ValueError(f"{name}: nu must be a scalar")
    return nu


def _conv_diff_launch(u, nu, scheme_id, perdir):
    """K12's launch (`conv_diff_k` on the card outside forward-mode AD, and
    `_ConvDiffRule`'s forward)."""
    shape, dev = u.shape[1:], u.device
    if not (len(shape) == 3 and _fits(dev, F32, (3, *shape), u)):
        _invalid("conv_diff_k", tuple(shape), dev, ("u", u, F32, (3,)))
    if not 0 <= scheme_id < len(SCHEMES):
        raise ValueError(f"conv_diff_k: unknown scheme id {scheme_id}")
    per = _perdir("conv_diff_k", perdir)[0]
    nu = torch.as_tensor(nu, dtype=torch.float32, device=dev)
    if nu.numel() != 1:
        raise ValueError("conv_diff_k: nu must be a scalar")
    out = torch.empty_like(u)
    _launch("conv_diff_k", _lib().wlt_conv_diff(
        u.data_ptr(), nu.data_ptr(), out.data_ptr(), *shape, scheme_id, per,
        _stream(u)), shape)
    return out


def conv_diff_jvp_k(u: torch.Tensor, du: torch.Tensor, nu, dnu, scheme_id: int,
                    perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """K12's tangent: `conv_diff_jvp_plain` in one launch (K12's tiles on
    duals, `csrc/convdiff_jvp.cu`); ``nu`` and ``dnu`` are 0-d tensors read
    on the card or floats."""
    if not u.is_cuda:
        return conv_diff_jvp_plain(u, du, nu, dnu, SCHEMES[scheme_id], perdir)
    if _peek() is not None or _fwad._current_level >= 0:
        _no_tangent("conv_diff_jvp_k", u, du, nu, dnu)
    shape, dev = u.shape[1:], u.device
    if not (len(shape) == 3 and _fits(dev, F32, (3, *shape), u, du)):
        _invalid("conv_diff_jvp_k", tuple(shape), dev, ("u", u, F32, (3,)),
                 ("du", du, F32, (3,)))
    if not 0 <= scheme_id < len(SCHEMES):
        raise ValueError(f"conv_diff_jvp_k: unknown scheme id {scheme_id}")
    per = _perdir("conv_diff_jvp_k", perdir)[0]
    nu, dnu = _scalar("conv_diff_jvp_k", nu, dev), _scalar("conv_diff_jvp_k", dnu, dev)
    out = torch.empty_like(u)
    _launch("conv_diff_jvp_k", _lib().wlt_conv_diff_jvp(
        u.data_ptr(), du.data_ptr(), nu.data_ptr(), dnu.data_ptr(), out.data_ptr(),
        *shape, scheme_id, per, _stream(u)), shape)
    return out


def _loop_vmap(fn):
    """A `vmap` rule that applies the Function ``fn`` to each batch entry in
    turn, on plain contiguous tensors: a kernel cannot read a batched tensor,
    and a solve reads its norms back on the host.  What `torch.func.jacfwd`
    needs of a rule, whose tangents it batches."""
    def vmap(info, in_dims, *args):
        # a batched tensor's dim is an int; any other argument's is None or,
        # for a tuple, a tuple of Nones
        outs = [fn.apply(*(a.select(d, b).contiguous() if isinstance(d, int) else a
                           for a, d in zip(args, in_dims)))
                for b in range(info.batch_size)]
        if isinstance(outs[0], torch.Tensor):
            return torch.stack(outs), 0
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
    return staticmethod(vmap)


class _ConvDiffRule(torch.autograd.Function):
    """K12 under forward-mode AD: the primal on K12, the tangent on
    `conv_diff_jvp_k` (through `_ConvDiffTangent`, whose forward receives
    plain tensors under `torch.func` too)."""

    @staticmethod
    def forward(u, nu, scheme_id, perdir):
        if not u.is_cuda:      # the rule on the plain version (the CPU tests)
            return conv_diff_plain(u, nu, SCHEMES[scheme_id], perdir)
        return _conv_diff_launch(u, nu, scheme_id, perdir)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, nu, ctx.scheme_id, ctx.perdir = inputs
        ctx.set_materialize_grads(False)    # an input without a tangent: None
        ctx.save_for_forward(u, nu)

    @staticmethod
    def jvp(ctx, du, dnu, *_):
        u, nu = ctx.saved_tensors
        return _ConvDiffTangent.apply(u, du, nu, dnu, ctx.scheme_id, ctx.perdir)


class _ConvDiffTangent(torch.autograd.Function):
    @staticmethod
    def forward(u, du, nu, dnu, scheme_id, perdir):
        du = torch.zeros_like(u) if du is None else du.contiguous()
        return conv_diff_jvp_k(u, du, nu, 0.0 if dnu is None else dnu, scheme_id,
                               perdir)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


_ConvDiffRule.vmap = _loop_vmap(_ConvDiffRule)
_ConvDiffTangent.vmap = _loop_vmap(_ConvDiffTangent)


def _bdim_args(name: str, u, u0, f, V, mu0, mu1):
    """The trailing shape of the BDIM arguments, validated (K14, K2)."""
    shape, dev = u.shape[1:], u.device
    vs = (3, *shape)
    if not (len(shape) == 3 and _fits(dev, F32, vs, u, u0, f, V, mu0)
            and _fits(dev, F32, (3, *vs), mu1)):
        _invalid(name, tuple(shape), dev, *((a, t, F32, (3,)) for a, t in (
            ("u", u), ("u0", u0), ("f", f), ("V", V), ("mu0", mu0))),
            ("mu1", mu1, F32, (3, 3)))
    return shape


def bdim_band_k(u, u0, f, V, mu0, mu1, dt: float, band: tuple[int, int],
                perdir: tuple[int, ...] = ()) -> torch.Tensor:
    """K2: `bdim_band_plain` in one launch over the whole field: the
    far-field update on the rows outside ``band``, K14's update on the rows
    inside, which reads ``f*`` at neighbours in the rows next to it."""
    if not u.is_cuda:
        return bdim_band_plain(u, u0, f, V, mu0, mu1, dt, band, perdir)
    if _peek() is not None or _fwad._current_level >= 0:
        _no_tangent("bdim_band_k", u, u0, f, V, mu0, mu1, dt)
    shape = _bdim_args("bdim_band_k", u, u0, f, V, mu0, mu1)
    lo, hi = int(band[0]), int(band[1])
    if hi > lo and not 1 <= lo < hi <= shape[0] - 1:
        raise ValueError(f"bdim_band_k: band {band} outside [1, {shape[0] - 1}]")
    per = _perdir("bdim_band_k", perdir)[0]
    out = torch.empty_like(u)
    _launch("bdim_band_k", _lib().wlt_bdim_band(
        u.data_ptr(), u0.data_ptr(), f.data_ptr(), V.data_ptr(), mu0.data_ptr(),
        mu1.data_ptr(), float(dt), lo, hi, per, out.data_ptr(), *shape, _stream(u)),
        shape)
    return out


def bdim_k(u, u0, f, V, mu0, mu1, dt) -> torch.Tensor:
    """K14: BDIM update with ``f* = u0 + dt·f − V`` fused in (`bdim_plain`);
    ghosts keep ``u``.  ``dt`` is a float or a 0-d tensor (read back once).
    Under forward-mode AD the launch goes through `_BdimRule`."""
    if not u.is_cuda:
        return bdim_plain(u, u0, f, V, mu0, mu1, dt)
    if _peek() is not None or _fwad._current_level >= 0:
        return _BdimRule.apply(u, u0, f, V, mu0, mu1, dt)
    return _bdim_launch(u, u0, f, V, mu0, mu1, float(dt))


def _bdim_launch(u, u0, f, V, mu0, mu1, dt: float) -> torch.Tensor:
    """K14's launch (`bdim_k` on the card outside forward-mode AD, and the
    rule's launches through `_k14`)."""
    shape = _bdim_args("bdim_k", u, u0, f, V, mu0, mu1)
    out = torch.empty_like(u)
    _launch("bdim_k", _lib().wlt_bdim(
        u.data_ptr(), u0.data_ptr(), f.data_ptr(), V.data_ptr(), mu0.data_ptr(),
        mu1.data_ptr(), dt, out.data_ptr(), *shape, _stream(u)), shape)
    return out


def _k14(u, u0, f, V, mu0, mu1, dt: float) -> torch.Tensor:
    """K14 on the card, its plain version on the CPU (where the tests hold
    the rules)."""
    if u.is_cuda:
        return _bdim_launch(u, u0, f, V, mu0, mu1, dt)
    return bdim_plain(u, u0, f, V, mu0, mu1, dt)


class _BdimRule(torch.autograd.Function):
    """K14 under forward-mode AD.  ``out = u + zg(½Σ_j μ1·δ_j f* + V + μ0·f*)``
    with ``f* = u0 + dt·f − V`` is linear in ``(u, u0, f, V)`` for fixed
    ``(μ0, μ1, dt)``, so its tangent is K14 itself (`_BdimTangent`):

    1. K14 on the tangents, ``(u̇, u̇0 + ḋt·f, ḟ, V̇)`` with the primal
       ``(μ0, μ1, dt)``: ``u̇ + zg(½Σμ1·δḟ* + V̇ + μ0·ḟ*)``, ``ḟ* = u̇0 +
       ḋt·f + dt·ḟ − V̇`` (V̇ enters ḟ* and the ``+V`` term, as V does);
    2. where ``μ0`` or ``μ1`` carries a tangent, K14 on step 1's result with
       ``(u0 − V, f, 0)`` and ``(μ̇0, μ̇1)``: ``f*`` is the primal one and the
       ``+V`` term is 0, so it adds ``zg(½Σμ̇1·δf* + μ̇0·f*)``.

    The ghosts are step 1's ``u``: ``u̇``, as the primal's are ``u``.  ``dt``
    reaches the launches as a host float of the primal, never of a
    tangent."""

    @staticmethod
    def forward(u, u0, f, V, mu0, mu1, dt):
        return _k14(u, u0, f, V, mu0, mu1, float(dt))

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, u0, f, V, mu0, mu1, dt = inputs
        ctx.dt = dt
        # moments without a tangent come as None (not zeros): no launch 2
        ctx.set_materialize_grads(False)
        ctx.save_for_forward(u0, f, V, mu0, mu1)

    @staticmethod
    def jvp(ctx, du, du0, df, dV, dmu0, dmu1, ddt):
        u0, f, V, mu0, mu1 = ctx.saved_tensors
        return _BdimTangent.apply(u0, f, V, mu0, mu1, ctx.dt, du, du0, df, dV,
                                  dmu0, dmu1, ddt)


class _BdimTangent(torch.autograd.Function):
    @staticmethod
    def forward(u0, f, V, mu0, mu1, dt, du, du0, df, dV, dmu0, dmu1, ddt):
        def tan(t, like):
            return torch.zeros_like(like) if t is None else t.contiguous()
        dt = float(dt)
        a0 = tan(du0, u0)
        if ddt is not None:
            a0 = a0 + ddt * f
        out = _k14(tan(du, u0), a0, tan(df, f), tan(dV, V), mu0, mu1, dt)
        if dmu0 is None and dmu1 is None:
            return out
        return _k14(out, u0 - V, f, torch.zeros_like(V), tan(dmu0, mu0),
                    tan(dmu1, mu1), dt)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


_BdimRule.vmap = _loop_vmap(_BdimRule)
_BdimTangent.vmap = _loop_vmap(_BdimTangent)


def mult_k(x: torch.Tensor, L: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """K16: A·x with zero ghosts (`mult_plain`)."""
    if not x.is_cuda:
        return mult_plain(x, L, D)
    if _peek() is not None or _fwad._current_level >= 0:
        _no_tangent("mult_k", x, L, D)
    shape, dev = x.shape, x.device
    if not (len(shape) == 3 and _fits(dev, F32, shape, x, D)
            and _fits(dev, F32, (3, *shape), L)):
        _invalid("mult_k", tuple(shape), dev, ("x", x, F32, ()),
                 ("L", L, F32, (3,)), ("D", D, F32, ()))
    out = torch.empty_like(x)
    _launch("mult_k", _lib().wlt_mult(x.data_ptr(), L.data_ptr(), D.data_ptr(),
                                      out.data_ptr(), *shape, _stream(x)), shape)
    return out


# the routes of `gs_incr_k`, `gauss_sweeps_k` and `fused3d.incr_gs_k`, as the
# C side names them
PER_COLOUR, CASCADE = 0, 1


def _smoother_args(name: str, cdt: torch.dtype, x, r, L, D, iD, eps=None):
    """The shape of the smoother arguments, validated: ``x``, ``r`` (and
    ``eps``) float32, ``L``, ``D``, ``iD`` of the coefficient type ``cdt``
    (K15, K7)."""
    shape, dev = x.shape, x.device
    fields = (x, r) if eps is None else (x, r, eps)
    if not (len(shape) == 3 and _fits(dev, F32, shape, *fields)
            and _fits(dev, cdt, shape, D, iD) and _fits(dev, cdt, (3, *shape), L)):
        named = (("x", x), ("r", r)) + (() if eps is None else (("eps", eps),))
        _invalid(name, tuple(shape), dev, *((a, t, F32, ()) for a, t in named),
                 ("L", L, cdt, (3,)), ("D", D, cdt, ()), ("iD", iD, cdt, ()))
    return shape


def gs_incr_k(x, r, L, D, iD, colors: Sequence[int], omega: float,
              mp: bool = False):
    """K15: red-black sweeps + increment (`gs_incr_plain`); ``colors=[]``
    is the Jacobi smoother.  ``mp`` launches the mixed-precision
    instantiation (K4/K5 with ``mp=True``) on bf16 ``L``, ``D``, ``iD`` with
    a bf16 scratch on the per-colour route.  1–4 colours on a large level
    (float32 or bf16, each with its own size rule) are one launch of the
    tiled cascade, the rest a launch per colour: the C side picks the route
    from the shape and the arguments (`wlt_gs_incr_route`).  Returns new
    ``(x, r)``."""
    if not x.is_cuda:
        return gs_incr_plain(x, r, L, D, iD, colors, omega, mp)
    return _gs_incr_launch(x, r, L, D, iD, colors, omega, mp)


def _gs_incr_launch(x, r, L, D, iD, colors, omega, mp, route=None):
    """`gs_incr_k` on the card, on the route the shape gives (``route`` None)
    or on the one named (`PER_COLOUR`, `CASCADE`), which the kernel tests
    use to hold both routes at any shape."""
    name = "gs_incr_mp_k" if mp else "gs_incr_k"
    if _peek() is not None or _fwad._current_level >= 0:
        _no_tangent(name, x, r, L, D, iD, omega)
    cdt = BF16 if mp else F32
    shape = _smoother_args(name, cdt, x, r, L, D, iD)
    carr, ncol = _colours(name, colors)
    if route is None:
        route = _rule("wlt_gs_incr_route", *shape, ncol, int(mp))
    # the per-colour sweeps need a scratch field (none for Jacobi)
    eps = torch.empty_like(x, dtype=cdt) if ncol and route == PER_COLOUR else x
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    lib = _lib()
    _launch(name, (lib.wlt_gs_incr_mp if mp else lib.wlt_gs_incr)(
        x.data_ptr(), r.data_ptr(), L.data_ptr(), D.data_ptr(), iD.data_ptr(),
        eps.data_ptr(), x_out.data_ptr(), r_out.data_ptr(), carr, ncol,
        float(omega), route, *shape, _stream(x)), shape, route, ncol)
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
    if _peek() is not None or _fwad._current_level >= 0:
        _no_tangent("gauss_sweeps_k", eps, r, L, iD)
    shape, dev = eps.shape, eps.device
    if not (len(shape) == 3 and _fits(dev, F32, shape, eps, r, iD)
            and _fits(dev, F32, (3, *shape), L)):
        _invalid("gauss_sweeps_k", tuple(shape), dev, ("eps", eps, F32, ()),
                 ("r", r, F32, ()), ("L", L, F32, (3,)), ("iD", iD, F32, ()))
    carr, ncol = _colours("gauss_sweeps_k", colors)
    per, parr, nper = _perdir("gauss_sweeps_k", perdir)
    if route is None:
        route = _rule("wlt_gauss_sweeps_route", *shape, ncol, per)
    out = torch.empty_like(eps)        # every cell is written on either route
    _launch("gauss_sweeps_k", _lib().wlt_gauss_sweeps(
        eps.data_ptr(), out.data_ptr(), r.data_ptr(), L.data_ptr(), iD.data_ptr(),
        carr, ncol, parr, nper, route, *shape, _stream(eps)), shape, route, ncol)
    return out
