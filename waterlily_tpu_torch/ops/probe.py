"""Copy probes: the streaming rate and the launch cost the card gives a
kernel of this package.

Counterpart of the probe kernels of `benchmarks/leanprobe.py` (`:99`,
`:117`, `:149`) and `benchmarks/bwprobe.py` (`:115`, `:128`, `:157`), which
gave the TPU kernels their roofline: ``out_k = a_k · 1.0000001`` on one or
six float32 fields.  One CUDA kernel (`csrc/probe.cu`, `copy_scale_kernel<NF>`)
serves all of them, launched at a chosen block size (one field through
`wlt_copy_scale`, two pointers; six through `wlt_copy_scale6`'s pointer
arrays); `tools/bandwidth_probe.py`
drives it at the shapes of the solver (one 258³ field, eight of them
concatenated, six fields, an 8×8×8 field launched back to back).

As in `ops/stencil3d.py`: `copy_scale_plain` is the plain version; the
wrapper given CPU tensors returns it, given CUDA tensors it launches the
kernel or raises (and raises when a field carries a forward-mode tangent,
`stencil3d._no_tangent`); each launch adds one to ``copy_scale_k`` (one field) or
``copy_scale6_k`` (six) in `stencil3d.launch_counts()`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .stencil3d import (F32, _fits, _fwad, _launch, _lib, _no_tangent, _peek,
                        _raw_stream, _stream)

__all__ = ["SCALE", "copy_scale_plain", "copy_scale_k"]

SCALE = 1.0000001      # rounds to 1 + 2⁻²³ in float32
_PTRS6 = ctypes.c_void_p * 6
_BLOCKS = frozenset(range(32, 1025, 32))


def copy_scale_plain(fields: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``a · 1.0000001`` of every field."""
    return [a * SCALE for a in fields]


def _refuse(dev) -> None:
    raise ValueError("copy_scale_k: every field and output must be a "
                     "contiguous, 16-byte aligned float32 tensor of one "
                     f"shape on {dev}")


def copy_scale_k(fields: Sequence[torch.Tensor], block: int = 256,
                 out: Optional[Sequence[torch.Tensor]] = None) -> list[torch.Tensor]:
    """`copy_scale_plain` of one or six float32 fields of one shape in one
    launch with ``block`` threads per block; writes into ``out`` when given
    (a chain of launches then allocates nothing).  One field, the tiny
    chain's case, passes two pointers and no pointer arrays."""
    a = fields[0]
    if not a.is_cuda:
        return copy_scale_plain(fields)
    if _peek() is not None or _fwad._current_level >= 0:
        _no_tangent("copy_scale_k", *fields)
    nf = len(fields)
    if nf != 1 and nf != 6:
        raise ValueError(f"copy_scale_k: takes 1 or 6 fields, got {nf}")
    if out is not None and len(out) != nf:
        raise ValueError("copy_scale_k: out must hold one tensor per field")
    if block not in _BLOCKS:
        raise ValueError(f"copy_scale_k: block must be a multiple of 32 in "
                         f"[32, 1024], got {block}")
    if nf == 1:
        # `_fits` and `_stream` written out: through them the tiny chain
        # paid 1.6 µs a launch more, which put it above `torch.mul`'s
        # (`tools/bandwidth_probe.py --against`, PERF.md section 6).  a is
        # on the card, so b is on its device iff b has its index.
        b = torch.empty_like(a) if out is None else out[0]
        pa, pb, idx = a.data_ptr(), b.data_ptr(), a.get_device()
        if ((pa | pb) % 16 or a.dtype is not F32 or b.dtype is not F32
                or not (a.is_contiguous() and b.is_contiguous())
                or b.get_device() != idx or b.shape != a.shape):
            _refuse(a.device)
        _launch("copy_scale_k", _lib().wlt_copy_scale(
            pa, pb, a.numel(), int(block), _raw_stream(idx)), a.shape)
        return [b]
    out = [torch.empty_like(t) for t in fields] if out is None else list(out)
    ptrs = [t.data_ptr() for t in (*fields, *out)]
    if any(p % 16 for p in ptrs) or not _fits(a.device, F32, a.shape, *fields, *out):
        _refuse(a.device)
    _launch("copy_scale6_k", _lib().wlt_copy_scale6(
        _PTRS6(*ptrs[:6]), _PTRS6(*ptrs[6:]), a.numel(), int(block), _stream(a)),
        a.shape)
    return out
