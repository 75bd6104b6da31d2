"""Copy probes: the streaming rate and the launch cost the card gives a
kernel of this package.

Counterpart of the probe kernels of `benchmarks/leanprobe.py` (`:99`,
`:117`, `:149`) and `benchmarks/bwprobe.py` (`:115`, `:128`, `:157`), which
gave the TPU kernels their roofline: ``out_k = a_k · 1.0000001`` on one or
six float32 fields.  One CUDA kernel (`csrc/probe.cu`, `copy_scale_kernel<NF>`)
serves all of them, launched at a chosen block size; `tools/bandwidth_probe.py`
drives it at the shapes of the solver (one 258³ field, eight of them
concatenated, six fields, an 8×8×8 field launched back to back).

As in `ops/stencil3d.py`: `copy_scale_plain` is the plain version; the
wrapper given CPU tensors returns it, given CUDA tensors it launches the
kernel or raises; each launch adds one to ``copy_scale_k`` (one field) or
``copy_scale6_k`` (six) in `stencil3d.launch_counts()`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .stencil3d import _launch, _lib, _stream

__all__ = ["SCALE", "copy_scale_plain", "copy_scale_k"]

SCALE = 1.0000001      # rounds to 1 + 2⁻²³ in float32


def copy_scale_plain(fields: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """``a · 1.0000001`` of every field."""
    return [a * SCALE for a in fields]


def copy_scale_k(fields: Sequence[torch.Tensor], block: int = 256,
                 out: Optional[Sequence[torch.Tensor]] = None) -> list[torch.Tensor]:
    """`copy_scale_plain` of one or six float32 fields of one shape in one
    launch with ``block`` threads per block; writes into ``out`` when given
    (a chain of launches then allocates nothing)."""
    fields = list(fields)
    if not fields[0].is_cuda:
        return copy_scale_plain(fields)
    name = {1: "copy_scale_k", 6: "copy_scale6_k"}.get(len(fields))
    if name is None:
        raise ValueError(f"copy_scale_k: takes 1 or 6 fields, got {len(fields)}")
    out = [torch.empty_like(a) for a in fields] if out is None else list(out)
    if len(out) != len(fields):
        raise ValueError("copy_scale_k: out must hold one tensor per field")
    ref = fields[0]
    for t in (*fields, *out):
        if (t.device != ref.device or t.dtype != torch.float32
                or t.shape != ref.shape or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("copy_scale_k: every field and output must be a "
                             "contiguous, 16-byte aligned float32 tensor of one "
                             f"shape on {ref.device}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"copy_scale_k: block must be a multiple of 32 in "
                         f"[32, 1024], got {block}")
    ptrs = ctypes.c_void_p * len(fields)
    _launch(name, _lib().wlt_copy_scale, ptrs(*(a.data_ptr() for a in fields)),
            ptrs(*(a.data_ptr() for a in out)), len(fields), ref.numel(),
            int(block), _stream(ref.device))
    return out
