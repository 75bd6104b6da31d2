"""Carry the JAX package's state across to the port.

The two packages share no objects: the JAX side hands over plain numpy
arrays (``np.asarray`` of its fields) and these functions build the port's
tensors from them, so that a test or a user can step the same state in both.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .models.flow import FlowState
from .ops.poisson import PoissonLevel

__all__ = ["flow_state_from_numpy", "levels_from_numpy"]

_FIELDS = ("u", "u0", "p", "V", "mu0", "mu1", "nu")


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def flow_state_from_numpy(arrays: Mapping[str, np.ndarray], device,
                          dtype: torch.dtype) -> FlowState:
    """A `FlowState` from ``{u, u0, p, V, mu0, mu1, nu}`` numpy arrays (the
    fields of the JAX `FlowState`); ``nu`` becomes a 0-d tensor."""
    missing = [k for k in _FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"flow_state_from_numpy: missing fields {missing}")
    return FlowState(**{k: _tensor(arrays[k], device, dtype) for k in _FIELDS})


def levels_from_numpy(levels: Sequence[Sequence], device,
                      dtype: torch.dtype) -> tuple[PoissonLevel, ...]:
    """The multigrid stack from ``(L, D, iD, Ainv)`` numpy tuples, one per
    level (``Ainv`` None except on the coarsest), dense: a level the JAX
    package keeps in its flat layout comes through its `from_flat`.  The
    bfloat16 copies of the mixed-precision smoother are `mgflat.mp_levels`'s
    to attach."""
    return tuple(
        PoissonLevel(_tensor(L, device, dtype), _tensor(D, device, dtype),
                     _tensor(iD, device, dtype),
                     None if Ainv is None else _tensor(Ainv, device, dtype))
        for L, D, iD, Ainv in levels)
