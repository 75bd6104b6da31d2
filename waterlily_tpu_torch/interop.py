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
from .models.rigidmap import RigidMap
from .ops.poisson import PoissonLevel
from .utils.metrics import MeanFlow
from .utils.pathlines import Particles

__all__ = ["flow_state_from_numpy", "levels_from_numpy", "rigidmap_from_numpy",
           "meanflow_from_numpy", "particles_from_numpy", "fields_from_blocked"]

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


_MAP_FIELDS = ("x0", "theta", "xp", "V", "omega")


def rigidmap_from_numpy(params: Mapping[str, np.ndarray], device,
                        dtype: torch.dtype) -> RigidMap:
    """A `RigidMap` from ``{x0, theta, xp, V, omega}`` numpy arrays (the
    parameters of the JAX `RigidMap`; R follows from theta), so that the
    same moving body steps in both packages."""
    missing = [k for k in _MAP_FIELDS if k not in params]
    if missing:
        raise KeyError(f"rigidmap_from_numpy: missing fields {missing}")
    return RigidMap(**{k: _tensor(params[k], device, dtype) for k in _MAP_FIELDS})


def meanflow_from_numpy(arrays: Mapping[str, np.ndarray], device,
                        dtype: torch.dtype) -> MeanFlow:
    """A `MeanFlow` from ``{P, U, t}`` and, with Reynolds stresses, ``UU``
    (the JAX `MeanFlow`'s fields: numpy arrays and the list of times)."""
    P = _tensor(arrays["P"], device, dtype)
    mf = MeanFlow(shape=tuple(n - 2 for n in P.shape), D=arrays["U"].shape[0],
                  uu_stats=arrays.get("UU") is not None, dtype=dtype,
                  device=device)
    mf.P, mf.U = P, _tensor(arrays["U"], device, dtype)
    if mf.UU is not None:
        mf.UU = _tensor(arrays["UU"], device, dtype)
    mf.t = [float(v) for v in arrays["t"]]
    return mf


def particles_from_numpy(arrays: Mapping[str, np.ndarray], device,
                         dtype: torch.dtype, life: int = 255,
                         seed: int = 0) -> Particles:
    """`Particles` at the JAX swarm's ``{pos, age}`` (numpy arrays), with a
    respawn generator seeded with ``seed`` (the JAX swarm's key has no
    counterpart: respawned positions differ)."""
    return Particles(pos=_tensor(arrays["pos"], device, dtype),
                     age=torch.as_tensor(np.array(arrays["age"]), dtype=torch.int64,
                                         device=device),
                     generator=torch.Generator(device=device).manual_seed(seed),
                     life=life)


def fields_from_blocked(arrays: Mapping[str, np.ndarray], sizes: Sequence[int],
                        device, dtype: torch.dtype) -> dict:
    """Dense single-device tensors from a distributed run's fields in the
    blocked layout (``np.asarray`` of the JAX `DistSimulation`'s
    ``state.u``, ``state.p``, ...: the shards' padded blocks side by side),
    through `parallel.dist.from_blocked` with the mesh extent per spatial
    dim ``sizes``.  The keys name the fields (`FlowState`'s: ``u``, ``u0``,
    ``p``, ``V``, ``mu0``, ``mu1``); the dense ``u`` and ``p`` restart a
    port run through `DistSimulation.restore_fields`."""
    from .parallel.dist import _LEAD, from_blocked

    unknown = set(arrays) - set(_LEAD)
    if unknown:
        raise KeyError(f"fields_from_blocked: unknown fields {sorted(unknown)}")
    return {k: _tensor(from_blocked(np.asarray(a), tuple(sizes), _LEAD[k]), device, dtype)
            for k, a in arrays.items()}
