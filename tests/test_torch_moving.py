"""The port's moving-body path against the JAX package's, float64 on the CPU.

A sphere of radius 4 at (10, 8, 8) on a (32, 16, 16) grid translates in x
at speed 1.5 or 4 (4: it leaves its padded box within a step, so the
escape-widen loop runs), re-measured at every step (`sim_step(remeasure=
True)`, `sim_step_n(n, remeasure=True)`).  Gates, from `tests/test_flat.py`
and `tests/test_simulation.py`:

- `test_banded_measure_matches_dense`: the flat engine's box measure gives
  the same run, bit for bit, as the dense measure (u, V, μ0, μ1, dt), and
  against JAX's flat engine stepped the same way: ``cfg.band_x`` and
  ``cfg.band_box`` equal at every step, equal `pois_n`, u and p within
  1e-10 of their max;
- `test_band_x_tracked_and_widened`: the band after the build, after a
  measure inside the pad and after one outside it, equal to JAX's.

`tests/test_torch_moving_parity.py` holds ``sim_step_n(remeasure=True)`` on
the same sphere.  Every port object lives on ``device="cpu"``."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu import AutoBody as AutoBodyJ
from waterlily_tpu import Simulation as SimulationJ
from waterlily_tpu.simulation import _BAND_PAD as BAND_PAD_J
from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.simulation import _BAND_PAD

F64 = torch.float64
DIMS = (32, 16, 16)
CTR = (10.0, 8.0, 8.0)


def close_rel(t, j, rel):
    t, j = np.asarray(t), np.asarray(j)
    assert np.abs(t - j).max() <= rel * np.abs(j).max(), np.abs(t - j).max()


def port_sim(speed: float, engine: str, dims=DIMS, ctr=CTR, nu=0.02):
    c = torch.tensor(ctr, dtype=F64)
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - c) ** 2)) - 4.0,
                    lambda x, t: x - torch.stack([speed * t, 0 * t, 0 * t]))
    return Simulation(dims, (1.0, 0.0, 0.0), 4.0, nu=nu, body=body, dtype=F64,
                      engine=engine, device="cpu")


def jax_sim(speed: float, engine: str, dims=DIMS, ctr=CTR, nu=0.02):
    c = jnp.asarray(ctr, jnp.float64)
    body = AutoBodyJ(lambda x, t: jnp.sqrt(jnp.sum((x - c) ** 2)) - 4.0,
                     lambda x, t: x - jnp.stack([speed * t, 0 * t, 0 * t]))
    return SimulationJ(dims, (1.0, 0.0, 0.0), 4.0, nu=nu, body=body,
                       dtype=jnp.float64, engine=engine)


def record(sim) -> dict:
    cfg = sim.flow.cfg
    return dict(band_x=cfg.band_x, band_box=cfg.band_box,
                pois_n=list(sim.pois_n), dt=list(sim.flow.dt),
                u=np.array(sim.flow.u), p=np.array(sim.flow.p))


@functools.lru_cache(maxsize=None)
def jax_loop(speed: float, steps: int):
    """JAX's flat engine: the build and ``steps`` host-loop steps, each
    re-measured, recorded after each."""
    sim = jax_sim(speed, "flat")
    out = [record(sim)]
    for _ in range(steps):
        sim.sim_step(remeasure=True)
        out.append(record(sim))
    return out


def check_step(sim, want: dict, k: int) -> None:
    got = record(sim)
    assert got["band_x"] == want["band_x"] and got["band_box"] == want["band_box"], k
    assert got["pois_n"] == want["pois_n"], k
    np.testing.assert_allclose(got["dt"], want["dt"], rtol=1e-10)
    close_rel(got["u"], want["u"], 1e-10)
    if k:
        close_rel(got["p"], want["p"], 1e-10)


@pytest.mark.parametrize("speed", [1.5, 4.0])
def test_banded_measure_matches_dense(speed):
    banded, dense = port_sim(speed, "flat"), port_sim(speed, "flat")
    dense.band_measure = False
    want = jax_loop(speed, 4)
    check_step(banded, want[0], 0)
    rounds = []
    for k in range(1, 5):
        banded.sim_step(remeasure=True)
        dense.sim_step(remeasure=True)
        rounds.append(banded.measure_rounds)
        check_step(banded, want[k], k)
        for name in ("u", "p", "V", "mu0", "mu1"):
            assert torch.equal(getattr(banded.flow.state, name),
                               getattr(dense.flow.state, name)), (speed, k, name)
        assert banded.flow.dt == dense.flow.dt
        assert dense.measure_rounds == 1
    # at speed 4 the body reaches its box face and the measure widens it
    assert (max(rounds) > 1) == (speed == 4.0), rounds


def test_band_x_tracked_and_widened():
    """`Simulation` keeps ``cfg.band_x``/``band_box`` around the measured
    moments: unchanged while the body moves inside the pad, widened when it
    escapes (`tests/test_flat.py::test_band_x_tracked_and_widened`), as the
    JAX package keeps them."""
    assert _BAND_PAD == BAND_PAD_J
    dims, ctr = (24, 16, 16), (8.0, 8.0, 8.0)
    sim_t = port_sim(1.0, "flat", dims, ctr, nu=0.05)
    sim_j = jax_sim(1.0, "flat", dims, ctr, nu=0.05)
    seen = []
    for t in (None, 1.0, float(_BAND_PAD + 3)):
        if t is not None:
            sim_t.measure(t=t)
            sim_j.measure(t=t)
        cfg_t, cfg_j = sim_t.flow.cfg, sim_j.flow.cfg
        assert (cfg_t.band_x, cfg_t.band_box) == (cfg_j.band_x, cfg_j.band_box), t
        seen.append(cfg_t.band_x)
        np.testing.assert_allclose(sim_t.flow.state.mu0.numpy(),
                                   np.asarray(sim_j.flow.state.mu0), atol=1e-12)
    (lo0, hi0), band1, (lo2, hi2) = seen
    R = 4
    assert 1 <= lo0 <= 8 - R and 8 + R <= hi0 <= dims[0] + 1
    assert band1 == seen[0]
    assert hi2 > hi0 and hi2 >= 8 + R + _BAND_PAD + 2
    assert sim_t.measure_rounds == 2
