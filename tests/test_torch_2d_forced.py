"""The port's forced 2-D flows against the JAX package, float64 on the
CPU (the gates of `test_torch_2d.py`): `tests/test_flow.py`'s jerk flow
through ``g`` and through a ``udf``, the periodic boundary layer (a
callable ``ubc``) and the rotating frame (``g`` against a ``udf``).  Where
the reference test's own check holds the port (the analytic jerk flow, the
``udf`` path against the ``g`` path) only one path is run in JAX."""
import math

import pytest
import torch

import jax.numpy as jnp

from test_torch_2d import F64, l2_inside, run_flows, step_port
from waterlily_tpu.models import flow as flj
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.ops.grid import loc_grid


@pytest.mark.parametrize("path", ["g", "udf"])
def test_jerk_flow_g_and_udf(path):
    """uₓ grows as ½·jerk·t² through ``g`` and through a ``udf``
    (`test_flow.jl:111-132`): the port's 8² periodic flow to tU/L = 1
    within the reference's 1e-4; the ``g`` path's first 10 steps equal
    JAX's."""
    N, jerk = 8, 4.0
    Us = math.sqrt(N)
    kt, ut = {}, None
    if path == "g":
        kt = dict(g=lambda i, x, t: t * jerk if i == 0 else torch.zeros_like(t))
    else:
        def ut(f, state, u_adv, t):
            f = f.clone()
            f[0] += t * jerk
            return f

    def make_t():
        return fl.Flow((N, N), (Us, 0.0), dt=0.001, nu=0.001, perdir=(0,), dtype=F64,
                       device="cpu", **kt)
    ft = make_t()
    while ft.time < N / Us:
        step_port(ft, ut)
    u_final = Us + 0.5 * jerk * ft.time ** 2
    assert l2_inside(ft.u[0] - u_final) < 1e-4 and l2_inside(ft.u[1]) < 1e-4
    if path == "g":
        run_flows(lambda: flj.Flow((N, N), (Us, 0.0), dt=0.001, nu=0.001, perdir=(0,),
                                   dtype=jnp.float64,
                                   g=lambda i, x, t: jnp.where(i == 0, t * jerk, 0.0)),
                  make_t, 10)


def test_boundary_layer_periodic():
    """The laminar boundary-layer inflow (a callable ``ubc``) on 32², 10
    steps (`test_flow.jl:134-140`)."""
    L = 32

    def prof(x):
        return 4.0 * (((x[1] + 0.5) / (2 * L)) - ((x[1] + 0.5) / (2 * L)) ** 2)

    def ubc_j(i, x, t):
        return jnp.where(i == 0, prof(x), 0.0)

    def ubc_t(i, x, t):
        return prof(x) if i == 0 else torch.zeros_like(x[0])
    run_flows(lambda: flj.Flow((L, L), ubc_j, nu=0.001, dtype=jnp.float64),
              lambda: fl.Flow((L, L), ubc_t, nu=0.001, dtype=F64, device="cpu"), 10)


def test_rotating_reference_frame():
    """A rotating frame forced through ``g`` (one step, equal to JAX's)
    equals the same force through a ``udf``, and p stays near 0
    (`test_flow.jl:142-159`)."""
    L = 4
    om = 1 / L

    def vel(i, x, t, lib):
        s, c = lib.sin(om * t), lib.cos(om * t)
        y = om * (x - L)
        return s * y[0] + c * y[1] if i == 0 else -c * y[0] + s * y[1]

    def g(i, x, t, lib):
        cor = 2 * om * vel(1, x, t, lib) if i == 0 else -2 * om * vel(0, x, t, lib)
        return cor + om ** 2 * (x - L)[i]

    def udf_t(f, state, u_adv, t):          # the port hands a udf a host t
        D, shape, t = f.shape[0], tuple(f.shape[1:]), torch.tensor(t, dtype=F64)
        return torch.stack([f[i] + g(i, loc_grid(i, shape, F64, "cpu"), t, torch)
                            for i in range(D)])

    vj = lambda i, x, t: vel(i, x, t, jnp)              # noqa: E731
    vt = lambda i, x, t: vel(i, x, t, torch)            # noqa: E731
    _, fg = run_flows(
        lambda: flj.Flow((2 * L, 2 * L), vj, g=lambda i, x, t: g(i, x, t, jnp),
                         dtype=jnp.float64),
        lambda: fl.Flow((2 * L, 2 * L), vt, g=lambda i, x, t: g(i, x, t, torch),
                        dtype=F64, device="cpu"), 1)
    fu = step_port(fl.Flow((2 * L, 2 * L), vt, dtype=F64, device="cpu"), udf_t)
    assert l2_inside(fg.p) == pytest.approx(l2_inside(fu.p), rel=1e-6)
    assert l2_inside(fg.p) < 3e-3
