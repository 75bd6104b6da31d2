"""A user's convection scheme (a callable ``scheme(u, c, d)`` that is none
of `quick`, `vanleer`, `cds`) runs on every path: `stencil3d.scheme_id`
gives None for it and the conv–diff callers take the plain PyTorch route,
where the kernels' routes raised before.  On the CPU: a `Simulation` with a
lambda that wraps `quick` gives `quick`'s u, p and iteration counts after 2
steps, on both engines, bit for bit (the same plain operations run).  The
card's half of the check is `tests/test_torch_cuda.py::
test_custom_scheme_runs_plain`."""
import pytest
import torch

from waterlily_tpu_torch import AutoBody, Simulation
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.models import flowflat as ff
from waterlily_tpu_torch.ops import fused3d as fz
from waterlily_tpu_torch.ops import stencil3d as st


def wrapped_quick(u, c, d):
    return st.quick(u, c, d)


def sphere16(scheme, engine):
    ctr = torch.tensor([16 / 3, 8.0, 8.0], dtype=torch.float64)
    body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - 2.5)
    return Simulation((16, 16, 16), (1.0, 0.0, 0.0), 2.5, nu=2.5 / 250,
                      body=body, scheme=scheme, dtype=torch.float64,
                      device="cpu", engine=engine)


def test_scheme_id_of_a_user_scheme_is_none():
    assert st.scheme_id(lambda u, c, d: st.quick(u, c, d)) is None
    assert st.scheme_id(wrapped_quick) is None
    assert [st.scheme_id(s) for s in st.SCHEMES] == [0, 1, 2]


@pytest.mark.parametrize("engine", ["flat", "3d"])
def test_wrapped_quick_equals_quick(engine):
    a = sphere16(st.quick, engine)
    b = sphere16(lambda u, c, d: st.quick(u, c, d), engine)
    assert a.engine == b.engine == engine
    st.reset_launch_counts()
    for _ in range(2):
        a.sim_step(remeasure=False)
        b.sim_step(remeasure=False)
    assert a.pois_n == b.pois_n
    assert torch.equal(a.flow.u, b.flow.u) and torch.equal(a.flow.p, b.flow.p)
    assert sum(st.launch_counts().values()) == 0


def test_conv_diff_callers_take_the_user_scheme():
    g = torch.Generator().manual_seed(3)
    u = torch.randn((3, 10, 8, 7), generator=g, dtype=torch.float64)
    u0 = torch.randn((3, 10, 8, 7), generator=g, dtype=torch.float64)
    half = lambda u, c, d: 0.5 * st.cds(u, c, d)
    assert torch.equal(fl.conv_diff(u, half, 0.02),
                       st.conv_diff_plain(u, 0.02, half))
    got = ff.conv_diff_bdim(u, u0, 0.02, 0.3, 1.0, 0.5, half)
    want = fz.conv_diff_bdim_plain(u, u0, 0.02, 0.3, 1.0, 0.5, half)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
