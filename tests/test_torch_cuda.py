"""The four CUDA kernels of `ops/stencil3d.py` against their plain versions on
the card, at small shapes.  No JAX: run it on a machine with an NVIDIA GPU
with ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``
(the repository conftest imports JAX).  Elsewhere every test skips.

Tolerances (float32, max |kernel − plain| relative to max |plain|): 2e-5
for the conv–diff RHS and the BDIM update, 1e-5 for A·x and the smoother.
The kernels and the plain versions round in a different order (fused
multiply-adds in the kernels), nothing more."""
import numpy as np
import pytest
import torch

from waterlily_tpu_torch.ops import poisson as ps
from waterlily_tpu_torch.ops import stencil3d as st
from waterlily_tpu_torch.ops.bc import bc_vector

pytestmark = pytest.mark.cuda

SHAPES = [(18, 18, 18), (26, 18, 10), (10, 6, 6)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def inputs(shape, seed, dev):
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.as_tensor(rng.standard_normal(s + shape),
                                   dtype=torch.float32, device=dev)
    L = bc_vector(torch.as_tensor(0.2 + rng.random((3,) + shape),
                                  dtype=torch.float32, device=dev), (0.0,) * 3)
    lev = ps.make_level(L)
    r = torch.zeros(shape, dtype=torch.float32, device=dev)
    r[1:-1, 1:-1, 1:-1] = g()[1:-1, 1:-1, 1:-1]
    return dict(u=g(3), u0=g(3), f=g(3), V=0.1 * g(3), mu0=g(3).abs(),
                mu1=0.3 * g(3, 3), x=g(), r=r, lev=lev)


def rel_err(got, want):
    torch.cuda.synchronize()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sid", [0, 1, 2], ids=["quick", "vanleer", "cds"])
def test_conv_diff_k(dev, shape, sid):
    d = inputs(shape, 0, dev)
    nu = torch.tensor(0.03, device=dev)
    got = st.conv_diff_k(d["u"], nu, sid)
    assert rel_err(got, st.conv_diff_plain(d["u"], nu, st.SCHEMES[sid])) <= 2e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_bdim_k(dev, shape):
    d = inputs(shape, 1, dev)
    args = [d[k] for k in ("u", "u0", "f", "V", "mu0", "mu1")]
    assert rel_err(st.bdim_k(*args, 0.3), st.bdim_plain(*args, 0.3)) <= 2e-5


@pytest.mark.parametrize("shape", SHAPES)
def test_mult_k(dev, shape):
    d = inputs(shape, 2, dev)
    lev = d["lev"]
    assert rel_err(st.mult_k(d["x"], lev.L, lev.D),
                   st.mult_plain(d["x"], lev.L, lev.D)) <= 1e-5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("colors", [[], [0, 1, 0, 1], [1, 0]],
                         ids=["jacobi", "rb4", "br2"])
def test_gs_incr_k(dev, shape, colors):
    d = inputs(shape, 3, dev)
    lev = d["lev"]
    got = st.gs_incr_k(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9)
    want = st.gs_incr_plain(d["x"], d["r"], lev.L, lev.D, lev.iD, colors, 0.9)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= 1e-5


def test_launch_counts_and_routing(dev):
    d = inputs((10, 8, 6), 4, dev)
    lev = d["lev"]
    st.reset_launch_counts()
    assert st.use_kernels(d["x"])
    ps.jacobi(lev, d["x"], d["r"])
    ps.gauss_seidel_rb(lev, d["x"], d["r"])
    ps.mult(lev, d["x"])
    with st.plain_ops():
        assert not st.use_kernels(d["x"])
        ps.mult(lev, d["x"])
    assert st.launch_counts() == {"conv_diff_k": 0, "bdim_k": 0, "mult_k": 1,
                                  "gs_incr_k": 2}
    # float64 on the card takes the plain version; the wrapper refuses it
    assert not st.use_kernels(d["x"].double())
    with pytest.raises(TypeError):
        st.mult_k(d["x"].double(), lev.L.double(), lev.D.double())
    with pytest.raises(ValueError):
        st.mult_k(d["x"][:, :, :-1], lev.L, lev.D)
