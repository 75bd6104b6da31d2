"""The port's bodies against the JAX package's, float64 on the CPU.

From `tests/test_bodies.py`: CSG set bodies, the CSG sdf identity,
curvature, `RigidMap` in 2-D and 3-D, `setmap` through a CSG tree and the
rotating annulus.  Each case evaluates the same body in both packages at
the same points and holds the port's distance, normal and velocity to
JAX's at 1e-12, besides the reference test's own values.

The box-banded measure (`measure_fill(band_box=)`): equal bit for bit to
the port's dense measure when the box covers the body, and to the JAX
package's banded measure at 1e-12, for a rotating and translating
`RigidMap` sphere, a CSG shell under a map callable, with periodic and
exit boundaries and boxes clamped at the domain.  Every port object lives
on ``device="cpu"``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waterlily_tpu.models import autobody as ab_j
from waterlily_tpu.models import body as body_j
from waterlily_tpu.models import rigidmap as rm_j
from waterlily_tpu.simulation import _band_box as band_box_j
from waterlily_tpu_torch import interop
from waterlily_tpu_torch.models import autobody as ab_t
from waterlily_tpu_torch.models import body as body_t
from waterlily_tpu_torch.models import rigidmap as rm_t
from waterlily_tpu_torch.simulation import _BAND_PAD, _band_box

F64 = torch.float64
INF = float("inf")
S2 = math.sqrt(2)


def jv(v):
    return jnp.asarray(v, jnp.float64)


def tv(v):
    return torch.as_tensor(v, dtype=F64)


def same(bj, bt, x, t=0.0, fastd2=INF):
    """Both packages' ``measure_at`` at ``x``, held together at 1e-12;
    returns the port's as floats/numpy."""
    dj, nj, vj = bj.measure_at(jv(x), jv(t), fastd2)
    dt, nt, vt = bt.measure_at(tv(x), tv(t), fastd2)
    for a, b in ((dt, dj), (nt, nj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    return float(dt), nt.numpy(), vt.numpy()


# ------------------------------------------------------------ bodies
def circ_j(x, t):
    return jnp.sqrt(jnp.sum(x**2)) - 2.0


def circ_t(x, t):
    return torch.sqrt(torch.sum(x**2)) - 2.0


def pair_bodies():
    """`test_bodies.py`'s body1 (a growing circle) and body2 (a circle under
    the map x + t²) in both packages."""
    b1 = (ab_j.AutoBody(lambda x, t: circ_j(x, t) - t),
          ab_t.AutoBody(lambda x, t: circ_t(x, t) - t))
    b2 = (ab_j.AutoBody(circ_j, lambda x, t: x + t**2),
          ab_t.AutoBody(circ_t, lambda x, t: x + t**2))
    return b1, b2


CSG = {"add": lambda a, b: a + b, "or": lambda a, b: a | b,
       "union": lambda a, b: a.union(b), "and": lambda a, b: a & b,
       "intersect": lambda a, b: a.intersect(b), "sub": lambda a, b: a - b,
       "neg": lambda a, b: -a}


@pytest.mark.parametrize("op", list(CSG))
def test_setbody_csg(op):
    (b1j, b1t), (b2j, b2t) = pair_bodies()
    bj, bt = CSG[op](b1j, b2j), CSG[op](b1t, b2t)
    assert isinstance(bt, body_t.SetBody)
    for x, t in (([-S2, -S2], 1.0), ([1.0, 0.5], 0.3), ([0.2, -3.0, 1.0], 0.7)):
        same(bj, bt, x, t)
    d, n, v = same(bj, bt, [-S2, -S2], 1.0)
    if op in ("add", "or", "union"):
        assert d == pytest.approx(-S2)
        assert np.allclose(n, [-math.sqrt(0.5)] * 2) and np.allclose(v, [-2, -2])
    if op == "sub":
        assert d == pytest.approx(S2)
        assert np.allclose(n, [math.sqrt(0.5)] * 2) and np.allclose(v, [-2, -2])


def test_setbody_tie_and_bad_op():
    """At an exactly equal distance the union takes ``a`` (`test_bodies.py`
    tie case); an unknown op is refused."""
    bj = ab_j.AutoBody(circ_j) + ab_j.AutoBody(circ_j, lambda x, t: x - jnp.asarray([6.0, 0.0]))
    bt = ab_t.AutoBody(circ_t) + ab_t.AutoBody(circ_t, lambda x, t: x - tv([6.0, 0.0]))
    d, _, _ = same(bj, bt, [3.0, 0.0])
    assert d == pytest.approx(1.0)
    assert float(bt.sdf_at(tv([3.0, 0.0]), tv(0.0))) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="op"):
        body_t.SetBody("xor", bt, bt)


def test_measure_sdf_csg_identity():
    (b1j, b1t), (b2j, b2t) = pair_bodies()
    pj = body_j.measure_sdf((b1j & b2j) | b1j, (4, 5), 0.0, jnp.float64)
    pt = body_t.measure_sdf((b1t & b2t) | b1t, (4, 5), 0.0, F64, "cpu")
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-12)
    x = np.arange(4)[:, None] - 0.5
    y = np.arange(5)[None, :] - 0.5
    expect = np.sqrt(x**2 + y**2) - 2
    assert np.allclose(pt.numpy()[1:-1, 1:-1], expect[1:-1, 1:-1], atol=1e-12)


@pytest.mark.parametrize("A", [np.eye(2), np.eye(3),
                               np.array([[2.0, 1, 0], [1, 2, 1], [0, 1, 2]])],
                         ids=["eye2", "eye3", "tridiag"])
def test_curvature(A):
    Hj, Kj = ab_j.curvature(jv(A))
    Ht, Kt = ab_t.curvature(tv(A))
    assert float(Ht) == pytest.approx(float(Hj), abs=1e-12)
    assert float(Kt) == pytest.approx(float(Kj), abs=1e-12)
    if A.shape == (2, 2):
        assert float(Ht) == 1.0 and float(Kt) == 0.0
    if A[0, 1] == 1:
        assert float(Ht) == pytest.approx(3.0) and float(Kt) == pytest.approx(10.0)


def sdf_unit_j(x, t):
    return jnp.sqrt(jnp.sum(x**2)) - 1.0


def sdf_unit_t(x, t):
    return torch.sqrt(torch.sum(x**2)) - 1.0


def rigid_pair(x0, theta, **kw):
    return (ab_j.AutoBody(sdf_unit_j, rm_j.RigidMap(jv(x0), jv(theta),
                                                   **{k: jv(v) for k, v in kw.items()})),
            ab_t.AutoBody(sdf_unit_t, rm_t.RigidMap(tv(x0), tv(theta),
                                                   **{k: tv(v) for k, v in kw.items()})))


def setmap_pair(pair, **kw):
    bj, bt = pair
    return (rm_j.setmap(bj, **{k: jv(v) for k, v in kw.items()}),
            rm_t.setmap(bt, **{k: tv(v) for k, v in kw.items()}))


def test_rigidmap_2d():
    pair = rigid_pair(np.zeros(2), 0.0)
    assert isinstance(pair[1].map, rm_t.RigidMap)
    d, n, v = same(*pair, [1.5, 0.0])
    assert d == pytest.approx(0.5) and np.allclose(n, [1, 0]) and np.allclose(v, 0)
    pair = setmap_pair(pair, theta=np.pi / 4, V=[1.0, 0.0])
    d, n, v = same(*pair, [1.5, 0.0])
    assert d == pytest.approx(0.5) and np.allclose(n, [1, 0]) and np.allclose(v, [1, 0])
    pair = setmap_pair(pair, omega=0.1)
    d, n, v = same(*pair, [1.5, 0.0])
    assert d == pytest.approx(0.5) and np.allclose(n, [1, 0])
    assert np.allclose(v, [1, 1.5 * 0.1])
    same(*pair, [0.3, -1.2], 0.5)


# (setmap kwargs, point, d, n, V) in the order of `test_bodies.py::test_rigidmap_3d`
RIGID_3D = [
    ({}, [1.5, 0, 0], 0.5, [1, 0, 0], [0, 0, 0]),
    (dict(theta=[np.pi, 0, 0]), [1.5, 0, 0], 0.5, [1, 0, 0], None),
    (dict(theta=[0, np.pi, 0], V=[1.0, 0, 0]), [1.5, 0, 0], 1.5, [1, 0, 0], [1, 0, 0]),
    (dict(theta=[0, 0, 0], V=[1.0, 0, 0], omega=[0, 0, 0.1]), [1.5, 0, 0], 0.5, None,
     [1, 0.2, 0]),
    (None, [0, 1.5, 0], 0.5, [0, 1, 0], [0.85, 0.05, 0]),
    (None, [1.5, 1.5, 1.5], math.sqrt(3 * 1.5**2) - 1, [math.sqrt(1 / 3)] * 3,
     [0.85, 0.2, 0]),
    (dict(V=[1.0, 0, 0], omega=[0, -0.1, 0.1]), [1.5, 0, 0], 0.5, None, [1, 0.2, 0.2]),
    (None, [0, 1.5, 1.5], math.sqrt(2 * 1.5**2) - 1, [0, math.sqrt(0.5), math.sqrt(0.5)],
     [0.7, 0.05, 0.05]),
]


def test_rigidmap_3d():
    pair = rigid_pair(np.zeros(3), np.zeros(3), xp=[-0.5, 0, 0])
    for kw, x, d0, n0, v0 in RIGID_3D:
        if kw:
            pair = setmap_pair(pair, **kw)
        d, n, v = same(*pair, x)
        assert d == pytest.approx(d0)
        if n0 is not None:
            assert np.allclose(n, n0, atol=1e-12)
        if v0 is not None:
            assert np.allclose(v, v0, atol=1e-12)
    same(*pair, [0.4, -0.7, 1.1], 2.0)


def test_rigidmap_parts():
    """`rotation`, `cross2` and the map's call, Jacobian and velocity
    against the JAX package's."""
    for theta in (0.3, [0.3, -1.1, 2.0]):
        np.testing.assert_allclose(rm_t.rotation(tv(theta)).numpy(),
                                   np.asarray(rm_j.rotation(jv(theta))), atol=1e-15)
    np.testing.assert_allclose(rm_t.cross2(tv(0.5), tv([1.0, -2.0])).numpy(),
                               np.asarray(rm_j.cross2(jv(0.5), jv([1.0, -2.0]))))
    kw = dict(xp=[0.1, 0.2, 0.3], V=[0.5, -1.0, 2.0], omega=[0.3, 0.0, -0.4])
    mj = rm_j.RigidMap(jv([1.0, 2.0, 3.0]), jv([0.3, -1.1, 2.0]),
                       **{k: jv(v) for k, v in kw.items()})
    mt = rm_t.RigidMap(tv([1.0, 2.0, 3.0]), tv([0.3, -1.1, 2.0]),
                       **{k: tv(v) for k, v in kw.items()})
    x = [0.7, -0.2, 1.9]
    for f in ("__call__", "map_jacobian", "map_velocity"):
        np.testing.assert_allclose(getattr(mt, f)(tv(x), tv(0.5)).numpy(),
                                   np.asarray(getattr(mj, f)(jv(x), jv(0.5))),
                                   atol=1e-14)
    m2 = mt.replace(theta=tv([0.0, 0.0, 0.0]))
    assert torch.equal(m2.R, torch.eye(3, dtype=F64)) and torch.equal(m2.V, mt.V)


def test_rigidmap_from_numpy():
    """`interop.rigidmap_from_numpy` builds the port's map from the JAX
    map's parameters: the same body in both packages."""
    mj = rm_j.RigidMap(jv([8.0, 7.5, 8.0]), jv([0.4, 0.1, -0.7]), xp=jv([0.5, 0, 0]),
                       V=jv([1.0, -0.5, 0.2]), omega=jv([0.1, 0.2, 0.3]))
    params = {k: np.asarray(getattr(mj, k)) for k in ("x0", "theta", "xp", "V", "omega")}
    mt = interop.rigidmap_from_numpy(params, "cpu", F64)
    assert mt.x0.dtype == F64 and torch.equal(mt.V, tv(params["V"]))
    bj = ab_j.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x**2)) - 3.0, mj)
    bt = ab_t.AutoBody(lambda x, t: torch.sqrt(torch.sum(x**2)) - 3.0, mt)
    for x in ([9.0, 8.0, 8.0], [5.5, 7.0, 10.0], [8.0, 11.2, 8.4]):
        same(bj, bt, x, 0.5)
    with pytest.raises(KeyError, match="omega"):
        interop.rigidmap_from_numpy({k: v for k, v in params.items() if k != "omega"},
                                    "cpu", F64)


def test_setmap_recursion():
    a, b = rigid_pair(np.zeros(2), 0.0), rigid_pair(np.ones(2), 0.0)
    pair = setmap_pair((a[0] + b[0], a[1] + b[1]), theta=np.pi / 4, V=[1.0, 0.0])
    bt = pair[1]
    assert float(bt.a.map.theta) == float(bt.b.map.theta) == pytest.approx(np.pi / 4)
    assert np.allclose(bt.a.map.V.numpy(), [1, 0]) and np.allclose(bt.b.map.V.numpy(), [1, 0])
    for x in ([0.5, 0.5], [1.7, 0.2], [-1.0, 2.0]):
        same(*pair, x, 0.3)
    # a body without a RigidMap and NoBody pass through unchanged
    plain = ab_t.AutoBody(sdf_unit_t)
    assert rm_t.setmap(plain, V=tv([1.0, 0.0])) is plain
    nb = body_t.NoBody()
    assert rm_t.setmap(nb, V=tv([1.0, 0.0])) is nb


def test_annulus():
    rj = rm_j.RigidMap(jnp.zeros(2, jnp.float64), jv(np.pi / 4))
    rt = rm_t.RigidMap(torch.zeros(2, dtype=F64), tv(np.pi / 4))
    bj = (ab_j.AutoBody(lambda x, t: jnp.sqrt(x @ x) - 1.0, rj)
          - ab_j.AutoBody(lambda x, t: jnp.sqrt(x @ x) - 0.5, rj))
    bt = (ab_t.AutoBody(lambda x, t: torch.sqrt(x @ x) - 1.0, rt)
          - ab_t.AutoBody(lambda x, t: torch.sqrt(x @ x) - 0.5, rt))
    pair = setmap_pair((bj, bt), omega=1.0)
    d, n, v = same(*pair, [0.25, 0.0])
    assert d == pytest.approx(0.25)
    assert np.allclose(n, [-1, 0], atol=1e-12) and np.allclose(v, [0, 0.25], atol=1e-12)
    same(*pair, [0.8, 0.1])
    same(*pair, [1.3, -0.4])


# ------------------------------------------------------------ banded measure
SHAPE = (26, 18, 18)


def rigid_sphere():
    """A sphere of radius 4 on a `RigidMap` that rotates and translates."""
    kw = dict(x0=[9.0, 8.5, 9.0], theta=[0.2, -0.3, 0.5], V=[1.5, 0.25, 0.0],
              omega=[0.0, 0.1, -0.2])
    sj = lambda x, t: jnp.sqrt(jnp.sum(x**2)) - 4.0
    st = lambda x, t: torch.sqrt(torch.sum(x**2)) - 4.0
    return (ab_j.AutoBody(sj, rm_j.RigidMap(**{k: jv(v) for k, v in kw.items()})),
            ab_t.AutoBody(st, rm_t.RigidMap(**{k: tv(v) for k, v in kw.items()})))


def shell():
    """A spherical shell (radius 5 minus radius 2.5, CSG) under a map
    callable that translates it in x and y."""
    cj, ct = jv([12.0, 9.0, 9.0]), tv([12.0, 9.0, 9.0])
    mj = lambda x, t: x - cj - jnp.stack([2.0 * t, 0.5 * t, 0 * t])
    mt = lambda x, t: x - ct - torch.stack([2.0 * t, 0.5 * t, 0 * t])
    return (ab_j.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x**2)) - 5.0, mj)
            - ab_j.AutoBody(lambda x, t: jnp.sqrt(jnp.sum(x**2)) - 2.5, mj),
            ab_t.AutoBody(lambda x, t: torch.sqrt(torch.sum(x**2)) - 5.0, mt)
            - ab_t.AutoBody(lambda x, t: torch.sqrt(torch.sum(x**2)) - 2.5, mt))


@pytest.mark.parametrize("case", [
    ("rigid", (), False, "pad"), ("rigid", (1,), False, "pad"),
    ("shell", (), True, "pad"), ("shell", (2,), False, "x only"),
    ("rigid", (), True, "clamped")],
    ids=["rigid", "rigid-per1", "shell-exit", "shell-per2-xonly", "rigid-clamped"])
def test_band_box_measure(case):
    """The box measure equals the dense one bit for bit when the box holds
    every deviating cell (the box from the dense measure's bounds, padded
    as `Simulation` pads it; only x banded; or reaching the domain on every
    face), and equals JAX's box measure at 1e-12; the box's own bounds
    (`_band_box(box=)`) equal the dense ones and JAX's."""
    kind, perdir, exit_bc, boxing = case
    bj, bt = rigid_sphere() if kind == "rigid" else shell()
    t = 0.7
    dense = body_t.measure_fill(bt, SHAPE, t, 1.0, F64, "cpu", perdir, exit_bc)
    raw = _band_box(*dense[:3], perdir).tolist()
    assert all(lo < hi for lo, hi in raw)
    if boxing == "pad":
        box = tuple((lo - _BAND_PAD, hi + _BAND_PAD) for lo, hi in raw)
    elif boxing == "x only":
        box = ((raw[0][0] - 1, raw[0][1] + 1), None, None)
    else:
        box = tuple((lo - 40, hi + 40) for lo, hi in raw[:1]) + tuple(
            (lo - 1, hi + 1) for lo, hi in raw[1:])
    banded = body_t.measure_fill(bt, SHAPE, t, 1.0, F64, "cpu", perdir, exit_bc,
                                 band_box=box)
    want = body_j.measure_fill(bj, SHAPE, t, 1.0, jnp.float64, perdir, exit_bc,
                               band_box=box)
    for name, a, b, c in zip(("V", "mu0", "mu1", "sdf"), banded, dense, want):
        if name != "sdf":   # the far-field sdf of the box measure is a constant
            assert torch.equal(a, b), name
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-12,
                                   err_msg=name)
    assert _band_box(*banded[:3], perdir, box).tolist() == raw
    assert np.asarray(band_box_j(*want[:3], perdir, box)).tolist() == raw
