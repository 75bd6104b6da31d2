"""`metrics.nds_field` on the body's shell against the dense measure, on the
CPU.

The port's own bodies (`AutoBody`, `NoBody`, `SetBody`s of them) are
measured only where ``sdf_at² ≤ 1``; any other `Body` at every cell.
`Dense` forwards ``measure_at`` to a port body, so that the same body takes
the dense path: the two fields must be equal bit for bit (`torch.equal`) in
float32 and float64 — a static sphere, a time-dependent `FnMap` body, a
`RigidMap` body, a CSG difference and union, a 2-D circle, `NoBody` and one
shard's offset — and so must ∮ p n dS and its tangent under
`torch.func.jvp`.  The rule the shell rests on is held per body type: the
distance alone (`SetBody.sdf_at`) equals ``measure_at(x, t, 0.0)[0]``, and
wherever ``sdf_at² > 1`` ``measure_at(x, t, 1.0)`` returns |d| > 1 of the
distance's sign, so n·K(d) = 0, and for a body that is not a `SetBody`
n = 0."""
import pytest
import torch
from torch.func import vmap

from waterlily_tpu_torch import AutoBody, tracing
from waterlily_tpu_torch.models.body import Body, NoBody, SetBody, _interior_points
from waterlily_tpu_torch.models.rigidmap import RigidMap
from waterlily_tpu_torch.utils import metrics as mt

F32, F64 = torch.float32, torch.float64
INF = float("inf")


class Dense(Body):
    """A port body behind a type of its own: `nds_field` measures it at
    every cell."""

    def __init__(self, body: Body):
        self.body = body

    def measure_at(self, x, t, fastd2=INF):
        return self.body.measure_at(x, t, fastd2)


def ball(c, r):
    """The sdf of a ball of radius ``r`` at ``c``."""
    def sdf(x, t):
        return torch.sqrt(torch.sum((x - torch.as_tensor(c, dtype=x.dtype)) ** 2)) - r
    return sdf


def pseudo(c, a, s):
    """A pseudo-sdf whose gradient is not of unit length: a scaled
    ellipsoid's level set."""
    def sdf(x, t):
        z = (x - torch.as_tensor(c, dtype=x.dtype)) / torch.as_tensor(a, dtype=x.dtype)
        return s * (torch.sqrt(torch.sum(z ** 2)) - 1)
    return sdf


def sphere(n, dtype):
    """The benchmark's sphere: R = n/8 at (n/3, n/2, n/2)."""
    return AutoBody(ball([n / 3, n / 2, n / 2], n / 8))


def moving(n, dtype):
    """A sphere on a time-dependent map with a non-trivial Jacobian."""
    def fmap(x, t):
        shift = torch.stack([2 * t, torch.sin(t), t * t / 4])
        return x - shift + 0.05 * torch.sin(t) * torch.roll(x, 1)
    return AutoBody(ball([n / 2, n / 2, n / 2], n / 6), fmap)


def rigid(n, dtype):
    m = RigidMap(torch.tensor([n / 2, n / 2 - 1, n / 2], dtype=dtype),
                 torch.tensor([0.3, -0.4, 0.7], dtype=dtype),
                 V=torch.tensor([0.5, 0.0, -0.2], dtype=dtype),
                 omega=torch.tensor([0.1, 0.2, -0.3], dtype=dtype))
    return AutoBody(pseudo([0.0, 0.0, 0.0], [n / 5, n / 7, n / 9], n / 8), m)


def difference(n, dtype):
    return (AutoBody(ball([n / 2, n / 2, n / 2], n / 4))
            - AutoBody(pseudo([n / 2, n / 3, n / 2], [n / 5, n / 4, n / 6], 3.0)))


def union(n, dtype):
    return (AutoBody(ball([n / 3, n / 2, n / 2], n / 6))
            + AutoBody(pseudo([n / 2, n / 2, n / 2 + 2], [n / 8, n / 5, n / 6], n / 6)))


BODIES = {"sphere": sphere, "moving": moving, "rigid": rigid,
          "difference": difference, "union": union}


def both(body, shape, t, dtype, offset=None):
    """`nds_field` of ``body`` and of `Dense(body)`, and the counters of the
    first call."""
    with tracing.tracing():     # a session of its own: recording was off
        got = mt.nds_field(body, shape, t, dtype, "cpu", offset)
        counts = dict(tracing.session().counters)
    return got, mt.nds_field(Dense(body), shape, t, dtype, "cpu", offset), counts


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("name, n, t", [("sphere", 64, 0.0), ("moving", 32, 0.0),
                                        ("moving", 32, 1.3), ("rigid", 32, 0.7),
                                        ("difference", 32, 0.0), ("union", 32, 0.0)])
def test_the_shell_equals_the_dense_field(name, n, t, dtype):
    got, want, counts = both(BODIES[name](n, dtype), (n + 2,) * 3, t, dtype)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert 0 < counts["nds.measured"] < counts["nds.points"] // 10
    assert torch.count_nonzero(got.abs().sum(0)) <= counts["nds.measured"]


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_the_2d_circle(dtype):
    body = AutoBody(ball([20.0, 24.0], 8.0))
    got, want, counts = both(body, (66, 50), 0.0, dtype)
    assert got.shape == (2, 66, 50) and torch.equal(got, want)
    assert 0 < counts["nds.measured"] < 64 * 48 // 5


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_no_body_measures_nothing(dtype):
    got, want, counts = both(NoBody(), (18, 18, 18), 0.0, dtype)
    assert torch.equal(got, want) and not torch.any(got)
    assert counts == {"nds.points": 16 ** 3, "nds.measured": 0}


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
def test_a_shards_offset(dtype):
    """The second of four x-shards of a 64-cell domain: its own part of the
    sphere, at global coordinates; the fourth holds none of it."""
    shape = (18, 66, 66)
    got, want, counts = both(sphere(64, dtype), shape, 0.0, dtype, offset=(16, 0, 0))
    assert torch.equal(got, want) and torch.any(got)
    assert 0 < counts["nds.measured"]
    far, far_dense, far_counts = both(sphere(64, dtype), shape, 0.0, dtype,
                                      offset=(48, 0, 0))
    assert torch.equal(far, far_dense) and not torch.any(far)
    assert far_counts["nds.measured"] == 0


def test_the_benchmark_spheres_counters():
    """The 64³ sphere of the benchmark's geometry measures 1,640 of its
    262,144 cells."""
    _, _, counts = both(sphere(64, F32), (66,) * 3, 0.0, F32)
    assert counts == {"nds.points": 262_144, "nds.measured": 1_640}


def points(n, dtype):
    return _interior_points(None, (n + 2,) * 3, dtype, "cpu")


@pytest.mark.parametrize("name", ["difference", "union"])
def test_setbody_sdf_at_is_the_measures_distance(name):
    body = BODIES[name](24, F32)
    assert isinstance(body, SetBody)
    x, t = points(24, F32), torch.tensor(0.0)
    assert torch.equal(vmap(lambda p: body.sdf_at(p, t))(x),
                       vmap(lambda p: body.measure_at(p, t, 0.0)[0])(x))


@pytest.mark.parametrize("name", ["sphere", "moving", "rigid", "difference", "union",
                                  "none"])
def test_outside_the_shell_the_normal_is_zero(name):
    body = NoBody() if name == "none" else BODIES[name](24, F64)
    x, t = points(24, F64), torch.tensor(1.3, dtype=F64)
    s = vmap(lambda p: body.sdf_at(p, t))(x)
    d, n, _ = vmap(lambda p: body.measure_at(p, t, 1.0))(x)
    out = s * s > 1
    assert torch.any(out)
    # a CSG body may pick a child measured inside its own shell whose
    # normalised |d| is past 1: its n is not zero, its K(d) is
    assert torch.all(d[out].abs() > 1)
    assert torch.equal(torch.sign(d[out]), torch.sign(s[out]))
    assert not torch.any(n[out] * mt.kern(torch.clamp(d[out], -1.0, 1.0))[:, None])
    if not isinstance(body, SetBody):
        assert not torch.any(n[out])


def test_pressure_integral_under_jvp():
    """∮ p n dS and its derivative in the sphere's radius, float64."""
    n = 24
    shape = (n + 2,) * 3
    p = torch.randn(shape, dtype=F64, generator=torch.Generator().manual_seed(5))

    def force(r, dense):
        body = AutoBody(lambda x, t: torch.sqrt(torch.sum((x - n / 2) ** 2)) - r)
        return mt.pressure_force(p, Dense(body) if dense else body)

    r0, one = torch.tensor(n / 5, dtype=F64), torch.tensor(1.0, dtype=F64)
    got = torch.func.jvp(lambda r: force(r, False), (r0,), (one,))
    want = torch.func.jvp(lambda r: force(r, True), (r0,), (one,))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.all(got[1] != 0)
