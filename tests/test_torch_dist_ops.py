"""The distributed-grid primitives of the port (`waterlily_tpu_torch.ops.dist`,
`parallel.dist.to_blocked`/`from_blocked`, `multigrid.dist_n_levels` and
`make_mg_dist`) against the JAX package's, on the CPU in float64.

The port runs four shards on a CPU mesh (one worker thread each, the
in-process `Communicator`); the JAX package runs the same functions under
`shard_map` on four of the eight virtual CPU devices.  Data movement (halo
refreshes, ring fetches, gathers and slices) must agree bit for bit, the
sums within 1e-15 relative, the level coefficients within 1e-15 of max per
shard (the coarsest level's dense pseudo-inverse, an SVD in each library,
within 1e-13), the replicated levels equal on every shard bit for bit.  Then the communicator itself: a worker's exception reaches the
caller without a hang, a missed rendezvous raises within its time limit, a
collective mismatch raises, and a sum is the same on every shard bit for
bit."""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from waterlily_tpu.ops import dist as dj
from waterlily_tpu.ops import multigrid as mg_j
from waterlily_tpu.parallel import dist as pdj
from waterlily_tpu_torch.ops import dist as dt
from waterlily_tpu_torch.ops import multigrid as mg_t
from waterlily_tpu_torch.ops.bc import bc_vector
from waterlily_tpu_torch.parallel import dist as pdt

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

F64 = torch.float64
TIMEOUT = 30.0

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 virtual devices")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocked(blocks, mesh_shape, lead):
    """The blocked global array of per-shard numpy ``blocks`` (rank order,
    row-major mesh) along the tensor axes ``lead + d``."""
    def cat(axis, prefix):
        if axis == len(mesh_shape):
            r = 0
            for c, k in zip(prefix, mesh_shape):
                r = r * k + c
            return blocks[r]
        return np.concatenate([cat(axis + 1, prefix + (c,)) for c in range(mesh_shape[axis])],
                              axis=lead + axis)
    return cat(0, ())


def local_blocks(a, mesh_shape, lead):
    """Shard r's block of a blocked global array (the inverse of `blocked`)."""
    out = []
    n = int(np.prod(mesh_shape))
    comm = dt.Communicator(mesh_shape, ["cpu"] * n)
    for r in range(n):
        c = comm.coords(r)
        sl = [slice(None)] * a.ndim
        for d, k in enumerate(mesh_shape):
            m = a.shape[lead + d] // k
            sl[lead + d] = slice(c[d] * m, (c[d] + 1) * m)
        out.append(a[tuple(sl)])
    return out


def port_run(mesh_shape, fn):
    """``fn(ctx_maker)`` per shard of a CPU mesh; the results in rank order."""
    n = int(np.prod(mesh_shape))
    comm = dt.Communicator(mesh_shape, ["cpu"] * n, TIMEOUT)
    pool = dt.ShardPool(comm)
    try:
        return pool.run(lambda r: fn(comm, r))
    finally:
        pool.close()


def test_blocked_layout_equals_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 34, 18, 10))
    for sizes in ((8, 2, 1), (2, 1, 2), (1, 1, 1)):
        b = pdt.to_blocked(a, sizes, lead=1)
        assert np.array_equal(b, np.asarray(pdj.to_blocked(a, sizes, lead=1)))
        assert np.array_equal(pdt.from_blocked(b, sizes, lead=1),
                              np.asarray(pdj.from_blocked(b, sizes, lead=1)))
        assert np.array_equal(pdt.from_blocked(b, sizes, lead=1), a)


def test_set_slab_equals_jax():
    from waterlily_tpu.ops.grid import set_slab as set_slab_j
    from waterlily_tpu_torch.ops.grid import set_slab

    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 6, 5, 4))
    for axis, idx in ((1, 0), (2, -1), (3, 2)):
        v = rng.standard_normal(np.asarray(a).take([0], axis=axis).shape)
        got = set_slab(torch.as_tensor(a), axis, idx, torch.as_tensor(v))
        assert np.array_equal(got.numpy(), np.asarray(set_slab_j(jnp.asarray(a), axis, idx,
                                                                  jnp.asarray(v))))
    assert np.array_equal(set_slab(torch.as_tensor(a), 1, 1, 0.5).numpy(),
                          np.asarray(set_slab_j(jnp.asarray(a), 1, 1, 0.5)))


# (mesh shape, axes per spatial dim, global interior of the 3-D field)
MESHES = [((2, 2), ("x", "y", None), (8, 6, 4)), ((4,), ("x", None, None), (8, 6, 4))]


def _ops(lib, d, ctx, a, v):
    """Every primitive on a shard, the same calls in both packages."""
    nx = a.shape[0]
    out = dict(
        s_zero=d.sync_scalar(a, ctx),
        s_keep=d.sync_scalar(a, ctx, edge_zero=False),
        s_per=d.sync_scalar(a, ctx, perdir=(0, 2)),
        s_per_keep=d.sync_scalar(a, ctx, perdir=(1,), edge_zero=False),
        v_keep=d.sync_vector(v, ctx),
        v_per=d.sync_vector(v, ctx, perdir=(0, 1, 2), edge_zero=True),
        lo=d.fetch_lo(ctx, a, 0, 0, nx - 2),
        hi=d.fetch_hi(ctx, v, 1, 0, 1),
        sl=d.slice_local(d.gather_scalar(a, ctx), ctx),
    )
    red = dict(sum=d.psum_all(lib.sum(a[1:-1, 1:-1, 1:-1] ** 2), ctx),
               max=d.pmax_all(lib.max(v), ctx),
               gather=d.gather_scalar(a, ctx))
    return out, red


def _jax_ops(mesh_shape, axes, a_blk, v_blk):
    mesh = pdj.make_mesh(mesh_shape)
    names = tuple(n for n in axes if n is not None)
    sp = P(*axes)
    vsp = P(None, *axes)
    sizes = tuple(mesh_shape) + (1,) * (3 - len(mesh_shape))

    def body(a, v):
        ctx = dj.make_ctx(axes, sizes, a.shape)
        out, red = _ops(jnp, dj, ctx, a, v)
        par = jnp.asarray([dj.parity_shift(ctx, a.shape)] + list(dj.offsets(ctx, a.shape)),
                          jnp.int32).reshape((1,) * len(names) + (4,))
        return out, red, par

    specs = dict(s_zero=sp, s_keep=sp, s_per=sp, s_per_keep=sp, v_keep=vsp,
                 v_per=vsp, lo=sp, hi=vsp, sl=sp)
    fn = shard_map(body, mesh=mesh, in_specs=(sp, vsp),
                   out_specs=(specs, dict(sum=P(), max=P(), gather=P()),
                              P(*names, None)), check_vma=False)
    out, red, par = jax.jit(fn)(jnp.asarray(a_blk), jnp.asarray(v_blk))
    return ({k: np.asarray(x) for k, x in out.items()},
            {k: np.asarray(x) for k, x in red.items()}, np.asarray(par))


@pytest.mark.parametrize("mesh_shape,axes,inner", MESHES, ids=["2x2", "4"])
def test_primitives_equal_jax(mesh_shape, axes, inner):
    rng = np.random.default_rng(1)
    sizes = tuple(mesh_shape) + (1,) * (3 - len(mesh_shape))
    gshape = tuple(n + 2 for n in inner)
    # random ghosts too: an edge ghost kept must be the shard's own
    a_blk = pdt.to_blocked(rng.standard_normal(gshape), sizes)
    a_blk = a_blk + 0.1 * rng.standard_normal(a_blk.shape)
    v_blk = pdt.to_blocked(rng.standard_normal((3,) + gshape), sizes, lead=1)
    v_blk = v_blk + 0.1 * rng.standard_normal(v_blk.shape)
    j_out, j_red, j_par = _jax_ops(mesh_shape, axes, a_blk, v_blk)
    a_loc = local_blocks(a_blk, sizes, 0)
    v_loc = local_blocks(v_blk, sizes, 1)
    local_shape = a_loc[0].shape

    def shard(comm, r):
        ctx = dt.make_ctx(axes, sizes, local_shape, comm, r)
        out, red = _ops(torch, dt, ctx, torch.as_tensor(a_loc[r]),
                        torch.as_tensor(v_loc[r]))
        return out, red, [dt.parity_shift(ctx, local_shape)] + list(dt.offsets(ctx, local_shape))

    res = port_run(sizes, shard)
    for k, want in j_out.items():
        lead = 1 if k in ("v_keep", "v_per", "hi") else 0
        got = blocked([r[0][k].numpy() for r in res], sizes, lead)
        assert np.array_equal(got, want), k
    for r in res:
        s = r[1]["sum"].item()
        assert abs(s - j_red["sum"]) <= 1e-15 * abs(j_red["sum"])
        assert r[1]["max"].item() == j_red["max"]
        assert np.array_equal(r[1]["gather"].numpy(), j_red["gather"])
    # every shard's sum is the same, bit for bit
    assert len({r[1]["sum"].item() for r in res}) == 1
    par = np.stack([r[2] for r in res]).reshape(j_par.shape)
    assert np.array_equal(par, j_par)


@pytest.mark.parametrize("gshape,sizes", [((34, 18, 10), (2, 2, 1)), ((66, 34, 34), (4, 1, 1)),
                                          ((66, 34), (8, 2)), ((18, 18, 18), (2, 2, 2))])
def test_dist_n_levels_equals_jax(gshape, sizes):
    got = mg_t.dist_n_levels(gshape, sizes, min_cells=64)
    want = mg_j.dist_n_levels(gshape, sizes, min_cells=64)
    assert [tuple(s) for s in got[0]] == [tuple(s) for s in want[0]]
    assert [tuple(m) for m in got[1]] == [tuple(m) for m in want[1]]
    assert got[2] == want[2]


@pytest.mark.parametrize("mesh_shape,perdir", [((2, 2), ()), ((4,), (0, 2))],
                         ids=["2x2", "4-periodic"])
def test_make_mg_dist_equals_jax(mesh_shape, perdir):
    rng = np.random.default_rng(2)
    gshape = (34, 18, 10)
    sizes = tuple(mesh_shape) + (1,) * (3 - len(mesh_shape))
    mu0 = bc_vector(torch.as_tensor(0.2 + rng.random((3,) + gshape), dtype=F64),
                    (0.0,) * 3, perdir=perdir)
    mu0_blk = pdt.to_blocked(mu0.numpy(), sizes, lead=1)
    shapes, masks, n_dist = mg_t.dist_n_levels(gshape, sizes, min_cells=64)
    masks = tuple(masks)
    axes = ("x", "y", None) if len(mesh_shape) == 2 else ("x", None, None)
    mesh = pdj.make_mesh(mesh_shape)
    dsp = (P(None, *axes), P(*axes), P(*axes))

    def body(m):
        ctx = dj.make_ctx(axes, sizes, m.shape[1:])
        levels = mg_j.make_mg_dist(m, ctx, masks, n_dist, perdir)
        return tuple(tuple(a for a in lv if a is not None) for lv in levels)

    specs = tuple(dsp if l < n_dist else (P(),) * (4 if l == len(shapes) - 1 else 3)
                  for l in range(len(shapes)))
    want = jax.jit(shard_map(body, mesh=mesh, in_specs=P(None, *axes), out_specs=specs,
                             check_vma=False))(jnp.asarray(mu0_blk))
    m_loc = local_blocks(mu0_blk, sizes, 1)

    def shard(comm, r):
        ctx = dt.make_ctx(axes, sizes, m_loc[r].shape[1:], comm, r)
        return mg_t.make_mg_dist(torch.as_tensor(m_loc[r]), ctx, masks, n_dist, perdir)

    res = port_run(sizes, shard)
    for l in range(len(shapes)):
        names = ("L", "D", "iD", "Ainv")
        for k, wj in enumerate(want[l]):
            wj = np.asarray(wj)
            lead = 1 if k == 0 else 0
            if l < n_dist:
                got = blocked([getattr(r[l], names[k]).numpy() for r in res], sizes, lead)
                assert got.shape == wj.shape
                assert np.abs(got - wj).max() <= 1e-15 * np.abs(wj).max(), (l, names[k])
            else:
                # the replicated tail: the same on every shard, bit for bit;
                # the dense pseudo-inverse comes from two SVD implementations
                tol = 1e-13 if names[k] == "Ainv" else 1e-15
                for r in res:
                    got = getattr(r[l], names[k]).numpy()
                    assert np.array_equal(got, getattr(res[0][l], names[k]).numpy())
                    assert np.abs(got - wj).max() <= tol * np.abs(wj).max(), (l, names[k])


# ---------------------------------------------------------- the communicator
def _pool(n, timeout):
    comm = dt.Communicator((n,), ["cpu"] * n, timeout)
    return comm, dt.ShardPool(comm)


def test_worker_exception_reaches_the_caller():
    comm, pool = _pool(4, TIMEOUT)
    try:
        def fn(r):
            if r == 2:
                raise ValueError("shard 2 fails")
            return comm.allreduce(r, torch.ones(()), "sum")
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="shard 2 fails"):
            pool.run(fn)
        assert time.monotonic() - t0 < 5.0
        # the pool runs again after the failure
        got = pool.run(lambda r: comm.allreduce(r, torch.tensor(float(r)), "sum").item())
        assert got == [6.0] * 4
    finally:
        pool.close()


def test_missed_rendezvous_raises_within_its_limit():
    comm, pool = _pool(4, 0.25)
    try:
        def fn(r):
            if r == 1:
                return None        # shard 1 skips the collective
            return comm.allreduce(r, torch.ones(()), "max")
        t0 = time.monotonic()
        with pytest.raises(dt.CollectiveTimeout, match=r"collective max #0: shard [023]"):
            pool.run(fn)
        assert time.monotonic() - t0 < 5.0
    finally:
        pool.close()


def test_collective_mismatch_raises():
    comm, pool = _pool(2, TIMEOUT)
    try:
        def fn(r):
            x = torch.ones(())
            return comm.allreduce(r, x, "sum" if r == 0 else "max")
        with pytest.raises(RuntimeError, match="collective mismatch"):
            pool.run(fn)
    finally:
        pool.close()


def test_sum_is_bitwise_the_same_on_every_shard():
    vals = [1e16, 1.0, -1e16, 3.0, 0.1, -0.3, 2.0 ** -30, 7.0]
    comm, pool = _pool(8, TIMEOUT)
    try:
        got = pool.run(lambda r: comm.allreduce(r, torch.tensor(vals[r], dtype=F64),
                                                "sum").item())
    finally:
        pool.close()
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v          # shard order
    assert got == [acc] * 8


def test_sent_slab_is_a_copy():
    """A sender that writes its field in place after the exchange does not
    change what its neighbour received."""
    comm, pool = _pool(2, TIMEOUT)
    try:
        def fn(r):
            a = torch.full((4, 3), float(r), dtype=F64)
            lo, hi = comm.ring(r, 0, a[2:3], a[1:2])
            a.fill_(-1.0)
            comm.allreduce(r, torch.zeros(()), "sum")   # the neighbour wrote
            return lo.clone(), hi.clone()
        (lo0, hi0), (lo1, hi1) = pool.run(fn)
    finally:
        pool.close()
    assert torch.all(lo0 == 1.0) and torch.all(hi0 == 1.0)
    assert torch.all(lo1 == 0.0) and torch.all(hi1 == 0.0)


def test_collectives_carry_tangents():
    """Under `shard_jvp` every collective exchanges the tangents too, in a
    rendezvous of its own: the ring, the sum and the gather of tangents;
    the max takes the tangent of the shards that hold it, averaged over
    them (here shards 1 and 2 tie).  Each is a jvp in one scalar ``s`` on
    four shards, against the derivative written out; without `shard_jvp`
    (each shard's `torch.func.jvp` as it is) the first shard to leave
    would clear the others' tangents.  A shard whose payload carries no
    tangent (shard 0's last sum and ring) takes the same route as the
    others and sends zeros."""
    comm, pool = _pool(4, TIMEOUT)
    c, d = (1.0, 3.0, 3.0, 2.0), (5.0, 7.0, 11.0, 13.0)

    def fn(r):
        ctx = dt.make_ctx(("x",), (4,), (6,), comm, r)
        base = torch.arange(6, dtype=F64) + 10.0 * r

        def f(s):
            a = base * (1.0 + 2.0 * s)
            lo, hi = dt.ring_pair(ctx, a, 0, 0, 4, 1)
            total = dt.psum_all(a.sum(), ctx)
            top = dt.pmax_all(c[r] + d[r] * s, ctx)
            whole = dt.gather_scalar(a, ctx)
            b = base if r == 0 else a
            mixed = dt.psum_all(b.sum(), ctx)
            lo2, _ = dt.ring_pair(ctx, b, 0, 0, 4, 1)
            return lo, hi, total, top, whole, mixed, lo2
        s = torch.zeros((), dtype=F64)
        return dt.shard_jvp(ctx, f, (s,), (torch.ones_like(s),))

    try:
        comm.reset_counts()
        res = pool.run(fn)
    finally:
        pool.close()
    # a primal and a tangent exchange each (the max's tangent is a sum of
    # the masked tangents and the mask); the two fences are not counted
    assert comm.counts == {"ring": 4, "sum": 5, "max": 1, "gather": 2}
    whole = torch.cat([torch.arange(1, 5, dtype=F64) + 10.0 * r for r in range(4)])
    for r, (prim, tan) in enumerate(res):
        left, right = 10.0 * ((r - 1) % 4), 10.0 * ((r + 1) % 4)
        assert float(prim[0]) == left + 4 and float(tan[0]) == 2 * (left + 4)
        assert float(prim[1]) == right + 1 and float(tan[1]) == 2 * (right + 1)
        assert float(prim[2]) == 15.0 * 4 + 60.0 * 6 and float(tan[2]) == 2 * float(prim[2])
        assert float(prim[3]) == 3.0 and float(tan[3]) == 9.0
        assert torch.equal(prim[4][1:-1], whole) and torch.equal(tan[4][1:-1], 2 * whole)
        assert float(prim[5]) == float(prim[2]) and float(tan[5]) == 2 * (float(prim[2]) - 15.0)
        assert float(prim[6]) == left + 4 and float(tan[6]) == (0.0 if r == 1 else 2 * (left + 4))


def test_make_mesh_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdt.make_mesh((2,))
    m = pdt.make_mesh((2, 2), ["cpu"] * 5)
    assert m.shape == (2, 2) and m.axis_names == ("x", "y") and len(m.devices) == 4
