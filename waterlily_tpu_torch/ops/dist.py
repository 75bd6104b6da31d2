"""Distributed-grid primitives: halo exchange, global reductions, gathers.

PyTorch counterpart of `waterlily_tpu/ops/dist.py`.  The domain is split
over a mesh of shards with axes ('x', 'y', 'z') mapped onto the leading
spatial dims.  Each shard holds its block in the same ghost-padded layout as
a single-device field (local interior ``N_d/k_d`` plus one ghost layer per
side), so every stencil op runs unchanged per shard; only the ghost contents
change, filled by ring exchanges instead of (or besides) the physical
boundary conditions.  Periodic directions need no special case: the ring
wraps.

The JAX package runs the per-shard code once per device under `shard_map`
and its collectives are `ppermute`/`psum`/`pmax`/`all_gather`.  The port
keeps that single-controller design in one process: a mesh is a list of
torch devices (repeats allowed, e.g. four shards on ``cuda:0``), one
persistent worker thread per shard (`ShardPool`) runs the per-shard code,
and the collectives are rendezvous points of a small in-process
`Communicator`.  One shard runs at a time: a worker holds the
communicator's turn (a baton) from the start of its job to its next
rendezvous, where it passes the turn on.  The threads are coroutines that
keep their own call stacks; they never compete for the interpreter (every
PyTorch call releases it, and four threads that all want it back hand it
over at every call: a step of four shards on one card ran 100 times a
single-device step's time that way), and process-wide state such as
forward-mode AD's level (`torch.func` in the body measure) or the launch
counts sees one shard at a time.  The card runs what the shards enqueue
asynchronously, as it does for one device.

* a sent tensor is cloned at the rendezvous and never written again, so a
  sender that goes on writing its field in place cannot change what its
  neighbour reads;
* a reduction combines the shards' values in shard order on every shard:
  every shard gets the same value, bit for bit (`multigrid.solve_loop` reads
  the norms on the host on every shard, and a shard that read another value
  would leave the loop alone);
* every rendezvous has a time limit (`DEFAULT_TIMEOUT`): when it passes the
  rendezvous raises `CollectiveTimeout` naming the collective and the
  shard; an exception in one worker aborts the rendezvous of the others,
  and `ShardPool.run` re-raises it in the caller's thread;
* on CUDA every hand-off carries an event: the sender records it on its
  current stream, the receiver's current stream waits on it, so shards on
  different streams or different cards exchange correctly;
* inside `shard_jvp` a collective exchanges the primals and then the
  tangents as plain tensors (autograd Functions with a jvp rule: the ring,
  the sum and the gather are linear, the max takes the tangent of the
  shards that hold it), and `shard_jvp` keeps the shards' forward-mode
  levels nested: a dual tensor never crosses threads.

Every function takes a `DistCtx` (one per shard, built by `make_ctx`);
``ctx=None`` (or a mesh extent of 1 in a dim) is the single-device
semantics exactly.  The ctx holds concrete shard coordinates, so the edge
tests are Python booleans.
"""
from __future__ import annotations

import contextvars
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from .bc import per_bc
from .grid import grow, slab

__all__ = ["DistCtx", "make_ctx", "sharded", "edge_lo", "edge_hi", "offsets",
           "parity_shift", "fetch_lo", "fetch_hi", "ring_pair",
           "sync_scalar", "sync_vector", "psum_all", "pmax_all",
           "global_inside_count", "gather_scalar", "slice_local", "shard_jvp",
           "Communicator", "ShardPool", "CollectiveTimeout",
           "DEFAULT_TIMEOUT"]

# seconds a shard waits at a rendezvous before it raises
DEFAULT_TIMEOUT = 120.0


class CollectiveTimeout(TimeoutError):
    """A shard waited at a rendezvous longer than the communicator's limit:
    another shard took another path (a divergence) or hangs."""


class _Aborted(RuntimeError):
    """The rendezvous was aborted because another shard failed."""


class Communicator:
    """The collectives of one mesh of ``n`` shards, in one process.

    Every collective is one rendezvous of all shards (the per-shard code is
    the same on every shard, as under `shard_map`): each shard deposits its
    contribution, waits for the others, and reads what it needs.  Two
    deposit buffers alternate: a shard can write the buffer of rendezvous
    ``k + 2`` only after every shard passed rendezvous ``k + 1``, that is
    after every shard read rendezvous ``k``.  A shard that arrives at
    another kind of collective than the others raises.

    ``mesh_shape`` is the mesh's extent per axis and ``devices`` the device
    of each shard in row-major mesh order.  ``counts`` holds the
    rendezvous per kind and ``halo_bytes`` the bytes of the ring slabs sent
    (summed over shards), both since the last `reset_counts`."""

    def __init__(self, mesh_shape: Sequence[int], devices: Sequence,
                 timeout: float = DEFAULT_TIMEOUT):
        self.mesh_shape = tuple(int(k) for k in mesh_shape)
        self.n = math.prod(self.mesh_shape)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != self.n:
            raise ValueError(f"{len(self.devices)} devices for a mesh of {self.n}")
        self.timeout = float(timeout)
        self._barrier = threading.Barrier(self.n)
        self._turn = threading.Lock()
        self._holder: Optional[int] = None
        self._slots = ([None] * self.n, [None] * self.n)
        self._seq = [0] * self.n
        # each shard's open `shard_jvp`: a zero that carries a tangent at
        # its forward-mode level, or None
        self._seed = [None] * self.n
        self._failed: Optional[str] = None
        self.reset_counts()

    # ------------------------------------------------------------ layout
    def coords(self, rank: int) -> tuple[int, ...]:
        """The mesh coordinates of shard ``rank`` (row-major)."""
        out = []
        for k in reversed(self.mesh_shape):
            out.append(rank % k)
            rank //= k
        return tuple(reversed(out))

    def _rank(self, coords: Sequence[int]) -> int:
        r = 0
        for c, k in zip(coords, self.mesh_shape):
            r = r * k + c
        return r

    def neighbour(self, rank: int, axis: int, step: int) -> int:
        """The shard ``step`` places along mesh ``axis`` on the ring."""
        c = list(self.coords(rank))
        c[axis] = (c[axis] + step) % self.mesh_shape[axis]
        return self._rank(c)

    def group(self, rank: int, axis: int) -> list[int]:
        """The shards of ``rank``'s ring along mesh ``axis``, in order."""
        c = list(self.coords(rank))
        out = []
        for s in range(self.mesh_shape[axis]):
            c[axis] = s
            out.append(self._rank(c))
        return out

    # ------------------------------------------------------------ bookkeeping
    def reset_counts(self) -> None:
        self.counts = {"ring": 0, "sum": 0, "max": 0, "gather": 0}
        self.halo_bytes = 0

    def reset(self) -> None:
        """Ready the communicator for a new run of every shard (after a
        failed one: the barrier, the buffers and the sequence numbers)."""
        self._barrier.reset()
        self._slots = ([None] * self.n, [None] * self.n)
        self._seq = [0] * self.n
        # each shard's open `shard_jvp`: a zero that carries a tangent at
        # its forward-mode level, or None
        self._seed = [None] * self.n
        self._failed = None

    def abort(self, reason: str) -> None:
        """Wake every shard waiting at a rendezvous with `_Aborted`."""
        self._failed = reason
        self._barrier.abort()

    def take_turn(self, rank: int, where: str = "its turn") -> None:
        """Wait until no other shard runs, then run (module docstring)."""
        if not self._turn.acquire(timeout=self.timeout):
            raise CollectiveTimeout(f"shard {rank} waited {self.timeout:g} s for {where}: "
                                    "another shard runs on without reaching a rendezvous")
        self._holder = rank

    def give_turn(self, rank: int) -> None:
        """Let the next shard run, if ``rank`` holds the turn."""
        if self._holder == rank:
            self._holder = None
            self._turn.release()

    # ------------------------------------------------------------ transport
    @staticmethod
    def _send(t: Optional[torch.Tensor]):
        """The sent copy of ``t`` and, on CUDA, an event recorded after the
        copy on the sender's current stream (None for None)."""
        if t is None:
            return None
        c = t.clone(memory_format=torch.contiguous_format)
        ev = None
        if c.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(c.device))
        return c, ev

    @staticmethod
    def _recv(item, dev: torch.device) -> torch.Tensor:
        """A received tensor on ``dev``, ordered after the sender's copy.
        The sender never writes it; a receiver must not either."""
        c, ev = item
        if ev is not None:
            src = torch.cuda.current_stream(c.device)
            src.wait_event(ev)
            # the block is read on this thread's stream: the allocator must
            # not hand it out again before that stream is done with it
            c.record_stream(src)
            if dev.type == "cuda" and dev != c.device:
                torch.cuda.current_stream(dev).wait_event(ev)
        if c.device == dev:
            return c
        # a copy across devices: PyTorch orders it after both devices'
        # current streams and them after it
        return c.to(dev, copy=True)

    def _exchange(self, rank: int, kind: str, payload, tag: str = "") -> list:
        """Deposit ``payload`` (a tensor, a tuple of tensors or None), wait
        for every shard, return every shard's deposit (as sent: `_recv` each
        entry used).  ``tag`` tells a tangent's exchange from its primal's
        (`_RingAD`): a shard at another kind or tag than the others raises.
        A fence (kind "fence") is not counted."""
        seq = self._seq[rank]
        self._seq[rank] = seq + 1
        buf = self._slots[seq % 2]
        name = kind + tag
        if isinstance(payload, tuple):
            buf[rank] = (name, tuple(self._send(t) for t in payload))
        else:
            buf[rank] = (name, self._send(payload))
        self.give_turn(rank)
        t0 = time.monotonic()
        try:
            self._barrier.wait(self.timeout)
        except threading.BrokenBarrierError:
            waited = time.monotonic() - t0
            if self._failed is None and waited >= 0.99 * self.timeout:
                raise CollectiveTimeout(
                    f"collective {name} #{seq}: shard {rank} waited {waited:.1f} s "
                    f"(limit {self.timeout:g} s) for the other shards") from None
            raise _Aborted(f"collective {name} #{seq} of shard {rank} aborted: "
                           f"{self._failed or 'another shard timed out'}") from None
        self.take_turn(rank, f"its turn after collective {name} #{seq}")
        names = {e[0] for e in buf}
        if names != {name}:
            raise RuntimeError(f"collective mismatch at #{seq}: shard {rank} is at "
                               f"{name}, the shards are at {[e[0] for e in buf]}")
        if rank == 0 and kind != "fence":
            self.counts[kind] += 1
        return [e[1] for e in buf]

    # ------------------------------------------------------------ collectives
    # Each collective is linear in what a shard sends but the max.  Inside
    # `shard_jvp` a collective of floating tensors runs as an autograd
    # Function (`_RingAD`, `_ReduceAD`, `_GatherAD`) whose forward exchanges
    # the primals as plain tensors and whose jvp rule exchanges the tangents
    # in a second rendezvous of the same kind (tagged ``'``); the receiving
    # shard rebuilds the dual in its own level.  The Function also takes the
    # shard's seed (a zero with a tangent, `shard_jvp`), so its jvp rule runs
    # on every shard, also where what a shard sends carries no tangent (it
    # sends zeros): every shard takes the same route whatever it sends.  A
    # tensor that carries a tangent never reaches another thread: one
    # shard's dual read in another shard's transform loses its tangent or
    # passes for the receiver's own.
    def ring(self, rank: int, axis: int, to_next: Optional[torch.Tensor],
             to_prev: Optional[torch.Tensor]):
        """One ring exchange along mesh ``axis``: every shard sends
        ``to_next`` to the next shard of the ring and ``to_prev`` to the
        previous one (either may be None: nothing goes that way); returns
        ``(from_prev, from_next)``: the previous shard's ``to_next`` and the
        next shard's ``to_prev``."""
        if self._ad(rank, to_next, to_prev):
            got = iter(_RingAD.apply(self, rank, axis, "", self._seed[rank], to_next,
                                    to_prev))
            return (None if to_next is None else next(got),
                    None if to_prev is None else next(got))
        return self._ring(rank, axis, to_next, to_prev)

    def _ring(self, rank, axis, to_next, to_prev, tag=""):
        got = self._exchange(rank, "ring", (to_next, to_prev), tag)
        self.halo_bytes += sum(t.numel() * t.element_size() for t in (to_next, to_prev)
                               if t is not None)
        dev = self.devices[rank]
        a = got[self.neighbour(rank, axis, -1)][0]
        b = got[self.neighbour(rank, axis, 1)][1]
        return (None if a is None else self._recv(a, dev),
                None if b is None else self._recv(b, dev))

    def allreduce(self, rank: int, t: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ("sum" or "max") of every shard's ``t``, elementwise,
        combined in shard order on this shard: the same value on every
        shard, bit for bit.  The tangent of a max is that of the shards
        that hold it, averaged over them (`_ReduceAD`)."""
        if self._ad(rank, t):
            return _ReduceAD.apply(self, rank, op, "", self._seed[rank], t)
        return self._allreduce(rank, t, op)

    def _allreduce(self, rank, t, op, tag=""):
        got = self._exchange(rank, op, t, tag)
        dev = self.devices[rank]
        acc = self._recv(got[0], dev)
        for item in got[1:]:
            v = self._recv(item, dev)
            acc = acc + v if op == "sum" else torch.maximum(acc, v)
        return acc

    def all_gather(self, rank: int, t: torch.Tensor, axis: int,
                   dim: int) -> torch.Tensor:
        """The shards' ``t`` of ``rank``'s ring along mesh ``axis``,
        concatenated along tensor dim ``dim`` in ring order."""
        if self._ad(rank, t):
            return _GatherAD.apply(self, rank, axis, dim, "", self._seed[rank], t)
        return self._all_gather(rank, t, axis, dim)

    def _all_gather(self, rank, t, axis, dim, tag=""):
        got = self._exchange(rank, "gather", t, tag)
        dev = self.devices[rank]
        return torch.cat([self._recv(got[s], dev) for s in self.group(rank, axis)],
                         dim=dim)

    def _ad(self, rank: int, *ts) -> bool:
        """Whether ``rank``'s collective of ``ts`` exchanges tangents: inside
        its `shard_jvp`, for floating tensors (a decision that is the same
        on every shard of the collective)."""
        return self._seed[rank] is not None and any(
            t is not None and t.is_floating_point() for t in ts)

    def fence(self, rank: int) -> None:
        """A rendezvous that exchanges nothing: every shard has reached it
        before any leaves it (`shard_jvp`)."""
        self._exchange(rank, "fence", None)


def _zeros_for(ts, meta):
    """``ts`` with each None whose primal was a tensor (``meta``: its shape,
    dtype and device, or None) replaced by zeros: a tangent exchange sends
    what its primal exchange sent."""
    return tuple(t if t is not None or m is None
                 else torch.zeros(m[0], dtype=m[1], device=m[2])
                 for t, m in zip(ts, meta))


def _meta(t):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def _present(*ts):
    return tuple(t for t in ts if t is not None)


# The jvp rules exchange the tangents through the Functions again (with no
# seed): a tangent reaches the rule wrapped by a functorch level of this
# thread, and `apply` unwraps it before it is sent.


class _RingAD(torch.autograd.Function):
    """`Communicator.ring` under `shard_jvp`: the ring of the primals, then
    (jvp) the ring of the tangents, a rendezvous of its own.  Returns the
    received slabs that exist (``from_prev`` when ``to_next`` is sent, then
    ``from_next`` when ``to_prev`` is).  ``seed``: the shard's (`_ad`)."""

    @staticmethod
    def forward(comm, rank, axis, tag, seed, to_next, to_prev):
        return _present(*comm._ring(rank, axis, to_next, to_prev, tag))

    @staticmethod
    def setup_context(ctx, inputs, output):
        comm, rank, axis, tag, _, to_next, to_prev = inputs
        ctx.set_materialize_grads(False)
        ctx.args = (comm, rank, axis, tag + "'", None)
        ctx.meta = (_meta(to_next), _meta(to_prev))

    @staticmethod
    def jvp(ctx, _c, _r, _a, _t, _s, d_next, d_prev):
        return _RingAD.apply(*ctx.args, *_zeros_for((d_next, d_prev), ctx.meta))


class _ReduceAD(torch.autograd.Function):
    """`Communicator.allreduce` under `shard_jvp`.  A sum's tangent is the
    sum of the tangents.  A max's tangent is the mean of the tangents of
    the shards whose value equals the max (one more sum, of the masked
    tangents and of the mask): the per-shard `torch.max` of a field
    averages the tangents of its tied cells, so this equals the tangent of
    the max over the whole field when the shards that tie hold as many tied
    cells each (as mirror images across a shard bound do).  The JAX
    package's `pmax` has no forward-mode rule: its decomposed step has no
    jvp to compare with."""

    @staticmethod
    def forward(comm, rank, op, tag, seed, t):
        return comm._allreduce(rank, t, op, tag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        comm, rank, op, tag, _, t = inputs
        ctx.set_materialize_grads(False)
        ctx.args = (comm, rank, tag + "'")
        ctx.op, ctx.meta = op, (_meta(t),)
        if op == "max":
            ctx.save_for_forward(t, output)

    @staticmethod
    def jvp(ctx, _c, _r, _o, _t, _s, dt):
        comm, rank, tag = ctx.args
        (dt,) = _zeros_for((dt,), ctx.meta)
        if ctx.op == "sum":
            return _ReduceAD.apply(comm, rank, "sum", tag, None, dt)
        t, top = ctx.saved_tensors
        hit = (t == top).to(dt.dtype)
        s = _ReduceAD.apply(comm, rank, "sum", tag, None, torch.stack([hit * dt, hit]))
        return s[0] / s[1]


class _GatherAD(torch.autograd.Function):
    """`Communicator.all_gather` under `shard_jvp`: the gather of the
    tangents (linear)."""

    @staticmethod
    def forward(comm, rank, axis, dim, tag, seed, t):
        return comm._all_gather(rank, t, axis, dim, tag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        comm, rank, axis, dim, tag, _, t = inputs
        ctx.set_materialize_grads(False)
        ctx.args = (comm, rank, axis, dim, tag + "'", None)
        ctx.meta = (_meta(t),)

    @staticmethod
    def jvp(ctx, _c, _r, _a, _d, _t, _s, dt):
        return _GatherAD.apply(*ctx.args, *_zeros_for((dt,), ctx.meta))


class ShardPool:
    """One persistent worker thread per shard.  `run` hands every worker
    its job, runs it in its turn (`Communicator.take_turn`), in a copy of
    the caller's `contextvars` context (so that `stencil3d.plain_ops()` and
    the like reach the shards) and, on CUDA, under the shard's stream
    (``streams``: None, the thread's current stream, or a list of one CUDA
    stream a shard, set before `run`), ordered after the caller's current
    stream and before it.  The workers are daemon threads; `close` stops
    them."""

    def __init__(self, comm: Communicator):
        self.comm = comm
        self.streams = None
        self._queues = [queue.SimpleQueue() for _ in range(comm.n)]
        self._threads = [threading.Thread(target=self._work, args=(r,), daemon=True,
                                          name=f"waterlily-shard-{r}")
                         for r in range(comm.n)]
        for th in self._threads:
            th.start()

    def _work(self, rank: int) -> None:
        dev = self.comm.devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        q = self._queues[rank]
        while True:
            job = q.get()
            if job is None:
                return
            fut, ctx, fn, before = job
            try:
                self.comm.take_turn(rank)
                stream = None if self.streams is None else self.streams[rank]
                if stream is None:
                    res = ctx.run(fn, rank)
                    after = None
                else:
                    with torch.cuda.stream(stream):
                        if before is not None:
                            stream.wait_event(before)
                        res = ctx.run(fn, rank)
                        after = torch.cuda.Event()
                        after.record(stream)
                fut.set_result((res, after))
            except BaseException as e:       # noqa: BLE001 - re-raised by `run`
                if not isinstance(e, _Aborted):
                    self.comm.abort(f"shard {rank} raised {type(e).__name__}: {e}")
                fut.set_exception(e)
            finally:
                self.comm.give_turn(rank)

    def run(self, fn: Callable[[int], Any]) -> list:
        """``fn(rank)`` on every shard's worker; the list of results in rank
        order.  The first exception of a shard (not a shard's abort that
        followed it) is raised here after every worker finished."""
        self.comm.reset()
        futs = []
        for rank, q in enumerate(self._queues):
            before = None
            if self.streams is not None:
                before = torch.cuda.Event()
                before.record(torch.cuda.current_stream(self.comm.devices[rank]))
            fut = Future()
            q.put((fut, contextvars.copy_context(), fn, before))
            futs.append(fut)
        results, errors = [], []
        for rank, fut in enumerate(futs):
            try:
                res, after = fut.result()
            except BaseException as e:       # noqa: BLE001
                errors.append(e)
                continue
            if after is not None:
                torch.cuda.current_stream(self.comm.devices[rank]).wait_event(after)
            results.append(res)
        if errors:
            first = next((e for e in errors if not isinstance(e, _Aborted)), errors[0])
            raise first
        return results

    def close(self) -> None:
        for q in self._queues:
            q.put(None)
        for th in self._threads:
            th.join(timeout=5.0)


# ---------------------------------------------------------------- the ctx
class DistCtx(NamedTuple):
    axes: tuple          # mesh axis name per spatial dim (None = unsharded)
    sizes: tuple         # mesh extent per spatial dim
    n_loc: tuple         # local interior size per spatial dim
    coords: tuple        # this shard's index along each dim (0 if unsharded)
    comm: Optional[Communicator] = None
    rank: int = 0


def make_ctx(axes: tuple, sizes: tuple, local_shape: tuple,
             comm: Communicator, rank: int) -> DistCtx:
    """The ctx of shard ``rank`` (the JAX `make_ctx` inside `shard_map`);
    ``local_shape`` is the local padded shape.  Spatial dim ``d`` maps to
    mesh axis ``d``."""
    mc = comm.coords(rank)
    coords = tuple(mc[d] if d < len(mc) and axes[d] is not None else 0
                   for d in range(len(axes)))
    n_loc = tuple(n - 2 for n in local_shape)
    return DistCtx(tuple(axes), tuple(sizes), n_loc, coords, comm, rank)


def sharded(ctx: Optional[DistCtx], d: int) -> bool:
    return ctx is not None and ctx.sizes[d] > 1


def edge_lo(ctx: Optional[DistCtx], d: int) -> bool:
    """True on shards owning the low physical boundary of dim d."""
    return not sharded(ctx, d) or ctx.coords[d] == 0


def edge_hi(ctx: Optional[DistCtx], d: int) -> bool:
    """True on shards owning the high physical boundary of dim d."""
    return not sharded(ctx, d) or ctx.coords[d] == ctx.sizes[d] - 1


def offsets(ctx: Optional[DistCtx], shape: tuple[int, ...]) -> tuple[int, ...]:
    """Global interior index offset of this shard's cell 0, per dim, for a
    field of local padded ``shape`` (levels differ from the finest)."""
    if ctx is None:
        return (0,) * len(shape)
    return tuple(ctx.coords[d] * (shape[d] - 2) for d in range(len(shape)))


def parity_shift(ctx: Optional[DistCtx], shape: tuple[int, ...]) -> int:
    """(sum of global offsets) mod 2: the red-black colour of this shard's
    cells relative to the global checkerboard."""
    return sum(offsets(ctx, shape)) % 2


def fetch_lo(ctx: Optional[DistCtx], a: torch.Tensor, axis: int, d: int,
             idx: int) -> torch.Tensor:
    """Slab ``idx`` of the LEFT (lower-coordinate) ring neighbour along
    spatial dim ``d`` (``axis`` the tensor axis, >= d when component axes
    lead).  Unsharded dims self-wrap: the single-device periodic read."""
    s = slab(a, axis, idx)
    if not sharded(ctx, d):
        return s
    return ctx.comm.ring(ctx.rank, d, s, None)[0]


def fetch_hi(ctx: Optional[DistCtx], a: torch.Tensor, axis: int, d: int,
             idx: int) -> torch.Tensor:
    """Slab ``idx`` of the RIGHT ring neighbour along spatial dim ``d``."""
    s = slab(a, axis, idx)
    if not sharded(ctx, d):
        return s
    return ctx.comm.ring(ctx.rank, d, None, s)[1]


def ring_pair(ctx: DistCtx, a: torch.Tensor, axis: int, d: int, idx_lo: int,
              idx_hi: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`fetch_lo` of slab ``idx_lo`` and `fetch_hi` of slab ``idx_hi`` in one
    exchange (dim ``d`` sharded)."""
    return ctx.comm.ring(ctx.rank, d, slab(a, axis, idx_lo), slab(a, axis, idx_hi))


def sync_scalar(a: torch.Tensor, ctx: Optional[DistCtx],
                perdir: tuple[int, ...] = (), lead: int = 0,
                edge_zero: bool = True) -> torch.Tensor:
    """Refresh the ghost layers of a (possibly component-leading) field, as
    a new tensor:

    * sharded dims: ring halo exchange; on physical-edge shards of
      non-periodic dims the outer ghost is zeroed (``edge_zero``, the solver
      fields' convention) or keeps its local value otherwise (BC and
      forcing ghosts);
    * unsharded periodic dims: local wrap (single-device `perBC!`);
    * unsharded non-periodic dims: untouched.

    Dims are refreshed in order, each after the ghosts of the ones before,
    so corners carry their neighbours' values."""
    if ctx is None:
        return per_bc(a, perdir, lead)
    a = a.clone()
    for d in range(len(ctx.axes)):
        ax = lead + d
        n = a.shape[ax]
        if sharded(ctx, d):
            lo, hi = ring_pair(ctx, a, ax, d, n - 2, 1)
            per = d in perdir
            if per or not edge_lo(ctx, d):
                slab(a, ax, 0).copy_(lo)
            elif edge_zero:
                slab(a, ax, 0).zero_()
            if per or not edge_hi(ctx, d):
                slab(a, ax, n - 1).copy_(hi)
            elif edge_zero:
                slab(a, ax, n - 1).zero_()
        elif d in perdir:
            slab(a, ax, 0).copy_(slab(a, ax, n - 2))
            slab(a, ax, n - 1).copy_(slab(a, ax, 1))
    return a


def sync_vector(a: torch.Tensor, ctx: Optional[DistCtx],
                perdir: tuple[int, ...] = (), edge_zero: bool = False) -> torch.Tensor:
    """Halo-refresh a ``(D, *local)`` field (edge ghosts kept by default:
    they carry BC values)."""
    return sync_scalar(a, ctx, perdir, lead=1, edge_zero=edge_zero)


def _any_sharded(ctx: Optional[DistCtx]) -> bool:
    return ctx is not None and any(k > 1 for k in ctx.sizes)


def psum_all(x: torch.Tensor, ctx: Optional[DistCtx]) -> torch.Tensor:
    """Sum across the shards (identity when ctx is None): the global
    reduction of norms, means and forces under decomposition."""
    if not _any_sharded(ctx):
        return x
    return ctx.comm.allreduce(ctx.rank, x, "sum")


def pmax_all(x: torch.Tensor, ctx: Optional[DistCtx]) -> torch.Tensor:
    """Max across the shards (identity when ctx is None): the CFL limit and
    the L∞ residual norm."""
    if not _any_sharded(ctx):
        return x
    return ctx.comm.allreduce(ctx.rank, x, "max")


def global_inside_count(ctx: Optional[DistCtx], shape: tuple[int, ...]) -> int:
    """Global interior cell count for a local padded ``shape``."""
    if ctx is None:
        return math.prod(n - 2 for n in shape)
    return math.prod((shape[d] - 2) * ctx.sizes[d] for d in range(len(shape)))


def gather_scalar(a: torch.Tensor, ctx: DistCtx) -> torch.Tensor:
    """All-gather a distributed padded scalar field into the replicated
    global padded field (interior concatenation, fresh zero ghosts): the
    coarse-grid gather of the multigrid transition."""
    D = a.dim()
    g = a[(slice(1, -1),) * D]
    for d in range(D):
        if sharded(ctx, d):
            g = ctx.comm.all_gather(ctx.rank, g, d, d)
    return grow(g)


def slice_local(g: torch.Tensor, ctx: DistCtx) -> torch.Tensor:
    """Inverse of `gather_scalar`: this shard's padded block of a replicated
    global padded field (interior slice, zero ghosts)."""
    D = g.dim()
    gi = g[(slice(1, -1),) * D]
    ix = []
    for d in range(D):
        if sharded(ctx, d):
            nl = gi.shape[d] // ctx.sizes[d]
            ix.append(slice(ctx.coords[d] * nl, (ctx.coords[d] + 1) * nl))
        else:
            ix.append(slice(None))
    return grow(gi[tuple(ix)])


def shard_jvp(ctx: Optional[DistCtx], fn: Callable, primals: tuple,
              tangents: tuple):
    """`torch.func.jvp` of ``fn`` on one shard of a mesh (in that shard's
    worker, e.g. through `ShardPool.run`), with the shards' forward-mode
    levels nested and every collective of ``fn`` exchanging tangents (the
    shard's seed: a zero primal with a zero tangent, `Communicator._ad`).

    This rests on how torch runs `torch.func.jvp` in several threads:
    forward mode's dual level is one for the process, made by the first jvp
    to enter and cleared on leaving, with every tangent of it, also those of
    the jvps still open in other threads (a jvp that leaves out of order
    returns a zero tangent, no error).  So shard 0 enters first (the others
    wait at a fence inside its transform) and leaves last (it waits at a
    fence inside its transform for the others to have left theirs): two
    rendezvous more per call.  A torch that keeps a level per jvp or per
    thread breaks that order's premise: the decomposed jvps of the tests,
    held against non-zero single-device tangents, show it.  Without a
    sharded ``ctx`` it is `torch.func.jvp` itself."""
    if not _any_sharded(ctx):
        return torch.func.jvp(fn, primals, tangents)
    comm, rank = ctx.comm, ctx.rank

    def seeded(seed, *args):
        if rank == 0:
            comm.fence(rank)
        outer, comm._seed[rank] = comm._seed[rank], seed
        try:
            out = fn(*args)
        finally:
            comm._seed[rank] = outer
        if rank == 0:
            comm.fence(rank)
        return out
    zero = torch.zeros(())
    if rank != 0:
        comm.fence(rank)
    out = torch.func.jvp(seeded, (zero, *primals), (zero, *tangents))
    if rank != 0:
        comm.fence(rank)
    return out
