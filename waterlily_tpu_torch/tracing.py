"""Spans and counters inside waterlily_tpu_torch, on the profiler's clock.

The program marks where its time goes with named spans (``wlt.step``, the
two momentum phases ``wlt.predict`` and ``wlt.correct``, the pressure
solve ``wlt.solve``, every device→host read ``wlt.read``, the body measure
``wlt.measure``, the output's ``wlt.force`` and ``wlt.nds_field``, the
constructor's ``wlt.build``) and counts the padded cells of each kernel
call (``cells.<wrapper>[.<route>]``, added where `ops.stencil3d.launch_counts`
counts the call) and the cells each `nds_field` call measures
(``nds.points``, ``nds.measured``).  README.md ("Tracing") lists every span
and counter.

Recording is on while a `torch.profiler` session runs (any profiler that
goes through `torch.autograd.profiler`'s start and stop) or inside
`tracing()`, and off otherwise.  When off, a span site costs one read of
the module flag `recording` and returns a shared no-op: no clock read, no
record, no device synchronisation.  A span never synchronises the device
when on either: its start and end are the host's, so a span that ends in a
device→host read (``wlt.read``) holds the time the host waited for the
queue to drain.

Each stretch of recording is a session: a new one starts at the first
record after an off period, and `session()` returns the newest.  Times are
nanoseconds on the Unix epoch, the clock the profiler stamps its host
events with (``start_ns()`` of `prof.profiler.kineto_results.events()`):
``perf_counter_ns`` plus an offset fixed when the session opens, so that a
session's times never run backwards.  Spans are never emitted as profiler
events (`record_function` ranges would count as device operations in a
trace's reduction): they live here, and `write_chrome` writes them as a
Chrome trace that opens in Perfetto beside the profiler's own.

A session keeps at most `LIMIT` spans and counts the spans past it in
``dropped``.  Spans opened on `parallel.DistSimulation`'s shard threads
inherit the caller's enclosing span (the pool runs each job in a copy of
the caller's `contextvars` context), so every shard's spans carry the
step's index; they carry no shard id.

The recorder follows the profiler through `torch.autograd.profiler`'s
``_run_on_profiler_start``/``_run_on_profiler_stop``, wrapped once when
this module is imported; a profiler already running then counts as on.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import threading
import time
from typing import Optional

from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "tracing", "session", "write_chrome", "Session",
           "Span", "LIMIT"]

# spans kept per session (~200 bytes each); later ones are counted as dropped
LIMIT = 1 << 18

# True while recording; read by every span site and by the launch path of
# `ops.stencil3d`, set here only
recording = False
_manual = 0                      # depth of open `tracing()` blocks
_profiling = bool(getattr(_profiler, "_is_profiler_enabled", False))
_epoch = 0                       # off → on transitions so far
_newest: Optional["Session"] = None
_lock = threading.Lock()
# the innermost open span of this context (a shard's job sees its caller's)
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "waterlily_tpu_torch_span", default=None)


class Session:
    """One stretch of recording: ``spans`` in the order they opened,
    ``counters`` (name → total), ``dropped`` (spans past ``limit``) and
    ``opened_ns`` (Unix-epoch ns)."""

    def __init__(self, epoch: int, limit: int):
        self.epoch, self.limit = epoch, limit
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.dropped = 0
        self.opened_ns = time.time_ns()
        self._offset = self.opened_ns - time.perf_counter_ns()
        self._ids = itertools.count(1)

    def now_ns(self) -> int:
        """The session's clock: Unix-epoch nanoseconds, monotonic."""
        return time.perf_counter_ns() + self._offset

    def named(self, name: str) -> list["Span"]:
        """The closed spans called ``name``."""
        return [s for s in self.spans if s.name == name and s.end is not None]

    def seconds(self, name: str) -> tuple[float, float]:
        """``(total, self)`` seconds of the closed spans called ``name``:
        their durations, and those less the durations of their direct
        children."""
        mine = {s.id: s for s in self.named(name)}
        total = sum(s.end - s.start for s in mine.values())
        inner = sum(s.end - s.start for s in self.spans
                    if s.parent in mine and s.end is not None)
        return total / 1e9, (total - inner) / 1e9


class Span:
    """A named interval: ``start``/``end`` in Unix-epoch ns (``end`` None
    while open), ``id``, the enclosing span's id (``parent``, None at the
    top), ``step`` (the ``step`` attr of the nearest ``wlt.step`` around
    it, None outside a step), ``thread`` and ``attrs``."""

    __slots__ = ("name", "attrs", "id", "parent", "step", "thread", "start",
                 "end", "_session", "_token")

    def __init__(self, name: str, attrs: dict, session: Session):
        self.name, self.attrs, self._session = name, attrs, session
        self.end = None

    def __enter__(self) -> "Span":
        up = _current.get()
        self.parent = None if up is None else up.id
        self.step = self.attrs.get("step", None if up is None else up.step)
        self.thread = threading.get_ident()
        self.id = next(self._session._ids)
        self._session.spans.append(self)
        self._token = _current.set(self)
        self.start = self._session.now_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = self._session.now_ns()
        _current.reset(self._token)
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a solve's
        iterations)."""
        self.attrs.update(attrs)


class _Off:
    """What a span site gets while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def _live() -> Session:
    """The session of this stretch of recording, opened by its first
    record."""
    global _newest
    s = _newest
    if s is None or s.epoch != _epoch:
        with _lock:
            if _newest is None or _newest.epoch != _epoch:
                _newest = Session(_epoch, LIMIT)
            s = _newest
    return s


def span(name: str, **attrs):
    """A context manager that records the block as the span ``name`` with
    ``attrs`` while recording is on (`Span`, with `Span.set`), and does
    nothing otherwise."""
    if not recording:
        return _OFF
    s = _live()
    if len(s.spans) >= s.limit:
        s.dropped += 1
        return _OFF
    return Span(name, attrs, s)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the session's counter ``name`` while recording."""
    if recording:
        s = _live()
        with _lock:
            s.counters[name] = s.counters.get(name, 0) + n


def _update() -> None:
    global recording, _epoch
    on = _manual > 0 or _profiling
    if on and not recording:
        _epoch += 1
    recording = on


@contextlib.contextmanager
def tracing():
    """Record inside the block without a profiler (a run's own timeline,
    `write_chrome`); blocks nest, and a profiler session inside or around
    one continues the same session."""
    global _manual
    with _lock:
        _manual += 1
        _update()
    try:
        yield
    finally:
        with _lock:
            _manual -= 1
            _update()


def session() -> Optional[Session]:
    """The newest session, or None before any record."""
    return _newest


def write_chrome(path) -> int:
    """Write the newest session as Chrome-trace ``"X"`` events (``ts`` and
    ``dur`` in µs on the Unix epoch, the span's id, parent, step and attrs
    under ``args``), the counters and ``dropped`` under ``otherData``;
    returns the number of events.  Open it in Perfetto (ui.perfetto.dev)
    beside `prof.export_chrome_trace`'s file."""
    s = _newest
    spans = [] if s is None else [x for x in s.spans if x.end is not None]
    events = [dict(name=x.name, ph="X", cat="waterlily_tpu_torch", pid=0,
                   tid=x.thread, ts=x.start / 1e3, dur=(x.end - x.start) / 1e3,
                   args=dict(x.attrs, id=x.id, parent=x.parent, step=x.step))
              for x in spans]
    other = {} if s is None else dict(counters=s.counters, dropped=s.dropped)
    with open(path, "w") as f:
        json.dump(dict(traceEvents=events, otherData=other), f, default=str)
    return len(events)


def _follow(name: str, on: bool) -> None:
    """Wrap the profiler's start or stop hook so that recording follows
    it."""
    hook = getattr(_profiler, name, None)
    if hook is None or getattr(hook, "_wlt_follows", False):
        return

    @functools.wraps(hook)
    def run(*args, **kwargs):
        global _profiling
        out = hook(*args, **kwargs)
        with _lock:
            _profiling = on
            _update()
        return out

    run._wlt_follows = True
    setattr(_profiler, name, run)


_follow("_run_on_profiler_start", True)
_follow("_run_on_profiler_stop", False)
_update()
