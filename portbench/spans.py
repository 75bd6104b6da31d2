"""What the per-layer metrics read of the program's own span recorder
(`waterlily_tpu_torch.tracing`): its newest session, which in a traced run
is the traced stretch (the recorder records while the profiler runs, and
the harness runs it over that stretch alone).  A program without the
recorder, or a session with nothing in it, gives None, and so does every
metric that reads it."""
from __future__ import annotations

from portbench import trace


def session(rec: dict):
    """The program's newest session in a traced run, or None."""
    if not rec.get("trace"):
        return None
    try:
        from waterlily_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.session()
    return s if s is not None and (s.spans or s.counters) else None


def share(rec: dict, names, own: bool = False) -> float | None:
    """The seconds of the spans ``names`` (``own``: less their children's)
    over the traced stretch's wall, in %; None without a span of them."""
    s = session(rec)
    if s is None or not any(s.named(n) for n in names):
        return None
    seconds = sum(s.seconds(n)[1 if own else 0] for n in names)
    return 100.0 * seconds / rec["trace"]["wall_s"]


def per_step(rec: dict, name: str) -> float | None:
    """The spans ``name`` over the traced stretch's steps; None without
    one."""
    s = session(rec)
    n = 0 if s is None else len(s.named(name))
    steps = rec["trace"]["steps"] if n else 0
    return n / steps if steps else None


def roofline(rec: dict, counter: str, symbols, bytes_per_cell: int) -> float | None:
    """A kernel's share of its floor, in %: the cells the program counted
    under ``cells.<counter>`` times ``bytes_per_cell`` over the published
    HBM rate, over the device time of the kernel's ``symbols``
    (`trace.device_seconds`); None when either is missing."""
    s = session(rec)
    cells = 0 if s is None else s.counters.get(f"cells.{counter}", 0)
    seconds = trace.device_seconds(rec["trace"], symbols) if cells else 0.0
    if seconds <= 0:
        return None
    return 100.0 * cells * bytes_per_cell / trace.HBM_BYTES_PER_S / seconds
