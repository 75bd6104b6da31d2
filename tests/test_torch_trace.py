"""The span recorder (`waterlily_tpu_torch.tracing`) on the CPU: nesting,
sessions, the cap, the off path, the Chrome file, and a 16³ sphere's steps
on the 3d engine under `torch.profiler`, whose host events the solve spans
enclose on the same clock."""
import contextlib
import json
import sys
import threading
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import waterlily_tpu_torch as wt
from waterlily_tpu_torch import tracing
from waterlily_tpu_torch.models import flow as fl
from waterlily_tpu_torch.ops import multigrid as mg


@pytest.fixture(scope="module")
def sphere():
    """A 16³ sphere on the 3d engine, built and stepped once untraced."""
    R = 4
    ctr = torch.tensor([6.0, 8.0, 8.0])
    body = wt.AutoBody(lambda x, t: torch.sqrt(torch.sum((x - ctr) ** 2)) - R)
    sim = wt.Simulation((16, 16, 16), (1.0, 0.0, 0.0), R, nu=R / 100, body=body,
                        engine="3d", device="cpu")
    sim.step_once(remeasure=False)
    return sim


def marked(monkeypatch, module, name, label):
    """Wrap ``module.name`` in a profiler range ``label``: a host event the
    test knows the caller of."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    monkeypatch.setattr(module, name, run)


@pytest.fixture(scope="module")
def profiled(sphere):
    """Two steps under `torch.profiler`: the session, the profiler's host
    events ``(name, start ns, end ns)`` and the iterations of the steps."""
    mp = pytest.MonkeyPatch()
    marked(mp, mg, "v_cycle", "test.v_cycle")
    marked(mp, fl, "conv_diff", "test.conv_diff")
    try:
        n0 = len(sphere.pois_n)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sphere.sim_step_n(2)
    finally:
        mp.undo()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return tracing.session(), events, sphere.pois_n[n0:]


def test_spans_nest_with_parents_and_a_shared_step(profiled):
    s, _, iters = profiled
    by_id = {x.id: x for x in s.spans}
    steps = s.named("wlt.step")
    assert [x.attrs["engine"] for x in steps] == ["3d", "3d"]
    assert steps[1].attrs["step"] == steps[0].attrs["step"] + 1
    for x in s.spans:
        up = by_id.get(x.parent)
        want = {"wlt.step": None, "wlt.predict": "wlt.step", "wlt.correct": "wlt.step",
                "wlt.solve": ("wlt.predict", "wlt.correct")}.get(x.name)
        if x.name == "wlt.read":
            want = ("wlt.solve",) if x.attrs["what"] == "norms" else ("wlt.step",)
        assert (up.name if up else None) in (want if isinstance(want, tuple) else (want,))
        assert up is None or up.start <= x.start <= x.end <= up.end
        top = x
        while top.parent is not None:
            top = by_id[top.parent]
        assert x.step == top.attrs["step"]
    assert [x.attrs["iters"] for x in s.named("wlt.solve")] == iters


def test_host_reads_are_one_plus_each_solves_entry_and_iterations(profiled):
    s, _, iters = profiled
    for st in s.named("wlt.step"):
        k = st.attrs["step"]
        reads = [x for x in s.named("wlt.read") if x.step == k]
        solves = [x.attrs["iters"] for x in s.named("wlt.solve") if x.step == k]
        assert len(solves) == 2
        assert len(reads) == 1 + sum(1 + n for n in solves)
        assert sum(x.attrs["what"] == "dt" for x in reads) == 1
    reads = len(s.named("wlt.read"))
    assert reads / 2 == 3 + sum(iters) / 2


def test_solve_spans_enclose_their_ops_on_the_profilers_clock(profiled):
    s, events, _ = profiled
    assert not [e for e in events if e[0].startswith("wlt.")]
    solves = [(x.start, x.end) for x in s.named("wlt.solve")]
    inner = [e for e in events if e[0] == "test.v_cycle"]
    outer = [e for e in events if e[0] == "test.conv_diff"]
    # one V-cycle an iteration, recursing once a level below the fine one
    assert len(inner) % sum(x.attrs["iters"] for x in s.named("wlt.solve")) == 0
    assert len(outer) == 4
    for _, a, b in inner:
        assert sum(lo <= a and b <= hi for lo, hi in solves) == 1
    for _, a, b in outer:
        assert not any(lo <= b and a <= hi for lo, hi in solves)
        assert any(x.start <= a and b <= x.end for x in s.named("wlt.step"))


def test_a_profiler_start_or_tracing_opens_a_session():
    assert not tracing.recording
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording
        with tracing.span("test.a"):
            pass
    first = tracing.session()
    assert [x.name for x in first.spans] == ["test.a"]
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test.b"):
            pass
    second = tracing.session()
    assert second is not first and [x.name for x in second.spans] == ["test.b"]
    with tracing.tracing():
        with tracing.span("test.c"):
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("test.d"):
                pass
        assert tracing.recording
    assert not tracing.recording
    third = tracing.session()
    assert third is not second and [x.name for x in third.spans] == ["test.c", "test.d"]
    assert first.opened_ns <= second.opened_ns <= third.opened_ns


def test_off_records_nothing_and_allocates_nothing():
    assert not tracing.recording
    before = tracing.session()
    n = None if before is None else len(before.spans)

    def site():
        for _ in range(100_000):
            with tracing.span("wlt.read", what="norms") as sp:
                sp.set(iters=1)
            tracing.count("cells.test", 1)
    site()                      # warm the interpreter's caches
    mine = [tracemalloc.Filter(True, tracing.__file__), tracemalloc.Filter(True, __file__)]
    tracemalloc.start()
    try:
        a = tracemalloc.take_snapshot().filter_traces(mine)
        site()
        b = tracemalloc.take_snapshot().filter_traces(mine)
    finally:
        tracemalloc.stop()
    # what the sites keep (this file's and the recorder's lines only: other
    # threads of the test process allocate elsewhere)
    assert sum(d.size_diff for d in b.compare_to(a, "filename")) < 1024
    assert tracing.session() is before
    assert n is None or len(before.spans) == n


def test_the_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 5)
    with tracing.tracing():
        for k in range(8):
            with tracing.span("test.capped", k=k):
                tracing.count("test.n", 2)
    s = tracing.session()
    assert [x.attrs["k"] for x in s.spans] == [0, 1, 2, 3, 4]
    assert s.dropped == 3 and s.counters == {"test.n": 16}


def test_self_seconds_leave_out_the_children():
    with tracing.tracing():
        with tracing.span("test.outer"):
            with tracing.span("test.inner"):
                pass
    s = tracing.session()
    (o,), (i,) = s.named("test.outer"), s.named("test.inner")
    total, own = s.seconds("test.outer")
    assert total == pytest.approx((o.end - o.start) / 1e9)
    assert own == pytest.approx((o.end - o.start - (i.end - i.start)) / 1e9)
    assert s.seconds("test.missing") == (0.0, 0.0)


def test_write_chrome_gives_one_x_event_a_span(tmp_path):
    with tracing.tracing():
        for k in range(3):
            with tracing.span("test.chrome", k=k):
                with tracing.span("test.leaf"):
                    pass
        tracing.count("cells.test", 7)
    path = tmp_path / "spans.json"
    assert tracing.write_chrome(path) == 6
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(doc["traceEvents"]) == 6
    assert [e["args"]["k"] for e in xs if e["name"] == "test.chrome"] == [0, 1, 2]
    assert all(e["dur"] >= 0 and e["ts"] > 1e15 for e in xs)   # µs since 1970
    assert doc["otherData"] == {"counters": {"cells.test": 7}, "dropped": 0}


def test_counters_from_many_threads_lose_nothing():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.tracing():
            def work():
                for _ in range(2000):
                    tracing.count("test.threads", 1)
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert tracing.session().counters == {"test.threads": 32_000}


def test_spans_on_shard_threads_keep_the_callers_step():
    """`DistSimulation`'s pool runs each job in a copy of the caller's
    context: a span opened there nests in the caller's span."""
    import contextvars
    with tracing.tracing():
        with tracing.span("wlt.step", step=7):
            ctx = contextvars.copy_context()
            t = threading.Thread(target=lambda: ctx.run(
                lambda: tracing.span("wlt.read", what="dt").__enter__().__exit__()))
            t.start()
            t.join(timeout=60)
    s = tracing.session()
    (step,), (read,) = s.named("wlt.step"), s.named("wlt.read")
    assert read.parent == step.id and read.step == 7 and read.thread != step.thread


@pytest.mark.parametrize("where", ["profiler", "tracing"])
def test_recording_ends_with_its_block_on_an_error(where):
    block = (profile(activities=[ProfilerActivity.CPU]) if where == "profiler"
             else tracing.tracing())
    with contextlib.suppress(RuntimeError):
        with block:
            with tracing.span("test.raises"):
                raise RuntimeError("inside")
    assert not tracing.recording
    (x,) = tracing.session().named("test.raises")
    assert x.end >= x.start
