"""The harness's own functions at 16³ on the CPU, down to the last line,
and the files it finds by name."""
import json
import os
import subprocess
import sys
import time

import pytest
from conftest import small_cell

from portbench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_entry_has_its_files():
    bench = harness.load_json(harness.BENCHMARK)
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert (harness.HERE / "configs" / f"{c['name']}.py").is_file()
        assert (harness.HERE / "configs" / f"{c['name']}_ref.py").is_file()
        builder = harness.load_module(harness.HERE / "configs" / f"{c['name']}.py")
        ref = harness.load_module(harness.HERE / "configs" / f"{c['name']}_ref.py")
        for fn in ("build", "advance", "output"):
            assert callable(getattr(builder, fn)), (c["name"], fn)
        for fn in ("case", "moments", "step", "initial_u", "velocity_scale", "output"):
            assert callable(getattr(ref, fn)), (c["name"], fn)
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench)
        assert set(cell.traffic["limits"]) <= {"start", "moments", "u", "p", "dt",
                                               "iters", "output"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)


@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace):
    cell = small_cell(workload)
    out = harness.run_cell(cell, 3_000_000_019, 0.2, trace, time.perf_counter(), "cpu")
    line = json.loads(json.dumps(out))
    want = KEYS + (["breakdown"] if trace else []) + ["run", "checks"]
    assert list(line) == want
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 4
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    assert "setup_s" in line["metrics"] or trace
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    cell = small_cell("sphere-256")
    a = harness.drive(cell, 77, 0.0, False, time.perf_counter(), "cpu")[1]
    b = harness.drive(cell, 77, 0.0, False, time.perf_counter(), "cpu")[1]
    c = harness.drive(cell, 78, 0.0, False, time.perf_counter(), "cpu")[1]
    assert a["start_rows"] == b["start_rows"]
    assert (a["start_u"] == b["start_u"]).all()
    assert [s["out0"] for s in a["samples"]] == [s["out0"] for s in b["samples"]]
    assert not (a["start_u"] == c["start_u"]).all()


def test_refuses_a_host_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                           "sphere-256", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
def test_kernels_hold_on_the_card(card, workload):
    """The run at 32³ on the card, through the port's kernels, is correct
    and reports every end-to-end metric of the cell."""
    cell = small_cell(workload, n=32, device=card)
    out = harness.run_cell(cell, 5_000_000_029, 0.5, False, time.perf_counter(), card)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) >= {"cell_updates_per_s", "peak_mem_gib", "setup_s"}
