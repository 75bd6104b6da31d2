"""The per-layer metrics that read the program's own spans and counters
(`portbench/spans.py`), from traced 16³ runs of each cell on the CPU and a
32³ run of each on the card."""
import time
from collections import Counter

import pytest
from conftest import small_cell

from portbench import harness

SPANS = {"step_self_share", "solve_share", "read_wait_share",
         "host_reads_per_step", "nds_share"}
ROOFLINES = {"roofline.incr_gs_k", "roofline.gauss_sweeps_k"}
NEW = SPANS | ROOFLINES


def listed(cell) -> set[str]:
    return {m["name"] for m in cell.per_layer} & NEW


def reads_by_what() -> tuple[dict[str, int], int]:
    """The program's device→host reads in the newest session (the traced
    stretch) by their ``what``, and the session's steps."""
    from waterlily_tpu_torch import tracing
    s = tracing.session()
    by = Counter(r.attrs.get("what") for r in s.named("wlt.read"))
    return dict(by), len(s.named("wlt.step"))


def check(line: dict, cell, want: set[str]) -> None:
    got = line["metrics"]
    assert line["correct"] is True, line["checks"]
    assert set(got) & NEW == want
    # a step reads its Δt and, in each of its two solves, the residual's
    # norms once before the first iteration and once after every one; each
    # output call on a sphere reads the shell of its two normals' fields
    by, steps = reads_by_what()
    assert set(by) <= {"norms", "dt", "nds"}, by
    per_step = (by.get("norms", 0) + by.get("dt", 0)) / steps
    assert per_step == pytest.approx(3 + got["pois_iters_per_step"]["value"], rel=1e-12)
    outputs = cell.traffic["trace_intervals"]
    assert by.get("nds", 0) == (2 * outputs if cell.name.startswith("sphere") else 0), by
    assert got["host_reads_per_step"]["value"] == pytest.approx(sum(by.values()) / steps,
                                                                rel=1e-12)
    for name in ("step_self_share", "solve_share", "read_wait_share", "nds_share"):
        if name in got:
            assert 0 < got[name]["value"] < 100, name
    if "nds_share" in got:
        assert got["nds_share"]["value"] <= got["output_share"]["value"]


@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256", "sphere-512"])
def test_a_traced_run_reports_the_span_metrics_its_cell_lists(workload):
    cell = small_cell(workload)
    line = harness.run_cell(cell, 4_000_000_007, 0.2, True, time.perf_counter(), "cpu")
    # no kernel runs on the CPU, so neither roofline has a device time
    check(line, cell, listed(cell) - ROOFLINES)
    assert ("nds_share" in listed(cell)) == workload.startswith("sphere")


def test_an_untraced_run_reports_none_of_them():
    cell = small_cell("sphere-256")
    line = harness.run_cell(cell, 4_000_000_009, 0.2, False, time.perf_counter(), "cpu")
    assert not set(line["metrics"]) & NEW
    assert "setup_s" in line["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
def test_a_traced_run_on_the_card_reports_every_metric_its_cell_lists(card, workload):
    cell = small_cell(workload, n=32, device=card)
    line = harness.run_cell(cell, 4_000_000_011, 0.5, True, time.perf_counter(), card)
    check(line, cell, listed(cell))
    for name in listed(cell) & ROOFLINES:
        assert 0 < line["metrics"][name]["value"] <= 100, name
