"""Shared set-up of the benchmark's own tests: a cell of the benchmark cut
to 16³ on the CPU (the port's plain path on its flat engine, the engine
`engine="auto"` takes on the card), and the card fixture of the tests
marked ``cuda``."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402

SMALL = dict(n=16, check_intervals=[2, 4], trace_from=1, trace_intervals=1)


def small_cell(workload: str, n: int = 16, device: str = "cpu") -> harness.Cell:
    """The cell's files with its grid cut to ``n``³, checked on the second
    and third of its intervals; on the CPU on the flat engine."""
    bench = harness.load_json(harness.BENCHMARK)
    entry = harness.cell_entry(workload, bench)
    traffic = harness.load_json(harness.HERE / "workloads" / f"{entry['traffic']}.json")
    traffic.update(SMALL, n=n)
    cell = harness.Cell(workload, bench, traffic=traffic)
    if device == "cpu":
        cell.params = dict(cell.params, engine="flat")
    return cell


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
