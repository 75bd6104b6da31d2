"""The plain reference against the port at 16³ on the CPU, and its
control, the reference in bfloat16 in the program's place, failing the
cell's limits there."""
import time

import pytest
from conftest import small_cell

from portbench import harness
from portbench.reference import compare


def readings(workload, dtype, seed, control=False):
    cell = small_cell(workload)
    cell.params = dict(cell.params, dtype=dtype)
    _, snap = harness.drive(cell, seed, 0.0, False, time.perf_counter(), "cpu")
    return cell, harness.judge(cell, snap, seed, "cpu", control)


@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
def test_reference_follows_the_port_in_float32(workload):
    cell, (prog, _) = readings(workload, "float32", 2_500_000_003)
    assert set(prog) == set(compare.NAMES)
    assert prog["iters"] == 0
    for k in ("u", "p", "start", "output"):
        assert prog[k] < 1e-5, (k, prog)


def test_reference_equals_the_port_in_float64():
    """The vortex has no body: the float64 port and the reference take the
    same operations in the same order."""
    _, (prog, _) = readings("tgv-256", "float64", 11)
    for k in ("start", "moments", "u", "p", "dt", "iters"):
        assert prog[k] == 0.0, (k, prog)
    assert prog["output"] < 1e-14


@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_control_fails(workload, seed):
    cell, (prog, ctl) = readings(workload, "float32", seed, control=True)
    limits = cell.traffic["limits"]
    assert all(prog[k] <= limits[k] for k in limits), prog
    over = [k for k in limits if not ctl[k] <= limits[k]]
    assert over, ctl
