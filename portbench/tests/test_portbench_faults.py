"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at 16³ on the
CPU, once for each fault a cell of this benchmark can have (it runs on one
chip: there is no exchange between chips to leave out)."""
import time

import pytest
import torch
from conftest import small_cell

from portbench import harness


def unchanged(sim):
    """Every step returns the state it was given (time still advances)."""
    def step_once(remeasure=True, udf=None):
        sim.flow.dt.append(sim.flow.dt[-1])
        sim.flow.pois_n += [1, 1]
        return sim
    sim.step_once = step_once


def half_left_out(sim):
    """Every step updates the lower half of the x rows; the upper half
    keeps the state it had."""
    step = sim.step_once

    def step_once(remeasure=True, udf=None):
        u, p = sim.flow.state.u.clone(), sim.flow.state.p.clone()
        step(remeasure, udf)
        h = u.shape[1] // 2
        st = sim.flow.state
        st.u[:, h:] = u[:, h:]
        st.p[h:] = p[h:]
        return sim
    sim.step_once = step_once


def velocity_altered(sim):
    """Every step's result has one face velocity moved by 1 % of the
    largest."""
    step = sim.step_once

    def step_once(remeasure=True, udf=None):
        step(remeasure, udf)
        u = sim.flow.state.u
        c = u.shape[1] // 2
        u[0, c, c, c] += 0.01 * u.abs().max()
        return sim
    sim.step_once = step_once


def output_altered(cell):
    """The output the users read is off by 1 %."""
    mod = cell.builder()
    orig = mod.output

    def output(sim):
        return [v * 1.01 for v in orig(sim)]
    return mod, orig, output


@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
@pytest.mark.parametrize("fault", [unchanged, half_left_out, velocity_altered])
def test_broken_step_is_not_correct(workload, fault):
    cell = small_cell(workload)
    out = harness.run_cell(cell, 4_000_000_007, 0.0, False, time.perf_counter(), "cpu",
                           after_build=fault)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", ["sphere-256", "tgv-256"])
def test_altered_output_is_not_correct(workload):
    cell = small_cell(workload)
    mod, orig, altered = output_altered(cell)
    mod.output = altered
    try:
        out = harness.run_cell(cell, 4_000_000_009, 0.0, False, time.perf_counter(),
                               "cpu")
    finally:
        mod.output = orig
    assert out["correct"] is False
    assert out["checks"]["output"]["value"] > out["checks"]["output"]["limit"]
    assert torch.isfinite(torch.tensor(out["checks"]["u"]["value"]))
