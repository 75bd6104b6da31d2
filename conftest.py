"""Root pytest configuration: the order in which `--dist loadfile` hands
test files to the xdist workers.

xdist's file scheduler hands files out most-tests-first
(`xdist/scheduler/loadscope.py`), so a slow file with few tests (the JAX
package's `tests/test_diff.py`: 5 tests, the longest file) starts late and
ends the run.  Here the files go out longest first, by the seconds each took
in a whole run of the suite (`SECONDS`: the files of 100 s or more, as
`tools/t1_schedule.py` prints them); a file missing from the table counts
`DEFAULT_SECONDS`, and such files go out in xdist's order.  Nothing is
skipped, deselected or changed: only the order.  Without xdist, or with
another `--dist` mode, this file does nothing; `--noconftest` (the CUDA
tests on the card) leaves it out.
"""
from collections import OrderedDict

import pytest

# seconds of the files that take 100 s or more, in one whole run of the
# suite (6 workers, 8-core host; `test_torch_dist2.py` on one core)
SECONDS = {
    "test_flat.py": 649, "test_dist.py": 574, "test_torch_mp.py": 489,
    "test_torch_incr_gs_cascade.py": 456, "test_diff.py": 415,
    "test_simulation.py": 389, "test_torch_simulation.py": 274,
    "test_torch_flowflat.py": 268, "test_torch_forcing.py": 243,
    "test_pallas_kernels.py": 221, "test_flow.py": 219, "test_io.py": 179,
    "test_torch_moving_parity.py": 124, "test_torch_moving_flow.py": 119,
    "test_torch_moving.py": 116, "test_torch_diff_body.py": 109,
    "test_torch_dist2.py": 107,
}
DEFAULT_SECONDS = 60


def seconds(scope: str) -> float:
    """The table's seconds of a file scope (``tests/test_x.py``)."""
    return SECONDS.get(scope.rsplit("/", 1)[-1], DEFAULT_SECONDS)


class LongestFirst(OrderedDict):
    """A work queue whose ``popitem(last=False)`` (the only way xdist's
    scheduler takes work from it) yields the longest file left; files of
    equal weight go in the order xdist queued them."""

    def popitem(self, last=True):
        if last or not self:
            return super().popitem(last)
        scope = max(self, key=seconds)     # max keeps the first of equals
        return scope, self.pop(scope)


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    sched = LoadFileScheduling(config, log)
    sched.workqueue = LongestFirst()
    return sched
