"""Solver: the host seconds blocked in the program's device→host reads (the
spans ``wlt.read``: the solvers' norm reads and the step's Δt read, each
waiting for the queue to drain) over the traced stretch's wall, in %."""
from portbench import spans


def read(rec):
    return spans.share(rec, ("wlt.read",))
