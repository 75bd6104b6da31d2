"""Solver: the host seconds of the pressure solves (the program's spans
``wlt.solve``, their norm reads included) over the traced stretch's wall,
in %."""
from portbench import spans


def read(rec):
    return spans.share(rec, ("wlt.solve",))
