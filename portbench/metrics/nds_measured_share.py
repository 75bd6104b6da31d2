"""Metrics: the share of the interior cells at which the output's body
normals were measured (the program's counters ``nds.measured`` over
``nds.points``, summed over the traced stretch's `nds_field` calls), in %.
None where the program counts neither (a program that measures every
cell and says nothing of it)."""
from portbench import spans


def read(rec):
    s = spans.session(rec)
    points = 0 if s is None else s.counters.get("nds.points", 0)
    if not points:
        return None
    return 100.0 * s.counters.get("nds.measured", 0) / points
