"""Step: the program's device→host reads (spans ``wlt.read``) over the
traced stretch's steps: 1 + Σ(1 + iterations) over a step's two solves on
a static body, so 3 + `pois_iters_per_step`."""
from portbench import spans


def read(rec):
    return spans.per_step(rec, "wlt.read")
