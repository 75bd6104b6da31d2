"""Step: the program's device→host reads (spans ``wlt.read``) over the
traced stretch's steps.  A step on a static body reads its Δt and, in each
of its two solves, the residual's norms 1 + iterations times: 3 +
`pois_iters_per_step`.  Each output call that measures the force reads the
shell of its two normals' fields (``what="nds"``), so the sphere cells read
2 more an output interval; a step that re-measures a body reads its band
once a round (``what="band"``)."""
from portbench import spans


def read(rec):
    return spans.per_step(rec, "wlt.read")
