"""Metrics: the host seconds of the output's body normals (the program's
spans ``wlt.nds_field``, two an output call of the force) over the traced
stretch's wall, in %; part of `output_share`."""
from portbench import spans


def read(rec):
    return spans.share(rec, ("wlt.nds_field",))
