"""Step: the host seconds of the two momentum phases less their pressure
solves (the self time of the program's spans ``wlt.predict`` and
``wlt.correct``) over the traced stretch's wall, in %."""
from portbench import spans


def read(rec):
    return spans.share(rec, ("wlt.predict", "wlt.correct"), own=True)
