"""Solver: pressure iterations of the traced stretch's projections (two a
step, `Simulation.pois_n`), over its steps."""


def read(rec):
    t = rec.get("trace")
    return sum(t["pois_n"]) / t["steps"] if t and t["steps"] else None
