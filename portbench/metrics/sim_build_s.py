"""Entry: host seconds of the `Simulation(...)` call (the body measure and
the multigrid levels)."""


def read(rec):
    return rec["sim_build_s"]
