"""Metrics: the output calls' host seconds (ending in their host read)
over the traced stretch's wall, in %."""


def read(rec):
    t = rec.get("trace")
    return 100.0 * t["output_s"] / t["wall_s"] if t else None
