"""Device: 1 − (union of the device intervals) / (the traced stretch's
wall), in %."""


def read(rec):
    t = rec.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"]) if t and t["busy_s"] else None
