"""Step: device operations (kernels, copies, memsets) in the traced
stretch, over its steps."""


def read(rec):
    t = rec.get("trace")
    return t["ops"] / t["steps"] if t and t["ops"] and t["steps"] else None
