"""Binding: kernel launches of the traced stretch (the program's
`launch_counts()`), over its steps."""


def read(rec):
    t = rec.get("trace")
    total = sum(t["launches"].values()) if t else 0
    return total / t["steps"] if total and t["steps"] else None
