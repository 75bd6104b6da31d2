"""Interior cells × steps completed in the window, over the window's wall
time (output calls included), in millions a second."""


def read(rec):
    return rec["cells"] * rec["steps"] / rec["window_s"] / 1e6
