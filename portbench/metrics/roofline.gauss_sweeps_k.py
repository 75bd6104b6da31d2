"""Kernels: K13, the periodic red-black colour sweeps (`gauss_sweeps_k` on
its tiled cascade), its floor over its device time, in %.  The program
counts each call's padded cells (``cells.gauss_sweeps_k.cascade``); a
cell needs 28 B (`chip_smoke.py`'s count)."""
from portbench import spans

SYMBOLS = [["gauss_sweeps_tile_kernel"]]


def read(rec):
    return spans.roofline(rec, "gauss_sweeps_k.cascade", SYMBOLS, 28)
