"""Kernels: K12, the conv-diff RHS (`conv_diff_k`, here in its periodic
mode), its floor over its device time, in %.  A launch covers the whole
padded grid: u read, the RHS written, 24 B a cell (`chip_smoke.py`'s
count, commit aaf499b)."""
from portbench import trace

LAUNCH = "conv_diff_k"
SYMBOLS = [["conv_diff_tile_kernel", "StoreRhs"]]


def launch_bytes(rec):
    nx, ny, nz = rec["shape"]
    return 24 * nx * ny * nz


def read(rec):
    return trace.roofline(rec, LAUNCH, SYMBOLS, launch_bytes)
