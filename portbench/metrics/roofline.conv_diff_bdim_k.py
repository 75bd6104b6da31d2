"""Kernels: K1, the conv-diff with the far-field BDIM fused in
(`conv_diff_bdim_k`), its floor over its device time, in %.  A launch
covers the whole padded grid: u and u0 read and u_new written (36 B a
cell), and f written on the body's x slab, the rows ``band_x ± 1``
(12 B a cell there); `chip_smoke.py`'s count (commit aaf499b)."""
from portbench import trace

LAUNCH = "conv_diff_bdim_k"
SYMBOLS = [["conv_diff_tile_kernel", "BdimEpilogue"]]


def launch_bytes(rec):
    nx, ny, nz = rec["shape"]
    band = rec["trace"]["band_x"]
    rows = nx
    if band is not None and 1 <= band[0] - 1 < band[1] + 1 <= nx - 1:
        rows = band[1] - band[0] + 2
    return 36 * nx * ny * nz + 12 * rows * ny * nz


def read(rec):
    return trace.roofline(rec, LAUNCH, SYMBOLS, launch_bytes)
