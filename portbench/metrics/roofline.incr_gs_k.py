"""Kernels: K7, the fine red-black smooth with the deferred increment and
the norms fused in (`incr_gs_k` with colours, on its tiled cascade), its
floor over its device time, in %.  The program counts each call's padded
cells (``cells.incr_gs_k.cascade``, every level); a cell needs 40 B
(`chip_smoke.py`'s count).  The float32 instantiation's symbol only: the
bf16 one ends in ``true>(``."""
from portbench import spans

SYMBOLS = [["incr_gs_tile_kernel", "false>("]]


def read(rec):
    return spans.roofline(rec, "incr_gs_k.cascade", SYMBOLS, 40)
