#!/usr/bin/env python3
"""Streaming rate and launch cost of one NVIDIA GPU through this package's
own kernel binding.

    PYTHONPATH=. python3 tools/bandwidth_probe.py [N]

The counterpart of running `benchmarks/leanprobe.py` (cases ``copy``,
``bspec``, ``big``) and `benchmarks/bwprobe.py` of the JAX package: the copy
kernel of `waterlily_tpu_torch/ops/probe.py` (``out = a · 1.0000001``,
float32) at the solver's shapes, ``N`` = 256 by default:

* one (N+2)³ field at 256 and at 1024 threads per block;
* eight such fields concatenated (550 MB at N = 256, beyond the 50 MB L2),
  at both block sizes;
* six fields in one launch (the read and write set of a smoother);
* an 8×8×8 field launched 20 times back to back: µs per launch on the host
  clock (enqueue through ctypes, then one synchronise) and between two CUDA
  events around the chain (the device waits for the host where the host is
  the slower of the two).

Beside each, torch's own ``torch.mul(a, c, out=b)`` on the same tensors.
Every case is checked against the plain version first.  Prints the card's
name and power limit, one line per case and a JSON object of the rows; needs
a CUDA device and imports no JAX.

    PYTHONPATH=. python3 tools/bandwidth_probe.py --against ROOT [N]

runs every case with this checkout's package and with the package of the
checkout at ``ROOT`` (imported under another name, built into that
checkout's ``build/``), both in this process, in turns: ``ROUNDS`` rounds,
the order swapped every round.  Prints each case's median and every
round's figure for both packages and ``torch.mul``.
"""
from __future__ import annotations

import collections
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
TINY, CHAIN = (8, 8, 8), 20
ROUNDS = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, launches: int, runs: int = 5) -> float:
    """Median over ``runs`` of the mean time per call of ``launches``
    back-to-back calls between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def host_us(torch, fn, launches: int, runs: int = 5) -> float:
    """Median over ``runs`` of the host time per call, in µs, of ``launches``
    back-to-back calls followed by one synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / launches * 1e6)
    return statistics.median(times)


def copy_case(torch, probe, name: str, shape, nf: int, block: int, dev) -> dict:
    """One copy case: ``nf`` fields of ``shape``, ping-ponged between two
    sets of buffers so that every launch reads what the last one wrote."""
    gen = torch.Generator(device=dev).manual_seed(0)
    a = [torch.rand(shape, generator=gen, device=dev) for _ in range(nf)]
    b = [torch.empty_like(t) for t in a]
    got, want = probe.copy_scale_k(a, block), probe.copy_scale_plain(a)
    torch.cuda.synchronize()
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if err != 0.0:
        raise RuntimeError(f"bandwidth_probe {name}: kernel differs from "
                           f"a * {probe.SCALE} by {err}")
    del got, want

    def kern():
        probe.copy_scale_k(a, block, out=b)
        probe.copy_scale_k(b, block, out=a)

    def lib():
        for x, y in zip(a, b):
            torch.mul(x, probe.SCALE, out=y)
        for x, y in zip(a, b):
            torch.mul(y, probe.SCALE, out=x)

    ms, lib_ms = median_ms(torch, kern, 10) / 2, median_ms(torch, lib, 10) / 2
    nbytes = 8 * nf * a[0].numel()
    return dict(name=name, shape=list(shape), fields=nf, block=block, ms=ms,
                library_ms=lib_ms, bytes=nbytes, gb_per_s=nbytes / ms / 1e6,
                library_gb_per_s=nbytes / lib_ms / 1e6,
                share_of_hbm=nbytes / (ms * 1e-3) / HBM_BYTES_PER_S,
                max_abs_err=err)


def tiny_case(torch, probe, dev) -> dict:
    """The tiny kernel launched `CHAIN` times back to back."""
    a = [torch.ones(TINY, device=dev)]
    b = [torch.empty_like(a[0])]

    def kern():
        for _ in range(CHAIN // 2):
            probe.copy_scale_k(a, 256, out=b)
            probe.copy_scale_k(b, 256, out=a)

    def lib():
        for _ in range(CHAIN // 2):
            torch.mul(a[0], probe.SCALE, out=b[0])
            torch.mul(b[0], probe.SCALE, out=a[0])

    return dict(name=f"tiny chained x{CHAIN}", shape=list(TINY), fields=1, block=256,
                host_us_per_launch=host_us(torch, kern, 20) / CHAIN,
                device_us_per_launch=median_ms(torch, kern, 20) / CHAIN * 1e3,
                library_host_us_per_launch=host_us(torch, lib, 20) / CHAIN,
                library_device_us_per_launch=median_ms(torch, lib, 20) / CHAIN * 1e3)


def load_checkout(root: str):
    """The package ``waterlily_tpu_torch`` of the checkout at ``root``,
    imported as ``waterlily_tpu_torch_against`` beside this checkout's."""
    pkg = Path(root).resolve() / "waterlily_tpu_torch"
    name = "waterlily_tpu_torch_against"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def run(n: int = 256, device="cuda", probe=None) -> list[dict]:
    """Run every case with ``probe`` (this checkout's `ops.probe` by
    default); returns one dict per case (times in ms or µs, rates in GB/s,
    measured on ``device``)."""
    import torch

    if probe is None:
        from waterlily_tpu_torch.ops import probe

    if not torch.cuda.is_available():
        raise RuntimeError("bandwidth_probe: needs a CUDA device")
    dev = torch.device(device)
    fine = (n + 2,) * 3
    rows = []
    for block in (256, 1024):
        rows.append(copy_case(torch, probe, f"1 field, block {block}", fine, 1,
                              block, dev))
    for block in (256, 1024):
        rows.append(copy_case(torch, probe, f"8 fields in one, block {block}",
                              (8 * fine[0],) + fine[1:], 1, block, dev))
        torch.cuda.empty_cache()
    rows.append(copy_case(torch, probe, "6 fields, block 256", fine, 6, 256, dev))
    rows.append(tiny_case(torch, probe, dev))
    return rows


def report(rows: list[dict]) -> None:
    for r in rows:
        if "ms" in r:
            print(f"probe {r['name']:32s} {str(tuple(r['shape'])):18s} kernel "
                  f"{r['ms']:.4f} ms {r['gb_per_s']:7.1f} GB/s "
                  f"({100 * r['share_of_hbm']:.1f} % of 3.35 TB/s); torch.mul "
                  f"{r['library_ms']:.4f} ms {r['library_gb_per_s']:7.1f} GB/s",
                  flush=True)
        else:
            print(f"probe {r['name']:32s} {str(tuple(r['shape'])):18s} kernel "
                  f"{r['host_us_per_launch']:.2f} us/launch on the host, "
                  f"{r['device_us_per_launch']:.2f} between CUDA events; torch.mul "
                  f"{r['library_host_us_per_launch']:.2f} and "
                  f"{r['library_device_us_per_launch']:.2f}", flush=True)


def against(n: int, probes: dict) -> dict:
    """Every case of `run` with each package's `ops.probe` of ``probes``
    (label -> module), in turns, ``ROUNDS`` rounds; returns label -> case
    name -> its row of every round."""
    res = {label: collections.defaultdict(list) for label in probes}
    labels = list(probes)
    for i in range(ROUNDS):
        for label in labels if i % 2 == 0 else labels[::-1]:
            for r in run(n, probe=probes[label]):
                res[label][r["name"]].append(r)
    return res


def report_against(res: dict) -> None:
    def fig(rows, key):
        v = [r[key] for r in rows]
        return f"{statistics.median(v):.5f} [" + " ".join(f"{t:.5f}" for t in v) + "]"

    for name, rows in next(iter(res.values())).items():
        keys = (("ms", "library_ms") if "ms" in rows[0] else
                ("host_us_per_launch", "library_host_us_per_launch"))
        print(f"against {name}: {keys[0]} " + "; ".join(
            f"{label} {fig(res[label][name], keys[0])}" for label in res)
            + "; torch.mul " + "; ".join(
            f"{label}'s round {fig(res[label][name], keys[1])}" for label in res),
            flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bandwidth_probe: needs a CUDA device", file=sys.stderr)
        return 2
    other = None
    if argv[:1] == ["--against"]:
        other, argv = argv[1], argv[2:]
    n = int(argv[0]) if argv else 256
    print(card_line(), flush=True)
    if other is not None:
        from waterlily_tpu_torch.ops import probe
        report_against(against(n, {"this": probe, "other": load_checkout(other).probe}))
        return 0
    rows = run(n)
    report(rows)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "probes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
