"""Time the scan and histogram kernels of one checkout on the card.

    python3 shared_simd_scan_tpu_torch/bench/scan_times.py [ROOT]

Imports ``shared_simd_scan_tpu_torch`` from ROOT (default: the checkout
holding this file), builds its kernels, and times with CUDA events the
interval kernel (keys 0..7 on ``i % 8``), the runtime bit-sliced and static
AND-DAG kernels (S8 and S64 on ``i % 512``), the chunked and dynamic scans
(S64 and S256 as CUDA keys), the chunked histogram program (lo 100, k 40)
and the host-lo span tier (lo 0, k 512, as ``histogram_device`` sends a
9-bit column) at the reference benchmark's n = 477,218,588; and, on the
host clock, ``stats.describe``, ``quantiles`` and ``topk_values`` of the
``i % 512`` column together (three span histograms; the median of five).
Run it on two checkouts in turns (parent, change, change, parent) within
one call to compare them on one card.  Needs a CUDA card; prints the
card's name and power limit and one line of medians.
"""
from __future__ import annotations

import pathlib
import statistics
import subprocess
import sys
import time

N_BYTES = 512 * 1024 * 1024
S8 = [3, 70, 141, 200, 262, 333, 400, 511]


def time_ms(fn, batches: int = 7, calls: int = 10) -> float:
    """Median over ``batches`` of the CUDA-event time per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main(root: pathlib.Path) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from shared_simd_scan_tpu_torch import layout, stats
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack

    if not pathlib.Path(_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {_cuda.__file__}, not the checkout at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.monotonic()
    _cuda.lib()
    build = time.monotonic() - t0
    device = torch.device("cuda", 0)
    n = harness.values_for(N_BYTES, 9)
    tiles = unpack.pack_device_kernel(harness.synth_modk(n, 8, 9, device=device), 9).tiles
    atiles = unpack.pack_device_kernel(harness.synth_modk(n, 512, 9, device=device), 9).tiles
    s64 = sorted(np.random.default_rng(3).choice(512, 64, replace=False).tolist())
    s256 = sorted(np.random.default_rng(4).choice(512, 256, replace=False).tolist())
    host = {8: np.asarray(S8, np.uint32), 64: np.asarray(s64, np.uint32),
            256: np.asarray(s256, np.uint32)}
    cuda = {k: torch.from_numpy(v.view(np.int32).copy()).to(device) for k, v in host.items()}
    cases = {
        "interval k=8": lambda: scan.interval_scan_tiles(tiles, 0, 8, 9, n),
        "bitsliced S8": lambda: scan.shared_scan_bitsliced_tiles(atiles, cuda[8], 9, n),
        "bitsliced S64": lambda: scan.shared_scan_bitsliced_tiles(atiles, cuda[64], 9, n),
        "static S8": lambda: scan.shared_scan_bitsliced_static_tiles(atiles, host[8], 9, n),
        "static S64": lambda: scan.shared_scan_bitsliced_static_tiles(atiles, host[64], 9, n),
        "chunked S64": lambda: scan.shared_scan_chunked_tiles(atiles, cuda[64], 9, n),
        "chunked S256": lambda: scan.shared_scan_chunked_tiles(atiles, cuda[256], 9, n),
        "dynamic S64": lambda: scan.shared_scan_dynamic_tiles(atiles, cuda[64], 9, n),
        "dynamic S256": lambda: scan.shared_scan_dynamic_tiles(atiles, cuda[256], 9, n),
        "histogram_dag H2": lambda: scan._histogram_chunked_tiles(atiles, 100, 40, 9, n),
        "histogram span H1": lambda: scan.histogram_dag_tiles(atiles, 0, 512, 9, n),
    }
    times = {name: time_ms(fn) for name, fn in cases.items()}
    col = layout.DeviceColumn(9, n, atiles)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        stats.describe(col), stats.quantiles(col, [0.5, 0.9]), stats.topk_values(col, 5)
        walls.append((time.monotonic() - t1) * 1e3)
    print(f"{smi}; {root}: build {build:.1f} s; "
          + "; ".join(f"{name} {ms:.6f} ms" for name, ms in times.items())
          + f"; stats trio (host clock) {statistics.median(walls[1:]):.6f} ms", flush=True)


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1
         else pathlib.Path(__file__).resolve().parents[2])
