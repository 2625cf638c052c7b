#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It builds the kernels of ``shared_simd_scan_tpu_torch``
from the sources in the checkout and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. runs the shift canary and prints what PTX ``shl.b32`` and C++ ``<<`` do
   with amounts >= 32;
3. holds every kernel bit-exact against its plain torch version on the card
   at small ragged sizes (widths 1-31, padding, out-of-domain keys, k up
   to 1024);
4. drives the main path at full size — a 9-bit column of 512 MiB packed:
   ``pack_device_kernel`` -> ``shared_scan_device`` keys 0..7 (interval
   kernel) -> ``scan_device(3)`` (compare kernel) -> ``unpack_device`` —
   with every launch counter set to 0 just before and read just after, and
   checks the counts against their closed form, every bitvector word
   against the plain version, a 2M-value prefix against the oracle, and
   the unpacked values against the input;
5. times each kernel and its plain version at the main path's shapes with
   CUDA events, beside a ``copy_`` of the packed column;
6. prints a JSON line with one entry per kernel, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check or error exits non-zero and prints no result; so does a
machine with no CUDA card, and a directory without the package.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

WIDTH = 9
K = 8
DATA_SIZE = 512 * 1024 * 1024  # packed payload bytes of the main path's column
SCAN_KEY = 3
SMALL_WIDTHS = (1, 2, 9, 16, 17, 31)
SMALL_NS = (100, 33 * 128 + 17, 32 * 1024)
SEED = 0

KERNELS = {  # name -> (source, TPU kernel it replaces)
    "unpack": ("shared_simd_scan_tpu_torch/csrc/unpack.cu",
               "shared_simd_scan_tpu/ops/unpack.py:79"),
    "pack": ("shared_simd_scan_tpu_torch/csrc/unpack.cu",
             "shared_simd_scan_tpu/ops/unpack.py:139"),
    "shared_scan": ("shared_simd_scan_tpu_torch/csrc/shared_scan.cu",
                    "shared_simd_scan_tpu/ops/scan.py:70"),
    "interval_scan": ("shared_simd_scan_tpu_torch/csrc/interval_scan.cu",
                      "shared_simd_scan_tpu/ops/scan.py:1266"),
    "shift_canary": ("shared_simd_scan_tpu_torch/csrc/interval_scan.cu",
                     "shared_simd_scan_tpu/ops/scan.py:1336"),
}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def max_abs_err(a, b) -> int:
    """Largest |a - b| over uint32 words held in int32 tensors (0 = bit-exact)."""
    from shared_simd_scan_tpu_torch.layout import u32

    if a.shape != b.shape:
        raise CheckFailed(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((u32(a) - u32(b)).abs().max())


def time_ms(fn, batches: int, calls: int) -> float:
    """Median over ``batches`` of the CUDA-event time of ``calls`` back-to-back
    calls, per call (after one warm-up call)."""
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


def build_phase() -> float:
    from shared_simd_scan_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    _cuda.lib()
    seconds = time.monotonic() - t0
    print(f"build: {seconds:.1f} s ({_cuda.library_path().name})")
    log_path = _cuda.BUILD_DIR / "ptxas.log"
    log_path.write_text(_cuda.build_log)
    # registers and spills of the width-9 kernels (the main path's width)
    entry = None
    for line in _cuda.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("ILi9E" in entry or "canary" in entry) and (
            "Used" in line or "spill" in line
        ):
            print(f"  ptxas {entry}: {line.split(':', 1)[-1].strip()}")
    return seconds


def canary_phase(device, errs: dict) -> bool:
    import torch
    from shared_simd_scan_tpu_torch.ops import scan

    base, amounts = scan.canary_inputs(device)
    out_ptx, out_cxx = scan.run_shift_canary(base, amounts)
    plain = scan.shift_canary_plain(base, amounts)
    torch.cuda.synchronize()
    errs["shift_canary"] = max(errs["shift_canary"], max_abs_err(out_ptx, plain))
    ptx_ok = bool((out_ptx == 0).all())
    cxx_ok = bool((out_cxx == 0).all())
    nonzero = sorted({int(a) & 0xFFFFFFFF for a, o in zip(amounts.flatten().tolist(),
                                                          out_cxx.flatten().tolist()) if o})
    print(f"shift canary: PTX shl.b32 saturates to 0 for all amounts >= 32: {ptx_ok}")
    print(f"shift canary: C++ << gives 0 for all amounts >= 32: {cxx_ok}"
          + ("" if cxx_ok else f" (nonzero for amounts {nonzero})"))
    check(errs["shift_canary"] == 0, "shift canary (PTX form) equals its plain version")
    return ptx_ok


def small_phase(device, errs: dict) -> None:
    """Every kernel against its plain version at small ragged sizes."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES, padded_blocks
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    rng = np.random.default_rng(SEED)
    for width in SMALL_WIDTHS:
        dom = 1 << width
        for n in SMALL_NS:
            b1 = padded_blocks(n) // LANES
            # pack: full 32-bit inputs, so the kernel's own masking is checked
            raw = rng.integers(0, 1 << 32, size=(32, b1, LANES), dtype=np.uint64)
            raw = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(device)
            e = max_abs_err(unpack.pack_tiles(raw, width), unpack.pack_tiles_plain(raw, width))
            errs["pack"] = max(errs["pack"], e)
            # unpack: a real column (zero padding past n)
            vals = torch.from_numpy(rng.integers(0, dom, size=n).astype(np.int32)).to(device)
            dev = unpack.pack_device_kernel(vals, width)
            got = unpack.unpack_tiles(dev.tiles, width)
            e = max_abs_err(got, unpack.unpack_tiles_plain(dev.tiles, width))
            errs["unpack"] = max(errs["unpack"], e)
            check(bool((unpack.values_to_flat(got, n) == vals).all()),
                  f"w={width} n={n}: unpack(pack(values)) == values")
            key_sets = [[0], [dom], [1 << 31, 0xFFFFFFFF],
                        sorted(set(rng.integers(0, dom, size=3).tolist()))]
            for keys in key_sets:
                kt = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)).to(device)
                a = scan.shared_scan_tiles(dev.tiles, kt, width, n)
                p = scan.shared_scan_tiles_plain(dev.tiles, kt, width, n)
                errs["shared_scan"] = max(errs["shared_scan"], max_abs_err(a[0], p[0]),
                                          int((a[1] - p[1]).abs().max()))
            for lo, k in [(0, 8), (max(dom - 4, 0), 8), (0, 20), (0, 33), (0, 100), (0, 1024)]:
                a = scan.interval_scan_tiles(dev.tiles, lo, k, width, n)
                p = scan.interval_scan_tiles_plain(dev.tiles, lo, k, width, n)
                errs["interval_scan"] = max(errs["interval_scan"], max_abs_err(a[0], p[0]),
                                            int((a[1] - p[1]).abs().max()))
    torch.cuda.synchronize()
    for name in ("pack", "unpack", "shared_scan", "interval_scan"):
        check(errs[name] == 0, f"{name} kernel bit-exact against its plain version "
              f"(widths {SMALL_WIDTHS}, n {SMALL_NS})")


def main_path_phase(device) -> tuple[int, object, dict]:
    """The main path at full size, with launch counts taken around it."""
    import torch
    from shared_simd_scan_tpu_torch import layout, pack_device_kernel, scan_device
    from shared_simd_scan_tpu_torch import shared_scan_device, unpack_device
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    wrappers = {
        "unpack": unpack.unpack_tiles, "pack": unpack.pack_tiles,
        "shared_scan": scan.shared_scan_tiles, "interval_scan": scan.interval_scan_tiles,
        "shift_canary": scan.run_shift_canary,
    }
    n = harness.values_for(DATA_SIZE, WIDTH)
    vals = harness.synth_modk(n, K, WIDTH, device=device)
    torch.cuda.synchronize()
    print(f"main path: width {WIDTH}, n {n}, {layout.packed_nbytes(WIDTH, n)} packed bytes")

    # a fresh process meets the canary on its first interval scan: so does this run
    scan._SHIFT_SEMANTICS.clear()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.monotonic()
    dev = pack_device_kernel(vals, WIDTH)
    bits8, counts8 = shared_scan_device(dev, list(range(K)))
    bits1, count1 = scan_device(dev, SCAN_KEY)
    back = unpack_device(dev)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"main path ran in {seconds:.3f} s (host clock, first calls); launches {launches}")
    print(f"tiles {tuple(dev.tiles.shape)}, interval gateless: {scan.shift_saturates(device)}")

    for name, c in launches.items():
        check(c > 0, f"main path launched the {name} kernel ({c}x)")
    expect = [(n - 1 - j) // K + 1 for j in range(K)]
    check(counts8.tolist() == expect, f"k=8 interval counts == closed form {expect}")
    check(int(count1) == expect[SCAN_KEY], f"k=1 compare count == {expect[SCAN_KEY]}")
    for keys, bits in ((list(range(K)), bits8), ([SCAN_KEY], bits1.reshape(1, -1))):
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        pbits, _ = scan.shared_scan_tiles_plain(dev.tiles, kt, WIDTH, n)
        check(bool((bits == scan.bits_to_canonical(pbits, n)).all()),
              f"keys {keys}: every main-path bitvector word equals the plain compare version's")
    del pbits
    check(harness.check_shared_scan(dev, list(range(K)), vals),
          "k=8: counts vs direct compare, all words vs plain compare, 2M prefix vs oracle")
    check(harness.check_shared_scan(dev, [SCAN_KEY], vals),
          "k=1: counts vs direct compare, all words vs plain compare, 2M prefix vs oracle")
    check(bool((back == vals).all()), "unpack_device gives back every value")
    return n, dev, launches


def timing_phase(device, n: int, dev, errs: dict) -> dict:
    """Each kernel and its plain version at the main path's shapes."""
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    tiles = dev.tiles
    nblocks = tiles.shape[1] * LANES
    tile_bytes = tiles.numel() * 4
    vals_layout = unpack.unpack_tiles(tiles, WIDTH)
    key1 = torch.tensor([SCAN_KEY], dtype=torch.int32, device=device)
    base, amounts = scan.canary_inputs(device)

    # full-size agreement of each kernel with its plain version
    pairs = {
        "unpack": (lambda: unpack.unpack_tiles(tiles, WIDTH),
                   lambda: unpack.unpack_tiles_plain(tiles, WIDTH)),
        "pack": (lambda: unpack.pack_tiles(vals_layout, WIDTH),
                 lambda: unpack.pack_tiles_plain(vals_layout, WIDTH)),
        "interval_scan": (lambda: scan.interval_scan_tiles(tiles, 0, K, WIDTH, n),
                          lambda: scan.interval_scan_tiles_plain(tiles, 0, K, WIDTH, n)),
        "shared_scan": (lambda: scan.shared_scan_tiles(tiles, key1, WIDTH, n),
                        lambda: scan.shared_scan_tiles_plain(tiles, key1, WIDTH, n)),
        "shift_canary": (lambda: scan.run_shift_canary(base, amounts)[0],
                         lambda: scan.shift_canary_plain(base, amounts)),
    }
    for name, (kern, plain) in pairs.items():
        a, p = kern(), plain()
        if isinstance(a, tuple):
            e = max(max_abs_err(a[0], p[0]), int((a[1] - p[1]).abs().max()))
        else:
            e = max_abs_err(a, p)
        errs[name] = max(errs[name], e)
        del a, p
        check(errs[name] == 0, f"{name} kernel bit-exact against its plain version at full size")

    traffic = {  # device-memory bytes each call must move (read + write)
        "unpack": tile_bytes + 32 * nblocks * 4,
        "pack": 32 * nblocks * 4 + tile_bytes,
        "interval_scan": tile_bytes + K * nblocks * 4,
        "shared_scan": tile_bytes + nblocks * 4,
        "shift_canary": 3 * base.numel() * 4,
    }
    results = {}
    copy_dst = torch.empty_like(tiles)
    copy_ms = time_ms(lambda: copy_dst.copy_(tiles), batches=5, calls=10)
    copy_rate = 2 * tile_bytes / (copy_ms * 1e-3)
    print(f"copy_ of the packed column ({tile_bytes} bytes): {copy_ms:.6f} ms, "
          f"{copy_rate:.6e} bytes/s")
    for name, (kern, plain) in pairs.items():
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2)
        rate = traffic[name] / (ms * 1e-3)
        plain_rate = traffic[name] / (plain_ms * 1e-3)
        results[name] = (ms, plain_ms)
        print(f"time {name}: kernel {ms:.6f} ms ({rate:.6e} bytes/s, {rate / copy_rate:.4f} of copy)"
              f"; plain {plain_ms:.6f} ms ({plain_rate:.6e} bytes/s)")
    return results


def main() -> int:
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "shared_simd_scan_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: shared_simd_scan_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    import shared_simd_scan_tpu_torch  # noqa: F401

    if "jax" in sys.modules:
        raise CheckFailed("the port imported jax")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    errs = {name: 0 for name in KERNELS}
    build_phase()
    canary_phase(device, errs)
    small_phase(device, errs)
    n, dev, launches = main_path_phase(device)
    times = timing_phase(device, n, dev, errs)
    check("jax" not in sys.modules, "no jax module was imported")

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
