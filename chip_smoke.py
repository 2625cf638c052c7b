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
   at small ragged sizes (widths 1-31, padding, spread, clustered,
   duplicate and out-of-domain keys, k up to 1024);
4. drives the main path at full size — a 9-bit column of 512 MiB packed:
   ``pack_device_kernel`` -> ``shared_scan_device`` keys 0..7 (interval
   kernel) -> ``scan_device(3)`` (compare kernel) -> ``unpack_device`` —
   with every launch counter set to 0 just before and read just after, and
   checks the counts against their closed form, every bitvector word
   against the plain version, a 2M-value prefix against the oracle, and
   the unpacked values against the input;
5. drives the arbitrary-key path at full size — a second 9-bit column of
   512 MiB packed with values ``i % 512``: ``shared_scan_device`` on spread
   sets (static AND-DAG kernel), clustered sets (windowed kernel) and the
   spread sets as CUDA tensors (runtime bit-sliced kernel), then
   ``windowed_scan_tiles`` on 64 keys (its chunked plan) — with the launch
   counters set to 0 just before and read just after, and checks that each
   tier ``pick_concrete_tier`` names is the kernel that ran, the counts
   against their closed form, and ``check_shared_scan`` for every set;
6. times each kernel and its plain version at the full-size shapes with
   CUDA events, beside a ``copy_`` of the packed column, and computes each
   kernel's bound: its bytes over the card's 3.35 TB/s;
7. prints a JSON line with one entry per kernel, and as its last line
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory at its 700 W limit (data sheet)
# the arbitrary-key phase: values i % 512, and its key sets
DOMAIN = 512
S8 = [3, 70, 141, 200, 262, 333, 400, 511]
W4 = [0, 2, 4, 6]
W8 = [7, 6, 5, 4, 3, 2, 1, 0]

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
    "bitsliced_scan": ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu",
                       "shared_simd_scan_tpu/ops/scan.py:2357"),
    "bitsliced_static_scan": ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu",
                              "shared_simd_scan_tpu/ops/scan.py:2715"),
    "windowed_scan": ("shared_simd_scan_tpu_torch/csrc/windowed.cu",
                      "shared_simd_scan_tpu/ops/scan.py:2980; "
                      "shared_simd_scan_tpu/ops/scan.py:2997"),
}
# the kernels of the arbitrary-key path, and the tier each one serves
ARBITRARY = {"bitsliced_static_scan": "bitsliced_static", "windowed_scan": "windowed",
             "bitsliced_scan": None}


def s64() -> list[int]:
    import numpy as np

    return sorted(np.random.default_rng(3).choice(DOMAIN, 64, replace=False).tolist())


def wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches."""
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    return {
        "unpack": unpack.unpack_tiles, "pack": unpack.pack_tiles,
        "shared_scan": scan.shared_scan_tiles, "interval_scan": scan.interval_scan_tiles,
        "shift_canary": scan.run_shift_canary,
        "bitsliced_scan": scan.shared_scan_bitsliced_tiles,
        "bitsliced_static_scan": scan.shared_scan_bitsliced_static_tiles,
        "windowed_scan": scan.windowed_scan_tiles,
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
        elif entry and ("ILi9E" in entry or "ILi31E" in entry or "canary" in entry) and (
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


def small_key_sets(width: int, rng) -> list[list[int]]:
    """Arbitrary key sets for one width: k = 1, 5, 33, 64 and 300, spread,
    clustered, duplicate and out-of-domain keys (2^w, 2^31, 0xFFFFFFFF)."""
    dom = 1 << width

    def draw(k, hi):
        return rng.integers(0, hi, size=k).tolist()

    return [
        draw(1, dom),
        draw(5, dom),                                                 # spread
        [v % dom for v in (0, 2, 4, 6)], [v % dom for v in W8],         # clustered
        [v % dom for v in (5, 5, 9, 0)] + [dom, 1 << 31, 0xFFFFFFFF],  # duplicate, out of domain
        draw(33, dom),
        draw(64, min(dom, 96)),                                       # clustered, duplicates
        draw(300, 2 * dom),                                           # half out of domain
    ]


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
            for keys in small_key_sets(width, rng):
                kt = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)).to(device)
                bo = (n % 3) * 2  # a shard whose tail lies further on, for some n
                for name, kern, plain in (
                    ("bitsliced_scan", lambda: scan.shared_scan_bitsliced_tiles(
                        dev.tiles, kt, width, n, bo),
                     lambda: scan.shared_scan_bitsliced_tiles_plain(dev.tiles, kt, width, n, bo)),
                    ("bitsliced_static_scan", lambda: scan.shared_scan_bitsliced_static_tiles(
                        dev.tiles, keys, width, n, bo),
                     lambda: scan.shared_scan_bitsliced_static_tiles_plain(
                         dev.tiles, keys, width, n, bo)),
                    ("windowed_scan", lambda: scan.windowed_scan_tiles(
                        dev.tiles, keys, width, n, bo),
                     lambda: scan.windowed_scan_tiles_plain(dev.tiles, keys, width, n, bo)),
                ):
                    a, p = kern(), plain()
                    errs[name] = max(errs[name], max_abs_err(a[0], p[0]),
                                     int((a[1] - p[1]).abs().max()))
    torch.cuda.synchronize()
    for name in ("pack", "unpack", "shared_scan", "interval_scan", *ARBITRARY):
        check(errs[name] == 0, f"{name} kernel bit-exact against its plain version "
              f"(widths {SMALL_WIDTHS}, n {SMALL_NS})")


def main_path_phase(device) -> tuple[int, object, dict]:
    """The main path at full size, with launch counts taken around it."""
    import torch
    from shared_simd_scan_tpu_torch import layout, pack_device_kernel, scan_device
    from shared_simd_scan_tpu_torch import shared_scan_device, unpack_device
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import scan

    path = {name: fn for name, fn in wrappers().items() if name not in ARBITRARY}
    n = harness.values_for(DATA_SIZE, WIDTH)
    vals = harness.synth_modk(n, K, WIDTH, device=device)
    torch.cuda.synchronize()
    print(f"main path: width {WIDTH}, n {n}, {layout.packed_nbytes(WIDTH, n)} packed bytes")

    # a fresh process meets the canary on its first interval scan: so does this run
    scan._SHIFT_SEMANTICS.clear()
    for fn in path.values():
        fn.launches = 0
    t0 = time.monotonic()
    dev = pack_device_kernel(vals, WIDTH)
    bits8, counts8 = shared_scan_device(dev, list(range(K)))
    bits1, count1 = scan_device(dev, SCAN_KEY)
    back = unpack_device(dev)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in path.items()}
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


def arbitrary_key_phase(device) -> tuple[object, dict]:
    """The arbitrary-key path at full size, with launch counts taken around it."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import pack_device_kernel, shared_scan_device
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import scan

    kernels = wrappers()
    n = harness.values_for(DATA_SIZE, WIDTH)
    vals = harness.synth_modk(n, DOMAIN, WIDTH, device=device)
    dev = pack_device_kernel(vals, WIDTH)
    torch.cuda.synchronize()
    print(f"arbitrary-key path: width {WIDTH}, n {n}, values i % {DOMAIN}")

    def cuda_keys(keys):
        return torch.tensor(keys, dtype=torch.int32, device=device)

    sets = [("S8", S8), ("S64", s64()), ("W4", W4), ("W8", W8),
            ("S8 as CUDA keys", cuda_keys(S8)), ("S64 as CUDA keys", cuda_keys(s64()))]
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.monotonic()
    ran, outs = {}, {}
    for name, keys in sets:
        before = {k: fn.launches for k, fn in kernels.items()}
        outs[name] = shared_scan_device(dev, keys)
        ran[name] = [k for k, fn in kernels.items() if fn.launches > before[k]]
    before = kernels["windowed_scan"].launches
    chunked = scan.windowed_scan_tiles(dev.tiles, s64(), WIDTH, n)
    chunked_launches = kernels["windowed_scan"].launches - before
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"arbitrary-key path ran in {seconds:.3f} s (host clock, first calls); "
          f"launches {launches}")

    for name in ARBITRARY:
        check(launches[name] > 0, f"arbitrary-key path launched the {name} kernel "
              f"({launches[name]}x)")
    tier_kernel = {"interval": "interval_scan", "compare": "shared_scan",
                   "bitsliced_static": "bitsliced_static_scan", "windowed": "windowed_scan"}
    for name, keys in sets:
        if isinstance(keys, torch.Tensor):
            k = keys.shape[0]
            want = "bitsliced_scan" if scan._bitsliced_wins(WIDTH, k) else "shared_scan"
            why = f"runtime keys, k={k}"
        else:
            tier, _ = scan.pick_concrete_tier(WIDTH, keys)
            want, why = tier_kernel[tier], f"pick_concrete_tier: {tier}"
        check(ran[name] == [want], f"{name}: ran {ran[name]}, the kernel of its tier ({why})")
    check(len(s64()) > 48 and chunked_launches == 1,
          "windowed_scan_tiles(S64) launched the windowed kernel on its chunked plan")

    for name, keys in sets:
        host = scan._host_keys(keys)
        expect = [(n - 1 - int(key)) // DOMAIN + 1 for key in host]
        check(outs[name][1].tolist() == expect, f"{name}: counts == closed form")
    bits_s64 = outs["S64"][0]
    check(bool((scan.bits_to_canonical(chunked[0], n) == bits_s64).all())
          and bool((chunked[1] == outs["S64"][1]).all()),
          "chunked windowed S64 == static AND-DAG S64, every word")
    del outs, chunked, bits_s64
    for name, keys in sets:
        check(harness.check_shared_scan(dev, keys, vals),
              f"{name}: counts vs direct compare, all words vs plain compare, 2M prefix vs oracle")
    del vals
    return dev, launches


def timing_phase(device, n: int, dev, arb, errs: dict) -> dict:
    """Each kernel and its plain version at the full-size shapes: the main
    path's column ``dev``, and for the arbitrary-key kernels the i % 512
    column ``arb`` at k=8 (S8) and k=64 (S64); all four arbitrary-key tiers
    also on the clustered W8, without their plain versions."""
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    tiles = dev.tiles
    nblocks = tiles.shape[1] * LANES
    tile_bytes = tiles.numel() * 4
    vals_layout = unpack.unpack_tiles(tiles, WIDTH)
    key1 = torch.tensor([SCAN_KEY], dtype=torch.int32, device=device)
    base, amounts = scan.canary_inputs(device)
    atiles = arb.tiles
    sets = {"k=8": S8, "k=64": s64(), "k=8 clustered": W8}
    ktens = {k: torch.tensor(keys, dtype=torch.int32, device=device) for k, keys in sets.items()}

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
    nkeys = {}
    for label, keys in sets.items():
        kt = ktens[label]
        checked = "clustered" not in label
        pairs[f"bitsliced_scan {label}"] = (
            lambda kt=kt: scan.shared_scan_bitsliced_tiles(atiles, kt, WIDTH, n),
            (lambda kt=kt: scan.shared_scan_bitsliced_tiles_plain(atiles, kt, WIDTH, n))
            if checked else None)
        pairs[f"bitsliced_static_scan {label}"] = (
            lambda keys=keys: scan.shared_scan_bitsliced_static_tiles(atiles, keys, WIDTH, n),
            (lambda keys=keys: scan.shared_scan_bitsliced_static_tiles_plain(
                atiles, keys, WIDTH, n)) if checked else None)
        pairs[f"windowed_scan {label}"] = (
            lambda keys=keys: scan.windowed_scan_tiles(atiles, keys, WIDTH, n),
            (lambda keys=keys: scan.windowed_scan_tiles_plain(atiles, keys, WIDTH, n))
            if checked else None)
        # the compare kernel on the same sets, for the tier comparison
        pairs[f"shared_scan {label}"] = (
            lambda kt=kt: scan.shared_scan_tiles(atiles, kt, WIDTH, n), None)
        for kernel in ("bitsliced_scan", "bitsliced_static_scan", "windowed_scan", "shared_scan"):
            nkeys[f"{kernel} {label}"] = len(keys)
    for name, (kern, plain) in pairs.items():
        if plain is None:
            continue
        kernel = name.split()[0]
        a, p = kern(), plain()
        if isinstance(a, tuple):
            e = max(max_abs_err(a[0], p[0]), int((a[1] - p[1]).abs().max()))
        else:
            e = max_abs_err(a, p)
        errs[kernel] = max(errs[kernel], e)
        del a, p
        check(errs[kernel] == 0, f"{name} kernel bit-exact against its plain version at full size")

    def scan_bytes(k):  # tiles read once; k bitvector rows and k int64 counts written; keys read
        return tile_bytes + k * (nblocks * 4 + 8 + 4)

    traffic = {  # device-memory bytes each call must move (each input read once, output written once)
        "unpack": tile_bytes + 32 * nblocks * 4,
        "pack": 32 * nblocks * 4 + tile_bytes,
        "interval_scan": scan_bytes(K) - 4 * K,  # lo is an argument, not a key array
        "shared_scan": scan_bytes(1),
        "shift_canary": 3 * base.numel() * 4,
    }
    for name, k in nkeys.items():
        traffic[name] = scan_bytes(k)
    results = {}
    copy_dst = torch.empty_like(tiles)
    copy_ms = time_ms(lambda: copy_dst.copy_(tiles), batches=5, calls=10)
    copy_rate = 2 * tile_bytes / (copy_ms * 1e-3)
    print(f"copy_ of the packed column ({tile_bytes} bytes): {copy_ms:.6f} ms, "
          f"{copy_rate:.6e} bytes/s")
    for name, (kern, plain) in pairs.items():
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2) if plain is not None else None
        bound_ms = traffic[name] / HBM_BYTES_PER_S * 1e3
        rate = traffic[name] / (ms * 1e-3)
        results[name] = (ms, plain_ms, bound_ms)
        print(f"time {name}: kernel {ms:.6f} ms ({rate:.6e} bytes/s, {rate / copy_rate:.4f} of copy"
              f", bound {bound_ms:.6f} ms for {traffic[name]} bytes)"
              + (f"; plain {plain_ms:.6f} ms" if plain_ms is not None else ""))
    print("library: no PyTorch call scans a bit-packed column, so library_ms is null")
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
    arb, arb_launches = arbitrary_key_phase(device)
    launches.update({name: arb_launches[name] for name in ARBITRARY})
    times = timing_phase(device, n, dev, arb, errs)
    check("jax" not in sys.modules, "no jax module was imported")

    def entry(name, src, rep):
        # the arbitrary-key kernels report k=8 (S8) and, beside it, k=64 (S64)
        key = name if name in times else f"{name} k=8"
        ms, plain_ms, bound_ms = times[key]
        e = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": None}
        if name in ARBITRARY:
            e["k"] = 8
            e["ms_k64"], e["plain_ms_k64"], e["bound_ms_k64"] = times[f"{name} k=64"]
        return e

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [entry(name, src, rep) for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
