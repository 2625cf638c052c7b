"""Time the scan and histogram kernels of one checkout on the card.

    python3 shared_simd_scan_tpu_torch/bench/scan_times.py [ROOT]

Imports ``shared_simd_scan_tpu_torch`` from ROOT (default: the checkout
holding this file), builds its kernels, and times with CUDA events the
interval kernel (keys 0..7 on ``i % 8``, and the same keys through the
windowed tier), the runtime bit-sliced tier and the static tier (S8 and S64
on ``i % 512``), the windowed tier (W4, W8, S8 and S64 on ``i % 512``), the
member OR-tree tier
(``_member_ortree_tiles``, S8 and S64 on ``i % 512``), the chunked and
dynamic scans (S64 and S256 as CUDA keys), the compare tier's wrapper
``shared_scan_tiles`` on CUDA keys (k = 1, 2, 4, S8, 32, S64 and S256 on
``i % 512``; k = 4 and 10 on the 31-bit member column), the interval
kernel at k = 1, 33, 64 and 1024 (keys 0..k-1 on ``i % 8``; k = 1024
timed last, alone: its rows take 61 GB), the chunked histogram program
(lo 100, k 40), the host-lo span tier (H1: lo 0, k 512, as
``histogram_device`` sends a 9-bit column), the runtime-lo bins kernel
(H3: lo 0, k 512; and lo 100, k 256), the full-domain histogram of a uniform 20-bit column (H5: one pass
of ``_histogram_domain_tiles`` where the checkout has it, else the 256
windows of ``histogram_tiles`` that ``stats.histogram_full`` launched), and
the linear export (L1: keys 0..7 on ``i % 8``; L2: S8, L4: S64 and L6:
S64 as eight groups of 8, host keys; L3: S8 and L4 CUDA: S64 as CUDA
keys), the chunked
histogram tier on full domains (H6: a uniform 12-bit column of 512 MiB
packed, 4096 keys; H7: a uniform 4-bit column, 16 keys) and the static
bit-plane aggregate (A2: a uniform 5-bit predicate, a 20-bit measure,
host keys 0..31; A7: the 20-bit column as the predicate, a 9-bit measure,
16 spread host keys), the runtime bit-plane aggregate (A4: A6's columns
and keys; A9: A7's columns, A7's keys as a CUDA tensor) and keyed MIN/MAX
(A6: the 5-bit predicate, the 20-bit measure, CUDA keys 0..7; A8: the
20-bit predicate, the 9-bit measure, A7's keys as a CUDA tensor), the
member compare, window and bit-sliced bodies on ``i % 512`` (compare:
keys 5, 77, 300, 411 as a CUDA tensor; chunked compare: S64 as CUDA keys
in chunks of 32; window: W4's window; chunked window: the 40 windows of
keys 32 i + i % 7 in chunks of 32; bit-sliced: the 16 CUDA keys 3 + 31 i)
and member sets on ``i % 512`` columns of 512 MiB packed: at width 31 the
3205 keys of 200 spread windows of 16 and five column values, which
``member_scan_device`` sends to the chunked window body (that body timed
as dispatched, and the whole call on the host clock), and S256 as CUDA
keys, which it sends to the bit-sliced body in chunks of 32 (the call and
the body), and at width 20 ``member_scan_device`` with S8 as CUDA keys
(the compare body), at the
reference benchmark's n = 477,218,588
(H6: 357,913,941; the member sets 138,547,332 and 214,748,364); and, on the host clock, ``stats.describe``,
``quantiles`` and ``topk_values`` of the ``i % 512`` column together
(three span histograms), ``stats.histogram_full`` of the 20-bit column
(H5 wall) and of H6's and H7's columns (medians of five).  Z3, the zoned
equality scan of ``chip_smoke.py`` (key 7 on a column of 100..199 with 7
in its first and last 64 block rows, zone maps of 64 rows: 3 of 456
steps of 256 rows live): ``zoned_range_tiles`` on the live steps (the row
form), the count form where the checkout has it, ``zoned_eq_scan(...,
full_bits=False)`` on CUDA events, the row form's device time by
``torch.profiler`` (every device operation of a call, and the zoned
kernel alone, with 256 MiB written before each call so the L2 holds none
of the row), and ``zoned_eq_scan``'s wall time (host clock,
synchronized, median of ten).  The shift canary: the verdict's first
call on each of eleven cleared caches (``shift_saturates``, host clock,
median), the elementwise canary and ``torch.bitwise_left_shift`` on its
inputs.  Every host-clock set runs before the profiler session; after
it, the w31 list's ``member_scan_device`` is timed again on the host
clock, to show what the session leaves behind.  Run it on two checkouts in
turns (parent, change, change, parent) within one call to compare them on
one card.  Needs a CUDA card; prints the card's name and power limit and
one line of medians.
"""
from __future__ import annotations

import inspect
import pathlib
import statistics
import subprocess
import sys
import time

N_BYTES = 512 * 1024 * 1024
L2_FLUSH_BYTES = 256 * 1024 * 1024  # five times the H100's 50 MB L2
S8 = [3, 70, 141, 200, 262, 333, 400, 511]
MEMBER_K4 = [5, 77, 300, 411]
CHUNKED_WINDOWS = [32 * i + i % 7 for i in range(40)]
A7_KEYS = [5521, 58228, 236145, 298913, 314745, 524063, 606377, 655451, 717405, 813357, 861120,
           874138, 915983, 940786, 956952, 990790]


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


def device_ms(fn, calls: int = 20, flush_bytes: int = 0) -> dict:
    """Kernel or device operation name -> its device time per call (ms),
    from ``torch.profiler`` over ``calls`` calls after a warm-up; empty
    where the profiler saw no device time.  With ``flush_bytes``, a buffer
    of that many bytes is written before each call and its kernel left out,
    so a call writing the same rows each time pays for evicting dirty L2
    lines.  (``bench/timing.py`` has the same helper; this script keeps its
    own, as it keeps ``time_ms``, because it runs against a parent checkout
    whose package may lack it.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def profiled(body) -> dict:
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                body()
            torch.cuda.synchronize()
        times = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
            if us and str(getattr(e, "device_type", "")).endswith("CUDA"):
                times[e.key] = us / 1e3 / calls
        return times

    if not flush_bytes:
        return profiled(fn)
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    skip = set(profiled(flush.bitwise_not_))

    def flushed():
        flush.bitwise_not_()
        fn()

    return {name: ms for name, ms in profiled(flushed).items() if name not in skip}


def host_ms(fn, runs: int, skip: int = 0) -> float:
    """Median host-clock time of ``fn`` (synchronized before and after)
    over ``runs`` calls, the first ``skip`` left out."""
    import torch

    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t1) * 1e3)
    return statistics.median(walls[skip:])


def main(root: pathlib.Path) -> None:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from shared_simd_scan_tpu_torch import layout, stats, zonemap
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import _cuda, aggregate, member, scan, unpack

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
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    rtiles = unpack.pack_device_kernel(torch.randint(0, 1 << 20, (n,), generator=gen, device=device,
                                                     dtype=torch.int32), 20).tiles
    los = torch.arange(0, 1 << 20, 4096, dtype=torch.int32, device=device)
    n12 = harness.values_for(N_BYTES, 12)
    t12 = unpack.pack_device_kernel(torch.randint(0, 1 << 12, (n12,), generator=gen, device=device,
                                                  dtype=torch.int32), 12).tiles
    t4, t5, t9 = (unpack.pack_device_kernel(torch.randint(0, 1 << w, (n,), generator=gen,
                                                          device=device, dtype=torch.int32),
                                            w).tiles for w in (4, 5, 9))
    lo100 = torch.tensor([100], dtype=torch.int32, device=device)
    k8 = torch.arange(8, dtype=torch.int32, device=device)
    a7 = torch.tensor(A7_KEYS, dtype=torch.int32, device=device)
    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    def windows(keys, chunk=None):
        bases, pops = member.member_window_plan(np.asarray(keys, np.uint32))
        win = np.stack([bases, pops], axis=1)
        pad = (-len(bases)) % chunk if chunk else 0
        return t32(np.concatenate([win, np.zeros((pad, 2), np.int64)]))

    rng = np.random.default_rng(1)
    bases = rng.choice(1 << 26, 200, replace=False) * 32
    w31_list = np.concatenate([np.concatenate([b + rng.choice(32, 16, replace=False)
                                               for b in bases]), [3, 70, 141, 200, 262]])
    n31, n20 = harness.values_for(N_BYTES, 31), harness.values_for(N_BYTES, 20)
    col31 = layout.DeviceColumn(31, n31, unpack.pack_device_kernel(
        harness.synth_modk(n31, 512, 31, device=device), 31).tiles)
    col20 = layout.DeviceColumn(20, n20, unpack.pack_device_kernel(
        harness.synth_modk(n20, 512, 20, device=device), 20).tiles)
    k4, w4, cw40, w31 = t32(MEMBER_K4), windows([0, 2, 4, 6]), windows(CHUNKED_WINDOWS, 32), \
        windows(w31_list, 32)
    k16 = t32([3 + 31 * i for i in range(16)])
    k256 = member._pad_keys(cuda[256], 32)
    if hasattr(scan, "_histogram_domain_tiles"):
        def h5():
            return scan._histogram_domain_tiles(rtiles, 20, n)
    else:
        def h5():
            return [scan.histogram_tiles(rtiles, los[w: w + 1], 4096, 20, n) for w in range(256)]
    cases = {
        "interval k=8": lambda: scan.interval_scan_tiles(tiles, 0, 8, 9, n),
        "bitsliced S8": lambda: scan.shared_scan_bitsliced_tiles(atiles, cuda[8], 9, n),
        "bitsliced S64": lambda: scan.shared_scan_bitsliced_tiles(atiles, cuda[64], 9, n),
        "static S8": lambda: scan.shared_scan_bitsliced_static_tiles(atiles, host[8], 9, n),
        "static S64": lambda: scan.shared_scan_bitsliced_static_tiles(atiles, host[64], 9, n),
        "windowed W4": lambda: scan.windowed_scan_tiles(atiles, [0, 2, 4, 6], 9, n),
        "windowed W8": lambda: scan.windowed_scan_tiles(atiles, list(range(7, -1, -1)), 9, n),
        "windowed S8": lambda: scan.windowed_scan_tiles(atiles, host[8], 9, n),
        "windowed S64": lambda: scan.windowed_scan_tiles(atiles, host[64], 9, n),
        "windowed keys 0..7": lambda: scan.windowed_scan_tiles(tiles, list(range(8)), 9, n),
        "ortree S8": lambda: member._member_ortree_tiles(atiles, 9, n, tuple(S8)),
        "ortree S64": lambda: member._member_ortree_tiles(atiles, 9, n, tuple(s64)),
        "chunked S64": lambda: scan.shared_scan_chunked_tiles(atiles, cuda[64], 9, n),
        "chunked S256": lambda: scan.shared_scan_chunked_tiles(atiles, cuda[256], 9, n),
        "dynamic S64": lambda: scan.shared_scan_dynamic_tiles(atiles, cuda[64], 9, n),
        "dynamic S256": lambda: scan.shared_scan_dynamic_tiles(atiles, cuda[256], 9, n),
        "histogram_dag H2": lambda: scan._histogram_chunked_tiles(atiles, 100, 40, 9, n),
        "histogram span H1": lambda: scan.histogram_dag_tiles(atiles, 0, 512, 9, n),
        "bins H3": lambda: scan.histogram_tiles(atiles, los[:1], 512, 9, n),
        "bins lo 100 k 256": lambda: scan.histogram_tiles(atiles, lo100, 256, 9, n),
        "H5 kernel": h5,
        "interval linear L1": lambda: scan._interval_linear_tiles_impl(tiles, 0, 8, 9, n),
        "static linear L2": lambda: scan._static_linear_tiles_impl(atiles, host[8], 9, n),
        "bitsliced linear L3": lambda: scan._bitsliced_linear_tiles_impl(atiles, cuda[8], 9, n),
        "bitsliced linear L4 CUDA": lambda: scan._bitsliced_linear_tiles_impl(atiles, cuda[64], 9,
                                                                             n),
        "static linear L4": lambda: scan._static_linear_tiles_impl(atiles, host[64], 9, n),
        "static linear L6": lambda: [scan._static_linear_tiles_impl(atiles, host[64][8 * g: 8 * g + 8],
                                                                    9, n) for g in range(8)],
        "histogram_dag H6": lambda: scan._histogram_chunked_tiles(t12, 0, 4096, 12, n12),
        "histogram_dag H7": lambda: scan._histogram_chunked_tiles(t4, 0, 16, 4, n),
        "aggregate static A2": lambda: aggregate.aggregate_bitplane_static_tiles(
            t5, rtiles, list(range(32)), 5, 20, n),
        "aggregate static A7": lambda: aggregate.aggregate_bitplane_static_tiles(
            rtiles, t9, A7_KEYS, 20, 9, n),
        "aggregate runtime A4": lambda: aggregate.aggregate_bitplane_tiles(t5, rtiles, k8, 5, 20,
                                                                           n),
        "aggregate runtime A9": lambda: aggregate.aggregate_bitplane_tiles(rtiles, t9, a7, 20, 9,
                                                                           n),
        "minmax A6": lambda: aggregate.minmax_scan_tiles(t5, rtiles, k8, 5, 20, n),
        "minmax A8": lambda: aggregate.minmax_scan_tiles(rtiles, t9, a7, 20, 9, n),
        "member compare k=4": lambda: member._member_compare_tiles(atiles, k4, 9, n),
        "member chunked compare k=64": lambda: member._member_chunked_compare_tiles(
            atiles, cuda[64], 9, n, 32),
        "member window W4": lambda: member._member_window_tiles(atiles, w4, 9, n),
        "member chunked window 40 windows": lambda: member._member_chunked_window_tiles(
            atiles, cw40, 9, n, 32),
        "member w31 list (chunked window body)": lambda: member._member_chunked_window_tiles(
            col31.tiles, w31, 31, n31, 32),
        "member_scan_device w20 S8 CUDA keys": lambda: member.member_scan_device(
            col20, cuda[8]),
        "member bitsliced k=16": lambda: member._member_bitsliced_tiles(atiles, k16, 9, n, 16),
        "member bitsliced w31_S256 (body)": lambda: member._member_bitsliced_tiles(
            col31.tiles, k256, 31, n31, 32),
        "member_scan_device w31_S256 CUDA keys": lambda: member.member_scan_device(
            col31, cuda[256]),
    }
    # the compare tier as CUDA keys (the compare kernel, or where the
    # checkout's rule routes it the bit-sliced tier's launch), and the
    # interval kernel beside its k = 8
    k32 = sorted(np.random.default_rng(5).choice(512, 32, replace=False).tolist())
    compare_sets = {"k=1": [3], "k=2": [3, 70], "k=4": MEMBER_K4, "S8": S8, "k=32": k32,
                    "S64": s64, "S256": s256}
    for label, keys in compare_sets.items():
        kt = t32(keys)
        cases[f"compare {label} CUDA keys"] = lambda kt=kt: scan.shared_scan_tiles(atiles, kt, 9, n)
    for label, keys in (("k=4", MEMBER_K4), ("k=10", [3 + 50 * i for i in range(10)])):
        kt = t32(keys)
        cases[f"compare w31 {label} CUDA keys"] = (
            lambda kt=kt: scan.shared_scan_tiles(col31.tiles, kt, 31, n31))
    for k in (1, 33, 64):
        cases[f"interval k={k}"] = lambda k=k: scan.interval_scan_tiles(tiles, 0, k, 9, n)
    # Z3: the zone-map phase's ends column, its zone map and live steps
    ends = torch.randint(100, 200, (n,), generator=gen, device=device, dtype=torch.int32)
    edge = 64 * 128 * 32
    ends[:edge] = 7
    ends[-edge:] = 7
    ecol = unpack.pack_device_kernel(ends, 9)
    del ends
    zmap = zonemap.build_zonemap(ecol, zone_b1=64)
    tb = zonemap._pick_tb(ecol.tiles.shape[1], 256)
    live = zonemap.zone_step_mask(zmap, 7, 8, tb)
    zidx = torch.from_numpy(np.nonzero(live)[0].astype(np.int32)).to(device)
    zflag = torch.ones_like(zidx)
    lo7, hi8 = t32([7]), t32([8])

    def z3_rows():
        return zonemap.zoned_range_tiles(ecol.tiles, zidx, zflag, lo7, hi8, 9, n, tb)

    cases["zoned Z3 rows"] = z3_rows
    if "full_bits" in inspect.signature(zonemap.zoned_range_tiles).parameters:
        cases["zoned Z3 count form"] = lambda: zonemap.zoned_range_tiles(
            ecol.tiles, zidx, zflag, lo7, hi8, 9, n, tb, False)
    cases["zoned_eq_scan Z3 full_bits=False"] = lambda: zonemap.zoned_eq_scan(
        ecol, zmap, 7, full_bits=False)
    base, amounts = scan.canary_inputs(device)
    cases["shift canary elementwise"] = lambda: scan.run_shift_canary(base, amounts)
    cases["torch.bitwise_left_shift on the canary inputs"] = (
        lambda: torch.bitwise_left_shift(base, amounts))
    times = {name: time_ms(fn) for name, fn in cases.items()}
    # last of the event sets, alone: its 1024 rows take 61 GB
    torch.cuda.empty_cache()
    times["interval k=1024"] = time_ms(lambda: scan.interval_scan_tiles(tiles, 0, 1024, 9, n),
                                       batches=5, calls=4)
    torch.cuda.empty_cache()
    # the host-clock sets, before anything that opens a profiler session
    col = layout.DeviceColumn(9, n, atiles)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        stats.describe(col), stats.quantiles(col, [0.5, 0.9]), stats.topk_values(col, 5)
        walls.append((time.monotonic() - t1) * 1e3)
    col20 = layout.DeviceColumn(20, n, rtiles)
    walls20 = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        stats.histogram_full(col20)
        walls20.append((time.monotonic() - t1) * 1e3)
    walls_full = {}
    for name, col in (("H6", layout.DeviceColumn(12, n12, t12)),
                      ("H7", layout.DeviceColumn(4, n, t4))):
        walls_full[name] = []
        for _ in range(6):
            torch.cuda.synchronize()
            t1 = time.monotonic()
            stats.histogram_full(col)
            walls_full[name].append((time.monotonic() - t1) * 1e3)

    def w31_list_wall():  # median of five after a warm-up
        return host_ms(lambda: member.member_scan_device(col31, w31_list), 6, skip=1)

    walls31 = w31_list_wall()
    z3_wall = host_ms(lambda: zonemap.zoned_eq_scan(ecol, zmap, 7), 11)
    firsts = []
    for _ in range(11):
        scan._SHIFT_SEMANTICS.clear()
        t1 = time.monotonic()
        scan.shift_saturates(device)
        firsts.append((time.monotonic() - t1) * 1e3)
    same = bool(torch.equal(torch.bitwise_left_shift(base, amounts),
                            scan.shift_canary_plain(base, amounts)))
    # then the profiler, and the w31 list's host clock once more after it
    z3_device = device_ms(z3_rows, flush_bytes=L2_FLUSH_BYTES)
    walls31_after = w31_list_wall()
    del ecol
    print(f"{smi}; {root}: build {build:.1f} s; "
          + "; ".join(f"{name} {ms:.6f} ms" for name, ms in times.items())
          + f"; stats trio (host clock) {statistics.median(walls[1:]):.6f} ms"
          + f"; H5 histogram_full (host clock) {statistics.median(walls20[1:]):.6f} ms"
          + "".join(f"; {name} histogram_full (host clock) {statistics.median(w[1:]):.6f} ms"
                    for name, w in walls_full.items())
          + f"; member_scan_device w31 list (host clock) {walls31:.6f} ms"
          + f"; Z3 {int(live.sum())} of {live.shape[0]} steps live, zoned_range_tiles device time "
          + (f"(torch.profiler) {sum(z3_device.values()):.6f} ms in all, "
             f"{sum(v for k, v in z3_device.items() if 'zoned' in k):.6f} ms the zoned kernel "
             f"({'; '.join(f'{k} {v:.6f}' for k, v in z3_device.items())})"
             if z3_device else "not measured (the profiler saw no device time)")
          + f"; zoned_eq_scan Z3 (host clock) {z3_wall:.6f} ms"
          + f"; member_scan_device w31 list after torch.profiler (host clock) "
          + f"{walls31_after:.6f} ms"
          + f"; shift verdict first call (host clock, median of {len(firsts)}) "
          + f"{statistics.median(firsts):.6f} ms"
          + f"; torch.bitwise_left_shift equals shift_canary_plain on the canary inputs: {same}",
          flush=True)


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1
         else pathlib.Path(__file__).resolve().parents[2])
