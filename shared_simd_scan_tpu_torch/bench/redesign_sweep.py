"""Time the redesigned kernels' designs side by side on the card.

    python -m shared_simd_scan_tpu_torch.bench.redesign_sweep [SECTION ...]

SECTION is any of copy, chunked, dynamic, bins, domain, fold, static,
ortree, histdag, aggstatic, minmax, windowed, runtime, member, interval,
compare, zoned (default: all).
Builds
``redesign_sweep.cu`` (copy, chunked, dynamic),
``redesign_sweep_scan.cu`` (interval, compare),
``redesign_sweep_zoned.cu`` (zoned),
``redesign_sweep_bins_fold.cu`` (bins, domain, fold),
``redesign_sweep_static_member.cu`` (static, ortree) and
``redesign_sweep_hist_agg.cu`` (histdag, aggstatic, minmax) and
``redesign_sweep_windowed.cu`` (windowed) beside this file
with nvcc into the package's ``_build/`` (in parallel) and prints their
registers and shared memory per kernel.  Then, with CUDA events (the
median of 5 batches of 10 calls, each variant timed twice, in one order
and then in the reverse one):

- copy: the copy on 512 MiB: the per-thread batch kernel, the pipelined
  grid-stride loop at 4 and 8 vectors a thread, the bulk-copy ring on the
  resident grid at three stage sizes and with a CTA for every run of 2-32
  consecutive chunks, the package's ``harness.memcpy`` and ``copy_``, on
  random words, on zeros, and as the CLI's ``memory`` rows run it (back and
  forth between two buffers of zeros); every variant byte-exact first;
- chunked: the chunked scan on the reference benchmark's column (9-bit
  ``i % 512``, 512 MiB packed): the register compare (16 keys a CTA)
  against the key lookup at C in {32, 64, 128} keys and 128 or 256 threads
  a CTA, two other forms of it at 64 and 256 (a shared atomic per row and
  warp for the counts, each row update right after its lookup; rep and the
  counts in registers) and the package's ``shared_scan_chunked_tiles``, on
  S64 and S256 (the key sets of ``chip_smoke.py``); every variant
  bit-exact against the register compare and its counts equal to the
  closed form first.  Beside them, timed only, the package's kernel without
  its lookups, its counts or its row stores;
- dynamic: the dynamic scan on the same column and key sets: the dynamic
  compare it replaced (values in shared memory, read back for every key)
  against the lookup of each value among a launch's keys at groups of G in
  {32, 64} rows and 128 or 256 threads a CTA, the package's
  ``shared_scan_dynamic_tiles`` and ``shared_scan_chunked_tiles``; every
  variant bit-exact against the dynamic compare and its counts equal to
  the closed form first.  Beside them, timed only, the package's dynamic
  kernel without its lookups or its row stores, and the CTAs an SM of each
  dynamic variant and of the chunked kernel;
- bins: the single-window histogram at the reference benchmark's n on the
  ``i % 512`` column and a uniform 9-bit one: the bins kernel before its
  redesign against the package's kernel with and without its bank swizzle
  on the whole domain (lo 0, k 512), and on a window (lo 100, k 256) with
  its spare counter or a branch for the values outside it;
  the package's ``histogram_tiles`` and span tier; every count equal to
  ``torch.bincount`` first;
- domain: the full-domain histogram of a uniform 20-bit column, one whose
  values are 0 nine times in ten and a constant one, at the same n: 256
  launches of 4096-value windows (the bins kernel before its redesign, and
  the package's), against one pass with int64 counters in device memory
  (the package's: a warp's hot value counted in registers and the lanes of
  one value merged; and without the merging), with 32-bit counters, and G
  in {4, 13} windows a CTA in shared memory, and the package's
  ``_histogram_domain_tiles``; every count equal to ``torch.bincount``
  first;
- fold: the linear export on the ``i % 512`` column at k = 8 (S8), 64
  (S64) and 128: the package's static entry, its plane masks in shared
  memory at 256 and 128 threads a CTA, the fold with its masks computed
  from the keys in the loop (keys as kernel parameters at 256 and 128
  threads, in constant memory, read from device memory: the runtime entry
  before its redesign), the package's runtime entry and the masks of keys
  in device memory staged in shared memory at 256 and 128 threads, and
  the package's ``_static_linear_tiles_impl`` and runtime-key
  ``_bitsliced_linear_tiles_impl``; every variant's words equal to the
  static entry's and its counts to the closed form first;
- static: the static tier (one row per host key, in tile order) on
  ``i % 512`` columns of 512 MiB packed at widths 9 (S8, 16 and 32 keys,
  S64, S256), 20 (S8, S64) and 31 (S8, S64, and 1024 keys of 0..511 with
  duplicates): the plane fold with its masks in shared memory at 128 and
  256 threads a CTA (at 1024 keys and width 31 also with its masks staged
  in chunks of 16, 32, 64 KB or all at once), row 14's lookup
  ``shared_scan_chunked_tiles``, the package's
  ``shared_scan_bitsliced_static_tiles`` and row 15's runtime fold
  ``shared_scan_bitsliced_tiles`` on the same keys as a CUDA tensor; every
  variant's bits equal to row 14's and its counts to the closed form
  first;
- ortree: the member OR-tree tier's one row on the same columns: at width
  9 S8, S64, S256 and the whole domain, at width 20 S64 and the OR-tree
  tier's largest set of a sweep of host key sets (widths 9-31, k 33-3000,
  spread and clustered, through ``member_dispatch_tier``; its tiers and
  largest sets printed): the set as a plane fold (masks in shared memory,
  rows ORed) at 128 and 256 threads, the package's
  ``_member_ortree_tiles`` (the lookup: the bitmap, or the search in
  shared memory), the search read from device memory, and
  ``_member_domain_tiles`` (width 9); every variant's words equal to the
  package's lookup's and its count to the closed form first;
- histdag: the host-lo histogram of keys lo..lo+k-1 (the tier of the
  JAX package's chunked AND-DAG programs) on uniform columns of 512 MiB
  packed at widths 1-6, 8, 9 and 12 (k from 1 to 4096: the whole domain and
  windows at lo 0, and 1000 keys at lo 100 at width 12) and on the
  ``i % 512`` column (H2: lo 100, k 40; and lo 0, k 40): (a) the bins
  kernel with lo by value and one spare counter, (b) with a spare counter
  a lane, (c) the static fold's counts form at 256 and 128 threads a CTA
  (k <= 64), and the package's ``_histogram_chunked_tiles``; every count
  equal to (a)'s, and (a)'s on ``i % 512`` to the closed form and over a
  whole domain summing to n, first;
- aggstatic: the static bit-plane aggregate (host keys) at the query
  table's n (477,218,588): A2 (a uniform 5-bit predicate, a 20-bit
  measure, keys 0..31), A7 (a uniform 20-bit predicate, a 9-bit measure,
  16 spread keys), a constant predicate and one 90% on a single key, and
  A2's predicate with 8- and 31-bit measures: the key lookup (past 16
  bits a byte table on a 16-bit window of the value, or the binary
  search) with its sums as a 32-bit word and its carries, with 64-bit
  shared atomics, with counters per warp, with the lanes of one slot
  merged, with a warp's hot slot summed in registers (always, or for the
  tiles where half a warp shares it), with values that have no slot
  skipped and carries checked after eight atomics, and the package's
  ``aggregate_bitplane_static_tiles``; every count and sum equal to the
  compare kernel's (``aggregate_scan_tiles``) first;
- minmax: keyed MIN/MAX (keys in device memory) at the query table's n: A6
  (a uniform 5-bit predicate, a 20-bit measure, keys 0..7), A8 (a uniform
  20-bit predicate, a 9-bit measure, A7's 16 spread keys), a constant
  predicate and one 90% on a single key, and A6's predicate with a
  measure that falls with the row index (every value a new minimum): the
  compare kernel it replaced against the key lookup with an atomicMin
  and an atomicMax every value, with each counter read first and its
  atomic only where the value improves on it, each with and without a
  warp's hot slot in registers (lane 0's first slot, or the slot most of
  the warp's first values share), the package's form with the binary search
  at every width and (past 16 bits) with the CTA's own 16-bit window, and
  the package's ``minmax_scan_tiles``; every count, min and max equal to
  the compare kernel's first;
- windowed: the windowed tier's host keys on ``i % 512`` columns of 512
  MiB packed at widths 9, 17, 20 and 31 (W4, W8, S8, S16, S32, S64, 64
  keys in two windows; and on columns of 64 MiB, 1024 keys in a window
  each): the package's window lookup (``windowed_scan_tiles``, kernel
  ``sss_windowed_lookup``: one lookup a value in the keys' window tables,
  rows by the first caller row holding each key) against the same lookup with its
  rows by key index (one table load a value), the static tier's fold
  (``shared_scan_bitsliced_static_tiles``) and rows 13 and 14's lookups
  (``shared_scan_dynamic_tiles``, ``shared_scan_chunked_tiles``) on the
  keys copied to the card once; every result equal to the window lookup's
  and its counts to the closed form first; then the largest ratio of the
  dynamic scan's time to the window lookup's, and the fold's time over the
  window lookup's at every shape;
- runtime: CUDA-tensor keys on ``i % 512`` columns of 128 MiB packed at
  every width 9-31, k = 8, 64, 128, 192, 256, 384, 512, 768 and 1024 (up
  to 512 distinct keys of 0..511; past 512 all of them and keys drawn
  past 511, duplicates at width 9): the plane fold in tile order on the
  key tensor (``sss_bitsliced_static_fold``) against row 13's lookup
  (``shared_scan_dynamic_tiles``, one launch); every result, the
  package's ``shared_scan_bitsliced_tiles``' too, equal to the fold's and
  its counts to the closed form first; then, per shape, the lookup's gain
  over the fold, and per width the k where it exceeds 5% (the table of
  ``scan._RUNTIME_LOOKUP_KS``, the route's choice between the fold and the
  lookup);
- member: the member compare and window kernels (``sss_member_compare``,
  ``sss_member_window``) on ``i % 512`` columns of 512 MiB packed at widths
  9, 16, 17, 20 and 31, k keys or windows 1, 4, 8, 32, 64, 200, 4096 and
  4097 (distinct keys of 0..511, then keys spread over the domain; windows
  with random popmasks, the first 16 in 0..511): the table's two layouts
  (up to width 16 the bitmap each resident CTA builds in the scan's launch,
  against one build launch and then the lookup) and, beside them, the
  lookup alone on the same table built once (``sss_member_lookup``) and
  the package's wrappers; every result equal to the first's and its count
  to the closed form first; then, per width up to 16, the row counts
  where the fused layout is faster (the rule of
  ``member.MEMBER_FUSED_ROWS``).

- interval: the interval kernel on ``i % 8`` (width 9, 512 MiB packed:
  keys 0..k-1 for k 1, 8, 33, 64; 64 MiB: k 1024) and ``i % 512`` (widths
  17, 25 and 31: k 8): before its redesign (a CTA a tile, the masks held across
  rounds) against the redesigned body on resident CTAs loading their own
  blocks and on a grid of a CTA a tile so loading, on a ring of bulk
  copies at 128 and 256 threads and 2 and 3 stages, and on a ring filled
  by a 2-D TMA tensor map (256 threads, 2 stages; also 3 stages, and 128
  threads) on the resident grid or with a CTA a run of 1-16 tiles (the
  package's: ``common.cuh`` ``staged_run`` tiles), beside the
  package's ``interval_scan_tiles`` and the static fold on the same keys;
  every result equal to the first's and its counts to the closed form;
- compare: the compare kernel's same designs (before its redesign: the
  32 shifted operands built for every key of every block) on ``i % 512``
  at width 9 (k 1, 2, 4, 8), 17 and 25 (k 1, 4) and 31 (k 1, 4, 10)
  beside the package's
  ``shared_scan_tiles`` and the plane fold; then the compare kernel
  (``sss_shared_scan``) against the plane fold
  (``shared_scan_bitsliced_tiles``) and the dynamic scan's lookup
  (``shared_scan_dynamic_tiles``), one launch each, at widths 1, 5, 9, 12,
  16, 17, 20, 25 and 31 and k 1-1024 on ``i % min(2^w, 512)`` columns of
  256 MiB packed (less where the k rows would pass 16 GiB), and the table
  of ``scan._COMPARE_FOLD_KS`` (the route's choice of the compare kernel):
  by width, the k where the faster of the two is more than 5% faster.
- zoned: the zoned range scan (k = 1, steps of 256 block rows, the listed
  steps in random order) on uniform columns of 477,218,588 values (456
  steps) at widths 9 and 31, with 1, 3, 50 and 227 of the 456 steps
  listed: the package's C entry (the rows and counts zeroed by memsets on
  the stream, then a flat grid of (entry, tile of its step)) against
  three designs that write the whole row in one launch: 1, 2, 4 or 8
  zero-filling CTAs a multiprocessor, each over a span of the rows, beside
  the flat grid, storing zeros by bulk copies or 16-byte stores; CTAs that
  walk the rows a run of 2-16 tiles each, reading the entries themselves,
  their listed tiles loaded by each thread or through the TMA ring; and
  that walk on a step table built on the card first; beside them the
  package's ``zoned_range_tiles``, its count form, the full-column
  ``range_scan_tiles`` and ``zero_`` of the row; then each one's device
  time by ``torch.profiler``, with 256 MiB written before each call so the
  L2 holds none of the row.  Every variant's words (written over a row
  filled with -1) equal to the package's entry's and its count to the
  plain version's first.

The bins and fold sections also print, from ``cuobjdump -sass`` of the
sweep's library, the instructions of each width-9 kernel's basic blocks
that hold eight or more shared atomics (bins: instructions per value) and
of each loop that stages rows (fold: instructions per four rows), with
their atomics, three-input logic ops and shared loads and stores.

Needs a CUDA card; prints the card's name and power limit first.  Not on
any path of the package.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from shared_simd_scan_tpu_torch.bench import harness
from shared_simd_scan_tpu_torch.bench.timing import device_ms
from shared_simd_scan_tpu_torch.layout import LANES
from shared_simd_scan_tpu_torch.ops import _cuda, aggregate, member, scan
from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel

SOURCE = pathlib.Path(__file__).with_name("redesign_sweep.cu")
HIST_AGG_SOURCE = pathlib.Path(__file__).with_name("redesign_sweep_hist_agg.cu")
BINS_FOLD_SOURCE = pathlib.Path(__file__).with_name("redesign_sweep_bins_fold.cu")
STATIC_MEMBER_SOURCE = pathlib.Path(__file__).with_name("redesign_sweep_static_member.cu")
WINDOWED_SOURCE = pathlib.Path(__file__).with_name("redesign_sweep_windowed.cu")
SCAN_SOURCE = pathlib.Path(__file__).with_name("redesign_sweep_scan.cu")
ZONED_SOURCE = pathlib.Path(__file__).with_name("redesign_sweep_zoned.cu")
SECTIONS = ("copy", "chunked", "dynamic", "bins", "domain", "fold", "static", "ortree",
            "histdag", "aggstatic", "minmax", "windowed", "runtime", "member", "interval",
            "compare", "zoned")
COPY_BYTES = 512 * 1024 * 1024
COPY_NAMES = {0: "batch (8 loads, then 8 stores)", 1: "pipelined 4", 2: "pipelined 8",
              3: "ring 16 KB x 4, resident grid", 4: "ring 32 KB x 4, resident grid",
              5: "ring 64 KB x 3, resident grid", 6: "ring 32 KB x 4, a CTA per 2 chunks",
              7: "ring 32 KB x 4, a CTA per 4 chunks", 8: "ring 32 KB x 4, a CTA per 8 chunks",
              9: "ring 16 KB x 4, a CTA per 4 chunks", 10: "ring 16 KB x 4, a CTA per 16 chunks",
              11: "ring 16 KB x 4, a CTA per 32 chunks"}
CHUNKED_NAMES = {0: "compare C=16 T=256", 1: "lookup C=32 T=128", 2: "lookup C=32 T=256",
                 3: "lookup C=64 T=128", 4: "lookup C=64 T=256", 5: "lookup C=128 T=128",
                 6: "lookup C=128 T=256",
                 7: "lookup C=64 T=256, row atomics, updates interleaved",
                 8: "lookup C=64 T=256, rep and counts in registers"}
# the library's kernel with a part taken out: timed, its results not checked
ABLATION_NAMES = {9: "C=64 T=256 without lookups", 10: "C=64 T=256 without counts",
                  11: "C=64 T=256 without row stores"}
DYNAMIC_NAMES = {0: "dynamic compare", 1: "lookup G=32 T=128", 2: "lookup G=32 T=256",
                 3: "lookup G=64 T=128", 4: "lookup G=64 T=256"}
DYNAMIC_ABLATIONS = {5: "the package's dynamic kernel without lookups",
                     6: "the package's dynamic kernel without row stores"}
# mangled-name fragment -> label of the kernels the SASS report reads
SASS_KERNELS = {"bins_baseline_kernelILi9E": "bins before the redesign",
                "histogram_kernelILi9ELb1ELb1E": "bins, the package's",
                "histogram_kernelILi9ELb0ELb1E": "bins without the swizzle",
                "histogram_kernelILi9ELb1ELb0E": "bins, a branch around the atomic",
                "histogram_domain_kernelILi20EyLb1E": "domain (width 20), the package's",
                "histogram_domain_kernelILi20EyLb0E": "domain (width 20) without merging",
                "static_fold_kernelILi9ENS_10LinearKeysELi0E": "fold, the package's",
                "fold_linear_kernelILi9ENS_10LinearKeys": "fold, parameter keys",
                "fold_linear_kernelILi9ENS_10DeviceKeys": "fold, device keys, before the redesign",
                "static_fold_kernelILi9ENS_10DeviceKeysELi0E": "fold, device keys, the package's",
                "fold_linear_kernelILi9ENS_9ConstKeys": "fold, constant-memory keys",
}
STATIC_NAMES = {1: "fold, 128 threads, masks up to 48 KB (the package's)",
                2: "fold, 256 threads, masks up to 48 KB"}
CHUNK_NAMES = {3: "fold, 128 threads, masks in chunks of 16 KB",
               4: "fold, 128 threads, masks in chunks of 32 KB",
               5: "fold, 128 threads, masks in chunks of 64 KB",
               6: "fold, 128 threads, all masks at once (128 KB)",
               7: "fold, 256 threads, masks in chunks of 16 KB",
               8: "fold, 256 threads, masks in chunks of 32 KB",
               9: "fold, 256 threads, masks in chunks of 64 KB",
               10: "fold, 256 threads, all masks at once (128 KB)"}
MEMBER_NAMES = {1: "the set as a plane fold, 128 threads",
                2: "the set as a plane fold, 256 threads",
                3: "the lookup, its search table in device memory"}
STATIC_MEMBER_SASS = {
    "static_fold_kernelILi9ENS_10DeviceKeysELi1E": "static fold in tile order (width 9)",
    "member_lookup_kernelILi9ELi0E": "member lookup, bitmap (width 9)",
    "member_lookup_kernelILi20ELi1E": "member lookup, search in shared memory (width 20)",
    "member_fold_kernelILi9E": "member as a plane fold (width 9)",
}
HIST_NAMES = {1: "(a) the bins kernel, one spare counter",
              2: "(b) the bins kernel, a spare counter a lane",
              3: "(c) the fold's counts form, 256 threads",
              4: "(c) the fold's counts form, 128 threads"}
AGG_NAMES = {1: "the package's entry (the warp's choice per tile; the window past 16 bits)",
             2: "lookup, 64-bit shared atomics", 3: "lookup, carries, counters per warp",
             4: "lookup, the lanes of one slot merged", 5: "lookup, a warp's hot slot in registers",
             6: "lookup, the sum's word and its carries", 7: "lookup, no-slot values skipped, "
             "carries checked after eight atomics", 8: "the same, with a warp's hot slot in "
             "registers", 9: "lookup, carries, the binary search past 16 bits",
             10: "the package's form with the binary search past 16 bits"}
MINMAX_NAMES = {0: "the compare kernel before the redesign", 1: "the package's entry",
                2: "lookup, atomicMin and atomicMax every value",
                3: "lookup, each counter read first, its atomic where the value improves on it",
                4: "lookup, atomics every value, a warp's hot slot in registers",
                5: "lookup, counters read first, a warp's hot slot in registers",
                8: "lookup, atomics every value, the warp's most shared slot in registers",
                6: "the package's form, the binary search at every width",
                7: "the package's form, the CTA's 16-bit window (else the search)"}
HIST_AGG_SASS = {
    "histogram_kernelILi9ELb1ELb1ELb0E": "bins, one spare counter (width 9)",
    "histogram_kernelILi9ELb1ELb1ELb1E": "bins, a spare counter a lane (width 9)",
    "static_fold_kernelILi1ENS_8SpanKeysELi2E": "the fold's counts form (width 1)",
    "static_fold_kernelILi4ENS_8SpanKeysELi2E": "the fold's counts form (width 4)",
    "agg_lookup_kernelILi0ELi6ELb0E": "aggregate lookup, table, the package's",
    "agg_lookup_kernelILi1ELi6ELb0E": "aggregate lookup, window, the package's",
    "agg_lookup_kernelILi2ELi6ELb0E": "aggregate lookup, search, the package's",
    "agg_lookup_kernelILi0ELi0ELb0E": "aggregate lookup, table, carries",
    "minmax_compare_kernel": "MIN/MAX compare before the redesign",
    "minmax_lookup_kernelILi0ELi0E": "MIN/MAX lookup, table, atomics",
    "minmax_lookup_kernelILi0ELi1E": "MIN/MAX lookup, table, read first",
    "minmax_lookup_kernelILi0ELi2E": "MIN/MAX lookup, table, atomics, hot slot",
    "minmax_lookup_kernelILi0ELi3E": "MIN/MAX lookup, table, read first, hot slot",
    "minmax_lookup_kernelILi0ELi4E": "MIN/MAX lookup, table, atomics, most shared slot (the "
                                     "package's form)",
    "minmax_lookup_kernelILi3ELi4E": "MIN/MAX lookup, the CTA's window or search (the package's "
                                     "form)",
}
WIDTH, DOMAIN = 9, 512
HBM_BYTES_PER_S = 3.35e12
N_BYTES_FULL = 512 * 1024 * 1024  # the reference benchmark's packed column
N_BYTES_SWEEP = 256 * 1024 * 1024  # the compare rule's columns


def _build(source: pathlib.Path) -> tuple[pathlib.Path, str]:
    out = _cuda.BUILD_DIR / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-shared", str(source), "-o", str(out)],
                          check=True, capture_output=True, text=True)
    return out, proc.stdout + proc.stderr


def _libraries(sources: list) -> dict:
    """source -> (loaded library, its path, nvcc's log), built in parallel."""
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(_build, sources)))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        SOURCE: {"sweep_copy": [i, vp, vp, ll, vp],
                 "sweep_chunked": [i, vp, vp, i, vp, vp, ll, i, ll, ll, vp],
                 "sweep_dynamic": [i, vp, vp, i, vp, vp, ll, i, ll, ll, vp],
                 "sweep_dynamic_ctas": [i, i]},
        BINS_FOLD_SOURCE: {"sweep_bins": [i, vp, vp, i, vp, ll, i, ll, vp],
                           "sweep_domain": [i, vp, vp, ll, i, ll, vp],
                           "sweep_fold": [i, vp, vp, vp, i, vp, vp, ll, i, ll, vp]},
        STATIC_MEMBER_SOURCE: {"sweep_static": [i, i, vp, vp, i, vp, vp, ll, ll, vp],
                               "sweep_member": [i, i, vp, vp, i, vp, i, vp, vp, ll, ll, vp]},
        HIST_AGG_SOURCE: {"sweep_hist": [i, i, vp, ctypes.c_uint32, i, vp, ll, ll, vp],
                          "sweep_agg": [i, vp, vp, vp, i, vp, vp, ll, i, i, ll, vp],
                          "sweep_minmax": [i, vp, vp, vp, i, vp, vp, vp, ll, i, i, ll, vp]},
        WINDOWED_SOURCE: {"sweep_window_key_index": [vp, vp, i, i, i, vp, vp, ll, i, ll, vp]},
        SCAN_SOURCE: {"sweep_scan": [i, i, vp, vp, ctypes.c_uint32, i, vp, vp, ll, i, ll, vp]},
        ZONED_SOURCE: {"sweep_zoned": [i, i, vp, vp, vp, i, vp, vp, i, vp, vp, vp, ll, ll, i, ll,
                                       vp]},
    }
    libs = {}
    for source, (path, log) in built.items():
        lib = ctypes.CDLL(str(path))
        for name, argtypes in signatures[source].items():
            getattr(lib, name).argtypes = argtypes
        libs[source] = (lib, path, log)
    return libs


def _resources(log: str) -> list[str]:
    """ptxas's registers, shared memory and spills of the swept kernels."""
    lines, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("Used" in line or "spill" in line) and any(
                w in entry for w in ("copy", "chunked", "dynamic", "bins", "histogram", "domain",
                                     "fold", "lookup", "window",
                                     "interval", "compare", "shared_scan_kernel", "zoned")):
            lines.append(f"  {entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def _time_ms(fn, batches: int = 5, calls: int = 10) -> float:
    """Median over ``batches`` of ``calls`` calls' CUDA-event time, per
    call; 3 batches of one call where one call takes over 20 ms."""
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    if time.monotonic() - t0 > 0.02:
        batches, calls = 3, 1
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _in_turns(calls: dict) -> dict:
    """name -> (first time, second time): every call timed in order, then in
    the reverse order."""
    first = {name: _time_ms(fn) for name, fn in calls.items()}
    second = {name: _time_ms(fn) for name, fn in reversed(calls.items())}
    return {name: (first[name], second[name]) for name in calls}


def _report(title: str, times: dict, bound_ms: float) -> None:
    print(f"{title} (bound {bound_ms:.6f} ms):")
    for name, (a, b) in times.items():
        mean = (a + b) / 2
        print(f"  {name}: {a:.6f} / {b:.6f} ms (mean {mean:.6f}, {bound_ms / mean:.3f} of bound)")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"redesign_sweep: {what}")


def copy_sweep(lib, device) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randint(0, 1 << 31, (COPY_BYTES // 4,), generator=gen, device=device,
                      dtype=torch.int32)
    y = torch.empty_like(x)

    def variant(v, src, dst):
        rc = lib.sweep_copy(v, src.data_ptr(), dst.data_ptr(), COPY_BYTES, stream)
        if rc:
            raise RuntimeError(f"copy variant {v}: CUDA error {rc}")

    for v in COPY_NAMES:
        y.zero_()
        variant(v, x, y)
        _check(torch.equal(x, y), f"copy variant {COPY_NAMES[v]} is not byte-exact")
    bound = 2 * COPY_BYTES / HBM_BYTES_PER_S * 1e3
    for label in ("random words", "zeros"):
        calls = {name: (lambda v=v: variant(v, x, y)) for v, name in COPY_NAMES.items()}
        calls["harness.memcpy"] = lambda: harness.memcpy(x, y)
        calls["copy_"] = lambda: y.copy_(x)
        _report(f"copy 512 MiB, {label}", _in_turns(calls), bound)
        x.zero_()
    # the CLI's memory rows: back and forth between two buffers of zeros
    state = {"i": 0}

    def back_and_forth(fn):
        def call():
            state["i"] ^= 1
            fn(x, y) if state["i"] else fn(y, x)
        return call

    calls = {name: back_and_forth(lambda a, b, v=v: variant(v, a, b))
             for v, name in COPY_NAMES.items()}
    calls["harness.memcpy"] = back_and_forth(harness.memcpy)
    calls["copy_"] = back_and_forth(lambda a, b: b.copy_(a))
    _report("copy 512 MiB, back and forth (the CLI's memory rows)", _in_turns(calls), bound)


def scan_sweep(title: str, entry, names: dict, ablations: dict, packaged: dict, tiles,
               n: int) -> None:
    """Time the variants of one sweep entry point (``entry(variant, ...)``)
    and the package's wrappers in ``packaged`` on S64 and S256 of the
    ``i % 512`` column: each checked first against variant 0's bits and the
    closed-form counts; the ablations timed only."""
    device = tiles.device
    stream = torch.cuda.current_stream().cuda_stream
    nblocks = tiles.shape[1] * LANES
    sets = {"S64": np.random.default_rng(3).choice(DOMAIN, 64, replace=False),
            "S256": np.random.default_rng(4).choice(DOMAIN, 256, replace=False)}
    for label, keys in sets.items():
        keys = sorted(keys.tolist())
        k = len(keys)
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        expect = torch.tensor([(n - 1 - key) // DOMAIN + 1 for key in keys], device=device)
        bits = torch.empty((k, tiles.shape[1], LANES), dtype=torch.int32, device=device)
        counts = torch.zeros(k, dtype=torch.int64, device=device)

        def variant(v):
            counts.zero_()
            rc = entry(v, tiles.data_ptr(), kt.data_ptr(), k, bits.data_ptr(), counts.data_ptr(),
                       nblocks, WIDTH, n, 0, stream)
            if rc:
                raise RuntimeError(f"{title} variant {v}: CUDA error {rc}")

        variant(0)
        ref = bits.clone()
        _check(torch.equal(counts, expect), f"{label}: {names[0]}'s counts")
        for v in list(names)[1:]:
            bits.zero_()
            variant(v)
            _check(torch.equal(bits, ref) and torch.equal(counts, expect),
                   f"{label}: {names[v]} differs from {names[0]}")
        for name, fn in packaged.items():
            got = fn(tiles, kt, WIDTH, n)
            _check(torch.equal(got[0], ref) and torch.equal(got[1], expect),
                   f"{label}: {name} differs from {names[0]}")
            del got
        del ref
        calls = {name: (lambda v=v: variant(v)) for v, name in names.items()}
        calls.update({name: (lambda fn=fn: fn(tiles, kt, WIDTH, n))
                      for name, fn in packaged.items()})
        calls.update({f"ablation: {name}": (lambda v=v: variant(v))
                      for v, name in ablations.items()})
        nbytes = tiles.numel() * 4 + k * (nblocks * 4 + 8 + 4)
        _report(f"{title} {label} (k={k})", _in_turns(calls), nbytes / HBM_BYTES_PER_S * 1e3)
        del bits
        torch.cuda.empty_cache()


def _sass(path: pathlib.Path, names=None) -> dict:
    """Function name -> its instructions [(address, opcode, text)], from
    ``cuobjdump -sass`` of the library at ``path`` (of the functions
    ``names`` only, where given)."""
    exe = pathlib.Path(_cuda.nvcc()).with_name("cuobjdump")
    args = [str(exe), "-sass", str(path)]
    if names:
        args[2:2] = ["-fun", ",".join(names)]
    out = subprocess.run(args, check=True, capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and m:
            text = m.group(2).strip()
            op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
            funcs[name].append((int(m.group(1), 16), op, text))
    return funcs


# opcodes the SASS report counts (by prefix: REDG is a RED, REDUX is not)
_COUNTED = ("ATOMS", "REDG", "LOP3", "LDS", "STS", "REDUX", "LDC", "PRMT", "MATCH")


def _tally(instrs) -> str:
    ops = [op.split(".")[0] for _, op, _ in instrs]
    return f"{len(instrs)} instructions, " + ", ".join(
        f"{ops.count(name)} {name}" for name in _COUNTED)


def _blocks(instrs) -> list:
    """The function's basic blocks: split after each branch or exit and at
    each branch target."""
    targets = set()
    for _, op, text in instrs:
        if op.startswith("BRA") or op.startswith("BRX"):
            m = re.search(r"0x([0-9a-f]+)", text.split(None, 1)[-1])
            if m:
                targets.add(int(m.group(1), 16))
    blocks, cur = [], []
    for addr, op, text in instrs:
        if addr in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append((addr, op, text))
        if op.startswith(("BRA", "EXIT", "RET", "BRX", "BSYNC", "WARPSYNC")):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    return blocks


def _loops(instrs) -> list:
    """(start, end, instructions) of each backward branch's loop."""
    loops = []
    for i, (addr, op, text) in enumerate(instrs):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", text.split(None, 1)[-1])
            if m and int(m.group(1), 16) <= addr:
                start = int(m.group(1), 16)
                loops.append((start, addr, [x for x in instrs if start <= x[0] <= addr]))
    return loops


def sass_report(path: pathlib.Path, fragments: dict, names=None) -> None:
    """For each kernel whose mangled name holds one of ``fragments``
    (fragment -> label): its basic blocks with eight or more atomics
    (shared ATOMS or device-memory REDG; instructions per atomic), and its
    innermost loops that store to shared memory or reduce.  ``names``: the
    kernels' full mangled names, to disassemble only those."""
    funcs = _sass(path, names)
    for fragment, label in fragments.items():
        names = [f for f in funcs if fragment in f]
        if not names:
            print(f"  sass {label}: not found ({fragment})")
            continue
        instrs = funcs[names[0]]
        print(f"  sass {label} ({names[0]}): {_tally(instrs)}")
        for block in _blocks(instrs):
            atoms = sum(op.split(".")[0] in ("ATOMS", "REDG") for _, op, _ in block)
            if atoms >= 8:
                print(f"    block {block[0][0]:#06x}-{block[-1][0]:#06x}: {_tally(block)}; "
                      f"{len(block) / atoms:.2f} instructions an atomic")
        inner = [lp for lp in _loops(instrs)
                 if not any(o[0] > lp[0] and o[1] < lp[1] for o in _loops(instrs))]
        for start, end, body in inner:
            if any(op.split(".")[0] in ("STS", "ATOMS", "REDG") for _, op, _ in body):
                print(f"    loop {start:#06x}-{end:#06x}: {_tally(body)}")


def bins_sweep(lib, device, n: int) -> None:
    """The single-window bins kernel on the i % 512 and a uniform 9-bit
    column, whole domain (lo 0, k 512) and a window (lo 100, k 256)."""
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    columns = {"i % 512": harness.synth_modk(n, DOMAIN, WIDTH, device=device),
               "uniform 9-bit": torch.randint(0, DOMAIN, (n,), generator=gen, device=device,
                                              dtype=torch.int32)}
    names = {0: "before the redesign", 1: "the package's kernel", 2: "without the bank swizzle",
             3: "a branch around the atomic, no spare counter"}
    for label, vals in columns.items():
        tiles = pack_device_kernel(vals, WIDTH).tiles
        truth = torch.bincount(vals.to(torch.int64), minlength=DOMAIN)
        del vals
        nblocks = tiles.shape[1] * LANES
        for lo, k, variants in ((0, DOMAIN, (0, 1, 2)), (100, 256, (0, 1, 3))):
            lo_t = torch.tensor([lo], dtype=torch.int32, device=device)
            counts = torch.zeros(k, dtype=torch.int64, device=device)

            def variant(v):
                counts.zero_()
                rc = lib.sweep_bins(v, tiles.data_ptr(), lo_t.data_ptr(), k, counts.data_ptr(),
                                    nblocks, WIDTH, n, stream)
                if rc:
                    raise RuntimeError(f"bins variant {v}: CUDA error {rc}")

            want = truth[lo: lo + k]
            for v in variants:
                variant(v)
                _check(torch.equal(counts, want), f"bins {label} lo {lo} k {k}: {names[v]}")
            packaged = {"histogram_tiles": lambda: scan.histogram_tiles(tiles, lo_t, k, WIDTH, n),
                        "span tier": lambda: scan._histogram_span_tiles(tiles, lo, k, WIDTH, n)}
            for name, fn in packaged.items():
                _check(torch.equal(fn(), want), f"bins {label} lo {lo} k {k}: {name}")
            calls = {names[v]: (lambda v=v: variant(v)) for v in variants}
            calls.update(packaged)
            bound = (tiles.numel() * 4 + 4 + k * 8) / HBM_BYTES_PER_S * 1e3
            _report(f"bins {label} (lo {lo}, k {k})", _in_turns(calls), bound)
        del tiles
        torch.cuda.empty_cache()


def domain_sweep(lib, device, n: int) -> None:
    """The full-domain histogram of a uniform 20-bit column and a skewed one."""
    width = 20
    dom = 1 << width
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    uniform = torch.randint(0, dom, (n,), generator=gen, device=device, dtype=torch.int32)
    skewed = torch.where(torch.rand(n, generator=gen, device=device) < 0.9, 0, uniform)
    constant = torch.full((n,), 12345, dtype=torch.int32, device=device)
    names = {0: "the package's: one pass, int64 counters, merged", 1: "without merging",
             2: "32-bit counters, merged", 4: "G = 4 windows a CTA in shared memory",
             13: "G = 13 windows a CTA"}
    columns = (("uniform 20-bit", uniform), ("0 nine times in ten", skewed),
               ("constant", constant))
    for label, vals in columns:
        tiles = pack_device_kernel(vals, width).tiles
        truth = torch.bincount(vals.to(torch.int64), minlength=dom)
        nblocks = tiles.shape[1] * LANES
        counts = torch.zeros(dom, dtype=torch.int64, device=device)
        los = torch.arange(0, dom, 4096, dtype=torch.int32, device=device)

        def variant(v):
            counts.zero_()
            rc = lib.sweep_domain(v, tiles.data_ptr(), counts.data_ptr(), nblocks, width, n, stream)
            if rc:
                raise RuntimeError(f"domain variant {v}: CUDA error {rc}")

        def windows(v):  # 256 launches of the single-window kernel v
            out = torch.zeros((dom // 4096, 4096), dtype=torch.int64, device=device)
            for w in range(dom // 4096):
                rc = lib.sweep_bins(v, tiles.data_ptr(), los[w:].data_ptr(), 4096, out[w].data_ptr(),
                                    nblocks, width, n, stream)
                if rc:
                    raise RuntimeError(f"bins variant {v}: CUDA error {rc}")
            return out.reshape(-1)

        for v in names:
            variant(v)
            # (the 32-bit counters fill the first half of the buffer)
            got = counts.view(torch.int32)[:dom].to(torch.int64) if v == 2 else counts
            _check(torch.equal(got, truth), f"domain {label}: {names[v]}")
        _check(torch.equal(windows(0), truth), f"domain {label}: 256 windows before the redesign")
        _check(torch.equal(windows(1), truth), f"domain {label}: 256 windows of the package's")
        _check(torch.equal(scan._histogram_domain_tiles(tiles, width, n), truth),
               f"domain {label}: _histogram_domain_tiles")
        calls = {names[v]: (lambda v=v: variant(v)) for v in names}
        calls["_histogram_domain_tiles"] = lambda: scan._histogram_domain_tiles(tiles, width, n)
        times = _in_turns(calls)
        slow = {"256 windows, the bins kernel before the redesign": lambda: windows(0),
                "256 windows, the package's bins kernel": lambda: windows(1)}
        times.update({name: (_time_ms(fn, 3, 2), _time_ms(fn, 3, 2)) for name, fn in slow.items()})
        bound = (tiles.numel() * 4 + dom * 8) / HBM_BYTES_PER_S * 1e3
        _report(f"domain {label} (n {n})", times, bound)
        del tiles, truth, counts
        torch.cuda.empty_cache()


def fold_sweep(lib, device, tiles, n: int) -> None:
    """The static linear export at k = 8, 64 and 128 on the i % 512 column."""
    stream = torch.cuda.current_stream().cuda_stream
    nblocks = tiles.shape[1] * LANES
    sets = {"S8": [3, 70, 141, 200, 262, 333, 400, 511],
            "S64": sorted(np.random.default_rng(3).choice(DOMAIN, 64, replace=False).tolist()),
            "k=128": sorted(np.random.default_rng(5).choice(DOMAIN, 128, replace=False).tolist())}
    names = {1: "the package's static entry",
             2: "masks in shared memory, 256 threads", 3: "masks in shared memory, 128 threads",
             4: "parameter keys, 256 threads", 5: "parameter keys, 128 threads",
             6: "constant-memory keys",
             7: "keys read from device memory (the runtime entry before its redesign)",
             8: "the package's runtime entry",
             9: "device keys, masks in shared memory, 256 threads",
             10: "device keys, masks in shared memory, 128 threads"}
    for label, keys in sets.items():
        k = len(keys)
        host = np.asarray(keys, np.uint32)
        kt = torch.from_numpy(host.view(np.int32).copy()).to(device)
        out = torch.empty(nblocks * k, dtype=torch.int32, device=device)
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        expect = torch.tensor([(n - 1 - key) // DOMAIN + 1 for key in keys], device=device)

        def variant(v):
            counts.zero_()
            rc = lib.sweep_fold(v, tiles.data_ptr(), host.ctypes.data, kt.data_ptr(), k,
                                out.data_ptr(), counts.data_ptr(), nblocks, WIDTH, n, stream)
            if rc:
                raise RuntimeError(f"fold variant {v}: CUDA error {rc}")

        variant(1)
        ref = out.clone()
        _check(torch.equal(counts, expect), f"fold {label}: {names[1]}'s counts")
        for v in list(names)[1:]:
            out.zero_()
            variant(v)
            _check(torch.equal(out, ref) and torch.equal(counts, expect),
                   f"fold {label}: {names[v]} differs from {names[1]}")
        packaged = {
            "_static_linear_tiles_impl": lambda: scan._static_linear_tiles_impl(tiles, host, WIDTH, n),
            "_bitsliced_linear_tiles_impl (runtime keys)":
                lambda: scan._bitsliced_linear_tiles_impl(tiles, kt, WIDTH, n)}
        for name, fn in packaged.items():
            got = fn()
            _check(torch.equal(got[0].reshape(-1), ref) and torch.equal(got[1], expect),
                   f"fold {label}: {name} differs from {names[1]}")
            del got
        del ref
        calls = {names[v]: (lambda v=v: variant(v)) for v in names}
        calls.update(packaged)
        bound = (tiles.numel() * 4 + nblocks * k * 4 + k * 8) / HBM_BYTES_PER_S * 1e3
        _report(f"fold {label} (k={k})", _in_turns(calls), bound)
        del out
        torch.cuda.empty_cache()


def _column(device, width: int) -> tuple:
    """(tiles, n) of the ``i % 512`` column of 512 MiB packed at ``width``."""
    n = harness.values_for(512 * 1024 * 1024, width)
    return pack_device_kernel(harness.synth_modk(n, DOMAIN, width, device=device), width).tiles, n


def _closed_counts(keys, n: int) -> list:
    """Each key's count on the ``i % 512`` column of n values."""
    return [(n - 1 - key) // DOMAIN + 1 if key < DOMAIN else 0 for key in keys]


def static_sweep(lib, device, columns: dict) -> None:
    """The static tier's designs on the i % 512 columns of ``columns``
    (width -> (tiles, n))."""
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(11)
    s8 = [3, 70, 141, 200, 262, 333, 400, 511]
    s64 = sorted(np.random.default_rng(3).choice(DOMAIN, 64, replace=False).tolist())
    sets = [(9, "S8", s8), (9, "S16", sorted(rng.choice(DOMAIN, 16, replace=False).tolist())),
            (9, "S32", sorted(rng.choice(DOMAIN, 32, replace=False).tolist())), (9, "S64", s64),
            (9, "S256", sorted(np.random.default_rng(4).choice(DOMAIN, 256, replace=False).tolist())),
            (20, "S8", s8), (20, "S64", s64), (31, "S8", s8), (31, "S64", s64),
            (31, "k=1024", rng.integers(0, DOMAIN, 1024).tolist())]
    for width, label, keys in sets:
        tiles, n = columns[width]
        nblocks = tiles.shape[1] * LANES
        k = len(keys)
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        expect = torch.tensor(_closed_counts(keys, n), device=device)
        bits = torch.empty((k, tiles.shape[1], LANES), dtype=torch.int32, device=device)
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        names = {**STATIC_NAMES, **(CHUNK_NAMES if k > 256 else {})}

        def variant(v):
            counts.zero_()
            rc = lib.sweep_static(v, width, tiles.data_ptr(), kt.data_ptr(), k, bits.data_ptr(),
                                  counts.data_ptr(), nblocks, n, stream)
            if rc:
                raise RuntimeError(f"static variant {v}: CUDA error {rc}")

        packaged = {
            "row 14: shared_scan_chunked_tiles (CUDA keys)":
                lambda: scan.shared_scan_chunked_tiles(tiles, kt, width, n),
            "shared_scan_bitsliced_static_tiles": lambda: scan.shared_scan_bitsliced_static_tiles(
                tiles, keys, width, n),
            "row 15: shared_scan_bitsliced_tiles (CUDA keys)":
                lambda: scan.shared_scan_bitsliced_tiles(tiles, kt, width, n)}
        ref, ref_counts = packaged["row 14: shared_scan_chunked_tiles (CUDA keys)"]()
        _check(torch.equal(ref_counts, expect), f"static {label} w={width}: row 14's counts")
        for v in names:
            bits.zero_()
            variant(v)
            _check(torch.equal(bits, ref) and torch.equal(counts, expect),
                   f"static {label} w={width}: {names[v]} differs from row 14's lookup")
        for name, fn in packaged.items():
            got = fn()
            _check(torch.equal(got[0], ref) and torch.equal(got[1], expect),
                   f"static {label} w={width}: {name} differs from row 14's lookup")
            del got
        del ref
        calls = {names[v]: (lambda v=v: variant(v)) for v in names}
        calls.update(packaged)
        bound = (tiles.numel() * 4 + k * (nblocks * 4 + 8 + 4)) / HBM_BYTES_PER_S * 1e3
        _report(f"static {label} at width {width} (k={k})", _in_turns(calls), bound)
        del bits
        torch.cuda.empty_cache()


def _random_tiles(device, width: int, b1: int, seed: int) -> torch.Tensor:
    """Random packed words: a column of uniform ``width``-bit values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (width, b1, LANES), generator=gen, device=device,
                         dtype=torch.int32)


def histdag_sweep(lib, device) -> None:
    """The host-lo histogram's designs on uniform columns of 512 MiB packed
    at widths 1, 4, 9 and 12, and on the i % 512 column."""
    stream = torch.cuda.current_stream().cuda_stream
    cases = {1: [(0, 2), (0, 1)], 2: [(0, 4), (0, 1), (0, 2)], 3: [(0, 8), (0, 2), (0, 4)],
             4: [(0, 16), (0, 2), (0, 8), (0, 32)], 5: [(0, 32), (0, 2), (0, 8)],
             6: [(0, 64), (0, 2), (0, 8)], 8: [(0, 256), (0, 2)],
             9: [(0, 2), (0, 8), (0, 32), (0, 48), (0, 64), (0, 512), (0, 4096)],
             12: [(0, 2), (0, 48), (100, 1000), (0, 4096)]}
    columns = [(f"uniform {w}-bit", w, None) for w in cases]
    columns.append(("i % 512", WIDTH, [(100, 40), (0, 40)]))
    for label, width, sets in columns:
        if sets is None:
            b1 = COPY_BYTES // (width * LANES * 4)
            tiles, n = _random_tiles(device, width, b1, width), b1 * LANES * 32
            sets = cases[width]
        else:
            n = harness.values_for(COPY_BYTES, width)
            tiles = pack_device_kernel(harness.synth_modk(n, DOMAIN, width, device=device),
                                       width).tiles
        nblocks = tiles.shape[1] * LANES
        for lo, k in sets:
            counts = torch.zeros(k, dtype=torch.int64, device=device)

            def variant(v):
                counts.zero_()
                rc = lib.sweep_hist(v, width, tiles.data_ptr(), lo, k, counts.data_ptr(), nblocks,
                                    n, stream)
                if rc:
                    raise RuntimeError(f"histogram variant {v}: CUDA error {rc}")

            names = {v: name for v, name in HIST_NAMES.items() if v < 3 or k <= 64}
            variant(1)
            ref = counts.clone()
            if label == "i % 512":
                _check(ref.tolist() == _closed_counts(range(lo, lo + k), n),
                       f"histdag {label} lo {lo} k {k}: {names[1]}'s counts")
            elif lo == 0 and k >= 1 << width:
                _check(int(ref.sum()) == n, f"histdag {label}: {names[1]}'s counts sum to n")
            for v in list(names)[1:]:
                variant(v)
                _check(torch.equal(counts, ref),
                       f"histdag {label} lo {lo} k {k}: {names[v]} differs from {names[1]}")
            _check(torch.equal(scan._histogram_chunked_tiles(tiles, lo, k, width, n), ref),
                   f"histdag {label} lo {lo} k {k}: _histogram_chunked_tiles differs")
            calls = {name: (lambda v=v: variant(v)) for v, name in names.items()}
            calls["_histogram_chunked_tiles"] = lambda: scan._histogram_chunked_tiles(
                tiles, lo, k, width, n)
            bound = (tiles.numel() * 4 + k * 8) / HBM_BYTES_PER_S * 1e3
            _report(f"histdag {label} (n {n}) lo {lo} k {k}", _in_turns(calls), bound)
        del tiles
        torch.cuda.empty_cache()


def aggstatic_sweep(lib, device) -> None:
    """The static bit-plane aggregate's designs at the query table's n."""
    from shared_simd_scan_tpu_torch import layout

    stream = torch.cuda.current_stream().cuda_stream
    n = harness.values_for(COPY_BYTES, WIDTH)
    b1 = layout.padded_blocks(n) // LANES
    nblocks = b1 * LANES
    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    skewed = torch.where(torch.rand(n, generator=gen, device=device) < 0.9, 3,
                         torch.randint(0, 32, (n,), generator=gen, device=device,
                                       dtype=torch.int32))
    cols = {"region": (5, _random_tiles(device, 5, b1, 5)),
            "revenue": (20, _random_tiles(device, 20, b1, 20)),
            "price": (9, _random_tiles(device, 9, b1, 9)),
            "constant": (5, pack_device_kernel(torch.full((n,), 3, dtype=torch.int32,
                                                          device=device), 5).tiles),
            "skewed": (5, pack_device_kernel(skewed, 5).tiles),
            "m8": (8, _random_tiles(device, 8, b1, 8)),
            "m31": (31, _random_tiles(device, 31, b1, 31))}
    del skewed
    keys32 = list(range(32))
    spread16 = sorted(np.random.default_rng(16).choice(1 << 20, 16, replace=False).tolist())
    cases = [("A2: uniform 5-bit predicate, 20-bit measure, keys 0..31", "region", "revenue",
              keys32),
             ("A7: uniform 20-bit predicate, 9-bit measure, 16 spread keys", "revenue", "price",
              spread16),
             ("constant predicate (every row key 3), 20-bit measure, keys 0..31", "constant",
              "revenue", keys32),
             ("predicate 90% key 3, 20-bit measure, keys 0..31", "skewed", "revenue", keys32),
             ("A2's predicate, 8-bit measure", "region", "m8", keys32),
             ("A2's predicate, 31-bit measure", "region", "m31", keys32)]
    for label, pname, mname, keys in cases:
        (wp, pt), (wm, mt) = cols[pname], cols[mname]
        k = len(keys)
        host = np.asarray(keys, np.uint32)
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        sums = torch.zeros(k, dtype=torch.int64, device=device)

        def variant(v):
            counts.zero_()
            sums.zero_()
            rc = lib.sweep_agg(v, pt.data_ptr(), mt.data_ptr(), host.ctypes.data, k,
                               counts.data_ptr(), sums.data_ptr(), nblocks, wp, wm, n, stream)
            if rc:
                raise RuntimeError(f"aggregate variant {v}: CUDA error {rc}")

        # the reference: the compare kernel (sss_agg_compare), a select-add
        # per key and value, on the keys in device memory
        ref = aggregate.aggregate_scan_tiles(pt, mt, torch.tensor(keys, dtype=torch.int32,
                                                                  device=device), wp, wm, n)
        if k == 32 and wp == 5:
            _check(int(ref[0].sum()) == n, f"aggstatic {label}: the compare kernel's counts sum "
                   "to n")
        for v in AGG_NAMES:
            variant(v)
            _check(torch.equal(counts, ref[0]) and torch.equal(sums, ref[1]),
                   f"aggstatic {label}: {AGG_NAMES[v]} differs from the compare kernel")
        got = aggregate.aggregate_bitplane_static_tiles(pt, mt, keys, wp, wm, n)
        _check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
               f"aggstatic {label}: aggregate_bitplane_static_tiles differs")
        calls = {name: (lambda v=v: variant(v)) for v, name in AGG_NAMES.items()}
        calls["aggregate_bitplane_static_tiles"] = (
            lambda: aggregate.aggregate_bitplane_static_tiles(pt, mt, keys, wp, wm, n))
        bound = (pt.numel() * 4 + mt.numel() * 4 + 4 * k + 16 * k) / HBM_BYTES_PER_S * 1e3
        print(f"aggstatic {label}: sums[:4] {ref[1][:4].tolist()}")
        _report(f"aggstatic {label} (n {n}, wp {wp}, wm {wm}, k {k})", _in_turns(calls), bound)
    del cols
    torch.cuda.empty_cache()


def minmax_sweep(lib, device) -> None:
    """Keyed MIN/MAX's designs at the query table's n, keys in device
    memory."""
    from shared_simd_scan_tpu_torch import layout

    stream = torch.cuda.current_stream().cuda_stream
    n = harness.values_for(COPY_BYTES, WIDTH)
    b1 = layout.padded_blocks(n) // LANES
    nblocks = b1 * LANES
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    skewed = torch.where(torch.rand(n, generator=gen, device=device) < 0.9, 3,
                         torch.randint(0, 32, (n,), generator=gen, device=device,
                                       dtype=torch.int32))
    falling = ((1 << 20) - 1 - torch.arange(n, device=device, dtype=torch.int64)) % (1 << 20)
    cols = {"region": (5, _random_tiles(device, 5, b1, 5)),
            "revenue": (20, _random_tiles(device, 20, b1, 20)),
            "price": (9, _random_tiles(device, 9, b1, 9)),
            "constant": (5, pack_device_kernel(torch.full((n,), 3, dtype=torch.int32,
                                                          device=device), 5).tiles),
            "skewed": (5, pack_device_kernel(skewed, 5).tiles),
            "falling": (20, pack_device_kernel(falling.to(torch.int32), 20).tiles)}
    del skewed, falling
    a7 = [5521, 58228, 236145, 298913, 314745, 524063, 606377, 655451, 717405, 813357, 861120,
          874138, 915983, 940786, 956952, 990790]
    cases = [("A6: uniform 5-bit predicate, 20-bit measure, keys 0..7", "region", "revenue",
              list(range(8))),
             ("A8: uniform 20-bit predicate, 9-bit measure, A7's 16 spread keys", "revenue",
              "price", a7),
             ("constant predicate (every row key 3), 20-bit measure, keys 0..7", "constant",
              "revenue", list(range(8))),
             ("predicate 90% key 3, 20-bit measure, keys 0..7", "skewed", "revenue",
              list(range(8))),
             ("A6's predicate, a measure that falls with the row index", "region", "falling",
              list(range(8)))]
    for label, pname, mname, keys in cases:
        (wp, pt), (wm, mt) = cols[pname], cols[mname]
        k = len(keys)
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        out = torch.empty((3, k), dtype=torch.int64, device=device)
        variants = [v for v in MINMAX_NAMES if v != 7 or wp > 16]

        def variant(v):
            out[0].zero_()
            out[1].fill_(0x7FFFFFFF)
            out[2].fill_(-1)
            rc = lib.sweep_minmax(v, pt.data_ptr(), mt.data_ptr(), kt.data_ptr(), k,
                                  out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), nblocks,
                                  wp, wm, n, stream)
            if rc:
                raise RuntimeError(f"minmax variant {v}: CUDA error {rc}")

        variant(0)
        ref = out.clone()
        _check(int(ref[0].sum()) > 0, f"minmax {label}: the compare kernel counts rows")
        for v in variants[1:]:
            variant(v)
            _check(torch.equal(out, ref), f"minmax {label}: {MINMAX_NAMES[v]} differs from the "
                   "compare kernel")
        got = aggregate.minmax_scan_tiles(pt, mt, kt, wp, wm, n)
        want = (ref[0], *aggregate._empty_groups(ref[0], ref[1], ref[2], wm))
        _check(all(torch.equal(g, w) for g, w in zip(got, want)),
               f"minmax {label}: minmax_scan_tiles differs")
        calls = {MINMAX_NAMES[v]: (lambda v=v: variant(v)) for v in variants}
        calls["minmax_scan_tiles"] = lambda: aggregate.minmax_scan_tiles(pt, mt, kt, wp, wm, n)
        bound = (pt.numel() * 4 + mt.numel() * 4 + 4 * k + 24 * k) / HBM_BYTES_PER_S * 1e3
        print(f"minmax {label}: counts[:4] {ref[0][:4].tolist()}, mins[:4] {ref[1][:4].tolist()}, "
              f"maxs[:4] {ref[2][:4].tolist()}")
        _report(f"minmax {label} (n {n}, wp {wp}, wm {wm}, k {k})", _in_turns(calls), bound)
    del cols
    torch.cuda.empty_cache()


def ortree_edge() -> dict:
    """The member dispatcher's tiers over a sweep of host key sets (widths
    9-31, k 33-3000, spread and clustered in 32-aligned windows); prints
    the tiers and returns width -> (windows, keys) of the OR-tree tier's
    largest set at each width past MAX_DOMAIN_WIDTH."""
    from shared_simd_scan_tpu_torch.ops import member

    tiers: dict = {}
    largest: dict = {}
    for width in (9, 13, 17, 20, 24, 28, 31):
        for k in (33, 64, 128, 256, 512, 1000, 2000, 3000):
            if k > 1 << width:
                continue
            rng = np.random.default_rng(width * 7 + k)
            nwin = min(max(1, k // 8), 1 << (width - 5))
            bases = rng.choice(1 << (width - 5), nwin, replace=False)
            sets = {"spread": rng.choice(1 << width, k, replace=False),
                    "clustered": bases[rng.integers(0, nwin, k)] * 32 + rng.integers(0, 32, k)}
            for kind, keys in sets.items():
                keys = np.asarray(keys, np.uint32)
                tier = member.member_dispatch_tier(keys, width)
                tiers[tier] = tiers.get(tier, 0) + 1
                wins = len(member.member_window_plan(keys)[0])
                if tier == "ortree" and width > member.MAX_DOMAIN_WIDTH and \
                        wins > largest.get(width, (0,))[0]:
                    largest[width] = (wins, keys.tolist())
    print(f"ortree edge: tiers of {sum(tiers.values())} host key sets: {tiers}; the OR-tree "
          f"tier's largest set past width {member.MAX_DOMAIN_WIDTH}: "
          + ", ".join(f"width {w}: {wins} windows ({len(keys)} keys)"
                      for w, (wins, keys) in sorted(largest.items())))
    return largest


def ortree_sweep(lib, device, columns: dict) -> None:
    """The member OR-tree body's designs on the i % 512 columns of
    ``columns`` (width -> (tiles, n))."""
    from shared_simd_scan_tpu_torch.ops import member

    stream = torch.cuda.current_stream().cuda_stream
    largest = ortree_edge()
    s64 = sorted(np.random.default_rng(3).choice(DOMAIN, 64, replace=False).tolist())
    sets = [(9, "S8", [3, 70, 141, 200, 262, 333, 400, 511]), (9, "S64", s64),
            (9, "S256", sorted(np.random.default_rng(4).choice(DOMAIN, 256, replace=False).tolist())),
            (9, "whole domain", list(range(DOMAIN))), (20, "S64", s64),
            (20, f"the largest OR-tree set ({largest[20][0]} windows)", largest[20][1])]
    for width, label, keys in sets:
        tiles, n = columns[width]
        nblocks = tiles.shape[1] * LANES
        pats = tuple(sorted(set(keys)))
        kt = torch.tensor(pats, dtype=torch.int32, device=device)
        table = member.member_set_table(width, pats).to(device)
        expect = sum(_closed_counts(pats, n))
        bits = torch.empty((1, tiles.shape[1], LANES), dtype=torch.int32, device=device)
        counts = torch.zeros(1, dtype=torch.int64, device=device)
        names = {v: name for v, name in MEMBER_NAMES.items() if v != 3 or width > 16}

        def variant(v):
            counts.zero_()
            rc = lib.sweep_member(v, width, tiles.data_ptr(), kt.data_ptr(), len(pats),
                                  table.data_ptr(), table.shape[-1], bits.data_ptr(),
                                  counts.data_ptr(), nblocks, n, stream)
            if rc:
                raise RuntimeError(f"member variant {v}: CUDA error {rc}")

        packaged = {"_member_ortree_tiles (the lookup)":
                    lambda: member._member_ortree_tiles(tiles, width, n, pats)}
        if width <= member.MAX_DOMAIN_WIDTH:
            packaged["_member_domain_tiles"] = lambda: member._member_domain_tiles(
                tiles, kt, width, n)
        ref, count = packaged["_member_ortree_tiles (the lookup)"]()
        _check(int(count) == expect, f"ortree {label} w={width}: the lookup's count")
        for v in names:
            bits.zero_()
            variant(v)
            _check(torch.equal(bits[0], ref) and int(counts[0]) == expect,
                   f"ortree {label} w={width}: {names[v]} differs from the lookup")
        for name, fn in packaged.items():
            got = fn()
            _check(torch.equal(got[0], ref) and int(got[1]) == expect,
                   f"ortree {label} w={width}: {name} differs from the lookup")
        print(f"ortree {label} at width {width}: the lookup's table {tuple(table.shape)}")
        calls = {names[v]: (lambda v=v: variant(v)) for v in names}
        calls.update(packaged)
        bound = (tiles.numel() * 4 + nblocks * 4 + 8) / HBM_BYTES_PER_S * 1e3
        _report(f"ortree {label} at width {width} (k={len(pats)})", _in_turns(calls), bound)


def _window_sets() -> dict:
    """The windowed section's key sets: label -> (keys, packed bytes of
    their column)."""
    s64 = sorted(np.random.default_rng(3).choice(DOMAIN, 64, replace=False).tolist())
    big, small = 512 * 1024 * 1024, 64 * 1024 * 1024
    s16, s32 = (sorted(np.random.default_rng(seed).choice(DOMAIN, k, replace=False).tolist())
                for seed, k in ((6, 16), (7, 32)))
    return {"W4": ([0, 2, 4, 6], big), "W8": (list(range(7, -1, -1)), big),
            "S8": ([3, 70, 141, 200, 262, 333, 400, 511], big), "S16": (s16, big),
            "S32": (s32, big), "S64": (s64, big),
            "64 keys in two windows": (list(range(32)) + list(range(256, 288)), big),
            "1024 keys, a window each": ([32 * i + i % 32 for i in range(1024)], small)}


def _key_index_tables(keys: np.ndarray, width: int) -> tuple[torch.Tensor, int, int]:
    """The key-index form's tables of one launch (redesign_sweep_windowed.cu):
    windows and masks as the package's, first the key index (in key order
    of the nd distinct keys below 2^width) of each window's smallest key,
    pos (each row's key index, 0xFFFF past the domain), order (the rows in
    caller order within each group of 64 key indices, rows past the domain
    with the last) and gstart (each group's start in order)."""
    keys = np.asarray(keys, dtype=np.uint32)
    k = keys.shape[0]
    inside = keys.astype(np.int64) < (1 << width)
    distinct = np.unique(keys[inside])
    pos = np.full(k, 0xFFFF, dtype=np.int64)
    pos[inside] = np.searchsorted(distinct, keys[inside])
    windows, first = np.unique(distinct >> 5, return_index=True)
    bit = np.left_shift(np.uint32(1), distinct & np.uint32(31))
    masks = np.bitwise_or.reduceat(bit, first) if distinct.size else bit
    ngroups = max(-(-distinct.size // 64), 1)
    group = np.minimum(pos // 64, ngroups - 1)
    order = np.argsort(group, kind="stable")
    gstart = np.concatenate([[0], np.cumsum(np.bincount(group, minlength=ngroups))])
    plan = np.concatenate([np.asarray(a, dtype=np.int64)
                           for a in (windows, masks, first, pos, order, gstart)])
    return torch.from_numpy(plan.astype(np.uint32).view(np.int32)), len(windows), len(distinct)


def windowed_sweep(lib, device, column) -> None:
    """The windowed tier's designs on the same keys; ``column(width,
    nbytes)`` gives (tiles, n) of an ``i % 512`` column."""
    stream = torch.cuda.current_stream().cuda_stream
    worst, fold_over = 0.0, {}
    for width in (9, 17, 20, 31):
        for label, (keys, nbytes) in _window_sets().items():
            tiles, n = column(width, nbytes)
            nblocks = tiles.shape[1] * LANES
            k = len(keys)
            kt = torch.tensor(keys, dtype=torch.int32, device=device)
            expect = torch.tensor(_closed_counts(keys, n), device=device)
            arr = np.asarray(keys, np.uint32)
            kplan, nwin, knd = _key_index_tables(arr, width)
            kplan = kplan.to(device)

            def key_index():
                bits = torch.empty((k, tiles.shape[1], LANES), dtype=torch.int32, device=device)
                counts = torch.zeros(k, dtype=torch.int64, device=device)
                rc = lib.sweep_window_key_index(tiles.data_ptr(), kplan.data_ptr(), k, nwin, knd,
                                                bits.data_ptr(), counts.data_ptr(), nblocks,
                                                width, n, stream)
                if rc:
                    raise RuntimeError(f"sweep_window_key_index: CUDA error {rc}")
                return bits, counts

            calls = {
                "the window lookup (windowed_scan_tiles)":
                    lambda: scan.windowed_scan_tiles(tiles, arr, width, n),
                "row 13: shared_scan_dynamic_tiles (keys copied once)":
                    lambda: scan.shared_scan_dynamic_tiles(tiles, kt, width, n),
                "row 14: shared_scan_chunked_tiles (keys copied once)":
                    lambda: scan.shared_scan_chunked_tiles(tiles, kt, width, n),
                "rows by key index (one table load a value)": key_index,
                "row 16: the static fold (shared_scan_bitsliced_static_tiles)":
                    lambda: scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, n)}
            ref = None
            for name, fn in calls.items():
                got = fn()
                _check(torch.equal(got[1], expect), f"windowed {label} w={width}: {name}'s counts")
                if ref is None:
                    ref = got[0]
                else:
                    _check(torch.equal(got[0], ref), f"windowed {label} w={width}: {name} differs")
                del got
            del ref
            torch.cuda.empty_cache()
            report = _in_turns(calls)
            times = {name: sum(t) / 2 for name, t in report.items()}
            window = times["the window lookup (windowed_scan_tiles)"]
            worst = max(worst, times["row 13: shared_scan_dynamic_tiles (keys copied once)"] / window)
            fold_over[(width, label)] = (
                times["row 16: the static fold (shared_scan_bitsliced_static_tiles)"] / window)
            bound = (tiles.numel() * 4 + k * (nblocks * 4 + 8 + 4)) / HBM_BYTES_PER_S * 1e3
            _report(f"windowed {label} at width {width} (k={k}, {nwin} windows, "
                    f"{nbytes >> 20} MiB packed)", report, bound)
    print(f"windowed: the dynamic scan's time over the window lookup's, largest over the shapes: "
          f"{worst:.4f}")
    print("windowed: the static fold's time over the window lookup's: "
          + "; ".join(f"w{w} {label} {r:.4f}" for (w, label), r in fold_over.items()))


RUNTIME_KS = (8, 64, 128, 192, 256, 384, 512, 768, 1024)


def _runtime_keys(k: int, width: int) -> list:
    """k keys of the runtime section: distinct keys of 0..511 up to 512,
    past it all of them and k - 512 keys drawn past 511 (of 0..511 at
    width 9, duplicates)."""
    rng = np.random.default_rng(k)
    if k <= DOMAIN:
        return sorted(rng.choice(DOMAIN, k, replace=False).tolist())
    extra = (rng.choice(DOMAIN, k - DOMAIN).tolist() if width == 9 else
             (DOMAIN + rng.choice((1 << width) - DOMAIN, k - DOMAIN, replace=False)).tolist())
    return list(range(DOMAIN)) + extra


def runtime_sweep(device, column) -> None:
    """CUDA keys: the plane fold on the key tensor against row 13's lookup."""
    gains = {}
    for width in range(9, 32):
        tiles, n = column(width, 128 * 1024 * 1024)
        nblocks = tiles.shape[1] * LANES
        for k in RUNTIME_KS:
            keys = _runtime_keys(k, width)
            kt = torch.tensor(np.asarray(keys, np.uint32).view(np.int32), device=device)
            expect = torch.tensor(_closed_counts(keys, n), device=device)

            def fold():
                bits = torch.empty((k, tiles.shape[1], LANES), dtype=torch.int32, device=device)
                counts = torch.zeros(k, dtype=torch.int64, device=device)
                _cuda.launch("sss_bitsliced_static_fold", device, tiles.data_ptr(), kt.data_ptr(),
                             k, bits.data_ptr(), counts.data_ptr(), nblocks, width, n, 0)
                return bits, counts

            calls = {"the plane fold on the key tensor": fold,
                     "row 13: shared_scan_dynamic_tiles":
                         lambda: scan.shared_scan_dynamic_tiles(tiles, kt, width, n)}
            ref = None
            checked = {**calls, "the package's shared_scan_bitsliced_tiles":
                       lambda: scan.shared_scan_bitsliced_tiles(tiles, kt, width, n)}
            for name, fn in checked.items():
                got = fn()
                _check(torch.equal(got[1], expect), f"runtime k={k} w={width}: {name}'s counts")
                if ref is None:
                    ref = got[0]
                else:
                    _check(torch.equal(got[0], ref), f"runtime k={k} w={width}: {name} differs")
                del got
            del ref
            torch.cuda.empty_cache()
            times = _in_turns(calls)
            fold_ms, lookup_ms = (sum(t) / 2 for t in times.values())
            gains[(width, k)] = fold_ms / lookup_ms - 1
            bound = (tiles.numel() * 4 + k * (nblocks * 4 + 8 + 4)) / HBM_BYTES_PER_S * 1e3
            _report(f"runtime k={k} at width {width}", times, bound)
    print("runtime: the lookup's gain over the fold (fold / lookup - 1): "
          + "; ".join(f"w{w} k{k} {g:+.4f}" for (w, k), g in gains.items()))
    wins = {w: tuple(k for k in RUNTIME_KS if gains[(w, k)] > 0.05) for w in range(9, 32)}
    print(f"runtime: k where the lookup is more than 5% faster, by width: "
          f"{ {w: ks for w, ks in wins.items() if ks} }")


SCAN_NAMES = {0: "before the redesign (a CTA a tile of 256 blocks)",
              1: "resident CTAs, each thread loading its block (256 threads)",
              2: "ring of bulk copies, 128 threads, 2 stages",
              3: "ring of bulk copies, 128 threads, 3 stages",
              4: "ring of bulk copies, 256 threads, 2 stages",
              5: "ring of bulk copies, 256 threads, 3 stages",
              6: "ring by a TMA map, 256 threads, 2 stages, resident grid",
              7: "ring by a TMA map, 256 threads, 3 stages",
              8: "ring by a TMA map, 128 threads, 3 stages",
              9: "ring by a TMA map, 128 threads, 2 stages",
              10: "a CTA a tile, the redesigned body (each thread loading its block)",
              **{11 + i: f"ring by a TMA map, 256 threads, 2 stages, a CTA a run of {r} tiles"
                 for i, r in enumerate((1, 2, 4, 8, 16))}}
SCAN_SASS = {"interval_parent_kernelILi9E": "interval before the redesign (width 9)",
             "interval_scan_kernelILi9ELb1ELi256ELi2E": "interval, the package's (width 9)",
             "compare_parent_kernelILi9E": "compare before the redesign (width 9)",
             "shared_scan_kernelILi9ELi256ELi2E": "compare, the package's (width 9)"}


def _modk_counts(keys, n: int, m: int) -> list:
    """Each key's count on an ``i % m`` column of n values."""
    return [(n - 1 - key) // m + 1 if key < m else 0 for key in keys]


def _scan_variants(lib, device, interval: bool, tiles, width: int, n: int, keys) -> dict:
    """name -> call of each sweep_scan variant (interval: keys lo..lo+k-1
    from keys[0]; else the CUDA key tensor ``keys``)."""
    stream = torch.cuda.current_stream().cuda_stream
    nblocks = tiles.shape[1] * LANES
    k = int(keys.shape[0])
    lo = int(keys[0]) if interval else 0

    def variant(v):
        bits = torch.empty((k, tiles.shape[1], LANES), dtype=torch.int32, device=device)
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        rc = lib.sweep_scan(int(interval), v, tiles.data_ptr(), keys.data_ptr(), lo, k,
                            bits.data_ptr(), counts.data_ptr(), nblocks, width, n, stream)
        if rc:
            raise RuntimeError(f"sweep_scan variant {v}: CUDA error {rc}")
        return bits, counts

    return {name: functools.partial(variant, v) for v, name in SCAN_NAMES.items()}


def _checked_turns(title: str, calls: dict, expect: list, bound_ms: float) -> dict:
    """Every call's counts equal to ``expect`` and its bits to the first
    call's, then the calls timed in turns and reported."""
    ref = None
    for name, fn in calls.items():
        bits, counts = fn()
        _check(counts.tolist() == expect, f"{title}: {name}'s counts")
        if ref is None:
            ref = bits
        else:
            _check(torch.equal(bits, ref), f"{title}: {name}'s bits differ")
        del bits
    del ref
    torch.cuda.empty_cache()
    times = _in_turns(calls)
    _report(title, times, bound_ms)
    return times


def interval_sweep(lib, device) -> None:
    """The interval kernel's designs on i % 8 (width 9, 512 MiB packed: k
    1, 8, 33, 64; 64 MiB: k 1024) and i % 512 (widths 17, 25 and 31: k 8),
    beside the package's wrapper and the static fold on the same keys."""
    shapes = ((9, 8, N_BYTES_FULL, (1, 8, 33, 64)), (9, 8, 64 * 1024 * 1024, (1024,)),
              (17, DOMAIN, N_BYTES_FULL, (8,)), (25, DOMAIN, N_BYTES_FULL, (8,)),
              (31, DOMAIN, N_BYTES_FULL, (8,)))
    for width, m, nbytes, ks in shapes:
        n = harness.values_for(nbytes, width)
        tiles = pack_device_kernel(harness.synth_modk(n, m, width, device=device), width).tiles
        nblocks = tiles.shape[1] * LANES
        for k in ks:
            keys = torch.arange(k, dtype=torch.int32, device=device)
            calls = _scan_variants(lib, device, True, tiles, width, n, keys)
            calls["the package's interval_scan_tiles"] = (
                lambda: scan.interval_scan_tiles(tiles, 0, k, width, n))
            calls["the static fold on keys 0..k-1 (shared_scan_bitsliced_static_tiles)"] = (
                lambda: scan.shared_scan_bitsliced_static_tiles(tiles, list(range(k)), width, n))
            bound = ((width + k) * nblocks * 4 + 8 * k) / HBM_BYTES_PER_S * 1e3
            _checked_turns(f"interval k={k} at width {width}, i % {m}, n {n}", calls,
                           _modk_counts(range(k), n, m), bound)
        del tiles
        torch.cuda.empty_cache()


COMPARE_WIDTHS = scan._COMPARE_SWEEP_WIDTHS
COMPARE_KS = scan._COMPARE_SWEEP_KS
COMPARE_ROW_BYTES = 16 << 30  # the most the k rows of one launch may take


def _compare_keys(k: int, width: int) -> list:
    """k keys of the compare section: distinct keys of the column's values
    (0 .. min(2^width, 512) - 1) while there are enough, then keys drawn
    from the whole domain."""
    rng = np.random.default_rng(1000 * width + k)
    m = min(1 << width, DOMAIN)
    first = rng.choice(m, min(k, m), replace=False).tolist()
    return first + rng.integers(0, 1 << width, k - len(first)).tolist()


def compare_sweep(lib, device) -> None:
    """The compare kernel's designs at width 9 (i % 512, 512 MiB packed, k
    1, 2, 4, 8), 17 and 25 (k 1, 4) and 31 (k 1, 4, 10), beside the
    package's wrapper and the plane fold; then the compare kernel against
    the fold and the dynamic scan's lookup at every swept width and k, and
    the table of ``scan._COMPARE_FOLD_KS``."""
    for width, ks in ((9, (1, 2, 4, 8)), (17, (1, 4)), (25, (1, 4)), (31, (1, 4, 10))):
        n = harness.values_for(N_BYTES_FULL, width)
        tiles = pack_device_kernel(harness.synth_modk(n, DOMAIN, width, device=device),
                                   width).tiles
        nblocks = tiles.shape[1] * LANES
        for k in ks:
            keys = _compare_keys(k, 9)
            kt = torch.tensor(keys, dtype=torch.int32, device=device)
            calls = _scan_variants(lib, device, False, tiles, width, n, kt)
            calls["the package's shared_scan_tiles"] = (
                lambda: scan.shared_scan_tiles(tiles, kt, width, n))
            calls["the plane fold (shared_scan_bitsliced_tiles)"] = (
                lambda: scan.shared_scan_bitsliced_tiles(tiles, kt, width, n))
            bound = (width * nblocks * 4 + k * (nblocks * 4 + 12)) / HBM_BYTES_PER_S * 1e3
            _checked_turns(f"compare k={k} at width {width}, i % {DOMAIN}, n {n}", calls,
                           _modk_counts(keys, n, DOMAIN), bound)
        del tiles
        torch.cuda.empty_cache()
    compare_rule_sweep(device)


def compare_rule_sweep(device) -> None:
    """The compare kernel against the route's other kernels, the plane fold
    and the dynamic scan's lookup (one launch each), at every swept width
    and k, and the table of ``scan._COMPARE_FOLD_KS``: the k where the
    faster of the two beats the compare kernel by more than 5%."""
    gains = {}
    for width in COMPARE_WIDTHS:
        m = min(1 << width, DOMAIN)
        cache = {}
        for k in COMPARE_KS:
            nbytes = min(N_BYTES_SWEEP, COMPARE_ROW_BYTES * width // k // 32 * 32)
            if nbytes not in cache:
                cache.clear()
                torch.cuda.empty_cache()
                n = harness.values_for(nbytes, width)
                cache[nbytes] = (pack_device_kernel(
                    harness.synth_modk(n, m, width, device=device), width).tiles, n)
            tiles, n = cache[nbytes]
            nblocks = tiles.shape[1] * LANES
            keys = _compare_keys(k, width)
            kt = torch.tensor(np.asarray(keys, np.uint32).view(np.int32), device=device)

            def compare(tiles=tiles, kt=kt, n=n, k=k):
                bits = torch.empty((k, tiles.shape[1], LANES), dtype=torch.int32, device=device)
                counts = torch.zeros(k, dtype=torch.int64, device=device)
                _cuda.launch("sss_shared_scan", device, tiles.data_ptr(), kt.data_ptr(), k,
                             bits.data_ptr(), counts.data_ptr(), tiles.shape[1] * LANES, width,
                             n, 0)
                return bits, counts

            calls = {"the compare kernel": compare,
                     "the plane fold":
                         lambda tiles=tiles, kt=kt, n=n: scan.shared_scan_bitsliced_tiles(
                             tiles, kt, width, n),
                     "the dynamic scan's lookup":
                         lambda tiles=tiles, kt=kt, n=n: scan.shared_scan_dynamic_tiles(
                             tiles, kt, width, n)}
            bound = (width * nblocks * 4 + k * (nblocks * 4 + 12)) / HBM_BYTES_PER_S * 1e3
            times = _checked_turns(f"compare k={k} at width {width}, i % {m}, n {n}", calls,
                                   _modk_counts(keys, n, m), bound)
            compare_ms, fold_ms, lookup_ms = (sum(t) / 2 for t in times.values())
            gains[(width, k)] = compare_ms / min(fold_ms, lookup_ms) - 1
        del cache
        torch.cuda.empty_cache()
    print("compare: the faster of the fold and the lookup over the compare kernel "
          "(compare / min(fold, lookup) - 1): "
          + "; ".join(f"w{w} k{k} {g:+.4f}" for (w, k), g in gains.items()))
    wins = {w: tuple(k for k in COMPARE_KS if gains[(w, k)] > 0.05) for w in COMPARE_WIDTHS}
    print(f"compare: k where the fold or the lookup is more than 5% faster, by width "
          f"(scan._COMPARE_FOLD_KS): { {w: ks for w, ks in wins.items() if ks} }")


MEMBER_WIDTHS = (9, 16, 17, 20, 31)
MEMBER_COUNTS = (1, 4, 8, 32, 64, 200, 4096, 4097)


def _member_operand(kind: str, count: int, width: int) -> np.ndarray:
    """``count`` keys (distinct of 0..511, then spread over the domain) or
    windows (random nonzero popmasks; aligned bases, the first 16 in
    0..511, then spread) of the member section."""
    rng = np.random.default_rng(count + width)
    if kind == "keys":
        low = rng.choice(DOMAIN, min(count, DOMAIN), replace=False)
        return np.concatenate([low, rng.integers(0, 1 << width, count - low.size)])
    nwin = 1 << max(0, width - 5)
    bases = rng.choice(nwin, min(count, nwin), replace=False)
    bases = np.concatenate([np.arange(min(count, 16)), bases[bases >= 16],
                            rng.integers(0, nwin, count)])[:count] * 32
    return np.stack([bases, rng.integers(1, 1 << 32, count)], axis=1)


def _member_matched(kind: str, operand: np.ndarray) -> list:
    """The values below 512 the operand matches."""
    if kind == "keys":
        return sorted({int(k) for k in operand if k < DOMAIN})
    return sorted({int(b) + j for b, p in operand.tolist() for j in range(32)
                   if p >> j & 1 and int(b) + j < DOMAIN})


def member_sweep(device) -> None:
    """The member compare and window kernels: the table's layouts."""
    wins = {}
    for width in MEMBER_WIDTHS:
        tiles, n = _column(device, width)
        nblocks = tiles.shape[1] * LANES
        for kind, fn in (("keys", "sss_member_compare"), ("windows", "sss_member_window")):
            for count in MEMBER_COUNTS:
                arr = _member_operand(kind, count, width)
                a = torch.from_numpy(arr.astype(np.int64).astype(np.uint32).view(np.int32)).to(
                    device)
                nrows = member._operand_rows(a)
                expect = sum(_closed_counts(_member_matched(kind, arr), n))

                def launch(fused):
                    table, scratch, size = member._operand_table_buffers(width, a, device)
                    bits = torch.empty((tiles.shape[1], LANES), dtype=torch.int32, device=device)
                    counts = torch.zeros(1, dtype=torch.int64, device=device)
                    _cuda.launch(fn, device, tiles.data_ptr(), a.data_ptr(), count,
                                 table.data_ptr(), size, scratch.data_ptr(), bits.data_ptr(),
                                 counts.data_ptr(), nblocks, width, n, 0, fused)
                    return bits, counts[0]

                if kind == "keys":
                    built = member.member_operand_table(width, keys=a)
                    wrapper = lambda: member._member_compare_tiles(tiles, a, width, n)  # noqa: E731
                else:
                    built = member.member_operand_table(width, win=a)
                    wrapper = lambda: member._member_window_tiles(tiles, a, width, n)  # noqa: E731
                calls = {"build launch, then the lookup": lambda: launch(0)}
                if width <= member.MAX_DOMAIN_WIDTH:
                    calls["the bitmap built in each CTA (fused)"] = lambda: launch(1)
                calls["the lookup alone, its table built once (sss_member_lookup)"] = (
                    lambda: member._launch_one_row("sss_member_lookup", tiles, built,
                                                   built.shape[-1], width, n, 0))
                calls["the package's wrapper"] = wrapper
                ref = None
                for name, call in calls.items():
                    got = call()
                    _check(int(got[1]) == expect,
                           f"member {kind} {count} w={width}: {name}'s count {int(got[1])} "
                           f"!= {expect}")
                    if ref is None:
                        ref = got[0]
                    else:
                        _check(torch.equal(got[0], ref),
                               f"member {kind} {count} w={width}: {name} differs")
                    del got
                del ref
                report = _in_turns(calls)
                if width <= member.MAX_DOMAIN_WIDTH:
                    fused, two = (sum(report[k]) / 2 for k in (
                        "the bitmap built in each CTA (fused)", "build launch, then the lookup"))
                    wins[(width, kind, nrows)] = two / fused - 1
                nbytes = tiles.numel() * 4 + nblocks * 4 + 8 + a.numel() * 4
                _report(f"member {kind} k={count} at width {width} ({nrows} rows)", report,
                        nbytes / HBM_BYTES_PER_S * 1e3)
        del tiles
        torch.cuda.empty_cache()
    print("member: the fused bitmap's gain over the build launch (two / fused - 1): "
          + "; ".join(f"w{w} {kind} {r} rows {g:+.4f}" for (w, kind, r), g in wins.items()))
    print(f"member: rows where the fused bitmap is faster: "
          f"{sorted({r for (_, _, r), g in wins.items() if g > 0})}; slower: "
          f"{sorted({r for (_, _, r), g in wins.items() if g <= 0})}")


ZONED_LIVE = (1, 3, 50, 227)  # listed steps of the 456
ZONED_TB = 256
ZONED_RUNS = (2, 4, 8, 16)
ZONED_TABLE_RUNS = (4, 16)
ZONED_FILLS = (1, 2, 4, 8)
ZONED_FLUSH_BYTES = 256 * 1024 * 1024  # written before each profiled call: past the L2


def zoned_sweep(lib, device) -> None:
    """The zoned range scan's designs on a uniform column of the reference
    benchmark's n at widths 9 and 31 (b1 = 116,736: 456 steps of 256 block
    rows), k = 1, with ZONED_LIVE of the steps listed in random order."""
    from shared_simd_scan_tpu_torch import zonemap

    stream = torch.cuda.current_stream().cuda_stream
    n = harness.values_for(N_BYTES_FULL, WIDTH)
    names = {(0, 1): "the package's entry: memsets of the rows and counts, the flat grid"}
    names.update({(5, f): f"one launch: {f} zero-filling CTAs a multiprocessor, bulk stores, "
                  "beside the flat grid" for f in ZONED_FILLS})
    names.update({(4, f): f"one launch: {f} zero-filling CTAs a multiprocessor, 16-byte "
                  "stores, beside the flat grid" for f in ZONED_FILLS})
    names.update({(1, r): f"walk in runs of {r} tiles, loads by its threads" for r in ZONED_RUNS})
    names.update({(2, r): f"walk in runs of {r} tiles, the TMA ring" for r in ZONED_RUNS})
    names.update({(3, r): f"walk in runs of {r} tiles on a step table built first"
                  for r in ZONED_TABLE_RUNS})
    for width in (9, 31):
        gen = torch.Generator(device=device)
        gen.manual_seed(width)
        vals = torch.randint(0, 1 << width, (n,), generator=gen, device=device, dtype=torch.int32)
        tiles = pack_device_kernel(vals, width).tiles
        del vals
        b1 = tiles.shape[1]
        nblocks, step_blocks = b1 * LANES, ZONED_TB * LANES
        steps = b1 // ZONED_TB
        lows = torch.tensor([0], dtype=torch.int32, device=device)
        highs = torch.tensor([1 << (width - 3)], dtype=torch.int32, device=device)
        table = torch.empty(steps, dtype=torch.int64, device=device)
        for live in ZONED_LIVE:
            rng = np.random.default_rng(live)
            idx = torch.from_numpy(rng.choice(steps, live, replace=False).astype(np.int32)).to(
                device)
            flag = torch.ones_like(idx)

            bits = torch.empty((1, b1, LANES), dtype=torch.int32, device=device)
            counts = torch.empty(1, dtype=torch.int64, device=device)

            def variant(v, r):  # into the same rows every call: each variant writes every word
                rc = lib.sweep_zoned(v, r, tiles.data_ptr(), idx.data_ptr(), flag.data_ptr(),
                                     live, lows.data_ptr(), highs.data_ptr(), 1, bits.data_ptr(),
                                     counts.data_ptr(), table.data_ptr(), nblocks, step_blocks,
                                     width, n, stream)
                if rc:
                    raise RuntimeError(f"sweep_zoned variant {v}, run {r}: CUDA error {rc}")
                return bits, counts

            _, want = zonemap.zoned_range_tiles_plain(tiles, idx, flag, lows, highs, width, n,
                                                      ZONED_TB)
            ref = variant(0, 1)[0].clone()
            _check(torch.equal(counts, want),
                   f"zoned w{width} {live}: the package's entry's count")
            for (v, r), name in names.items():
                bits.fill_(-1)
                counts.fill_(-1)
                variant(v, r)
                _check(torch.equal(bits, ref) and torch.equal(counts, want),
                       f"zoned w{width} {live}: {name} differs from the package's entry")
            del ref
            calls = {name: functools.partial(variant, v, r) for (v, r), name in names.items()}
            calls["the package's zoned_range_tiles"] = lambda: zonemap.zoned_range_tiles(
                tiles, idx, flag, lows, highs, width, n, ZONED_TB)
            calls["the package's count form (full_bits=False)"] = lambda: zonemap.zoned_range_tiles(
                tiles, idx, flag, lows, highs, width, n, ZONED_TB, False)
            calls["the full-column range_scan_tiles"] = lambda: scan.range_scan_tiles(
                tiles, lows, highs, width, n)
            calls["the row's zeros alone (zero_)"] = bits.zero_
            nbytes = live * step_blocks * width * 4 + nblocks * 4 + 8 * live + 16
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            _report(f"zoned w{width}, {live} of {steps} steps listed, k = 1 (row bound "
                    f"{nbytes} bytes; the count form's {nbytes - nblocks * 4})", _in_turns(calls),
                    bound)
            print("  device time a call (torch.profiler, every device operation; 256 MiB "
                  "written before each call):")
            for name, fn in calls.items():
                ms = sum(device_ms(fn, flush_bytes=ZONED_FLUSH_BYTES).values())
                print(f"    {name}: " + (f"{ms:.6f} ms ({bound / ms:.3f} of the row bound)"
                                         if ms else "not measured"))
            torch.cuda.empty_cache()
        del tiles, table
        torch.cuda.empty_cache()


def main(sections) -> None:
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"redesign_sweep: unknown sections {sorted(unknown)}; choose from {SECTIONS}")
    if not torch.cuda.is_available():
        raise SystemExit("redesign_sweep: no CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    sources = [src for src, names in ((SOURCE, ("copy", "chunked", "dynamic")),
                                      (BINS_FOLD_SOURCE, ("bins", "domain", "fold")),
                                      (STATIC_MEMBER_SOURCE, ("static", "ortree")),
                                      (HIST_AGG_SOURCE, ("histdag", "aggstatic", "minmax")),
                                      (WINDOWED_SOURCE, ("windowed",)),
                                      (SCAN_SOURCE, ("interval", "compare")),
                                      (ZONED_SOURCE, ("zoned",)))
               if set(names) & set(sections)]
    libs = _libraries(sources) if sources else {}
    print("ptxas:")
    for _, _, log in libs.values():
        print("\n".join(_resources(log)))
    n = harness.values_for(512 * 1024 * 1024, WIDTH)
    if SOURCE in libs:
        lib = libs[SOURCE][0]
        ctas = {name: lib.sweep_dynamic_ctas(v, WIDTH) for v, name in DYNAMIC_NAMES.items() if v}
        ctas["the package's chunked kernel"] = lib.sweep_dynamic_ctas(0, WIDTH)
        print(f"CTAs an SM at width {WIDTH} (occupancy calculator): {ctas}")
    if HIST_AGG_SOURCE in libs:
        lib, path, _ = libs[HIST_AGG_SOURCE]
        print("sass of the histogram and aggregate kernels (cuobjdump -sass):")
        sass_report(path, HIST_AGG_SASS)
        if "histdag" in sections:
            histdag_sweep(lib, device)
        if "aggstatic" in sections:
            aggstatic_sweep(lib, device)
        if "minmax" in sections:
            minmax_sweep(lib, device)
    if {"windowed", "runtime"} & set(sections):
        cache = {}

        def column(width, nbytes):
            if (width, nbytes) not in cache:
                m = harness.values_for(nbytes, width)
                cache[width, nbytes] = (pack_device_kernel(
                    harness.synth_modk(m, DOMAIN, width, device=device), width).tiles, m)
            return cache[width, nbytes]

        if "windowed" in sections:
            windowed_sweep(libs[WINDOWED_SOURCE][0], device, column)
        if "runtime" in sections:
            cache.clear()
            torch.cuda.empty_cache()
            runtime_sweep(device, column)
        del cache
        torch.cuda.empty_cache()
    if "member" in sections:
        member_sweep(device)
    if SCAN_SOURCE in libs:
        lib, path, _ = libs[SCAN_SOURCE]
        print("sass of the interval and compare kernels (cuobjdump -sass):")
        sass_report(path, SCAN_SASS)
        if "interval" in sections:
            interval_sweep(lib, device)
        if "compare" in sections:
            compare_sweep(lib, device)
    if "zoned" in sections:
        zoned_sweep(libs[ZONED_SOURCE][0], device)
    if "copy" in sections:
        copy_sweep(libs[SOURCE][0], device)
    if {"chunked", "dynamic", "fold", "static", "ortree"} & set(sections):
        tiles = pack_device_kernel(harness.synth_modk(n, DOMAIN, WIDTH, device=device),
                                   WIDTH).tiles
    if STATIC_MEMBER_SOURCE in libs:
        lib, path, _ = libs[STATIC_MEMBER_SOURCE]
        print("sass of the static and member kernels (cuobjdump -sass):")
        sass_report(path, STATIC_MEMBER_SASS)
        columns = {9: (tiles, n), 20: _column(device, 20)}
        if "static" in sections:
            columns[31] = _column(device, 31)
            static_sweep(lib, device, columns)
        if "ortree" in sections:
            ortree_sweep(lib, device, columns)
        del columns
        torch.cuda.empty_cache()
    if "chunked" in sections:
        scan_sweep("chunked scan", libs[SOURCE][0].sweep_chunked, CHUNKED_NAMES, ABLATION_NAMES,
                   {"shared_scan_chunked_tiles": scan.shared_scan_chunked_tiles}, tiles, n)
    if "dynamic" in sections:
        scan_sweep("dynamic scan", libs[SOURCE][0].sweep_dynamic, DYNAMIC_NAMES, DYNAMIC_ABLATIONS,
                   {"shared_scan_dynamic_tiles": scan.shared_scan_dynamic_tiles,
                    "shared_scan_chunked_tiles": scan.shared_scan_chunked_tiles}, tiles, n)
    if BINS_FOLD_SOURCE in libs:
        lib, path, _ = libs[BINS_FOLD_SOURCE]
        print("sass of the width-9 kernels (cuobjdump -sass):")
        sass_report(path, SASS_KERNELS)
        if "bins" in sections:
            bins_sweep(lib, device, n)
        if "fold" in sections:
            fold_sweep(lib, device, tiles, n)
        if "domain" in sections:
            if {"chunked", "dynamic", "fold", "static", "ortree"} & set(sections):
                del tiles
                torch.cuda.empty_cache()
            domain_sweep(lib, device, n)


if __name__ == "__main__":
    main(sys.argv[1:] or SECTIONS)
