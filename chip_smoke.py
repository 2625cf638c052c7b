#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --spans    # the build and the span phase alone

Run from the root of the repository on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It builds the kernels of ``shared_simd_scan_tpu_torch``
from the sources in the checkout and then:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. runs the shift canary and prints what PTX ``shl.b32`` and C++ ``<<`` do
   with amounts >= 32, and holds its verdict kernel (one warp's ballot of
   the 16 amounts, ``scan.shift_verdict``) against the plain verdict and
   the elementwise canary's;
3. holds every kernel bit-exact against its plain torch version on the card
   at small ragged sizes (widths 1-31, padding, spread, clustered,
   duplicate and out-of-domain keys, k up to 1024; for the aggregates
   pairs of predicate and measure widths, k = 1, 2, 4 and 32, and sums
   past 2^32; the member compare and window kernels' tables, built on the
   card from 1 to 9000 keys or windows at widths 1-31 -- unsorted,
   unaligned, straddling 2^width, wrapping past 2^32, repeated and empty
   windows --, bit-exact against the plain build);
   then the interval and compare kernels at every width 1-31 on a ragged
   column of two and a half tiles (the interval kernel gateless and gated
   at k 1-1024 with lo 0, 2^w - 4 and 2^32 - 3; the compare wrapper at k
   1-1025 with key 0 over the padding, duplicates, 2^w, 2^31 and
   0xFFFFFFFF, and on both sides of ``scan._compare_fold_wins`` the
   compare kernel and the bit-sliced tier's launch; block_offset 0 and 3;
   the wrapper's launches by kernel);
4. drives the main path at full size — a 9-bit column of 512 MiB packed:
   ``pack_device_kernel`` -> ``shared_scan_device`` keys 0..7 (interval
   kernel) -> ``scan_device(3)`` (compare kernel) -> ``unpack_device`` —
   with every launch counter set to 0 just before and read just after, and
   checks the counts against their closed form, every bitvector word
   against the plain version, a 2M-value prefix against the oracle, and
   the unpacked values against the input;
5. drives the arbitrary-key path at full size — a second 9-bit column of
   512 MiB packed with values ``i % 512``: ``shared_scan_device`` on spread
   sets (static tier: the plane fold), clustered sets (windowed tier: the
   plane fold below 64 keys, else a window lookup a value) and the spread
   sets as CUDA tensors (runtime tier: the plane fold on the key tensor),
   then ``windowed_scan_tiles`` on 64 keys (one launch of the window
   lookup) — with the launch counters set to 0 just before and
   read just after (each wrapper counts in its launch loop: the windowed
   tier's fold under the static tier's counter, the runtime tier's lookup
   under the dynamic scan's), and checks that each tier
   ``pick_concrete_tier`` names is the kernel that ran, the counts against their closed form, and
   ``check_shared_scan`` for every set; before it, the windowed and runtime
   tiers' edges at small ragged sizes (the window lookup at widths 1, 5,
   12, 13, 17, 18 and 31, each side of its direct table and its search, k
   = 1, 8, 64, 65, 1024 and 1025, keys in one window, a window each --
   1024 windows from 15 bits --, in the top windows of the domain and drawn
   from the column; the runtime tier at every width 1-31, k = 5, 8, 64,
   128 and 1025, and 1024 at width 31, where the fold stages its masks in
   chunks; every set with a duplicate across passes of 64 rows and
   launches of 1024, keys past the domain and 0xFFFFFFFF, a block_offset);
6. drives the query path at full size — a table of three columns of the
   main path's n (``price`` 9-bit, ``region`` 5-bit, ``status`` 4-bit, the
   analytics demo's widths), drawn on the card from a seeded generator:
   ``query.evaluate`` on four WHERE clauses (fused conjunction, range scan,
   member window and domain tiers), then ``member_scan_device`` on the
   ``i % 512`` column with host key sets of every tier
   ``member_dispatch_tier`` names there and CUDA-tensor keys of every
   runtime tier (under ``torch.cuda.set_sync_debug_mode("error")``), the
   chunked member bodies directly, and ``member_scan_device`` on ``i %
   512`` columns of 512 MiB packed at width 31 (3205 keys in 205 windows:
   the chunked window body; S256 as CUDA keys: the bit-sliced body, on
   this card the compare kernel's table and lookup) and width 20 (S8 as
   CUDA keys: the compare body) — with the launch counters set to 0 just
   before and read just after; checks each query's words and count
   against the predicate
   computed with plain torch on the raw values, and each member set's
   kernel, closed-form count and words;
7. drives the encodings, NULLs, persistence and utilities at full size
   (``encodings_phase``), each set with the launch counters set to 0 just
   before it and read just after: a day of timestamps from 1,700,000,000
   drawn on the card at the main path's n, FOR-encoded at 17 bits
   (``forcol.pack_for``: 1,014,089,500 bytes packed), ``forcol.evaluate``
   on a Range, an Eq and an In of 40 keys, ``describe``, ``quantiles`` and
   ``unpack_for``; a ``NullableColumn`` of the query table's ``price``
   with 10% NULLs, ``nullable.evaluate`` on a leaf, its ``Not``, an ``And``
   with two plain ranges (whose pure siblings must run as one fused
   conjunction launch) and an ``Or`` with an ``In`` on ``status``, and
   ``forcol.masked_aggregate`` of the timestamps over the ``And``; the
   NULL-aware WHERE and that sum once more inside ``utils.profiling.trace``
   under ``ProfileSample(sync=True)`` (the trace must name the ``sss_``
   entry points; the kernels' summed device time is printed beside the
   host clock), and ``dump_memory`` of a CUDA tensor against its CPU copy;
   ``io`` saving the main path's column, the query table and the NULL-aware
   result (each file exactly the header and the payload) and loading each
   back onto the card (the loaded column's ``shared_scan_device`` keys
   0..7 equal to the original's); and 40-bit SKUs of 150 distinct values at
   n = 2^27 (cut from the main path's n: the host ``np.unique`` encode),
   dictionary-encoded at 8 bits, ``dictcol.evaluate`` on an Eq, a Range,
   an In with absent keys and a tree with a FOR column, ``topk_values``,
   ``describe`` and ``unpack_dict``; checks each result against plain
   torch (or numpy) on the raw values and the NULL mask, prints one
   ``{"encodings": ...}`` line (each set's host-clock ms beside the card's
   name and power limit, the launches by kernel, the bytes packed, the
   dictionary's cut) and frees what it drew;
8. drives the aggregate path at full size — the query phase's table plus
   the analytics demo's 20-bit ``revenue`` column, drawn on the card from
   the same seed: ``masked_aggregate_device`` over ``query.evaluate`` of
   the demo's WHERE clause, ``aggregate_scan_device`` with host keys
   (static bit-plane and compare tiers) and CUDA-tensor keys (runtime
   bit-plane and compare tiers, under ``set_sync_debug_mode("error")``) and
   ``minmax_scan_device``, A7, ``aggregate_scan_device`` with the
   20-bit revenue as the predicate of 16 spread host keys (the key lookup
   past its byte table), and A8, ``minmax_scan_device`` with the same
   predicate and keys as a CUDA tensor (the MIN/MAX lookup's window, found
   by each CTA), and A9, ``aggregate_scan_device`` with the same predicate
   and keys as a CUDA tensor (the runtime bit-plane tier: the SUM lookup's
   window, found by each CTA) — with the launch counters set to 0 just
   before and read just after; checks that each call ran the kernel its
   tier names and that every result equals plain torch on the raw values
   (``scatter_add_``, ``bincount``, ``scatter_reduce_``, the masked sum);
   before it, the two key lookup aggregates' edges at small ragged sizes
   (constant, 90%-skewed, sorted and uniform predicates at widths 1-31, a
   measure that falls with the row index, duplicates, keys past the
   domain, host keys and keys in device memory, k = 1 to 32, keys whose
   16-bit windows meet at every shift, a block_offset, one CTA's sum past
   2^32);
9. holds the histogram and zone-map kernels against their plain versions
   at small ragged sizes (widths 1-31, k 1-4096, key 0 over padding, keys
   past the domain, a lo within k of 2^32 -- wrapping for a runtime lo,
   counting nothing for the span tier --, a ``block_offset``, a padded
   flag-0 step; at every width 1-31 on a column whose last tile is
   partial, the bins kernel's whole-domain window, one key short of it,
   and lo = 2^32 - 3; the domain histogram at widths 13, 16 and 20 with
   ragged n, constant and skewed columns), then drives the statistics path
   at full size — ``histogram_device`` on the ``i % 512`` column with a
   host lo (the bins kernel's span form, and as the chunked tier) and a
   CUDA-tensor lo (bins kernel, under ``set_sync_debug_mode("error")``),
   ``stats`` on ``price``, on the 20-bit ``revenue`` (one pass of the
   domain histogram), and H6-H8: ``stats.histogram_full`` of a uniform
   12-bit column of 512 MiB packed, of ``status`` and of a 1-bit flag
   column, each one launch of the chunked tier — and the zone-map
   path on three columns of the same n (clustered, clustered at both ends,
   uniform ``price``): ``build_zonemap``, pruned and zoned equality scans
   and ``evaluate`` with zone maps, with the launch counters set to 0 just
   before and read just after each call; checks that each call ran the
   kernel its rule names and equals plain torch on the raw values
   (``bincount``, per-zone ``amin``/``amax``, the full range scan,
   ``evaluate`` without zone maps), the zoned scan also in its count form
   (``full_bits=False``); the zoned kernel launched on rows filled with -1
   first at every width 1-31 and at full size (every word written); then
   the span forms of the conjunction and the masked sum (``span_phase``)
   on flight 1's four columns at 600M rows, the date sorted: first the
   conjunction over the whole columns (widths 12, 6, 4) with the dates in
   random order, as ``flight1`` stores them, bit-exact against its plain
   version and timed beside its bound and the plain version's time, then
   over a year's, a month's and a week's block rows; then for the
   block-row spans ``zonemap.prune_span`` gives a year, a month, a week
   and the table's last week (the padded end), ``conj_range_scan_tiles``
   and ``masked_aggregate_tiles`` with ``rows=``, bit-exact against their
   plain versions with the same span and against the whole-column kernel
   inside the span (zeros outside), and ``query.evaluate_pruned`` with
   ``masked_aggregate_device`` equal to them, with the launch counters set
   to 0 just before each span and read just after;
10. holds the linear export's kernels against their plain versions at small
   ragged sizes (the interleave at k 1-1024 and the stream interleave with
   ragged M; the fused interval, static and runtime-key kernels at every k
   their tiers admit, widths 1-31 (the static and runtime-key folds at
   every one of them), a ``block_offset``, keys past the domain, 0xFFFFFFFF
   and duplicates), then
   drives the linear export at
   full size on the main path's column and the ``i % 512`` column: L1-L4
   ``shared_scan_linear_words_device`` (keys 0..7; S8 as host keys and as
   CUDA keys under ``set_sync_debug_mode("error")``; S64 both ways), L5
   ``shared_scan_linear_device`` (keys 0..5, uint8) and L6 (S64 as eight
   fused groups of 8 joined by ``interleave_streams_words``), with the
   launch counters set to 0 just before each call and read just after;
   checks that each set ran the kernel its rule names, its counts against
   their closed form, every word against the plain twin and the linear
   bytes, de-interleaved, against ``shared_scan_device``'s bits;
11. times each kernel and its plain version at the full-size shapes with
    CUDA events, beside a ``copy_`` of the packed column, and computes each
    kernel's bound: its bytes over the card's 3.35 TB/s; each fused linear
    kernel also beside its two-pass composition (scan kernel, then the
    interleave kernel), the interleave beside the PyTorch call that gives
    the same bytes (``.t().contiguous()``); the static tier and the member
    OR-tree tier also on S64 of a 20-bit ``i % 512`` column of 512 MiB
    packed, the member compare and chunked window kernels on the query
    phase's 20- and 31-bit member sets and the bit-sliced body on its
    w31_S256 (each held against its plain version and the closed-form
    counts); on a 31-bit one, where the lookups win, the runtime tier on
    S256 as CUDA keys (the dynamic scan's lookup, held against its plain
    version) and the windowed tier on 1024 keys a window each (the window
    lookup, held against the static fold, every word), each beside the
    fold on the same keys; and prints the registers, shared memory and SASS instructions
    per value or per row (``cuobjdump -sass``) of the bins kernel, the
    domain histogram, the static fold (linear and in tile order) and the
    member lookup (bitmap and search);
12. holds the benchmark's kernels against their plain versions at small
    ragged sizes (``memcpy`` at byte counts that are not multiples of 16,
    one stage of its ring +- 16 bytes, several stages plus a 7-byte tail,
    and enough stages to wrap every CTA's ring; the chunked and dynamic
    scans at widths 1-31, the last width of their direct tables and the
    first of their search among them, k 1-1025 and around one chunk, keys
    past the domain and 0xFFFFFFFF, a key repeated across the chunk
    boundary, across groups of rows and across the dynamic kernel's launch
    boundary, a chunk of equal keys, keys all past the domain, a
    ``block_offset``);
13. times the memcpy kernel beside its plain version and ``copy_`` on 512
    MiB (random words, and zeros), and the chunked and dynamic scans and
    the general compare kernel on S64 and a 256-key set of the ``i % 512``
    column, each checked against its plain twin and the closed-form
    counts, with the copy, chunked and dynamic kernels' registers and
    shared memory; then
    drives the benchmark CLI in process, ``cli.main`` with 3 reps: the
    default suite with ``all`` (memory with the memcpy and ``copy_`` rows,
    decompression, scan, sharedscan at data_size/8, pack), sharedscan k=64
    at 512 MiB (the chunked and dynamic scans at full size), linear,
    member, conj, aggregate and histogram at 64 MiB and ``scaling 8`` (the
    one-card mesh's row), with the
    launch counters set to 0 just before and read just after; checks that
    every run returns 0, every verification reads ok, every row parses with
    the sweep script's regexes and none is above 105% of the card's
    data-sheet memory rate;
14. times the compare wrapper on k = 1 and on S8, S64 and S256 of the
    ``i % 512`` column as CUDA keys (the compare kernel, or from
    ``scan._compare_fold_wins`` the bit-sliced tier's launch) and the
    interval kernel on keys 0..63 and 0..1023 of the main path's column,
    each with its launches by kernel, its counts against the closed form
    and its bits against the plain version, beside its bound and the
    staged fold on the same keys, with both kernels' registers and spills;
15. times the shift canary's verdict (CUDA events, its first call on a
    cleared cache on the host clock, its device time by ``torch.profiler``),
    the elementwise canary and ``torch.bitwise_left_shift`` on the same
    inputs (held against the plain shift first), and the zoned scan Z3:
    the row form, the count form, the row form's device time and
    ``zoned_eq_scan``'s wall time;
16. drives the sharded surface at full size (``sharded_phase``, after the
    statistics timing phase): ``parallel.dist`` on meshes of card 0 with
    one shard, four shards (B1 a multiple of 32, block offsets inside the
    column) and a process group of one over NCCL (``dist.initialize``
    through a ``file://`` rendezvous; the backend printed and checked):
    the multi-process demo's sets (``multiproc_demo.sets``:
    ``sharded_shared_scan`` on keys 0..7 (interval), key 3 (compare) and
    eight spread keys of ``price``, ``sharded_member_scan`` on those keys,
    ``evaluate_sharded`` on Q1-Q4, ``sharded_masked_aggregate`` on Q1's
    bits, ``sharded_aggregate_scan`` on A2 and A3, ``sharded_minmax_scan``
    on A6), then ``sharded_shared_scan`` on S64 of the ``i % 512`` column,
    ``sharded_unpack``, ``stats.describe(mesh=)`` on the 12-bit column,
    ``sharded_linear_scan`` on L1 and ``sharded_member_scan`` on
    ``w31_list`` (a 31-bit ``i % 512`` column of 512 MiB packed); each set
    held bit for bit against its unsharded call (bits and the linear
    stream through ``fetch_global``), its launches counted (S=4 four a
    kernel), its host-clock ms printed for the unsharded call and each
    mesh, in one ``{"sharded": ...}`` line; the CLI phase also runs
    ``scaling 8``;
17. launches the multi-process demo through the real launcher
    (``ranks_phase``: ``python -m torch.distributed.run --standalone
    --nproc_per_node=1`` at the main path's n), which loads the kernels
    this process built; checks that its rank reports ``LOCAL_RANK`` 0,
    current device 0, the mesh ``["cuda:0"]`` (``make_mesh()`` bound to the
    rank's card), NCCL and every set equal to its unsharded call; checks
    that a child given ``LOCAL_RANK=1`` on this one-card machine is refused
    by ``dist.initialize()`` with its ValueError; the rank also runs
    ``bench_scaling`` over its NCCL group (one row, ``verification:
    ok``); prints the rank's host-clock ms a set beside the sharded
    phase's NCCL-1 ms in one ``{"ranks": ...}`` line;
18. prints a JSON line with one entry per kernel, and as its last line
    ``{"ok": true, "device": {...}}``.

Any failed check or error exits non-zero and prints no result; so does a
machine with no CUDA card, and a directory without the package.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
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

KERNELS = {  # name -> (source, its C entry point, TPU kernel it replaces)
    "unpack": ("shared_simd_scan_tpu_torch/csrc/unpack.cu", "sss_unpack",
               "shared_simd_scan_tpu/ops/unpack.py:79"),
    "pack": ("shared_simd_scan_tpu_torch/csrc/unpack.cu", "sss_pack",
             "shared_simd_scan_tpu/ops/unpack.py:139"),
    "shared_scan": ("shared_simd_scan_tpu_torch/csrc/shared_scan.cu", "sss_shared_scan",
                    "shared_simd_scan_tpu/ops/scan.py:70"),
    "interval_scan": ("shared_simd_scan_tpu_torch/csrc/interval_scan.cu", "sss_interval_scan",
                      "shared_simd_scan_tpu/ops/scan.py:1266"),
    # the verdict (one launch, one sync); its elementwise form, CANARY_ELEMENTWISE
    "shift_canary": ("shared_simd_scan_tpu_torch/csrc/interval_scan.cu", "sss_shift_verdict",
                     "shared_simd_scan_tpu/ops/scan.py:1336"),
    # the runtime keys through the static fold's body (RUNTIME_LOOKUP where
    # scan._runtime_lookup_wins picks it)
    "bitsliced_scan": ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu", "sss_bitsliced_static_fold",
                       "shared_simd_scan_tpu/ops/scan.py:2357"),
    "bitsliced_static_scan": ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu",
                              "sss_bitsliced_static_fold", "shared_simd_scan_tpu/ops/scan.py:2715"),
    "windowed_scan": ("shared_simd_scan_tpu_torch/csrc/shared_scan.cu", "sss_windowed_lookup",
                      "shared_simd_scan_tpu/ops/scan.py:2980; "
                      "shared_simd_scan_tpu/ops/scan.py:2997"),
    "range_scan": ("shared_simd_scan_tpu_torch/csrc/range_scan.cu", "sss_range_scan",
                   "shared_simd_scan_tpu/ops/scan.py:1984"),
    "conj_range_scan": ("shared_simd_scan_tpu_torch/csrc/conj.cu", "sss_conj_range_scan",
                        "shared_simd_scan_tpu/ops/conj.py:52"),
    "member_compare": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_compare",
                       "shared_simd_scan_tpu/ops/member.py:89"),
    "member_chunked_compare": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_compare",
                               "shared_simd_scan_tpu/ops/member.py:122"),
    "member_window": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_window",
                      "shared_simd_scan_tpu/ops/member.py:107"),
    "member_chunked_window": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_window",
                              "shared_simd_scan_tpu/ops/member.py:146"),
    "member_domain": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_domain",
                      "shared_simd_scan_tpu/ops/member.py:169"),
    "member_ortree": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_lookup",
                      "shared_simd_scan_tpu/ops/member.py:250"),
    # the keys' table and one lookup a value, as the compare bodies
    "member_bitsliced": ("shared_simd_scan_tpu_torch/csrc/member.cu", "sss_member_compare",
                         "shared_simd_scan_tpu/ops/member.py:321"),
    "aggregate_scan": ("shared_simd_scan_tpu_torch/csrc/aggregate.cu", "sss_agg_compare",
                       "shared_simd_scan_tpu/ops/aggregate.py:55"),
    "aggregate_bitplane_static": ("shared_simd_scan_tpu_torch/csrc/agg_lookup.cu",
                                  "sss_agg_lookup", "shared_simd_scan_tpu/ops/aggregate.py:233"),
    "aggregate_bitplane": ("shared_simd_scan_tpu_torch/csrc/agg_lookup.cu",
                           "sss_agg_device_lookup", "shared_simd_scan_tpu/ops/aggregate.py:258"),
    "minmax_scan": ("shared_simd_scan_tpu_torch/csrc/agg_lookup.cu", "sss_minmax_lookup",
                    "shared_simd_scan_tpu/ops/aggregate.py:480"),
    "masked_aggregate": ("shared_simd_scan_tpu_torch/csrc/aggregate.cu", "sss_masked_agg",
                         "shared_simd_scan_tpu/ops/aggregate.py:671"),
    "histogram": ("shared_simd_scan_tpu_torch/csrc/histogram.cu", "sss_histogram",
                  "shared_simd_scan_tpu/ops/scan.py:1553"),
    # the bins kernel with lo by value; at the narrowest widths the static
    # fold's counts form (FOLD_KERNEL), as _histogram_chunked_tiles picks
    "histogram_dag": ("shared_simd_scan_tpu_torch/csrc/histogram.cu", "sss_histogram_span",
                      "shared_simd_scan_tpu/ops/scan.py:1716"),
    "histogram_span": ("shared_simd_scan_tpu_torch/csrc/histogram.cu", "sss_histogram_span",
                       "shared_simd_scan_tpu/ops/scan.py:1816"),
    # stats.histogram_full's windows of _histogram_tiles_impl (stats.py:67)
    "histogram_domain": ("shared_simd_scan_tpu_torch/csrc/histogram.cu", "sss_histogram_domain",
                         "shared_simd_scan_tpu/ops/scan.py:1667"),
    "zoned_range_scan": ("shared_simd_scan_tpu_torch/csrc/zoned.cu", "sss_zoned_range_scan",
                         "shared_simd_scan_tpu/zonemap.py:298"),
    "interval_scan_linear": ("shared_simd_scan_tpu_torch/csrc/interval_scan.cu",
                             "sss_interval_scan_linear", "shared_simd_scan_tpu/ops/scan.py:618"),
    "static_scan_linear": ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu",
                           "sss_bitsliced_static_scan_linear",
                           "shared_simd_scan_tpu/ops/scan.py:854"),
    "bitsliced_scan_linear": ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu",
                              "sss_bitsliced_scan_linear", "shared_simd_scan_tpu/ops/scan.py:1025"),
    "interleave": ("shared_simd_scan_tpu_torch/csrc/linear.cu", "sss_interleave",
                   "shared_simd_scan_tpu/ops/linear.py:339"),
    "interleave_streams": ("shared_simd_scan_tpu_torch/csrc/linear.cu", "sss_interleave",
                           "shared_simd_scan_tpu/ops/linear.py:201"),
    "memcpy": ("shared_simd_scan_tpu_torch/csrc/copy.cu", "sss_copy",
               "shared_simd_scan_tpu/bench/harness.py:170"),
    "shared_scan_chunked": ("shared_simd_scan_tpu_torch/csrc/shared_scan.cu",
                            "sss_shared_scan_chunked", "shared_simd_scan_tpu/ops/scan.py:2192"),
    "shared_scan_dynamic": ("shared_simd_scan_tpu_torch/csrc/shared_scan.cu",
                            "sss_shared_scan_dynamic", "shared_simd_scan_tpu/ops/scan.py:2089"),
}
# the canary's elementwise kernel, held against its plain version and timed
# beside the verdict: (source, C entry point)
CANARY_ELEMENTWISE = ("shared_simd_scan_tpu_torch/csrc/interval_scan.cu", "sss_shift_canary")
# the other kernel of the histogram_dag entry: (source, C entry point)
FOLD_KERNEL = ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu", "sss_histogram_fold")
# the kernel the runtime tier launches where scan._runtime_lookup_wins says so
# (counted by the shared_scan_dynamic entry), and the one the windowed tier
# runs below scan.WINDOW_LOOKUP_KEYS host keys (counted by the
# bitsliced_static_scan entry): (source, C entry point)
RUNTIME_LOOKUP = ("shared_simd_scan_tpu_torch/csrc/shared_scan.cu", "sss_shared_scan_dynamic")
WINDOW_FOLD = ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu", "sss_bitsliced_static_fold")
# the kernels also timed on S64 of a 20-bit i % 512 column (the lookup's
# search past width 16; the static fold's 20 planes)
WIDTH20 = ("bitsliced_static_scan", "member_ortree")
# the kernels of the arbitrary-key path, and the tier each one serves
ARBITRARY = {"bitsliced_static_scan": "bitsliced_static", "windowed_scan": "windowed",
             "bitsliced_scan": None}
# the edges of the window lookup (its direct window table up to width 17, the
# search past it; k around a pass of 64 rows and a launch of 1024 rows) and
# of the runtime tier
WINDOW_EDGE_WIDTHS = (1, 5, 12, 13, 17, 18, 31)
WINDOW_EDGE_KS = (1, 8, 64, 65, 1024, 1025)
RUNTIME_EDGE_KS = (5, 8, 64, 128, 1025)
# the kernels of the query path
QUERY = ("range_scan", "conj_range_scan", "member_compare", "member_chunked_compare",
         "member_window", "member_chunked_window", "member_domain", "member_ortree",
         "member_bitsliced")
# the query path's table: the analytics demo's columns and widths
TABLE = {"price": 9, "region": 5, "status": 4}
# the kernels of the aggregate path, and the set each one reports
AGGREGATE = {"masked_aggregate": "A1", "aggregate_bitplane_static": "A2",
             "aggregate_scan": "A3", "aggregate_bitplane": "A4", "minmax_scan": "A6"}
# the aggregate path's measure: the analytics demo's revenue column
REVENUE_WIDTH = 20
# (predicate, measure) widths of the small aggregate phase: wm <= 16,
# wm > 16, wm = 31, wp = 1 and wp = 31, and the full-size pairs
AGG_PAIRS = ((1, 16), (2, 17), (9, 31), (16, 1), (17, 2), (31, 9), (9, 20), (5, 20))
# the statistics path's kernels, and the set each one reports
HISTOGRAM = {"histogram_span": "H1", "histogram_dag": "H2", "histogram": "H3",
             "histogram_domain": "H5"}
# H6's column: 12 bits, 512 MiB packed (a full-domain histogram of 4096 keys
# in one launch of the chunked tier); H8's: a 1-bit flag column of the
# table's n (the fold's counts form)
H6_WIDTH = 12
H8_WIDTH = 1
# the zone-map path's kernel, and the set it reports
ZONED = {"zoned_range_scan": "Z3"}
# the linear export's kernels, and the shape each one reports (L sets of
# the linear phase; the interleave at k = 8 on the main path's bits)
LINEAR = {"interval_scan_linear": "L1", "static_scan_linear": "L2",
          "bitsliced_scan_linear": "L3", "interleave": "k=8", "interleave_streams": "L6"}
LINEAR_WIDTHS = (1, 2, 9, 17, 31)
# every k of the fused tiers (linear._mxu_supported, linear._mxu_large_supported)
FUSED_KS = tuple(k for k in range(4, 129, 4) if k <= 64 or k % 8 == 0)
INTERLEAVE_KS = (1, 3, 4, 6, 8, 12, 16, 24, 33, 64, 1024)
STREAM_CASES = ((4, 2), (3, 2), (8, 2), (4, 128))
HIST_WIDTHS = (1, 2, 9, 12, 16, 17, 31)
HIST_KS = (1, 5, 32, 48, 49, 64, 512, 4096)
ZONE_B1 = 64
QS = [0.0, 0.25, 0.5, 0.9, 1.0]
# the benchmark's kernels; their small phase's widths, key counts and copy sizes
BENCH = ("memcpy", "shared_scan_chunked", "shared_scan_dynamic")
# (12 and 13: the chunked and dynamic kernels' last width on their direct
# tables, their first on the search)
BENCH_WIDTHS = (1, 2, 9, 12, 13, 17, 31)
# and CHUNK_KEYS - 1, CHUNK_KEYS, CHUNK_KEYS + 1; 130: three groups of the
# dynamic kernel's rows; 1025: past one dynamic launch
BENCH_KS = (1, 8, 33, 40, 64, 130, 1025)
COPY_BYTES = (1, 15, 17, 4097, 65_539, 1_000_003)  # and sizes around the copy's stages
# the CLI runs of the bench phase, and the verification lines each prints
CLI_RUNS = ((["_", "3", "all"], 4), (["512m", "3", "sharedscan", "64"], 1),
            (["64m", "3", "linear"], 1), (["64m", "3", "member"], 1), (["64m", "3", "conj"], 1),
            (["64m", "3", "aggregate"], 1), (["64m", "3", "histogram"], 1),
            (["_", "3", "scaling", "8"], 1))
PEAK_SHARE = 1.05  # no CLI row may claim more than this share of the data-sheet rate
# the edges of the interval and compare kernels at every width 1-31 (the
# card tests' sets): k around a round of 8 keys and a chunk of 32, and
# around a launch of 1024; lo 0, near the top of the domain and wrapping
# past 2^32 - 1
SCAN_EDGE_N = 5 * 128 * 32 - 7  # two and a half tiles of 256 blocks
INTERVAL_EDGE_KS = (1, 7, 8, 9, 31, 32, 33, 1024)
COMPARE_EDGE_KS = (1, 2, 3, 4, 5, 8, 32, 33, 64, 1024, 1025)
# the timing of the two scan kernels: the compare wrapper on CUDA keys of
# the i % 512 column (the compare kernel, or from scan._compare_fold_wins
# the bit-sliced tier's launch, COMPARE_ROUTE), the interval kernel on keys
# 0..k-1 of the main path's column; each beside the staged fold
COMPARE_TIMED = ("S8", "S64", "S256")
INTERVAL_TIMED = (64, 1024)
COMPARE_ROUTE = ("shared_simd_scan_tpu_torch/csrc/bitsliced.cu", "sss_bitsliced_static_fold")
# compare kernels whose JSON entry carries these key sets beside its own
EXTRA_SETS = {"shared_scan": COMPARE_TIMED, "shared_scan_chunked": ("S256",),
              "shared_scan_dynamic": ("S256",), "member_compare": ("w20_k8",),
              "member_chunked_window": ("w31_list",), "member_bitsliced": ("w31_S256",)}


def s64() -> list[int]:
    import numpy as np

    return sorted(np.random.default_rng(3).choice(DOMAIN, 64, replace=False).tolist())


def s256() -> list[int]:
    import numpy as np

    return sorted(np.random.default_rng(4).choice(DOMAIN, 256, replace=False).tolist())


def wrappers() -> dict:
    """Kernel name -> the wrapper that counts its launches (:func:`launched`)."""
    from shared_simd_scan_tpu_torch import zonemap
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import aggregate, conj, linear, member, scan, unpack

    return {
        "unpack": unpack.unpack_tiles, "pack": unpack.pack_tiles,
        "shared_scan": scan.shared_scan_tiles, "interval_scan": scan.interval_scan_tiles,
        "shift_canary": scan.shift_verdict,
        "bitsliced_scan": scan.shared_scan_bitsliced_tiles,
        "bitsliced_static_scan": scan.shared_scan_bitsliced_static_tiles,
        "windowed_scan": scan.windowed_scan_tiles,
        "range_scan": scan.range_scan_tiles, "conj_range_scan": conj.conj_range_scan_tiles,
        **{name: getattr(member, f"_{name}_tiles") for name in QUERY if name.startswith("member")},
        "aggregate_scan": aggregate.aggregate_scan_tiles,
        "aggregate_bitplane_static": aggregate.aggregate_bitplane_static_tiles,
        "aggregate_bitplane": aggregate.aggregate_bitplane_tiles,
        "minmax_scan": aggregate.minmax_scan_tiles,
        "masked_aggregate": aggregate.masked_aggregate_tiles,
        "histogram": scan.histogram_tiles, "histogram_dag": scan._histogram_chunked_tiles,
        "histogram_span": scan._histogram_span_tiles,
        "histogram_domain": scan._histogram_domain_tiles,
        "zoned_range_scan": zonemap.zoned_range_tiles,
        "interval_scan_linear": scan._interval_linear_tiles_impl,
        "static_scan_linear": scan._static_linear_tiles_impl,
        "bitsliced_scan_linear": scan._bitsliced_linear_tiles_impl,
        "interleave": linear.interleave_words,
        "interleave_streams": linear.interleave_streams_words,
        "memcpy": harness.memcpy, "shared_scan_chunked": scan.shared_scan_chunked_tiles,
        "shared_scan_dynamic": scan.shared_scan_dynamic_tiles,
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
    for name, (_, c_entry, _) in KERNELS.items():
        check(c_entry in _cuda._SIGNATURES, f"{name}: its entry point {c_entry} is in the library")
    for other in (FOLD_KERNEL, RUNTIME_LOOKUP, WINDOW_FOLD, COMPARE_ROUTE, CANARY_ELEMENTWISE):
        check(other[1] in _cuda._SIGNATURES, f"{other[1]} is in the library")
    log_path = _cuda.BUILD_DIR / "ptxas.log"
    log_path.write_text(_cuda.build_log)
    # registers and spills of the width-9 kernels (the main path's width),
    # and of the kernels with one body for every width (aggregates, the
    # chunked, dynamic and windowed scans) and the copy
    for entry, line in ptxas_lines(_cuda.build_log):
        if ("ILi9E" in entry or "ILi31E" in entry or "canary" in entry or "agg" in entry
                or "chunked" in entry or "dynamic" in entry or "windowed" in entry
                or "copy" in entry) and (
                "Used" in line or "spill" in line):
            print(f"  ptxas {entry}: {line}")
    return seconds


def ptxas_lines(log: str):
    """(kernel, report) for each line ptxas's -v output gives a kernel."""
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry:
            yield entry, line.split(":", 1)[-1].strip()


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
    before = launched(scan.shift_verdict)
    verdict = scan.shift_verdict(device)
    plain_verdict = scan.shift_verdict_plain(device)
    errs["shift_canary"] = max(errs["shift_canary"], int(verdict != plain_verdict))
    check(verdict == plain_verdict == ptx_ok and launched(scan.shift_verdict) == before + 1,
          f"shift verdict ({verdict}, one launch) == the plain verdict == the elementwise canary's")
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


def compare_launches(width: int, k: int) -> dict:
    """The launches of ``shared_scan_tiles`` on k keys, by kernel entry: one
    a group of 1024 keys, the compare kernel where scan._compare_fold_wins
    keeps it, else the bit-sliced tier's launch (the fold under
    bitsliced_scan, the dynamic scan's lookup under shared_scan_dynamic)."""
    from shared_simd_scan_tpu_torch.ops import scan

    out = {}
    for g0 in range(0, k, scan.MAX_LAUNCH_KEYS):
        rows = min(k - g0, scan.MAX_LAUNCH_KEYS)
        name = ("shared_scan" if not scan._compare_fold_wins(width, rows) else
                "shared_scan_dynamic" if scan._runtime_lookup_wins(width, rows) else
                "bitsliced_scan")
        out[name] = out.get(name, 0) + 1
    return out


_LAUNCH_ZERO: dict[str, int] = {}  # wrapper name -> its count at its last zero_launched


def launched(fn) -> int:
    """The launches wrapper ``fn`` has counted since ``zero_launched``:
    ``launches.<its name>`` in the port's counter set (``utils.profiling``)."""
    from shared_simd_scan_tpu_torch.utils import profiling

    return profiling.launch_count(fn) - _LAUNCH_ZERO.get(fn.__name__, 0)


def zero_launched(fns) -> None:
    """Count the launches of the wrappers ``fns`` from 0 again."""
    from shared_simd_scan_tpu_torch.utils import profiling

    for fn in fns:
        _LAUNCH_ZERO[fn.__name__] = profiling.launch_count(fn)


def ran_kernels(before: dict) -> dict:
    """Kernel name -> launches since ``before`` (name -> launches), the
    kernels that ran."""
    return {name: launched(fn) - before[name] for name, fn in wrappers().items()
            if launched(fn) != before[name]}


def small_scan_edge_phase(device, errs: dict) -> None:
    """The interval and compare kernels against their plain versions at
    every width 1-31 on a ragged column of two and a half tiles: the
    interval kernel (its C entry, gateless and gated, and the wrapper) at k
    INTERVAL_EDGE_KS with lo 0, 2^w - 4 and 2^32 - 3; the compare wrapper
    at k COMPARE_EDGE_KS with key 0 over the padding, a duplicate, 2^w,
    2^31 and 0xFFFFFFFF, and on both sides of scan._compare_fold_wins the
    compare kernel's C entry and the bit-sliced tier's launch; each with
    block_offset 0 and 3, and the wrapper's launches by kernel."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack

    t0 = time.monotonic()
    n = SCAN_EDGE_N

    def entry(name, tiles, first, k, width, bo, *extra):
        b1 = tiles.shape[1]
        bits = torch.empty((k, b1, LANES), dtype=torch.int32, device=device)
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        _cuda.launch(name, device, tiles.data_ptr(), first, k, bits.data_ptr(), counts.data_ptr(),
                     b1 * LANES, width, n, bo, *extra)
        return bits, counts

    def err(a, p):
        return max(max_abs_err(a[0], p[0]), int((a[1] - p[1]).abs().max()))

    for width in range(1, 32):
        dom = 1 << width
        rng = np.random.default_rng(width + 700)
        values = rng.integers(0, dom, size=n).astype(np.uint32)
        tiles = unpack.pack_device_kernel(torch.from_numpy(values.view(np.int32)).to(device),
                                          width).tiles
        for k in INTERVAL_EDGE_KS:
            for lo in (0, max(dom - 4, 0), (1 << 32) - 3):
                for bo in (0, 3):
                    p = scan.interval_scan_tiles_plain(tiles, lo, k, width, n, bo)
                    e = max(err(entry("sss_interval_scan", tiles, lo, k, width, bo, g), p)
                            for g in (1, 0))
                    e = max(e, err(scan.interval_scan_tiles(tiles, lo, k, width, n, bo), p))
                    errs["interval_scan"] = max(errs["interval_scan"], e)
        for k in COMPARE_EDGE_KS:
            keys = values[rng.integers(0, n, size=k)].astype(np.uint64)
            for at, key in ((0, 0), (1, int(keys[0])), (2, dom), (3, 1 << 31), (4, 0xFFFFFFFF)):
                if at < k:
                    keys[at] = key
            kt = torch.from_numpy(keys.astype(np.uint32).view(np.int32)).to(device)
            for bo in (0, 3):
                p = scan.shared_scan_tiles_plain(tiles, kt, width, n, bo)
                before = {name: launched(fn) for name, fn in wrappers().items()}
                a = scan.shared_scan_tiles(tiles, kt, width, n, bo)
                if ran_kernels(before) != compare_launches(width, k):
                    check(False, f"compare w={width} k={k}: ran {ran_kernels(before)}, not "
                          f"{compare_launches(width, k)} as scan._compare_fold_wins names")
                e = max(err(a, p), err(entry("sss_shared_scan", tiles, kt.data_ptr(), k, width, bo),
                                       p),
                        err(scan.shared_scan_bitsliced_tiles(tiles, kt, width, n, bo), p))
                errs["shared_scan"] = max(errs["shared_scan"], e)
    torch.cuda.synchronize()
    check(errs["interval_scan"] == 0, f"interval_scan bit-exact against its plain version at "
          f"widths 1-31, k {INTERVAL_EDGE_KS}, lo 0, 2^w - 4 and 2^32 - 3, gateless and gated, "
          f"n {n}, block_offset 0 and 3")
    check(errs["shared_scan"] == 0, f"shared_scan (the wrapper, the compare kernel and the "
          f"bit-sliced launch) bit-exact against the plain compare at widths 1-31, k "
          f"{COMPARE_EDGE_KS}, key 0 over padding, duplicates, 2^w, 2^31, 0xFFFFFFFF, "
          f"block_offset 0 and 3; each launch the kernel scan._compare_fold_wins names")
    print(f"interval and compare edge phase ran in {time.monotonic() - t0:.1f} s")


def with_edges(keys, width: int) -> list[int]:
    """keys with a duplicate of the first across passes of 64 rows and
    launches of 1024, keys past the domain (2^w, 0xFFFFFFFF) and a key of
    the domain's top window."""
    keys, dom = [int(x) for x in keys], 1 << width
    k = len(keys)
    for at, key in ((k - 1, keys[0]), (k // 2, keys[0]), (1, dom), (2, 0xFFFFFFFF), (3, dom - 1)):
        if at < k:
            keys[at] = key
    return keys


def small_window_phase(device, errs: dict) -> None:
    """The window lookup and the runtime tier against their plain versions
    at their edges, small ragged sizes."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    n = 33 * 128 + 17
    t0 = time.monotonic()
    fns = (scan.windowed_scan_tiles, scan.shared_scan_bitsliced_static_tiles)
    for width in WINDOW_EDGE_WIDTHS:
        dom = 1 << width
        rng = np.random.default_rng(width)
        values = rng.integers(0, dom, size=n).astype(np.uint32)
        tiles = unpack.pack_device_kernel(torch.from_numpy(values.view(np.int32)).to(device),
                                          width).tiles
        for k in WINDOW_EDGE_KS:
            base = int(values[5]) // 32 * 32
            layouts = {
                "one window": (base + rng.integers(0, min(32, dom), size=k)) % dom,
                "a window each": (32 * np.arange(k) + np.arange(k) % 32) % dom,
                "top windows": dom - 1 - rng.integers(0, min(64, dom), size=k),
                "drawn": values[rng.integers(0, n, size=k)],
            }
            for layout, keys in layouts.items():
                keys = with_edges(keys, width)
                kt = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)).to(device)
                arr = np.asarray(keys, np.uint32)
                for bo in (0, 3):
                    p = scan.shared_scan_tiles_plain(tiles, kt, width, n, bo)
                    # the window lookup at every k, and the tier (the fold below
                    # WINDOW_LOOKUP_KEYS keys); each wrapper counts in its launch loop
                    before = [launched(f) for f in fns]
                    a = scan._window_lookup(tiles, arr, width, n, bo, device)
                    mid = [launched(f) for f in fns]
                    t = scan.windowed_scan_tiles(tiles, keys, width, n, bo)
                    tier = (-(-k // 1024), 0) if k >= scan.WINDOW_LOOKUP_KEYS else (0, 1)
                    if [m - b for m, b in zip(mid, before)] != [-(-k // 1024), 0] or \
                            tuple(launched(f) - m for f, m in zip(fns, mid)) != tier:
                        check(False, f"windowed w={width} k={k} {layout}: one launch of the "
                              f"lookup per 1024 rows, or one of the fold below "
                              f"{scan.WINDOW_LOOKUP_KEYS} keys")
                    errs["windowed_scan"] = max(errs["windowed_scan"], max_abs_err(a[0], p[0]),
                                                int((a[1] - p[1]).abs().max()),
                                                max_abs_err(t[0], p[0]),
                                                int((t[1] - p[1]).abs().max()))
    torch.cuda.synchronize()
    check(errs["windowed_scan"] == 0, f"windowed_scan (the window lookup, and the tier) bit-exact "
          f"against the plain compare at widths {WINDOW_EDGE_WIDTHS}, k {WINDOW_EDGE_KS}, four key "
          f"layouts, every set with duplicates across passes and launches and keys past the "
          f"domain")
    for width in range(1, 32):
        rng = np.random.default_rng(width + 100)
        values = rng.integers(0, 1 << width, size=n).astype(np.uint32)
        tiles = unpack.pack_device_kernel(torch.from_numpy(values.view(np.int32)).to(device),
                                          width).tiles
        for k in RUNTIME_EDGE_KS + ((1024,) if width == 31 else ()):
            keys = with_edges(values[rng.integers(0, n, size=k)], width)
            kt = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)).to(device)
            rfns = (scan.shared_scan_bitsliced_tiles, scan.shared_scan_dynamic_tiles)
            before = [launched(f) for f in rfns]
            a = scan.shared_scan_bitsliced_tiles(tiles, kt, width, n, 2)
            lookups = sum(scan._runtime_lookup_wins(width, min(k - g0, 1024))
                          for g0 in range(0, k, 1024))
            if [launched(f) - b for f, b in zip(rfns, before)] != [-(-k // 1024) - lookups,
                                                                   lookups]:
                check(False, f"runtime tier w={width} k={k}: one launch per 1024 keys, of the "
                      f"lookup where scan._runtime_lookup_wins says so, else of the fold")
            p = scan.shared_scan_bitsliced_tiles_plain(tiles, kt, width, n, 2)
            errs["bitsliced_scan"] = max(errs["bitsliced_scan"], max_abs_err(a[0], p[0]),
                                         int((a[1] - p[1]).abs().max()))
    torch.cuda.synchronize()
    check(errs["bitsliced_scan"] == 0, f"bitsliced_scan (runtime tier) bit-exact against its plain "
          f"version at widths 1-31, k {RUNTIME_EDGE_KS} and 1024 at width 31 (the masks staged "
          f"in chunks), duplicates and keys past the domain")
    print(f"window and runtime edge phase ran in {time.monotonic() - t0:.1f} s")


def main_path_phase(device) -> tuple[int, object, dict]:
    """The main path at full size, with launch counts taken around it."""
    import torch
    from shared_simd_scan_tpu_torch import layout, pack_device_kernel, scan_device
    from shared_simd_scan_tpu_torch import shared_scan_device, unpack_device
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import scan

    path = {name: fn for name, fn in wrappers().items()
            if name not in (*ARBITRARY, *QUERY, *AGGREGATE, *HISTOGRAM, *ZONED, *LINEAR, *BENCH)}
    n = harness.values_for(DATA_SIZE, WIDTH)
    vals = harness.synth_modk(n, K, WIDTH, device=device)
    torch.cuda.synchronize()
    print(f"main path: width {WIDTH}, n {n}, {layout.packed_nbytes(WIDTH, n)} packed bytes")

    # a fresh process meets the canary on its first interval scan: so does this run
    scan._SHIFT_SEMANTICS.clear()
    zero_launched(path.values())
    t0 = time.monotonic()
    dev = pack_device_kernel(vals, WIDTH)
    bits8, counts8 = shared_scan_device(dev, list(range(K)))
    bits1, count1 = scan_device(dev, SCAN_KEY)
    back = unpack_device(dev)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: launched(fn) for name, fn in path.items()}
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
    zero_launched(kernels.values())
    t0 = time.monotonic()
    ran, outs = {}, {}
    for name, keys in sets:
        before = {k: launched(fn) for k, fn in kernels.items()}
        outs[name] = shared_scan_device(dev, keys)
        ran[name] = [k for k, fn in kernels.items() if launched(fn) > before[k]]
    before = launched(kernels["windowed_scan"])
    chunked = scan.windowed_scan_tiles(dev.tiles, s64(), WIDTH, n)  # (JAX: its chunked plan)
    chunked_launches = launched(kernels["windowed_scan"]) - before
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: launched(fn) for name, fn in kernels.items()}
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
            if tier == "windowed" and len(keys) < scan.WINDOW_LOOKUP_KEYS:
                want, why = "bitsliced_static_scan", f"{why}, the fold below " \
                    f"{scan.WINDOW_LOOKUP_KEYS} keys"
        check(ran[name] == [want], f"{name}: ran {ran[name]}, the kernel of its tier ({why})")
    check(chunked_launches == 1 and len(s64()) >= scan.WINDOW_LOOKUP_KEYS,
          "windowed_scan_tiles(S64): one launch of the window lookup for 64 keys")

    for name, keys in sets:
        host = scan._host_keys(keys)
        expect = [(n - 1 - int(key)) // DOMAIN + 1 for key in host]
        check(outs[name][1].tolist() == expect, f"{name}: counts == closed form")
    bits_s64 = outs["S64"][0]
    check(bool((scan.bits_to_canonical(chunked[0], n) == bits_s64).all())
          and bool((chunked[1] == outs["S64"][1]).all()),
          "chunked windowed S64 == static fold S64, every word")
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
    also on the clustered W8, the windowed tier on W4 and on keys 0..7 of
    ``dev`` (beside the interval kernel), without their plain versions."""
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    tiles = dev.tiles
    nblocks = tiles.shape[1] * LANES
    tile_bytes = tiles.numel() * 4
    vals_layout = unpack.unpack_tiles(tiles, WIDTH)
    key1 = torch.tensor([SCAN_KEY], dtype=torch.int32, device=device)
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
    # the windowed tier on W4, and on keys 0..7 of the main path's column
    # beside the interval kernel
    for label, cols, keys in (("W4", atiles, W4), ("keys 0..7", tiles, list(range(K)))):
        pairs[f"windowed_scan {label}"] = (
            lambda cols=cols, keys=keys: scan.windowed_scan_tiles(cols, keys, WIDTH, n), None)
        nkeys[f"windowed_scan {label}"] = len(keys)
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
    print(f"keys 0..7 of the main path: the windowed tier (the plane fold below "
          f"{scan.WINDOW_LOOKUP_KEYS} keys) {results['windowed_scan keys 0..7'][0]:.6f} ms beside "
          f"the interval kernel's {results['interval_scan'][0]:.6f} ms")
    print("library: no PyTorch call scans a bit-packed column, so library_ms is null")
    kernel_report({"static_fold_kernelILi9ENS_10DeviceKeysELi1E": "static fold, width 9",
                   "windowed_lookup_kernelILb1E": "window lookup, direct table",
                   "windowed_lookup_kernelILb0E": "window lookup, search"})
    return results


def canary_timing_phase(device, errs: dict) -> dict:
    """The shift canary's verdict (``scan.shift_verdict``, one launch and
    one sync a call: CUDA events over calls, its first call on a cleared
    cache on the host clock, its device time by ``torch.profiler``) beside
    the plain verdict, the elementwise canary and
    ``torch.bitwise_left_shift`` on the same inputs, each shift held
    against the plain one first."""
    import torch
    from shared_simd_scan_tpu_torch.ops import scan

    from shared_simd_scan_tpu_torch.bench.timing import device_ms

    base, amounts = scan.canary_inputs(device)
    plain = scan.shift_canary_plain(base, amounts)
    errs["shift_canary"] = max(errs["shift_canary"],
                               max_abs_err(scan.run_shift_canary(base, amounts)[0], plain))
    check(errs["shift_canary"] == 0, "elementwise shift canary equals its plain version")
    same = torch.equal(torch.bitwise_left_shift(base, amounts), plain)
    print(f"torch.bitwise_left_shift on the canary inputs equals the plain shift: {same}")
    firsts = []
    for _ in range(11):
        scan._SHIFT_SEMANTICS.clear()
        t0 = time.monotonic()
        scan.shift_saturates(device)
        firsts.append((time.monotonic() - t0) * 1e3)
    dev = device_ms(lambda: scan.shift_verdict(device))
    out = {
        "ms": time_ms(lambda: scan.shift_verdict(device), batches=5, calls=10),
        "plain_ms": time_ms(lambda: scan.shift_verdict_plain(device), batches=5, calls=10),
        # the amounts in, the word out
        "bound_ms": (len(scan.CANARY_AMOUNTS) + 1) * 4 / HBM_BYTES_PER_S * 1e3,
        "first_call_ms": statistics.median(firsts),
        "device_ms": sum(dev.values()) if dev else None,
        "ms_elementwise": time_ms(lambda: scan.run_shift_canary(base, amounts), batches=5,
                                  calls=10),
        "plain_ms_elementwise": time_ms(lambda: scan.shift_canary_plain(base, amounts),
                                        batches=5, calls=10),
        "bound_ms_elementwise": 3 * base.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        "library_ms": time_ms(lambda: torch.bitwise_left_shift(base, amounts), batches=5,
                              calls=10) if same else None,
        "library_equal": same,
    }
    print(f"time shift verdict: {out['ms']:.6f} ms a call (CUDA events, a launch and a sync), "
          f"first call on a cleared cache {out['first_call_ms']:.6f} ms (host clock, median of "
          f"{len(firsts)}), device time "
          + (f"{out['device_ms']:.6f} ms ({dev})" if dev else "not measured (the profiler saw "
             "no device time)")
          + f"; plain verdict {out['plain_ms']:.6f} ms; elementwise canary "
          f"{out['ms_elementwise']:.6f} ms, plain {out['plain_ms_elementwise']:.6f} ms, "
          + (f"torch.bitwise_left_shift {out['library_ms']:.6f} ms" if same else
             "torch.bitwise_left_shift differs from the plain shift: no library time"))
    return out


def width20_phase(device, errs: dict) -> dict:
    """S64 on a 20-bit ``i % 512`` column of 512 MiB packed: the static
    tier (the fold over 20 planes) and the member OR-tree tier (the
    lookup's search, past the bitmap's 16 bits), each held against its
    plain version and the closed-form counts, then timed."""
    import torch
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import member, scan, unpack

    width = 20
    n = harness.values_for(DATA_SIZE, width)
    tiles = unpack.pack_device_kernel(harness.synth_modk(n, DOMAIN, width, device=device),
                                      width).tiles
    keys = s64()
    nblocks = tiles.shape[1] * LANES
    tile_bytes = tiles.numel() * 4
    expect = [(n - 1 - key) // DOMAIN + 1 for key in keys]
    pairs = {  # name -> (kernel, plain, bytes it must move, closed-form counts)
        "bitsliced_static_scan w20 S64": (
            lambda: scan.shared_scan_bitsliced_static_tiles(tiles, keys, width, n),
            lambda: scan.shared_scan_bitsliced_static_tiles_plain(tiles, keys, width, n),
            tile_bytes + len(keys) * (nblocks * 4 + 8 + 4), expect),
        "member_ortree w20 S64": (
            lambda: member._member_ortree_tiles(tiles, width, n, tuple(keys)),
            lambda: member._member_ortree_tiles_plain(tiles, width, n, tuple(keys)),
            tile_bytes + nblocks * 4 + 8, [sum(expect)]),
    }
    print(f"width-20 phase: n {n}, values i % {DOMAIN}, S64")
    results = {}
    for name, (kern, plain, nbytes, counts) in pairs.items():
        kernel = name.split()[0]
        a, p = kern(), plain()
        errs[kernel] = max(errs[kernel], max_err(a, p))
        check(a[1].reshape(-1).tolist() == counts, f"{name}: counts == closed form")
        del a, p
        check(errs[kernel] == 0, f"{name} kernel bit-exact against its plain version at full size")
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        results[name] = (ms, plain_ms, bound_ms)
        print(f"time {name}: kernel {ms:.6f} ms (bound {bound_ms:.6f} ms for {nbytes} bytes, "
              f"{bound_ms / ms:.4f} of it); plain {plain_ms:.6f} ms")
    kernel_report({"static_fold_kernelILi20ENS_10DeviceKeysELi1E": "static fold, width 20",
                   "member_lookup_kernelILi20ELi1E": "member lookup, search in shared memory, "
                                                     "width 20"})
    del tiles
    torch.cuda.empty_cache()
    return results


def width31_phase(device, errs: dict) -> dict:
    """A 31-bit ``i % 512`` column of 512 MiB packed, where the lookups win:
    the runtime tier on S256 as CUDA keys (the dynamic scan's lookup where
    ``scan._runtime_lookup_wins`` says so) held against its plain version,
    and the windowed tier on 1024 keys, a window each (one launch of the
    window lookup) held against the static fold, every word; both timed
    beside the fold on the same keys."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    width = 31
    n = harness.values_for(DATA_SIZE, width)
    tiles = unpack.pack_device_kernel(harness.synth_modk(n, DOMAIN, width, device=device),
                                      width).tiles
    nblocks = tiles.shape[1] * LANES
    print(f"width-31 phase: n {n}, values i % {DOMAIN}")

    def nbytes(k):
        return tiles.numel() * 4 + k * (nblocks * 4 + 8 + 4)

    def closed(keys):
        return [(n - 1 - key) // DOMAIN + 1 if key < DOMAIN else 0 for key in keys]

    results = {}
    keys = s256()
    kt = torch.tensor(keys, dtype=torch.int32, device=device)
    fns = (scan.shared_scan_bitsliced_tiles, scan.shared_scan_dynamic_tiles)
    before = [launched(f) for f in fns]
    a = scan.shared_scan_bitsliced_tiles(tiles, kt, width, n)
    ran = [launched(f) - b for f, b in zip(fns, before)]
    kernel = RUNTIME_LOOKUP[1] if ran == [0, 1] else KERNELS["bitsliced_scan"][1]
    check(ran == ([0, 1] if scan._runtime_lookup_wins(width, 256) else [1, 0]),
          f"runtime tier w31 S256: one launch, the kernel scan._runtime_lookup_wins picks ({ran})")
    check(a[1].tolist() == closed(keys), "runtime tier w31 S256: counts == closed form")
    p = scan.shared_scan_bitsliced_tiles_plain(tiles, kt, width, n)
    errs["bitsliced_scan"] = max(errs["bitsliced_scan"], max_err(a, p))
    del a, p
    check(errs["bitsliced_scan"] == 0,
          "runtime tier w31 S256 bit-exact against its plain version at full size")
    fold = (lambda: scan._static_fold(tiles, np.asarray(keys, np.uint32), width, n, 0, device))
    times = {"tier": time_ms(lambda: scan.shared_scan_bitsliced_tiles(tiles, kt, width, n),
                             batches=5, calls=10),
             "plain": time_ms(lambda: scan.shared_scan_bitsliced_tiles_plain(
                 tiles, kt, width, n), batches=3, calls=2),
             "fold": time_ms(fold, batches=5, calls=10)}
    bound_ms = nbytes(256) / HBM_BYTES_PER_S * 1e3
    results["bitsliced_scan w31 S256"] = (times["tier"], times["plain"], bound_ms, kernel,
                                          times["fold"])
    print(f"time bitsliced_scan w31 S256 as CUDA keys ({kernel}): {times['tier']:.6f} ms (bound "
          f"{bound_ms:.6f} ms, {bound_ms / times['tier']:.4f} of it); the fold on the same keys "
          f"{times['fold']:.6f} ms; plain {times['plain']:.6f} ms")

    keys = [32 * i + i % 32 for i in range(1024)]
    arr = np.asarray(keys, np.uint32)
    fns = (scan.windowed_scan_tiles, scan.shared_scan_bitsliced_static_tiles)
    before = [launched(f) for f in fns]
    a = scan.windowed_scan_tiles(tiles, keys, width, n)
    ran = [launched(f) - b for f, b in zip(fns, before)]
    check(ran == [1, 0], f"windowed tier w31, 1024 windows: one launch of the lookup ({ran})")
    check(a[1].tolist() == closed(keys), "windowed tier w31, 1024 windows: counts == closed form")
    f = scan._static_fold(tiles, arr, width, n, 0, device)
    for r0 in range(0, 1024, 64):  # rows of 17 MB: compare 64 at a time
        errs["windowed_scan"] = max(errs["windowed_scan"],
                                    max_abs_err(a[0][r0 : r0 + 64], f[0][r0 : r0 + 64]))
    errs["windowed_scan"] = max(errs["windowed_scan"], int((a[1] - f[1]).abs().max()))
    del a, f
    torch.cuda.empty_cache()
    check(errs["windowed_scan"] == 0,
          "windowed tier w31, 1024 windows == the static fold, every word and count")
    ms = time_ms(lambda: scan.windowed_scan_tiles(tiles, keys, width, n), batches=5, calls=10)
    fold_ms = time_ms(lambda: scan._static_fold(tiles, arr, width, n, 0, device),
                      batches=5, calls=10)
    bound_ms = nbytes(1024) / HBM_BYTES_PER_S * 1e3
    results["windowed_scan w31 k=1024"] = (ms, None, bound_ms, KERNELS["windowed_scan"][1],
                                           fold_ms)
    print(f"time windowed_scan w31, 1024 keys a window each (the window lookup, search): "
          f"{ms:.6f} ms (bound {bound_ms:.6f} ms, {bound_ms / ms:.4f} of it); the static fold "
          f"on the same keys {fold_ms:.6f} ms")
    del tiles
    torch.cuda.empty_cache()
    return results


def member_bodies(width: int, n: int, values, rng) -> list:
    """(kernel name, call) for the seven member bodies on small columns:
    call(fn, tiles, block_offset) runs the body's wrapper or plain version
    ``fn`` on duplicate, out-of-domain and zero keys, one key, clustered and
    out-of-domain windows, unsorted, unaligned, straddling, wrapping,
    repeated and empty windows, a spread OR-tree set (the lookup's bitmap up
    to width 16, its search past it), the whole domain, an
    all-out-of-domain set and, past width 17, a set of 4097 windows (the
    search table read from device memory)."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.ops import member

    device = values.device
    dom = 1 << width

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    v = [int(x) for x in values[:8].tolist()]
    spread = rng.integers(0, dom, size=12).tolist() + [0, v[3], v[3], dom, 0xFFFFFFFF]
    keys = t32(spread)
    padded = member._pad_keys(keys, 32)
    many = t32(rng.integers(0, 2 * dom, size=70).tolist() + [v[1]])
    # around a chunk of 32 keys: 31 in one chunk, 33 in two (31 pads)
    k31 = t32(rng.integers(0, 2 * dom, size=29).tolist() + [v[4], 0xFFFFFFFF])
    k33 = member._pad_keys(t32(rng.integers(0, 2 * dom, size=31).tolist() + [v[4], v[4]]), 32)
    wkeys = [x % dom for x in (0, 2, 4, 6, 31, 40, 77)] + [v[7], dom + 1]
    wb, wp = member.member_window_plan(np.asarray(wkeys, np.uint32))
    win = t32(np.stack([wb, wp], axis=1))
    ckeys = [32 * i + i % 7 for i in range(40)] + [v[5]]  # 40+ windows, some out of domain
    cb, cp = member.member_window_plan(np.asarray(ckeys, np.uint32))
    cwin = np.concatenate([np.stack([cb, cp], axis=1), np.zeros(((-len(cb)) % 32, 2), np.int64)])
    cwin = t32(cwin)
    # the table build's edges: unsorted and unaligned windows, one
    # straddling 2^width, one past 2^32 - 32 (its popmask wraps to value
    # 4), a base repeated across two chunks of 4, zero-popmask padding
    edge = [(v[1], 0b1011), (max(v[2] - 5, 0), 0xF0F0F0F1), ((dom - 7) % (1 << 32), 0xFFFF),
            (0xFFFFFFF0, (1 << 20) | (1 << 3)), (dom + 64, 0xFFFFFFFF), (v[1], 1 << 4),
            (v[6] & ~31, 1 << (v[6] & 31)), (0, 0)]
    ewin, echunked = t32(edge), t32(edge + edge[:2] + [(0, 0)] * 2)
    bodies = [
        ("member_compare", lambda fn, t, bo: fn(t, keys, width, n, bo)),
        ("member_compare", lambda fn, t, bo: fn(t, keys[:1], width, n, bo)),
        ("member_window", lambda fn, t, bo: fn(t, ewin, width, n, bo)),
        ("member_chunked_window", lambda fn, t, bo: fn(t, echunked, width, n, 4, bo)),
        ("member_chunked_compare", lambda fn, t, bo: fn(t, padded, width, n, 32, bo)),
        ("member_chunked_compare", lambda fn, t, bo: fn(
            t, member._pad_keys(many, 32), width, n, 32, bo)),
        ("member_window", lambda fn, t, bo: fn(t, win, width, n, bo)),
        ("member_chunked_window", lambda fn, t, bo: fn(t, cwin, width, n, 32, bo)),
        ("member_ortree", lambda fn, t, bo: fn(t, width, n, tuple(spread), bo)),
        ("member_ortree", lambda fn, t, bo: fn(t, width, n, (dom, dom + 5, 1 << 31), bo)),
        ("member_bitsliced", lambda fn, t, bo: fn(t, padded, width, n, 32, bo)),
        ("member_bitsliced", lambda fn, t, bo: fn(t, member._pad_keys(many, 32), width, n, 32, bo)),
        ("member_bitsliced", lambda fn, t, bo: fn(t, k31, width, n, 31, bo)),
        ("member_bitsliced", lambda fn, t, bo: fn(t, k33, width, n, 32, bo)),
    ]
    if width <= 9:  # the whole domain: an all-ones row, tail masked
        bodies.append(("member_ortree", lambda fn, t, bo: fn(t, width, n, tuple(range(dom)), bo)))
    if width > 17:  # 4097 windows: the lookup's search table read from device memory
        wide = tuple(range(0, 32 * 4097, 32)) + (v[2],)
        bodies.append(("member_ortree", lambda fn, t, bo: fn(t, width, n, wide, bo)))
    if width <= member.MAX_DOMAIN_WIDTH:
        bodies.append(("member_domain", lambda fn, t, bo: fn(t, keys, width, n, bo)))
        bodies.append(("member_domain", lambda fn, t, bo: fn(t, many, width, n, bo)))
    return bodies


def small_query_phase(device, errs: dict) -> None:
    """The query path's kernels against their plain versions at small
    ragged sizes: every width, ragged n, a block_offset; wrapped, empty,
    full and 2^32-ended ranges; mixed-width conjunctions with empty
    ranges; every member body."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.ops import conj, member, scan, unpack

    rng = np.random.default_rng(SEED + 1)

    def note(name, a, b):
        e = max(max_abs_err(a[0], b[0]), int((a[1] - b[1]).abs().max()))
        errs[name] = max(errs[name], e)

    for n in SMALL_NS:
        cols = {}
        for width in SMALL_WIDTHS:
            vals = torch.from_numpy(rng.integers(0, 1 << width, size=n).astype(np.int32)).to(device)
            cols[width] = (vals, unpack.pack_device_kernel(vals, width).tiles)
        for width, (vals, tiles) in cols.items():
            dom = 1 << width
            lows = [0, 1, dom - 1, 5, 3, 0xFFFFFFF0, int(vals[0])]
            highs = [dom, 0, 2, 5, 1 << 31, 0, int(vals[0]) + 1]  # [1, 2^32), wrapped, empty
            lo = torch.from_numpy(np.asarray(lows, np.uint32).view(np.int32)).to(device)
            hi = torch.from_numpy(np.asarray(highs, np.uint32).view(np.int32)).to(device)
            for bo in (0, 2):
                note("range_scan", scan.range_scan_tiles(tiles, lo, hi, width, n, bo),
                     scan.range_scan_tiles_plain(tiles, lo, hi, width, n, bo))
                for name, call in member_bodies(width, n, vals, rng):
                    note(name, call(getattr(member, f"_{name}_tiles"), tiles, bo),
                         call(getattr(member, f"_{name}_tiles_plain"), tiles, bo))
        widths = list(cols)
        for ws in (widths, widths[::-1][:3], [9], [1, 31], widths + [5, 12][: 8 - len(widths)]):
            tiles = [cols[w][1] if w in cols else
                     unpack.pack_device_kernel(cols[9][0] % (1 << w), w).tiles for w in ws]
            doms = [1 << w for w in ws]
            for lows, highs in (([d // 4 for d in doms], [d - d // 5 for d in doms]),
                                ([0] * len(ws), doms),
                                ([1] + [0] * (len(ws) - 1), [1] + doms[1:]),    # hi == lo
                                ([3] + [0] * (len(ws) - 1), [2] + doms[1:])):   # hi < lo
                for bo in (0, 2):
                    note("conj_range_scan",
                         conj.conj_range_scan_tiles(tiles, lows, highs, ws, n, bo),
                         conj.conj_range_scan_tiles_plain(tiles, np.asarray(lows, np.uint32),
                                                          np.asarray(highs, np.uint32), ws, n,
                                                          bo))
    torch.cuda.synchronize()
    for name in QUERY:
        check(errs[name] == 0, f"{name} kernel bit-exact against its plain version "
              f"(widths {SMALL_WIDTHS}, n {SMALL_NS})")


MEMBER_TABLE_WIDTHS = (1, 5, 9, 16, 17, 20, 31)
# rows of the compare and window tables: one, around the fused bitmap's
# limit (MEMBER_FUSED_ROWS: 256 keys, 128 windows) and one CTA's sort, and
# past it; a small search
# table before a chunked one (a launch must not cap the next one's shared
# memory)
MEMBER_TABLE_ROWS = (1, 4, 128, 129, 256, 257, 1025, 4097, 4096, 9000)


def member_table_operand(width: int, kind: str, rows: int, v) -> list:
    """Keys (spread over twice the domain, duplicates, a column value) or
    windows (any base below 2^width + 64, any popmask, some empty,
    duplicate bases, one at a column value) of ``rows`` rows."""
    import numpy as np

    rng = np.random.default_rng(rows + width)
    if kind == "keys":
        keys = rng.integers(0, 2 << width, size=rows)
        keys[rows // 2:: 97] = keys[0]
        keys[-1] = v[9]
        return keys
    bases = rng.integers(0, (1 << width) + 64, size=rows)
    bases[rows // 2:: 89] = bases[0]
    pops = rng.integers(0, 1 << 32, size=rows)
    pops[:: 13] = 0
    bases[-1], pops[-1] = max(int(v[4]) - 2, 0), 0b100
    return np.stack([bases, pops], axis=1)


def small_member_table_phase(device, errs: dict) -> None:
    """The compare and window kernels' tables, built on the card from keys
    or windows of 1 to 9000 rows at widths 1-31, bit-exact against the
    plain build; the kernels' rows (fused bitmap or not) against the plain
    table's lookup, with a block_offset."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.ops import member, scan, unpack

    n = SMALL_NS[1]
    rng = np.random.default_rng(SEED + 5)
    for width in MEMBER_TABLE_WIDTHS:
        vals = torch.from_numpy(rng.integers(0, 1 << width, size=n).astype(np.int32)).to(device)
        tiles = unpack.pack_device_kernel(vals, width).tiles
        v = vals.cpu().numpy()
        block_vals = scan._block_values_plain(tiles, width)
        lookup = (member._bitmap_row_plain if width <= member.MAX_DOMAIN_WIDTH
                  else member._search_row_plain)
        for kind, name in (("keys", "member_compare"), ("windows", "member_window")):
            for rows in MEMBER_TABLE_ROWS:
                a = member_table_operand(width, kind, rows, v)
                a = torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32))
                arg = {"keys": a} if kind == "keys" else {"win": a.reshape(-1, 2)}
                plain = member.member_operand_table_plain(width, **arg)
                arg = {k: t.to(device) for k, t in arg.items()}
                errs[name] = max(errs[name], max_abs_err(member.member_operand_table(width, **arg),
                                                         plain.to(device)))
                for bo in (0, 2):
                    want = member._member_finish(lookup(block_vals, plain.to(device)), n, bo)
                    got = (member._member_compare_tiles(tiles, arg["keys"], width, n, bo)
                           if kind == "keys" else
                           member._member_window_tiles(tiles, arg["win"], width, n, bo))
                    errs[name] = max(errs[name], max_abs_err(got[0], want[0]),
                                     int((got[1] - want[1]).abs().max()))
    torch.cuda.synchronize()
    for name in ("member_compare", "member_window"):
        check(errs[name] == 0, f"{name}: the table built on the card bit-exact against the plain "
              f"build, and the rows against its lookup (widths {MEMBER_TABLE_WIDTHS}, rows "
              f"{MEMBER_TABLE_ROWS})")


def draw_columns(device, n: int, widths: dict) -> dict:
    """Uniform int32 columns of n values below 2^width, drawn on the card in
    the order of ``widths`` from one generator seeded with SEED (so the
    query phase's table is the aggregate phase's, with revenue after it)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    return {name: torch.randint(0, 1 << w, (n,), generator=gen, device=device, dtype=torch.int32)
            for name, w in widths.items()}


MEMBER_HOST = {  # name -> (keys, the tier member_dispatch_tier names at width 9)
    "interval k=64": (list(range(100, 164)), "interval"),
    "window W4": (W4, "window"),
    "or-tree S8": (S8, "ortree"),
    "or-tree S64": (None, "ortree"),
    "compare [5, 300]": ([5, 300], "compare"),
}
MEMBER_RUNTIME = {  # name -> (keys, the runtime rule's kernel at width 9)
    "CUDA keys k=4": ([5, 77, 300, 411], "member_compare"),
    "CUDA keys k=16": ([3 + 31 * i for i in range(16)], "member_bitsliced"),
    "CUDA keys S64": (None, "member_domain"),
}
CHUNKED_COMPARE_KEYS = 64
CHUNKED_WINDOWS = [32 * i + i % 7 for i in range(40)]  # 16 in the 9-bit domain, 24 beyond
def w31_window_list() -> list[int]:
    """200 windows of 16 keys spread over 31 bits and five values of the
    column: the window tier past 32 windows (the OR-tree priced out by its
    liveness), 205 windows in chunks of 32."""
    import numpy as np

    rng = np.random.default_rng(1)
    bases = rng.choice(1 << 26, 200, replace=False) * 32
    keys = np.concatenate([b + rng.choice(32, 16, replace=False) for b in bases])
    return np.concatenate([keys, [3, 70, 141, 200, 262]]).tolist()


# member sets on wider i % 512 columns of 512 MiB packed: name -> (width,
# its keys, CUDA keys, the kernel its tier runs); w31_S256 takes the
# runtime rule's bit-sliced body (256 keys in chunks of 32)
MEMBER_WIDE = {"w31_list": (31, w31_window_list, False, "member_chunked_window"),
               "w20_k8": (20, lambda: S8, True, "member_compare"),
               "w31_S256": (31, s256, True, "member_bitsliced")}


def wide_member_column(device, width: int):
    """(values, DeviceColumn) of an i % 512 column of 512 MiB packed."""
    from shared_simd_scan_tpu_torch import pack_device_kernel
    from shared_simd_scan_tpu_torch.bench import harness

    vals = harness.synth_modk(harness.values_for(DATA_SIZE, width), DOMAIN, width, device=device)
    return vals, pack_device_kernel(vals, width)


def query_phase(device, arb) -> tuple[dict, dict]:
    """The query path at full size, with launch counts taken around it."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import bitvector, pack_device_kernel, query
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import member
    from shared_simd_scan_tpu_torch.parallel import multiproc_demo

    kernels = wrappers()
    n = harness.values_for(DATA_SIZE, WIDTH)
    raw = draw_columns(device, n, TABLE)
    cols = {name: pack_device_kernel(raw[name], w) for name, w in TABLE.items()}
    torch.cuda.synchronize()
    packed = sum(c.tiles.numel() * 4 for c in cols.values())
    print(f"query path: table of {n} rows, columns {TABLE}, {packed} bytes of tiles")
    trees = multiproc_demo.query_trees(query, cols)
    for name, expr in trees.items():
        print(f"explain {name}:\n{query.explain(expr)}")

    host = {name: (keys if keys is not None else s64(), tier)
            for name, (keys, tier) in MEMBER_HOST.items()}
    runtime = {name: (torch.tensor(keys if keys is not None else s64(), dtype=torch.int32,
                                   device=device), want)
               for name, (keys, want) in MEMBER_RUNTIME.items()}
    chunked_keys = member._pad_keys(torch.tensor(s64(), dtype=torch.int32, device=device),
                                    CHUNKED_COMPARE_KEYS)
    cb, cp = member.member_window_plan(np.asarray(CHUNKED_WINDOWS, np.uint32))
    cwin = np.concatenate([np.stack([cb, cp], axis=1), np.zeros(((-len(cb)) % 32, 2), np.int64)])
    cwin = torch.from_numpy(cwin.astype(np.uint32).view(np.int32)).to(device)

    wide = {}
    for name, (width, keys, on_card, _) in MEMBER_WIDE.items():
        keys = keys()
        wide[name] = (*wide_member_column(device, width), keys,
                      torch.tensor(keys, dtype=torch.int32, device=device) if on_card else keys)
    torch.cuda.synchronize()
    zero_launched(kernels.values())
    ran, outs = {}, {}

    def run(name, fn):
        before = {k: launched(f) for k, f in kernels.items()}
        outs[name] = fn()
        ran[name] = [k for k, f in kernels.items() if launched(f) > before[k]]

    t0 = time.monotonic()
    for name, expr in trees.items():
        run(name, lambda expr=expr: query.evaluate(expr))
    for name, (keys, _) in host.items():
        run(name, lambda keys=keys: member.member_scan_device(arb, keys))
    on_card = {name for name, spec in MEMBER_WIDE.items() if spec[2]}
    for name, (_, col, _, keys) in wide.items():
        if name not in on_card:
            run(name, lambda col=col, keys=keys: member.member_scan_device(col, keys))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # runtime keys: any device-to-host copy raises
    try:
        for name, (keys, _) in runtime.items():
            run(name, lambda keys=keys: member.member_scan_device(arb, keys))
        for name in on_card:
            _, col, _, keys = wide[name]
            run(name, lambda col=col, keys=keys: member.member_scan_device(col, keys))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    run("chunked compare, 64 keys", lambda: member._member_chunked_compare_tiles(
        arb.tiles, chunked_keys, WIDTH, n, 32))
    run("chunked window, 40 windows", lambda: member._member_chunked_window_tiles(
        arb.tiles, cwin, WIDTH, n, 32))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: launched(fn) for name, fn in kernels.items()}
    print(f"query path ran in {seconds:.3f} s (host clock, first calls); launches "
          f"{ {k: launches[k] for k in QUERY} }")

    for name in QUERY:
        check(launches[name] > 0, f"query path launched the {name} kernel ({launches[name]}x)")
    want_ran = {"Q1": ["conj_range_scan", "member_window"], "Q2": ["range_scan"],
                "Q3": ["conj_range_scan"], "Q4": ["member_domain"],
                "chunked compare, 64 keys": ["member_chunked_compare"],
                "chunked window, 40 windows": ["member_chunked_window"]}
    tier_kernel = {"interval": "range_scan", "window": "member_window",
                   "ortree": "member_ortree", "compare": "member_compare"}
    for name, (keys, tier) in host.items():
        got = member.member_dispatch_tier(keys, WIDTH)
        check(got == tier, f"{name}: member_dispatch_tier names {got}")
        want_ran[name] = [tier_kernel[tier]]
    for name, (_, want) in runtime.items():
        want_ran[name] = [want]
    for name, (_, _, _, want) in MEMBER_WIDE.items():
        want_ran[name] = [want]
    keys31 = wide["w31_list"][2]
    check(member.member_dispatch_tier(keys31, 31) == "window"
          and len(member.member_window_plan(keys31)[0]) > member._MAX_WINDOWS,
          "w31_list: member_dispatch_tier names the window tier, past 32 windows")
    for name, (vals, col, keys, _) in wide.items():
        bits, count = outs[name]
        expect = sum((col.n - 1 - key) // DOMAIN + 1 for key in set(keys) if key < DOMAIN)
        truth = torch.isin(vals, torch.tensor(keys, dtype=torch.int32, device=device))
        check(int(count) == expect and bool((bits == bitvector.from_bool(truth)).all()),
              f"{name} (width {col.width}, {len(keys)} keys): count {int(count)} == closed form "
              f"{expect}, every word equals torch.isin on the raw values")
        del truth
    del wide
    for name, want in want_ran.items():
        check(ran[name] == want, f"{name}: ran {ran[name]}, the kernel of its tier")

    for name in trees:
        truth = multiproc_demo.query_truth(name, raw)
        bits, count = outs[name]
        check(bool((bits == bitvector.from_bool(truth)).all()) and int(count) == int(truth.sum()),
              f"{name}: every word and the count ({int(count)}) equal the plain-torch predicate "
              "on the raw values")
        del truth
    del raw

    def closed_form(keys):
        return sum((n - 1 - key) // DOMAIN + 1 for key in set(keys) if key < DOMAIN)

    sets = {name: keys for name, (keys, _) in host.items()}
    sets.update({name: keys.tolist() for name, (keys, _) in runtime.items()})
    sets["chunked compare, 64 keys"] = s64()
    sets["chunked window, 40 windows"] = CHUNKED_WINDOWS
    for name, keys in sets.items():
        bits, count = outs[name]
        check(int(count) == closed_form(keys), f"{name}: count {int(count)} == closed form")
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        pbits, _ = member._member_compare_tiles_plain(arb.tiles, kt, WIDTH, n)
        if bits.ndim == 2:  # a direct call returns the tile layout
            bits = bits.reshape(-1)[: pbits.numel()]
        check(bool((bits == pbits.reshape(-1)[: bits.numel()]).all()),
              f"{name}: every word equals the plain compare version's")
    return cols, launches


TS0, DAY = 1_700_000_000, 86_400  # a day of timestamps from 1,700,000,000, as the demo draws
TS_IN = [TS0 + 2159 * i + 11 for i in range(40)]  # 40 keys spread over the day
NULL_SHARE = 0.1
DICT_N = 1 << 27  # cut from the main path's n: the host np.unique encode
SKUS = 150  # the demo's 40-bit SKUs: 150 distinct values
SKU_MULT = 982_451_653


_GENERIC = {"AUnaryFunctor", "BUnaryFunctor", "BinaryFunctor", "func_wrapper_t"}


def kernel_label(name: str) -> str:
    """A trace's kernel name, short: ``sss::<kernel>`` for the port's, else
    ``torch:<functor>`` for the PyTorch operation's."""
    m = re.search(r"sss::\w+", name)
    if m:
        return m.group(0)
    for token in re.findall(r"\w*Functor\w*|\w+_kernel_cuda|\w+_functor|CatArray\w+", name):
        if token not in _GENERIC:
            return f"torch:{token}"
    return f"torch:{name.split('(')[0][-60:]}"


def trace_kernels(log_dir: str) -> tuple[dict, dict]:
    """The Chrome trace in ``log_dir`` -> (kernel label -> summed device ms,
    ``sss_`` entry point -> summed ms of its ranges, on the card where the
    trace spans the entry point's kernels there, else on the host)."""
    (path,) = pathlib.Path(log_dir).glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    kernels, gpu, cpu = {}, {}, {}
    for e in events:
        name, cat = str(e.get("name", "")), e.get("cat")
        if cat == "kernel":
            label = kernel_label(name)
            kernels[label] = kernels.get(label, 0.0) + e["dur"] / 1e3
        elif name.startswith("sss.launch."):  # the span utils.profiling opens a launch
            entry = name[len("sss.launch."):]
            side = gpu if cat == "gpu_user_annotation" else cpu
            side[entry] = side.get(entry, 0.0) + e.get("dur", 0) / 1e3
    return kernels, gpu or cpu


def encodings_phase(device, n: int, dev, cols) -> None:
    """The FOR, dictionary and NULL-aware columns, persistence and the
    utilities at full size, each set with the launch counters set to 0
    just before it and read just after, checked against plain torch (or
    numpy) on the raw values; prints one ``{"encodings": ...}`` line."""
    import tempfile

    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import bitvector, dictcol, forcol, layout, nullable
    from shared_simd_scan_tpu_torch import io as sio
    from shared_simd_scan_tpu_torch import query as q
    from shared_simd_scan_tpu_torch import shared_scan_device, utils

    t_phase = time.monotonic()
    kernels = wrappers()
    ms, ran = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        zero_launched(kernels.values())
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        ran[name] = {k: launched(f) for k, f in kernels.items() if launched(f)}
        return out

    def same_bits(name, got, truth):
        bits, count = got
        check(bool((bits == bitvector.from_bool(truth)).all())
              and int(count) == int(truth.sum()),
              f"{name}: every word and the count ({int(count)}) equal plain torch on the raw values")

    # FOR: a day of timestamps at 17 bits
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    ts = torch.randint(TS0, TS0 + DAY, (n,), generator=gen, device=device, dtype=torch.int32)
    null_mask = torch.rand(n, generator=gen, device=device) < NULL_SHARE
    fts = run("F0 pack_for", lambda: forcol.pack_for(ts))
    base = int(ts.min())
    packed = {"ts FOR": layout.packed_nbytes(fts.width, n)}
    check(fts.width == 17 and fts.base == base,
          f"F0: timestamps FOR-encoded at 17 bits from base {base}, {packed['ts FOR']} bytes packed")
    trees = {"F1 Range": (q.Range(fts, TS0 + 40_000, TS0 + 50_000),
                          lambda: (ts >= TS0 + 40_000) & (ts < TS0 + 50_000)),
             "F2 Eq": (q.Eq(fts, TS0 + 12_345), lambda: ts == TS0 + 12_345),
             "F3 In 40 keys": (q.In(fts, TS_IN), lambda: torch.isin(
                 ts, torch.tensor(TS_IN, dtype=torch.int32, device=device)))}
    for name, (expr, truth) in trees.items():
        same_bits(name, run(name, lambda expr=expr: forcol.evaluate(expr)), truth())
    d = run("F4 describe", lambda: forcol.describe(fts))
    got_q = run("F5 quantiles", lambda: forcol.quantiles(fts, QS))
    srt = torch.sort(ts).values
    idx = [max(1, int(np.ceil(f * n))) - 1 for f in QS]
    want = {"n": n, "min": int(srt[0]), "max": int(srt[-1]),
            "mean": int((ts - base).sum(dtype=torch.int64)) / n + base,
            "median": int(srt[(n + 1) // 2 - 1]),
            "distinct": int((srt[1:] != srt[:-1]).sum()) + 1}
    check(d == want, f"F4: describe {d} equals the sorted raw values'")
    check(got_q.dtype == np.uint64 and got_q.tolist() == srt[idx].tolist(),
          f"F5: quantiles {QS} -> {got_q.tolist()} (uint64) equal the sorted raw values'")
    del srt
    back = run("F6 unpack_for", lambda: forcol.unpack_for(fts))
    check(back.dtype == np.uint64 and np.array_equal(back, ts.cpu().numpy().astype(np.uint64)),
          "F6: unpack_for gives back every timestamp (host uint64)")
    del back

    # NULLs: the query phase's 9-bit price with 10% NULLs
    raw = draw_columns(device, n, TABLE)
    nc = run("N0 pack_nullable", lambda: nullable.pack_nullable(raw["price"], null_mask, 9))
    packed["price nullable"] = layout.packed_nbytes(9, n)
    packed["nulls"] = nc.nulls.numel() * 4
    check(bool((nc.nulls == bitvector.from_bool(null_mask)).all()),
          f"N0: {int(null_mask.sum())} NULLs, {packed['nulls']} bytes of NULL words")
    p, g, s = raw["price"], raw["region"], raw["status"]
    known = ~null_mask
    leaf = q.Range(nc, 100, 400)
    in_leaf = (p >= 100) & (p < 400)
    st = torch.tensor([1, 4, 9], dtype=torch.int32, device=device)
    ntrees = {"N1 leaf": (leaf, lambda: in_leaf & known),
              "N2 Not(leaf)": (q.Not(leaf), lambda: ~in_leaf & known),
              "N3 And": (q.And(leaf, q.Range(cols["price"], 200, 500),
                               q.Range(cols["region"], 2, 10)),
                         lambda: in_leaf & known & (p >= 200) & (p < 500) & (g >= 2) & (g < 10)),
              "N4 Or": (q.Or(leaf, q.In(cols["status"], [1, 4, 9])),
                        lambda: (in_leaf & known) | torch.isin(s, st))}
    outs = {}
    for name, (expr, truth) in ntrees.items():
        outs[name] = run(name, lambda expr=expr: nullable.evaluate(expr))
        same_bits(name, outs[name], truth())
    conj = {name: ran[name].get("conj_range_scan", 0) for name in ("N1 leaf", "N3 And")}
    check(conj == {"N1 leaf": 1, "N3 And": 2},
          f"N3: the And's pure siblings ran as one conj_range_scan launch (the And {conj['N3 And']}"
          f" launches, its nullable leaf alone {conj['N1 leaf']})")
    where = ntrees["N3 And"][0]
    mask = ntrees["N3 And"][1]()
    want_sum, want_count = int(ts[mask].sum(dtype=torch.int64)), int(mask.sum())
    del mask
    total, count = run("N5 FOR sum", lambda: forcol.masked_aggregate(fts, outs["N3 And"][0]))
    check(total == want_sum and int(count) == want_count,
          f"N5: SUM(ts), COUNT(*) WHERE the And = {total}, {int(count)}: exact against Python ints")

    # utils: the NULL-aware WHERE and the FOR aggregate under the trace
    utils.reset_samples()
    with tempfile.TemporaryDirectory() as log_dir:
        with utils.trace(log_dir):
            torch.cuda.synchronize()
            with utils.ProfileSample("U0 where+sum", sync=True):
                bits_u, _ = nullable.evaluate(where)
                total_u, _ = forcol.masked_aggregate(fts, bits_u)
        traced, named = trace_kernels(log_dir)
    sample = utils.get_sample("U0 where+sum")
    device_ms = sum(traced.values())
    port_ms = sum(v for k, v in traced.items() if k.startswith("sss::"))
    host_ms = sample.total_ns / 1e6
    print(f"U0 trace: {device_ms:.6f} ms of device time ({port_ms:.6f} ms in the port's "
          f"kernels, {device_ms - port_ms:.6f} ms in PyTorch's) in {host_ms:.6f} ms of host "
          f"clock: the card idle {1 - device_ms / host_ms:.1%} of it; by kernel {traced}; the "
          f"sss_ entry points' ranges {named}")
    check(total_u == total and bool((bits_u == outs["N3 And"][0]).all()),
          "U0: the traced WHERE and sum equal the untraced ones")
    check(any(name.startswith("sss_") for name in named) and bool(traced),
          f"U0: the exported trace names sss_ entry points ({len(named)}) and their kernels")
    check(sample.count == 1 and host_ms >= device_ms,
          f"U0: ProfileSample(sync=True) took one sample, {host_ms:.6f} ms >= the kernels' "
          f"{device_ms:.6f} ms")
    check(utils.dump_memory(nc.nulls) == utils.dump_memory(nc.nulls.cpu()),
          "U1: dump_memory of the CUDA NULL words equals that of their CPU copy")

    # io: the main path's column, the query table and the NULL-aware result
    header = sio._HEADER.size
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        canon = layout.to_canonical(dev)
        run("I0 save_column", lambda: sio.save_column(canon, tmp / "main.sss"))
        table = {name: layout.to_canonical(c) for name, c in cols.items()}
        run("I1 save_table", lambda: sio.save_table(table, tmp / "table"))
        run("I2 save_bitvector", lambda: sio.save_bitvector(outs["N3 And"][0], n,
                                                            tmp / "where.sss"))
        files = {tmp / "main.sss": (sio.KIND_COLUMN, canon),
                 **{tmp / "table" / f"{name}.sss": (sio.KIND_COLUMN, c)
                    for name, c in table.items()},
                 tmp / "where.sss": (sio.KIND_BITVECTOR, None)}
        for path, (kind, col) in files.items():
            data = path.read_bytes()
            if col is None:
                width, nbytes, words = 0, (n + 7) // 8, outs["N3 And"][0]
            else:
                width, nbytes, words = col.width, col.nbytes_payload, col.words
            head = sio._HEADER.pack(sio.MAGIC, kind, width, 0, n)
            payload = words.cpu().numpy().view(np.uint8)[:nbytes]
            check(len(data) == header + nbytes and data[:header] == head
                  and np.array_equal(np.frombuffer(data, np.uint8, offset=header), payload),
                  f"{path.name}: {len(data)} bytes, exactly the header and the payload")
        manifest = json.loads((tmp / "table" / "MANIFEST.json").read_text())
        check(manifest == {name: {"width": c.width, "n": n} for name, c in table.items()},
              f"MANIFEST.json {manifest}")
        del table, canon
        loaded = run("I3 load_column", lambda: sio.load_column(tmp / "main.sss"))
        ltable = run("I4 load_table", lambda: sio.load_table(tmp / "table"))
        lbits, ln = run("I5 load_bitvector", lambda: sio.load_bitvector(tmp / "where.sss"))
    ldev = layout.to_device(loaded)
    check(loaded.words.is_cuda and bool((ldev.tiles == dev.tiles).all()),
          "I3: the loaded main-path column lies on the card, its tiles the original's")
    bits_l, counts_l = shared_scan_device(ldev, list(range(K)))
    bits_o, counts_o = shared_scan_device(dev, list(range(K)))
    check(bool((bits_l == bits_o).all()) and counts_l.tolist() == counts_o.tolist(),
          f"I3: shared_scan_device keys 0..7 of the loaded column equals the original's "
          f"({counts_l.tolist()})")
    del ldev, loaded, bits_l, bits_o
    check(list(ltable) == list(cols) and all(
        bool((layout.to_device(c).tiles == cols[name].tiles).all()) for name, c in ltable.items()),
        "I4: every loaded table column's tiles equal the original's")
    check(ln == n and lbits.is_cuda and bool((lbits == outs["N3 And"][0]).all()),
          "I5: the loaded NULL-aware result equals the one saved")
    del ltable, lbits, outs, raw, p, g, s, known, in_leaf, null_mask

    # dictionary: 40-bit SKUs of 150 distinct values at 2^27 rows
    print(f"dictionary: n = {DICT_N}, cut from the main path's {n}: the encode is the host's "
          "np.unique(..., return_inverse=True)")
    rng = np.random.default_rng(SEED)
    skus = (rng.integers(0, SKUS, DICT_N).astype(np.uint64) * np.uint64(SKU_MULT)) % (1 << 40)
    dc = run("D0 pack_dict", lambda: dictcol.pack_dict(skus))
    packed["sku dict"] = layout.packed_nbytes(dc.width, DICT_N)
    check(dc.width == 8 and dc.values.size == SKUS and dc.n == DICT_N,
          f"D0: SKUs dictionary-encoded at 8 bits ({dc.values.size} distinct), "
          f"{packed['sku dict']} bytes packed; encoded on the host in {ms['D0 pack_dict']:.1f} ms")
    sk = torch.from_numpy(skus.view(np.int64)).to(device)
    v = [int(x) for x in dc.values]
    fts2 = forcol.pack_for(ts[:DICT_N])
    t2 = ts[:DICT_N]
    absent = [v[3], v[3] + 1, v[140], 7, (1 << 40) + 5]  # three keys not in the dictionary
    dtrees = {"D1 Eq": (q.Eq(dc, v[17]), lambda: sk == v[17]),
              "D2 Range": (q.Range(dc, v[20], v[90]), lambda: (sk >= v[20]) & (sk < v[90])),
              "D3 In, absent keys": (q.In(dc, absent), lambda: torch.isin(
                  sk, torch.tensor(absent, dtype=torch.int64, device=device))),
              "D4 dict and FOR": (
                  q.And(q.Range(dc, v[10], v[120]), q.Range(fts2, TS0 + 10_000, TS0 + 60_000)),
                  lambda: (sk >= v[10]) & (sk < v[120]) & (t2 >= TS0 + 10_000)
                  & (t2 < TS0 + 60_000))}
    for name, (expr, truth) in dtrees.items():
        same_bits(name, run(name, lambda expr=expr: dictcol.evaluate(expr)), truth())
    uniq, counts = torch.unique(sk, return_counts=True)  # sorted ascending
    order = torch.sort(-counts, stable=True).indices[:5]
    top, top_counts = run("D5 topk_values", lambda: dictcol.topk_values(dc, 5))
    check(top.tolist() == uniq[order].tolist() and top_counts.tolist() == counts[order].tolist(),
          f"D5: top-5 SKUs {top.tolist()} and counts equal torch.unique's")
    d = run("D6 describe", lambda: dictcol.describe(dc))
    uv, uc = uniq.tolist(), counts.tolist()
    cum = np.cumsum(uc)
    want = {"n": DICT_N, "min": uv[0], "max": uv[-1],
            "mean": sum(a * b for a, b in zip(uv, uc)) / DICT_N,
            "median": uv[int(np.searchsorted(cum, (DICT_N + 1) // 2))], "distinct": len(uv)}
    check(d == want, f"D6: describe {d} equals torch.unique's counts")
    back = run("D7 unpack_dict", lambda: dictcol.unpack_dict(dc))
    check(back.dtype == np.uint64 and np.array_equal(back, skus),
          "D7: unpack_dict gives back every SKU (host uint64)")
    del back, sk, skus, t2, fts2, dc, fts, ts
    torch.cuda.empty_cache()

    seconds = time.monotonic() - t_phase
    print(json.dumps({"encodings": {
        "card": nvidia_smi(), "n": n, "dict_n": DICT_N, "dict_cut_from": n,
        "dict_encode_ms": ms["D0 pack_dict"], "packed_bytes": packed, "ms": ms,
        "launches": ran, "trace": {"device_ms": device_ms, "port_kernels_ms": port_ms, "host_ms": host_ms,
                                   "kernels": traced, "entry_points": named},
        "seconds": seconds}}))
    print(f"encodings phase ran in {seconds:.1f} s")


def query_timing_phase(device, cols, arb, errs: dict) -> dict:
    """Each query-path kernel and its plain version at full size: the
    conjunctions of Q1 (m=2) and Q3 (m=3) and the range scan of Q2 (k=3) on
    the table, each member body on the i % 512 column; and Q1's whole
    ``evaluate``, host included."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import query
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import conj, member, scan
    from shared_simd_scan_tpu_torch.parallel import multiproc_demo

    n = cols["price"].n
    nblocks = arb.tiles.shape[1] * LANES
    row = nblocks * 4

    def tile_bytes(*ts):
        return sum(t.numel() * 4 for t in ts)

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    p, g, s = (cols[k].tiles for k in TABLE)
    at = arb.tiles
    lo3, hi3 = t32([0, 300, 500]), t32([50, 350, 512])
    k4, k16, k64 = (t32(MEMBER_RUNTIME[k][0] or s64()) for k in MEMBER_RUNTIME)
    chunked = member._pad_keys(k64, CHUNKED_COMPARE_KEYS)
    wb, wp = member.member_window_plan(np.asarray(W4, np.uint32))
    win = t32(np.stack([wb, wp], axis=1))
    cb, cp = member.member_window_plan(np.asarray(CHUNKED_WINDOWS, np.uint32))
    cwin = t32(np.concatenate([np.stack([cb, cp], axis=1),
                               np.zeros(((-len(cb)) % 32, 2), np.int64)]))
    s8, s64_ = tuple(S8), tuple(s64())
    conj_plain = conj.conj_range_scan_tiles_plain
    pairs = {  # name -> (kernel, plain, bytes it must move)
        "conj_range_scan m=2": (
            lambda: conj.conj_range_scan_tiles((p, g), [100, 2], [400, 10], (9, 5), n),
            lambda: conj_plain((p, g), np.asarray([100, 2], np.uint32),
                               np.asarray([400, 10], np.uint32), (9, 5), n),
            tile_bytes(p, g) + row + 8),
        "conj_range_scan m=3": (
            lambda: conj.conj_range_scan_tiles((p, g, s), [3, 4, 5], [4, 5, 6], (9, 5, 4), n),
            lambda: conj_plain((p, g, s), np.asarray([3, 4, 5], np.uint32),
                               np.asarray([4, 5, 6], np.uint32), (9, 5, 4), n),
            tile_bytes(p, g, s) + row + 8),
        "range_scan k=3": (
            lambda: scan.range_scan_tiles(p, lo3, hi3, 9, n),
            lambda: scan.range_scan_tiles_plain(p, lo3, hi3, 9, n),
            tile_bytes(p) + 3 * (row + 8 + 8)),
        "member_compare k=4": (
            lambda: member._member_compare_tiles(at, k4, WIDTH, n),
            lambda: member._member_compare_tiles_plain(at, k4, WIDTH, n),
            tile_bytes(at) + row + 8 + 4 * 4),
        "member_chunked_compare k=64": (
            lambda: member._member_chunked_compare_tiles(at, chunked, WIDTH, n, 32),
            lambda: member._member_chunked_compare_tiles_plain(at, chunked, WIDTH, n, 32),
            tile_bytes(at) + row + 8 + 64 * 4),
        "member_window W4": (
            lambda: member._member_window_tiles(at, win, WIDTH, n),
            lambda: member._member_window_tiles_plain(at, win, WIDTH, n),
            tile_bytes(at) + row + 8 + 8),
        "member_chunked_window 40 windows": (
            lambda: member._member_chunked_window_tiles(at, cwin, WIDTH, n, 32),
            lambda: member._member_chunked_window_tiles_plain(at, cwin, WIDTH, n, 32),
            tile_bytes(at) + row + 8 + 64 * 8),
        "member_domain k=64": (
            lambda: member._member_domain_tiles(at, k64, WIDTH, n),
            lambda: member._member_domain_tiles_plain(at, k64, WIDTH, n),
            tile_bytes(at) + row + 8 + 64 * 4),
        "member_ortree S8": (
            lambda: member._member_ortree_tiles(at, WIDTH, n, s8),
            lambda: member._member_ortree_tiles_plain(at, WIDTH, n, s8),
            tile_bytes(at) + row + 8),
        "member_ortree S64": (
            lambda: member._member_ortree_tiles(at, WIDTH, n, s64_),
            lambda: member._member_ortree_tiles_plain(at, WIDTH, n, s64_),
            tile_bytes(at) + row + 8),
        "member_bitsliced k=16": (
            lambda: member._member_bitsliced_tiles(at, k16, WIDTH, n, 16),
            lambda: member._member_bitsliced_tiles_plain(at, k16, WIDTH, n, 16),
            tile_bytes(at) + row + 8 + 16 * 4),
    }
    # the wide sets' bodies as member_scan_device dispatches them
    _, c31 = wide_member_column(device, 31)
    wb31, wp31 = member.member_window_plan(np.asarray(w31_window_list(), np.uint32))
    w31 = t32(np.concatenate([np.stack([wb31, wp31], axis=1),
                              np.zeros(((-len(wb31)) % 32, 2), np.int64)]))
    _, c20 = wide_member_column(device, 20)
    k8 = t32(MEMBER_WIDE["w20_k8"][1]())
    k256 = member._pad_keys(t32(MEMBER_WIDE["w31_S256"][1]()), 32)
    pairs["member_chunked_window w31_list"] = (
        lambda: member._member_chunked_window_tiles(c31.tiles, w31, 31, c31.n, 32),
        lambda: member._member_chunked_window_tiles_plain(c31.tiles, w31, 31, c31.n, 32),
        tile_bytes(c31.tiles) + c31.tiles.shape[1] * LANES * 4 + 8 + w31.numel() * 4)
    pairs["member_compare w20_k8"] = (
        lambda: member._member_compare_tiles(c20.tiles, k8, 20, c20.n),
        lambda: member._member_compare_tiles_plain(c20.tiles, k8, 20, c20.n),
        tile_bytes(c20.tiles) + c20.tiles.shape[1] * LANES * 4 + 8 + k8.numel() * 4)
    pairs["member_bitsliced w31_S256"] = (
        lambda: member._member_bitsliced_tiles(c31.tiles, k256, 31, c31.n, 32),
        lambda: member._member_bitsliced_tiles_plain(c31.tiles, k256, 31, c31.n, 32),
        tile_bytes(c31.tiles) + c31.tiles.shape[1] * LANES * 4 + 8 + 256 * 4)
    for name, (kern, plain, _) in pairs.items():
        kernel = name.split()[0]
        a, b = kern(), plain()
        errs[kernel] = max(errs[kernel], max_abs_err(a[0], b[0]),
                           int((a[1] - b[1]).abs().max()))
        del a, b
        check(errs[kernel] == 0, f"{name} kernel bit-exact against its plain version at full size")

    results = {}
    copy_dst = torch.empty_like(at)
    copy_ms = time_ms(lambda: copy_dst.copy_(at), batches=5, calls=10)
    copy_rate = 2 * tile_bytes(at) / (copy_ms * 1e-3)
    print(f"copy_ of the i % 512 column ({tile_bytes(at)} bytes): {copy_ms:.6f} ms, "
          f"{copy_rate:.6e} bytes/s")
    for name, (kern, plain, nbytes) in pairs.items():
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rate = nbytes / (ms * 1e-3)
        results[name] = (ms, plain_ms, bound_ms)
        print(f"time {name}: kernel {ms:.6f} ms ({rate:.6e} bytes/s, {rate / copy_rate:.4f} of "
              f"copy, bound {bound_ms:.6f} ms for {nbytes} bytes); plain {plain_ms:.6f} ms")
    # Q1's conjunction composed from single-column passes instead: two
    # range scans, each writing its row, then a word-wise AND
    lo_p, hi_p, lo_g, hi_g = t32([100]), t32([400]), t32([2]), t32([10])

    def composed():
        a, _ = scan.range_scan_tiles(p, lo_p, hi_p, 9, n)
        b, _ = scan.range_scan_tiles(g, lo_g, hi_g, 5, n)
        return a[0] & b[0]

    fused = pairs["conj_range_scan m=2"][0]()[0]
    check(bool((composed() == fused).all()), "Q1's conjunction composed == fused, every word")
    del fused
    ms = time_ms(composed, batches=5, calls=10)
    print(f"time Q1 conjunction composed (2 range scans + AND): {ms:.6f} ms, against "
          f"{results['conj_range_scan m=2'][0]:.6f} ms fused")
    kernel_report({"member_lookup_kernelILi9ELi0E": "member lookup, bitmap, width 9",
                   "member_lookup_kernelILi9ELi3ENS_7KeyRows": "member compare, the bitmap each "
                   "CTA builds from the keys, width 9"})
    q1 = multiproc_demo.query_trees(query, cols)["Q1"]
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        query.evaluate(q1)
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    print(f"time Q1 evaluate (host clock, host included): median {statistics.median(walls[1:]):.6f}"
          f" ms of {len(walls) - 1} after a warm-up")
    return results


def max_err(a, b) -> int:
    """Largest |a - b| over the int64 tensors of two results (0 = exact)."""
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        raise CheckFailed(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a - b).abs().max()) if a.numel() else 0


def small_aggregate_phase(device, errs: dict) -> None:
    """The aggregate kernels against their plain versions at small ragged
    sizes: pairs of widths, k = 1, 2, 4 and 32 with key 0 over the
    padding, duplicates, keys >= 2^wp and 0xFFFFFFFF, a block_offset, a
    masked bitvector; and sums past 2^32 (wm = 31, every value 2^31 - 1,
    every row matching)."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import bitvector
    from shared_simd_scan_tpu_torch.ops import aggregate as agg
    from shared_simd_scan_tpu_torch.ops import unpack

    rng = np.random.default_rng(SEED + 2)

    def note(name, kern, plain):
        errs[name] = max(errs[name], max_err(kern(), plain()))

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    for n in SMALL_NS:
        for wp, wm in AGG_PAIRS:
            pv = t32(rng.integers(0, 1 << wp, size=n))
            mv = t32(rng.integers(0, 1 << wm, size=n))
            pt, mt = unpack.pack_device_kernel(pv, wp).tiles, unpack.pack_device_kernel(mv, wm).tiles
            dom, v = 1 << wp, [int(x) for x in pv[:4].tolist()]
            bo = (n % 3) * 2  # a shard whose tail lies further on, for some n
            for keys in ([v[0]], [0, dom], [v[1], v[1], 0xFFFFFFFF, 0],
                         rng.integers(0, min(dom, 64), size=30).tolist() + [dom, 0xFFFFFFFF]):
                kt = t32(keys)
                for name in ("aggregate_scan", "aggregate_bitplane", "minmax_scan"):
                    fn = getattr(agg, f"{name}_tiles")
                    plain = getattr(agg, f"{name}_tiles_plain")
                    note(name, lambda: fn(pt, mt, kt, wp, wm, n, bo),
                         lambda: plain(pt, mt, kt, wp, wm, n, bo))
                note("aggregate_bitplane_static",
                     lambda: agg.aggregate_bitplane_static_tiles(pt, mt, keys, wp, wm, n, bo),
                     lambda: agg.aggregate_bitplane_static_tiles_plain(pt, mt, keys, wp, wm, n, bo))
            mask = torch.from_numpy(rng.random(n) < 0.3).to(device)
            row = agg.bits_from_canonical(bitvector.from_bool(mask), pt.shape[1])
            note("masked_aggregate", lambda: agg.masked_aggregate_tiles(mt, row, wm, n),
                 lambda: agg.masked_aggregate_tiles_plain(mt, row, wm, n))
    # headroom: every value 2^31 - 1 and every row matching key 5
    n, top = SMALL_NS[-1], (1 << 31) - 1
    pt = unpack.pack_device_kernel(t32(np.full(n, 5)), 3).tiles
    mt = unpack.pack_device_kernel(t32(np.full(n, top)), 31).tiles
    kt = t32([5, 0])
    row = agg.bits_from_canonical(bitvector.from_bool(torch.ones(n, dtype=torch.bool,
                                                                 device=device)), pt.shape[1])
    sums = {
        "aggregate_scan": agg.aggregate_scan_tiles(pt, mt, kt, 3, 31, n)[1][0],
        "aggregate_bitplane": agg.aggregate_bitplane_tiles(pt, mt, kt, 3, 31, n)[1][0],
        "aggregate_bitplane_static": agg.aggregate_bitplane_static_tiles(pt, mt, [5, 0], 3, 31,
                                                                         n)[1][0],
        "masked_aggregate": agg.masked_aggregate_tiles(mt, row, 31, n)[1],
    }
    torch.cuda.synchronize()
    for name, total in sums.items():
        check(int(total) == n * top, f"{name}: all-max wm=31 sum {int(total)} == {n} x (2^31 - 1)"
              " (past 2^32)")
    _, mins, maxs = agg.minmax_scan_tiles(pt, mt, kt, 3, 31, n)
    check(mins.tolist() == [top, 1 << 31] and maxs.tolist() == [top, 0],
          "minmax_scan: all-max wm=31 min and max, and the empty group's 2^31 and 0")
    for name in AGGREGATE:
        check(errs[name] == 0, f"{name} kernel exact against its plain version "
              f"(width pairs {AGG_PAIRS}, n {SMALL_NS})")


def small_lookup_phase(device, errs: dict) -> None:
    """The edges of the one-pass kernels that replaced per-key work,
    against their plain versions: the key lookup aggregate on constant,
    90%-skewed and uniform predicates at the byte table's widths and the
    search's, with key 0 over the padding of a ragged n, a duplicate, keys
    >= 2^wp and 0xFFFFFFFF, a block_offset, and a sum past 2^32 within one
    CTA (8192 values of 2^31 - 1, one tile); the same SUM for keys in
    device memory (k = 1, 7 and 32) and the MIN/MAX lookup, on the same
    columns and a sorted one (past 16 bits also keys whose 16-bit windows
    meet at every shift, which leave each CTA the binary search, where
    spread keys take its window), a measure that falls with the row index
    (every value a new minimum) and a uniform 31-bit one; the chunked histogram
    tier (the fold's counts form and the bins kernel) on the same kinds of
    columns at widths 1-12 and 31, keys from 2^32 - 3 (k = 40 and 1000: all
    zeros) and a block_offset."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.ops import aggregate as agg
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    rng = np.random.default_rng(SEED + 7)

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    def columns(width, n):
        dom = 1 << width
        uniform = rng.integers(0, dom, size=n)
        return {"uniform": uniform, "constant": np.full(n, dom // 3),
                "skewed": np.where(rng.random(n) < 0.9, dom - 1, uniform)}

    n = SMALL_NS[1]  # not a multiple of 32: the last block holds padding
    falling = unpack.pack_device_kernel(t32(((1 << 20) - 1 - np.arange(n)) % (1 << 20)), 20).tiles
    for wp in (1, 5, 16, 17, 20, 31):
        dom = 1 << wp
        for label, pv in {**columns(wp, n), "sorted": np.sort(rng.integers(0, dom, n))}.items():
            pt = unpack.pack_device_kernel(t32(pv), wp).tiles
            keys = [0, int(pv[1]), int(pv[1]), dom, 0xFFFFFFFF, dom // 3, dom - 1]
            wide = keys + rng.integers(0, dom, size=25).tolist()  # k = 32
            for wm in (1, 31):
                mt = unpack.pack_device_kernel(t32(rng.integers(0, 1 << wm, size=n)), wm).tiles
                for bo in (0, 3):
                    errs["aggregate_bitplane_static"] = max(
                        errs["aggregate_bitplane_static"],
                        max_err(agg.aggregate_bitplane_static_tiles(pt, mt, keys, wp, wm, n, bo),
                                agg.aggregate_bitplane_static_tiles_plain(pt, mt, keys, wp, wm, n,
                                                                          bo)))
                    for kt in (t32(keys[:1]), t32(keys), t32(wide)):  # keys in device memory
                        errs["aggregate_bitplane"] = max(
                            errs["aggregate_bitplane"],
                            max_err(agg.aggregate_bitplane_tiles(pt, mt, kt, wp, wm, n, bo),
                                    agg.aggregate_bitplane_tiles_plain(pt, mt, kt, wp, wm, n, bo)))
                    for kt, m, w in ((t32(keys), mt, wm), (t32(keys), falling, 20)):
                        errs["minmax_scan"] = max(
                            errs["minmax_scan"],
                            max_err(agg.minmax_scan_tiles(pt, m, kt, wp, w, n, bo),
                                    agg.minmax_scan_tiles_plain(pt, m, kt, wp, w, n, bo)))
            if wp > 16:  # windows that meet at every shift: the search
                clash = t32([0, 1 << (wp - 1), 4, 5, int(pv[1]), dom, 4])
                errs["minmax_scan"] = max(
                    errs["minmax_scan"],
                    max_err(agg.minmax_scan_tiles(pt, falling, clash, wp, 20, n, 3),
                            agg.minmax_scan_tiles_plain(pt, falling, clash, wp, 20, n, 3)))
                errs["aggregate_bitplane"] = max(
                    errs["aggregate_bitplane"],
                    max_err(agg.aggregate_bitplane_tiles(pt, falling, clash, wp, 20, n, 3),
                            agg.aggregate_bitplane_tiles_plain(pt, falling, clash, wp, 20, n, 3)))
    top = (1 << 31) - 1
    pt = unpack.pack_device_kernel(t32(np.full(8192, 5)), 3).tiles
    mt = unpack.pack_device_kernel(t32(np.full(8192, top)), 31).tiles
    for name, keys in (("aggregate_bitplane_static", [5, 0, 5]),
                       ("aggregate_bitplane", t32([5, 0, 5]))):
        counts, sums = getattr(agg, f"{name}_tiles")(pt, mt, keys, 3, 31, 8192)
        check(counts.tolist() == [8192, 0, 8192] and sums.tolist() == [8192 * top, 0, 8192 * top],
              f"{name}: one CTA's sum {sums.tolist()[0]} of 8192 values 2^31 - 1 (past 2^32), "
              "a duplicate key and an absent one")
    for width in (*range(1, 13), 31):
        dom = 1 << width
        for label, vals in columns(width, n).items():
            tiles = unpack.pack_device_kernel(t32(vals), width).tiles
            for lo, k in ((0, min(dom, 4096)), (0, 1), (0, 2), (dom // 3, 8), (0, 40),
                          ((1 << 32) - 3, 40), ((1 << 32) - 3, 1000)):
                for bo in (0, 3):
                    errs["histogram_dag"] = max(
                        errs["histogram_dag"],
                        max_err(scan._histogram_chunked_tiles(tiles, lo, k, width, n, bo),
                                scan._histogram_chunked_tiles_plain(tiles, lo, k, width, n, bo)))
            zero = scan._histogram_chunked_tiles(tiles, (1 << 32) - 3, 1000, width, n)
            check(int(zero.abs().sum()) == 0, f"histogram_dag: keys from 2^32 - 3 count nothing "
                  f"(width {width}, {label})")
    torch.cuda.synchronize()
    for name in ("aggregate_bitplane_static", "aggregate_bitplane", "minmax_scan",
                 "histogram_dag"):
        check(errs[name] == 0, f"{name} kernel exact against its plain version on constant, "
              f"skewed and uniform columns (n {n}, block_offset 0 and 3)")


# the aggregate phase's sets: name -> (what, the tier pick_aggregate_tier must name)
AGG_SETS = {
    "A1": ("masked_aggregate_device(revenue, evaluate(Q1))", None),
    "A2": ("aggregate_scan_device(region, revenue, 0..31), host keys", "bitplane"),
    "A3": ("aggregate_scan_device(price, revenue, [3]), host keys", "compare"),
    "A4": ("aggregate_scan_device(region, revenue, CUDA keys 0..7)", "bitplane"),
    "A5": ("aggregate_scan_device(price, revenue, CUDA keys [3, 70])", "compare"),
    "A6": ("minmax_scan_device(region, revenue, 0..7)", None),
    "A7": ("aggregate_scan_device(revenue, price, 16 spread host keys)", "bitplane"),
    "A8": ("minmax_scan_device(revenue, price, A7's keys as a CUDA tensor)", None),
    "A9": ("aggregate_scan_device(revenue, price, A7's keys as a CUDA tensor)", "bitplane"),
}
# A7's keys: 16 values spread over revenue's 20-bit domain
A7_KEYS = [5521, 58228, 236145, 298913, 314745, 524063, 606377, 655451, 717405, 813357, 861120,
           874138, 915983, 940786, 956952, 990790]
AGG_KEYS = {"A2": list(range(32)), "A3": [3], "A4": list(range(8)), "A5": [3, 70],
            "A6": list(range(8)), "A7": A7_KEYS, "A8": A7_KEYS, "A9": A7_KEYS}


def aggregate_phase(device, cols) -> tuple[dict, dict]:
    """The aggregate path at full size, with launch counts taken around it."""
    import torch
    from shared_simd_scan_tpu_torch import aggregate_scan_device, masked_aggregate_device
    from shared_simd_scan_tpu_torch import minmax_scan_device, pack_device_kernel, query
    from shared_simd_scan_tpu_torch.ops import aggregate
    from shared_simd_scan_tpu_torch.parallel import multiproc_demo

    kernels = {name: fn for name, fn in wrappers().items() if name in AGGREGATE}
    n = cols["price"].n
    raw = draw_columns(device, n, {**TABLE, "revenue": REVENUE_WIDTH})
    rev = pack_device_kernel(raw["revenue"], REVENUE_WIDTH)
    price, region = cols["price"], cols["region"]
    torch.cuda.synchronize()
    print(f"aggregate path: measure revenue {REVENUE_WIDTH}-bit, n {n}, tiles "
          f"{tuple(rev.tiles.shape)} ({rev.tiles.numel() * 4} bytes)")
    q1 = multiproc_demo.query_trees(query, cols)["Q1"]
    runtime = {name: torch.tensor(AGG_KEYS[name], dtype=torch.int32, device=device)
               for name in ("A4", "A5", "A8", "A9")}
    calls = {
        "A1": lambda: masked_aggregate_device(rev, query.evaluate(q1)[0]),
        "A2": lambda: aggregate_scan_device(region, rev, AGG_KEYS["A2"]),
        "A3": lambda: aggregate_scan_device(price, rev, AGG_KEYS["A3"]),
        "A4": lambda: aggregate_scan_device(region, rev, runtime["A4"]),
        "A5": lambda: aggregate_scan_device(price, rev, runtime["A5"]),
        "A6": lambda: minmax_scan_device(region, rev, AGG_KEYS["A6"]),
        "A7": lambda: aggregate_scan_device(rev, price, AGG_KEYS["A7"]),
        "A8": lambda: minmax_scan_device(rev, price, runtime["A8"]),
        "A9": lambda: aggregate_scan_device(rev, price, runtime["A9"]),
    }
    zero_launched(kernels.values())
    ran, outs = {}, {}
    t0 = time.monotonic()
    for name, call in calls.items():
        before = {k: launched(f) for k, f in kernels.items()}
        if name in runtime:  # runtime keys: any device-to-host copy raises
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs[name] = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ran[name] = [k for k, f in kernels.items() if launched(f) > before[k]]
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {name: launched(fn) for name, fn in kernels.items()}
    print(f"aggregate path ran in {seconds:.3f} s (host clock, first calls); launches {launches}")

    for name in AGGREGATE:
        check(launches[name] > 0, f"aggregate path launched the {name} kernel ({launches[name]}x)")
    # set -> (predicate, measure, the predicate's name) of its keyed aggregate
    columns = {"A2": (region, rev, "region"), "A3": (price, rev, "price"),
               "A4": (region, rev, "region"), "A5": (price, rev, "price"),
               "A7": (rev, price, "revenue"), "A9": (rev, price, "revenue")}
    tier_kernel = {("bitplane", False): "aggregate_bitplane_static", ("compare", False):
                   "aggregate_scan", ("bitplane", True): "aggregate_bitplane",
                   ("compare", True): "aggregate_scan"}
    want = {"A1": "masked_aggregate", "A6": "minmax_scan", "A8": "minmax_scan"}
    for name, (pcol, mcol, _) in columns.items():
        keys = runtime.get(name, AGG_KEYS[name])
        tier = aggregate.pick_aggregate_tier(pcol.width, mcol.width, keys)
        check(tier == AGG_SETS[name][1], f"{name}: pick_aggregate_tier names {tier}")
        want[name] = tier_kernel[(tier, name in runtime)]
    for name, (what, _) in AGG_SETS.items():
        check(ran[name] == [want[name]], f"{name} {what}: ran {ran[name]}, the kernel of its tier")

    # the same aggregates with plain torch on the raw values
    r64 = raw["revenue"].to(torch.int64)
    truth = {}
    for cname, dom in (("region", 1 << TABLE["region"]), ("price", 1 << TABLE["price"])):
        g = raw[cname].to(torch.int64)
        truth[cname] = (torch.zeros(dom, dtype=torch.int64, device=device).scatter_add_(0, g, r64),
                        torch.bincount(g, minlength=dom))
        if cname == "region":
            mins = torch.full((dom,), (1 << 31) - 1, dtype=torch.int32, device=device)
            maxs = torch.full((dom,), -1, dtype=torch.int32, device=device)
            mins.scatter_reduce_(0, g, raw["revenue"], "amin")
            maxs.scatter_reduce_(0, g, raw["revenue"], "amax")
            truth["minmax"] = (mins, maxs)
        del g
    g = raw["revenue"].to(torch.int64)
    truth["revenue"] = (torch.zeros(1 << REVENUE_WIDTH, dtype=torch.int64, device=device)
                        .scatter_add_(0, g, raw["price"].to(torch.int64)),
                        torch.bincount(g, minlength=1 << REVENUE_WIDTH))
    dom = 1 << REVENUE_WIDTH
    truth["minmax_revenue"] = (
        torch.full((dom,), (1 << 31) - 1, dtype=torch.int32, device=device).scatter_reduce_(
            0, g, raw["price"], "amin"),
        torch.full((dom,), -1, dtype=torch.int32, device=device).scatter_reduce_(
            0, g, raw["price"], "amax"))
    del g
    mask = multiproc_demo.query_truth("Q1", raw)
    total, count = outs["A1"]
    want_total = int(torch.where(mask, r64, 0).sum())
    check(int(count) == int(mask.sum()) and int(total) == want_total,
          f"A1: SUM(revenue) {int(total)} and COUNT {int(count)} over Q1 == the masked plain-torch "
          "sum and count on the raw values")
    for name, (_, _, pname) in columns.items():
        sums, counts = outs[name]
        keys = torch.tensor(AGG_KEYS[name], device=device)
        tsums, tcounts = truth[pname]
        check(torch.equal(sums, tsums[keys]) and torch.equal(counts, tcounts[keys]),
              f"{name}: every sum and count equals scatter_add_ / bincount on the raw values")
    mins, maxs, counts = outs["A6"]
    keys = torch.tensor(AGG_KEYS["A6"], device=device)
    check(torch.equal(counts, truth["region"][1][keys])
          and torch.equal(mins, truth["minmax"][0][keys].to(torch.int64))
          and torch.equal(maxs, truth["minmax"][1][keys].to(torch.int64)),
          "A6: every count, min and max equals bincount / scatter_reduce_ (amin, amax) on the raw "
          "values")
    mins8, maxs8, counts8 = outs["A8"]
    keys = torch.tensor(AGG_KEYS["A8"], device=device)
    empty = truth["revenue"][1][keys] == 0
    check(torch.equal(counts8, truth["revenue"][1][keys])
          and torch.equal(mins8, torch.where(empty, 1 << TABLE["price"],
                                             truth["minmax_revenue"][0][keys].to(torch.int64)))
          and torch.equal(maxs8, torch.where(empty, 0,
                                             truth["minmax_revenue"][1][keys].to(torch.int64))),
          "A8: every count, min and max equals bincount / scatter_reduce_ (amin, amax) on the raw "
          "values (20-bit predicate, keys as a CUDA tensor)")
    print(f"A1: SUM(revenue) {int(total)}, COUNT {int(count)}; A2 sums[:4] "
          f"{outs['A2'][0][:4].tolist()}; A6 mins {mins.tolist()}, maxs {maxs.tolist()}; A7 "
          f"counts {outs['A7'][1].tolist()}; A8 mins {mins8.tolist()}, maxs {maxs8.tolist()}")
    row = aggregate.bits_from_canonical(query.evaluate(q1)[0], rev.tiles.shape[1])
    del raw, r64, mask, truth
    return {"rev": rev, "row": row, "runtime": runtime}, launches


def aggregate_timing_phase(device, cols, agg_data, errs: dict) -> dict:
    """Each aggregate kernel and its plain version at full size on the sets
    of the aggregate phase (A1 the masked aggregate over Q1's bitvector);
    beside them, without plain versions, the other keyed tiers on each
    keyed set, for the tier comparison; and A1 end to end, ``evaluate``
    included."""
    import torch
    from shared_simd_scan_tpu_torch import masked_aggregate_device, query
    from shared_simd_scan_tpu_torch.ops import aggregate as agg
    from shared_simd_scan_tpu_torch.parallel import multiproc_demo

    n = cols["price"].n
    rev, row, runtime = agg_data["rev"], agg_data["row"], agg_data["runtime"]
    mt = rev.tiles
    pt = {"A2": cols["region"].tiles, "A3": cols["price"].tiles, "A4": cols["region"].tiles,
          "A5": cols["price"].tiles, "A6": cols["region"].tiles}
    wp = {"A2": TABLE["region"], "A3": TABLE["price"], "A4": TABLE["region"],
          "A5": TABLE["price"], "A6": TABLE["region"]}
    ktens = {name: runtime.get(name, torch.tensor(AGG_KEYS[name], dtype=torch.int32,
                                                  device=device)) for name in AGG_KEYS}
    wm = REVENUE_WIDTH

    def nbytes(name, outputs):  # each input read once, each output written once
        tiles = mt.numel() * 4 + (row.numel() * 4 if name == "A1" else pt[name].numel() * 4)
        k = 1 if name == "A1" else len(AGG_KEYS[name])
        return tiles + (0 if name == "A1" else 4 * k) + 8 * outputs * k

    pairs = {  # "kernel set" -> (kernel, plain or None, bytes it must move)
        "masked_aggregate A1": (lambda: agg.masked_aggregate_tiles(mt, row, wm, n),
                                lambda: agg.masked_aggregate_tiles_plain(mt, row, wm, n),
                                nbytes("A1", 2)),
        "minmax_scan A6": (lambda: agg.minmax_scan_tiles(pt["A6"], mt, ktens["A6"], 5, wm, n),
                           lambda: agg.minmax_scan_tiles_plain(pt["A6"], mt, ktens["A6"], 5, wm,
                                                               n),
                           nbytes("A6", 3)),
    }
    for name in ("A2", "A3", "A4", "A5"):
        p, w, kt, keys = pt[name], wp[name], ktens[name], AGG_KEYS[name]
        calls = {
            "aggregate_scan": (lambda p=p, w=w, kt=kt: agg.aggregate_scan_tiles(p, mt, kt, w, wm, n),
                               lambda p=p, w=w, kt=kt: agg.aggregate_scan_tiles_plain(
                                   p, mt, kt, w, wm, n)),
            "aggregate_bitplane_static": (
                lambda p=p, w=w, keys=keys: agg.aggregate_bitplane_static_tiles(
                    p, mt, keys, w, wm, n),
                lambda p=p, w=w, keys=keys: agg.aggregate_bitplane_static_tiles_plain(
                    p, mt, keys, w, wm, n)),
            "aggregate_bitplane": (
                lambda p=p, w=w, kt=kt: agg.aggregate_bitplane_tiles(p, mt, kt, w, wm, n),
                lambda p=p, w=w, kt=kt: agg.aggregate_bitplane_tiles_plain(p, mt, kt, w, wm, n)),
        }
        for kernel, (kern, plain) in calls.items():
            # the plain version where the set's tier runs this kernel
            checked = AGGREGATE[kernel] == name or (kernel, name) == ("aggregate_scan", "A5")
            pairs[f"{kernel} {name}"] = (kern, plain if checked else None, nbytes(name, 2))
    # A7: the 20-bit revenue as the predicate, price as the measure
    ptile = cols["price"].tiles
    pairs["aggregate_bitplane_static A7"] = (
        lambda: agg.aggregate_bitplane_static_tiles(mt, ptile, AGG_KEYS["A7"], wm, TABLE["price"],
                                                    n),
        lambda: agg.aggregate_bitplane_static_tiles_plain(mt, ptile, AGG_KEYS["A7"], wm,
                                                          TABLE["price"], n),
        mt.numel() * 4 + ptile.numel() * 4 + 4 * len(A7_KEYS) + 16 * len(A7_KEYS))
    # A9: SUM of price by the 20-bit revenue, A7's keys in device memory
    # (the device-key lookup's CTA plan)
    pairs["aggregate_bitplane A9"] = (
        lambda: agg.aggregate_bitplane_tiles(mt, ptile, ktens["A9"], wm, TABLE["price"], n),
        lambda: agg.aggregate_bitplane_tiles_plain(mt, ptile, ktens["A9"], wm, TABLE["price"], n),
        mt.numel() * 4 + ptile.numel() * 4 + 4 * len(A7_KEYS) + 16 * len(A7_KEYS))
    # A8: MIN/MAX of price by the 20-bit revenue, A7's keys in device memory
    pairs["minmax_scan A8"] = (
        lambda: agg.minmax_scan_tiles(mt, ptile, ktens["A8"], wm, TABLE["price"], n),
        lambda: agg.minmax_scan_tiles_plain(mt, ptile, ktens["A8"], wm, TABLE["price"], n),
        mt.numel() * 4 + ptile.numel() * 4 + 4 * len(A7_KEYS) + 24 * len(A7_KEYS))
    for name, (kern, plain, _) in pairs.items():
        if plain is None:
            continue
        kernel = name.split()[0]
        errs[kernel] = max(errs[kernel], max_err(kern(), plain()))
        check(errs[kernel] == 0, f"{name} kernel exact against its plain version at full size")

    results = {}
    copy_dst = torch.empty_like(mt)
    copy_ms = time_ms(lambda: copy_dst.copy_(mt), batches=5, calls=10)
    copy_rate = 2 * mt.numel() * 4 / (copy_ms * 1e-3)
    print(f"copy_ of the revenue column ({mt.numel() * 4} bytes): {copy_ms:.6f} ms, "
          f"{copy_rate:.6e} bytes/s")
    for name, (kern, plain, nb) in pairs.items():
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2) if plain is not None else None
        bound_ms = nb / HBM_BYTES_PER_S * 1e3
        rate = nb / (ms * 1e-3)
        results[name] = (ms, plain_ms, bound_ms)
        print(f"time {name}: kernel {ms:.6f} ms ({rate:.6e} bytes/s, {rate / copy_rate:.4f} of copy"
              f", bound {bound_ms:.6f} ms for {nb} bytes)"
              + (f"; plain {plain_ms:.6f} ms" if plain_ms is not None else ""))
    print("library: no PyTorch call aggregates a bit-packed column, so library_ms is null")
    print("the key lookup aggregate (the static bit-plane tier):")
    kernel_report({"agg_lookup_kernelILi0ELi6ELb0ENS_7AggKeys": "key lookup, byte table "
                                                               "(wp <= 16)",
                   "agg_lookup_kernelILi1E": "key lookup, 16-bit window (wp > 16, A7)",
                   "agg_lookup_kernelILi2E": "key lookup, search (wp > 16)"})
    print("the key lookup aggregate for keys in device memory (the runtime bit-plane tier):")
    kernel_report({"agg_lookup_kernelILi0ELi6ELb0ENS_10DeviceKeys": "device-key lookup, byte "
                                                                   "table (wp <= 16, A4)",
                   "agg_lookup_kernelILi3E": "device-key lookup, the CTA's window or search "
                                             "(wp > 16, A9)"})
    print("the MIN/MAX key lookup (keys in device memory):")
    kernel_report({"minmax_lookup_kernelILi0E": "MIN/MAX lookup, byte table (wp <= 16, A6)",
                   "minmax_lookup_kernelILi3E": "MIN/MAX lookup, the CTA's window or search "
                                                "(wp > 16, A8)"})
    q1 = multiproc_demo.query_trees(query, cols)["Q1"]
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        masked_aggregate_device(rev, query.evaluate(q1)[0])
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    print(f"time A1 SELECT SUM(revenue), COUNT(*) WHERE Q1 (host clock, host included): median "
          f"{statistics.median(walls[1:]):.6f} ms of {len(walls) - 1} after a warm-up")
    return results


def small_stats_phase(device, errs: dict) -> None:
    """The histogram and zone-map kernels against their plain versions at
    small ragged sizes: widths 1-31, n 100, 4241 and 32768, k 1-4096 with
    key 0 over the padding, windows past the domain, a lo within k of 2^32
    (the runtime lo wraps, the span tier counts nothing) and a
    ``block_offset``; the zoned kernel with a
    padded flag-0 step, on the small columns (one step of 8 rows) and on a
    ragged column of 9 steps; the range kernel on an in-place row span."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch import zonemap
    from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack

    rng = np.random.default_rng(SEED + 3)

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.uint32).view(np.int32)).to(device)

    def note(name, a, b):
        if isinstance(a, tuple):  # (bits, counts)
            e = max(max_abs_err(a[0], b[0]), int((a[1] - b[1]).abs().max()))
        else:
            e = max_err(a, b)
        errs[name] = max(errs[name], e)

    n_steps = 9 * 8 * LANES * 32 - 77  # b1 = 72: nine steps of 8 rows, the tail in the last
    for width in HIST_WIDTHS:
        dom = 1 << width
        for n in (*SMALL_NS, n_steps):
            vals = rng.integers(0, dom, size=n)
            tiles = unpack.pack_device_kernel(t32(vals), width).tiles
            v0 = int(vals[0])
            lows, highs = t32([0, 1, dom - 1, 0xFFFFFFF0, v0]), t32([dom, 0, 2, 0, v0 + 1])
            if n == n_steps:  # steps 0, 4 and the ragged last, then a flag-0 repeat
                idx, flag = t32([0, 4, 8, 8]), t32([1, 1, 1, 0])
                note("zoned_range_scan",
                     zonemap.zoned_range_tiles(tiles, idx, flag, lows, highs, width, n, 8),
                     zonemap.zoned_range_tiles_plain(tiles, idx, flag, lows, highs, width, n, 8))
                note("range_scan", scan.range_scan_tiles(tiles, lows, highs, width, n, rows=(16, 24)),
                     scan.range_scan_tiles_plain(tiles, lows, highs, width, n, rows=(16, 24)))
                continue
            idx, flag = t32([0, 0]), t32([1, 0])
            note("zoned_range_scan",
                 zonemap.zoned_range_tiles(tiles, idx, flag, lows, highs, width, n, 8),
                 zonemap.zoned_range_tiles_plain(tiles, idx, flag, lows, highs, width, n, 8))
            runtime = [(0, k) for k in HIST_KS] + [(v0, 64), (dom, 32), ((1 << 32) - 3, 40)]
            chunked = [(0, k) for k in HIST_KS if k <= 48] + [(max(dom - 3, 0), 40), (dom, 8),
                                                             (0, 64)]
            span = [(0, k) for k in HIST_KS if 48 < k <= 512] + [(max(dom - 20, 0), 64), (0, 5),
                                                                ((1 << 32) - 3, 40)]
            if n == SMALL_NS[2] and width in (12, 16):  # the statistics' k = 4096 programs
                chunked.append((0, 4096))
                span.append((0, 4096))
            for bo in ((0, 2) if n == SMALL_NS[1] else (0,)):
                for lo, k in runtime:
                    note("histogram", scan.histogram_tiles(tiles, t32([lo]), k, width, n, bo),
                         scan.histogram_tiles_plain(tiles, lo, k, width, n, bo))
                for lo, k in chunked:
                    note("histogram_dag", scan._histogram_chunked_tiles(tiles, lo, k, width, n, bo),
                         scan._histogram_chunked_tiles_plain(tiles, lo, k, width, n, bo))
                for lo, k in span:
                    note("histogram_span", scan._histogram_span_tiles(tiles, lo, k, width, n, bo),
                         scan._histogram_span_tiles_plain(tiles, lo, k, width, n, bo))
    # every width on the nine-step column (its last tile partial): the
    # whole-domain window, one key short of it, and lo = 2^32 - 3
    for width in range(1, 32):
        dom = 1 << width
        vals = rng.integers(0, dom, size=n_steps)
        tiles = unpack.pack_device_kernel(t32(vals), width).tiles
        for lo, k in ((0, min(dom, 4096)), (0, min(dom, 4097) - 1), ((1 << 32) - 3, 40)):
            for bo in (0, 2):
                note("histogram", scan.histogram_tiles(tiles, t32([lo]), k, width, n_steps, bo),
                     scan.histogram_tiles_plain(tiles, lo, k, width, n_steps, bo))
                note("histogram_span", scan._histogram_span_tiles(tiles, lo, k, width, n_steps, bo),
                     scan._histogram_span_tiles_plain(tiles, lo, k, width, n_steps, bo))
    # the domain histogram: ragged n, a constant column (a warp's hot value)
    # and a skewed one (lanes of one value merged), a block_offset
    for width in (13, 16, 20):
        dom = 1 << width
        columns = [rng.integers(0, dom, size=n) for n in (*SMALL_NS, n_steps)]
        columns.append(np.full(n_steps, dom // 3))
        skewed = rng.integers(0, dom, size=n_steps)
        columns.append(np.where(skewed % 8 < 6, 5, skewed))
        for vals in columns:
            vals[-1] = dom - 1
            tiles = unpack.pack_device_kernel(t32(vals), width).tiles
            for bo in (0, 2):
                note("histogram_domain",
                     scan._histogram_domain_tiles(tiles, width, vals.size, bo),
                     scan._histogram_domain_tiles_plain(tiles, width, vals.size, bo))
    # the zoned kernel launched on rows filled with -1 at every width: every
    # word written (unsorted steps, a step listed twice with flag 1, a flag-0
    # repeat, a step past the column), and its count form
    idx, flag = t32([8, 0, 4, 4, 0, 9]), t32([1, 1, 1, 1, 0, 1])
    for width in range(1, 32):
        dom = 1 << width
        vals = rng.integers(0, dom, size=n_steps)
        tiles = unpack.pack_device_kernel(t32(vals), width).tiles
        lows, highs = t32([0, dom // 3, 0xFFFFFFF0]), t32([dom, dom // 2, 0])
        pbits, pcounts = zonemap.zoned_range_tiles_plain(tiles, idx, flag, lows, highs, width,
                                                         n_steps, 8)
        bits = torch.full_like(pbits, -1)
        counts = torch.empty_like(pcounts)
        for out in (bits, None):
            counts.fill_(-1)  # the C entry zeroes them in both forms
            _cuda.launch("sss_zoned_range_scan", device, tiles.data_ptr(), idx.data_ptr(),
                         flag.data_ptr(), idx.numel(), lows.data_ptr(), highs.data_ptr(), 3,
                         None if out is None else out.data_ptr(), counts.data_ptr(),
                         tiles.shape[1] * LANES, 8 * LANES, width, n_steps)
            note("zoned_range_scan", (bits, counts), (pbits, pcounts))
    torch.cuda.synchronize()
    for name in (*HISTOGRAM, *ZONED, "range_scan"):
        check(errs[name] == 0, f"{name} kernel exact against its plain version (widths "
              f"{HIST_WIDTHS}, n {SMALL_NS} and {n_steps}, k {HIST_KS}; widths 1-31 at n "
              f"{n_steps}, the zoned kernel on rows filled with -1 and in its count form; the "
              f"domain histogram at widths 13, 16 and 20)")


def stats_phase(device, arb, cols, rev) -> tuple[dict, dict]:
    """The statistics path at full size, with launch counts taken around
    each call: H1-H3 ``histogram_device`` on the i % 512 column, H4
    ``stats`` on ``price``, H5 ``stats.histogram_full`` on ``revenue``, H6
    on a uniform 12-bit column of 512 MiB packed, H7 on ``status`` and H8
    on a 1-bit flag column.  Returns the launches and H6's and H8's
    columns."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import histogram_device, pack_device_kernel, stats
    from shared_simd_scan_tpu_torch.bench.harness import values_for

    kernels = {name: fn for name, fn in wrappers().items() if name in HISTOGRAM}
    n = arb.n
    raw = draw_columns(device, n, {**TABLE, "revenue": REVENUE_WIDTH})
    price_raw, rev_raw, status_raw = raw["price"], raw["revenue"], raw["status"]
    del raw
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    h6_raw = torch.randint(0, 1 << H6_WIDTH, (values_for(DATA_SIZE, H6_WIDTH),), generator=gen,
                           device=device, dtype=torch.int32)
    h6 = pack_device_kernel(h6_raw, H6_WIDTH)
    flags_raw = (torch.rand(n, generator=gen, device=device) < 0.3).to(torch.int32)
    flags = pack_device_kernel(flags_raw, H8_WIDTH)
    price = cols["price"]
    lo_t = torch.zeros(1, dtype=torch.int32, device=device)  # made before the sync-debug mode
    torch.cuda.synchronize()
    print(f"statistics path: i % {DOMAIN} column and price (9-bit), revenue ({REVENUE_WIDTH}-bit), "
          f"n {n}")
    zero_launched(kernels.values())
    ran, outs, walls = {}, {}, {}

    def run(name, fn, strict=False):
        before = {k: launched(f) for k, f in kernels.items()}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if strict:  # a CUDA-tensor lo: any device-to-host copy raises
            torch.cuda.set_sync_debug_mode("error")
        try:
            outs[name] = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        walls[name] = (time.monotonic() - t0) * 1e3
        ran[name] = {k: launched(f) - before[k] for k, f in kernels.items() if launched(f) > before[k]}

    run("H1", lambda: histogram_device(arb))
    run("H2", lambda: histogram_device(arb, 100, 40))
    run("H3", lambda: histogram_device(arb, lo_t), strict=True)
    run("H4", lambda: (stats.describe(price), stats.quantiles(price, QS), stats.topk_values(price, 5)))
    run("H5", lambda: stats.histogram_full(rev))
    run("H6", lambda: stats.histogram_full(h6))
    run("H7", lambda: stats.histogram_full(cols["status"]))
    run("H8", lambda: stats.histogram_full(flags))
    launches = {name: launched(fn) for name, fn in kernels.items()}
    print(f"statistics path launches {launches}; host clock per set (first calls, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))

    want = {"H1": {"histogram_span": 1}, "H2": {"histogram_dag": 1}, "H3": {"histogram": 1},
            "H4": {"histogram_span": 3}, "H5": {"histogram_domain": 1},
            "H6": {"histogram_dag": 1}, "H7": {"histogram_dag": 1}, "H8": {"histogram_dag": 1}}
    for name, w in want.items():
        check(ran[name] == w, f"{name}: ran {ran[name]}, the kernel its rule names")
    expect = torch.tensor([(n - 1 - j) // DOMAIN + 1 for j in range(DOMAIN)], device=device)
    check(torch.equal(outs["H1"], expect), "H1: full-domain counts == closed form (n - 1 - j) // 512 + 1")
    check(torch.equal(outs["H2"], expect[100:140]), "H2: keys 100..139 == closed form")
    check(torch.equal(outs["H3"], expect), "H3: runtime-lo counts == closed form")
    truth = torch.bincount(price_raw.to(torch.int64), minlength=1 << TABLE["price"])
    check(np.array_equal(stats.histogram_full(price), truth.cpu().numpy()),
          "H4: histogram_full(price) == torch.bincount on the raw values")
    described, qs, (top, top_counts) = outs["H4"]
    vals = torch.arange(truth.shape[0], device=device)
    cum = torch.cumsum(truth, 0)
    total = int(cum[-1])
    nz = torch.nonzero(truth).flatten()
    want_d = {"n": total, "min": int(nz[0]), "max": int(nz[-1]),
              "mean": int((vals * truth).sum()) / total,
              "median": int(torch.searchsorted(cum, (total + 1) // 2)), "distinct": int(nz.numel())}
    check(described == want_d, f"H4: describe(price) {described} == bincount's")
    ranks = torch.tensor([max(1, int(np.ceil(q * total))) for q in QS], device=device)
    check(qs.tolist() == torch.searchsorted(cum, ranks).tolist(),
          f"H4: quantiles(price, {QS}) {qs.tolist()} == bincount's")
    order = torch.sort(truth, descending=True, stable=True).indices[:5]
    check(top.tolist() == order.tolist() and top_counts.tolist() == truth[order].tolist(),
          f"H4: topk_values(price, 5) {top.tolist()} == bincount's")
    rtruth = torch.bincount(rev_raw.to(torch.int64), minlength=1 << REVENUE_WIDTH)
    check(np.array_equal(outs["H5"], rtruth.cpu().numpy()),
          f"H5: histogram_full(revenue), 2^{REVENUE_WIDTH} counts == torch.bincount on the raw "
          "values")
    print(f"H5 histogram_full(revenue): {walls['H5']:.3f} ms host clock, first call")
    for name, raw, width in (("H6", h6_raw, H6_WIDTH), ("H7", status_raw, TABLE["status"]),
                             ("H8", flags_raw, H8_WIDTH)):
        truth = torch.bincount(raw.to(torch.int64), minlength=1 << width)
        check(np.array_equal(outs[name], truth.cpu().numpy()),
              f"{name}: histogram_full of a {width}-bit column of {raw.numel()} values, "
              f"2^{width} counts == torch.bincount on the raw values")
    del h6_raw, flags_raw
    return launches, {"h6": h6, "flags": flags}


def zone_columns(device, n: int, price) -> tuple[dict, dict]:
    """The zone-map phase's columns: (raw int32 values, DeviceColumns)."""
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch import pack_device_kernel

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    ends = torch.randint(100, 200, (n,), generator=gen, device=device, dtype=torch.int32)
    edge = 64 * LANES * 32  # 64 block rows
    ends[:edge] = 7
    ends[-edge:] = 7
    raw = {"clustered": ((torch.arange(n, device=device) * DOMAIN) // n).to(torch.int32),
           "ends": ends, "price": draw_columns(device, n, {"price": TABLE["price"]})["price"]}
    zcols = {"clustered": pack_device_kernel(raw["clustered"], WIDTH),
             "ends": pack_device_kernel(raw["ends"], WIDTH), "price": price}
    return raw, zcols


def zone_phase(device, cols) -> tuple[dict, dict]:
    """The zone-map path at full size, with launch counts taken around each
    call: Z1 ``build_zonemap`` of three columns, Z2 a pruned and Z3/Z4
    zoned equality scans, Z5 ``evaluate`` with zone maps."""
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch import bitvector, query, zonemap
    from shared_simd_scan_tpu_torch.ops import scan

    kernels = {name: fn for name, fn in wrappers().items()
               if name in ("unpack", "range_scan", "conj_range_scan", *ZONED)}
    n = cols["price"].n
    raw, zcols = zone_columns(device, n, cols["price"])
    torch.cuda.synchronize()
    b1 = zcols["price"].tiles.shape[1]
    print(f"zone-map path: columns clustered (i * 512) // n, ends (7 in the first and last 64 block "
          f"rows, else 100..199), price; n {n}, zone_b1 {ZONE_B1} ({b1 // ZONE_B1} zones)")
    zero_launched(kernels.values())
    ran, outs = {}, {}

    def run(name, fn):
        before = {k: launched(f) for k, f in kernels.items()}
        outs[name] = fn()
        ran[name] = {k: launched(f) - before[k] for k, f in kernels.items() if launched(f) > before[k]}

    for name, col in zcols.items():
        run(f"Z1 {name}", lambda col=col: zonemap.build_zonemap(col, zone_b1=ZONE_B1))
    zmaps = {name: outs[f"Z1 {name}"] for name in zcols}
    run("Z2", lambda: zonemap.pruned_eq_scan(zcols["clustered"], zmaps["clustered"], 100))
    run("Z3", lambda: zonemap.zoned_eq_scan(zcols["ends"], zmaps["ends"], 7))
    run("Z3c", lambda: zonemap.zoned_eq_scan(zcols["ends"], zmaps["ends"], 7, full_bits=False))
    run("Z4", lambda: zonemap.zoned_eq_scan(zcols["price"], zmaps["price"], 7))
    z5 = query.And(query.Range(zcols["clustered"], 100, 120),
                   query.Not(query.Eq(zcols["price"], 7)))
    run("Z5", lambda: query.evaluate(z5, zonemaps={id(zcols["clustered"]): zmaps["clustered"]}))
    torch.cuda.synchronize()
    launches = {name: launched(fn) for name, fn in kernels.items()}
    print(f"zone-map path launches {launches}")

    per = ZONE_B1 * LANES * 32
    nz = b1 // ZONE_B1
    for name, col in zcols.items():
        check(ran[f"Z1 {name}"].get("unpack", 0) > 0 and set(ran[f"Z1 {name}"]) == {"unpack"},
              f"Z1 {name}: build_zonemap ran the unpack kernel ({ran[f'Z1 {name}']})")
        v = raw[name].to(torch.int64)
        lo_pad = torch.full((nz * per,), 0xFFFFFFFF, dtype=torch.int64, device=device)
        hi_pad = torch.zeros(nz * per, dtype=torch.int64, device=device)
        lo_pad[:n] = v
        hi_pad[:n] = v
        zmin, zmax = lo_pad.view(nz, per).amin(1), hi_pad.view(nz, per).amax(1)
        zm = zmaps[name]
        check(zm.zmin.tolist() == zmin.tolist() and zm.zmax.tolist() == zmax.tolist(),
              f"Z1 {name}: {nz} zone minima and maxima == amin / amax on the raw values")
        del v, lo_pad, hi_pad
    spans = {"Z2": zonemap.prune_span(zmaps["clustered"], 100, 101)}
    live = zonemap.zone_step_mask(zmaps["ends"], 7, 8, zonemap._pick_tb(b1, 256))
    check(spans["Z2"] is not None and spans["Z2"][1] <= 1024,
          f"Z2: prune_span(clustered, [100, 101)) = {spans['Z2']}, at most 1024 rows")
    check(0 < int(live.sum()) <= 3 and live.shape[0] == 456,
          f"Z3: {int(live.sum())} of {live.shape[0]} steps of 256 rows live (steps "
          f"{live.nonzero()[0].tolist()})")
    want = {"Z2": {"range_scan": 1}, "Z3": {"zoned_range_scan": 1},
            "Z3c": {"zoned_range_scan": 1}, "Z4": {"range_scan": 1},
            "Z5": {"conj_range_scan": 2}}
    for name, w in want.items():
        check(ran[name] == w, f"{name}: ran {ran[name]}, the kernel its rule names")
    for name, col, key in (("Z2", "clustered", 100), ("Z3", "ends", 7), ("Z4", "price", 7)):
        bits, count = outs[name]
        fbits, fcount = scan.range_scan_device(zcols[col], [key], [key + 1])
        truth = raw[col] == key
        check(torch.equal(bits, fbits[0]) and int(count) == int(fcount[0]) == int(truth.sum())
              and torch.equal(bits, bitvector.from_bool(truth)),
              f"{name}: every word and the count ({int(count)}) equal the full range scan's and "
              f"the raw values' {col} == {key}")
    bits, count = outs["Z3c"]
    check(bits is None and int(count) == int(outs["Z3"][1]),
          f"Z3c: the count form gives no row and Z3's count ({int(count)})")
    bits, count = outs["Z5"]
    pbits, pcount = query.evaluate(z5)
    check(torch.equal(bits, pbits) and int(count) == int(pcount),
          f"Z5: evaluate with zone maps == without, every word and the count ({int(count)})")
    del raw
    return {"zcols": zcols, "zmaps": zmaps, "spans": spans, "live": live}, launches


# the span phase: flight 1's columns of the date-sorted table at the cell's
# size, and the day ranges whose pruned spans it checks
SPAN_ROWS = 600_000_000
SPAN_WIDTHS = {"date": 12, "quantity": 6, "discount": 4, "price": 24}
SPAN_DAYS = {"year 1994": (731, 1096), "month 1995-03": (1155, 1186),
             "week 1996-10": (1735, 1742), "last week": (2399, 2406)}
# the block rows a year's, a month's and a week's pruned span take (the
# date-sorted cell's zone map of 64 block rows), timed as spans at the end
SPAN_TIMED = (("365", 32768), ("31", 2048), ("7", 512))


def span_phase(device) -> None:
    """The conjunction and the masked sum over the block-row spans that a
    zone map on a sorted date column gives flight 1's ranges, at the
    date-sorted cell's 600M rows and widths, each launch held bit-exact
    against its plain version with the same span; before them the
    conjunction over the whole columns (``flight1``'s shape: widths 12, 6,
    4, the dates in random order), held bit-exact to its plain version and
    timed beside its bound (row 22 of PERF.md's kernel table)."""
    import torch
    from shared_simd_scan_tpu_torch import pack_device_kernel, query, zonemap
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import aggregate, conj

    n, days = SPAN_ROWS, SPAN_WIDTHS["date"]
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 26)
    cols = {}
    for name, width in SPAN_WIDTHS.items():
        if name == "date":  # days 0..2405 in order, as the sorted table holds them
            raw = ((torch.arange(n, device=device) * 2406) // n).to(torch.int32)
        else:
            raw = torch.randint(0, 1 << width, (n,), generator=gen, device=device,
                                dtype=torch.int32)
        cols[name] = pack_device_kernel(raw, width)
        del raw
    zmap = zonemap.build_zonemap(cols["date"], zone_b1=ZONE_B1)
    b1 = cols["date"].tiles.shape[1]
    tiles = [cols[c].tiles for c in ("date", "quantity", "discount")]
    widths = [SPAN_WIDTHS[c] for c in ("date", "quantity", "discount")]
    price = cols["price"]
    kernels = {name: fn for name, fn in wrappers().items()
               if name in ("conj_range_scan", "masked_aggregate")}
    print(f"span path: date {days} bits sorted, quantity, discount, price 24 bits; n {n}, "
          f"b1 {b1}, zone_b1 {ZONE_B1}")

    # flight 1's own date column: days 0..2405 in random order, as the
    # unsorted table stores them, so a block's 32 dates differ
    raw = torch.randint(0, 2406, (n,), generator=gen, device=device, dtype=torch.int32)
    shuffled = [pack_device_kernel(raw, days).tiles, *tiles[1:]]
    del raw
    lows, highs = [731, 1, 4], [1096, 25, 5]  # Q1.1: a year, quantity < 25, discount 4
    zero_launched(kernels.values())
    bits, total = conj.conj_range_scan_tiles(shuffled, lows, highs, widths, n)
    torch.cuda.synchronize()
    ran = launched(kernels["conj_range_scan"])
    pbits, ptotal = conj.conj_range_scan_tiles_plain(shuffled, torch.tensor(lows),
                                                     torch.tensor(highs), widths, n)
    check(ran == 1 and max_abs_err(bits, pbits) == 0 and int(total) == int(ptotal),
          f"flight 1's conjunction {widths} over all {n} rows, dates in random order: "
          f"{ran} launch, words and count ({int(total)}) == the plain version's")
    del bits, pbits
    # timed: the whole columns as flight 1 stores them, then the sorted
    # columns' spans of a year, a month and a week
    for label, count in (("whole", b1), *((f"{d} days", c) for d, c in SPAN_TIMED)):
        rows = None if count == b1 else (b1 - count, count)
        cols_timed = shuffled if rows is None else tiles
        ms = time_ms(lambda: conj.conj_range_scan_tiles(cols_timed, lows, highs, widths, n,
                                                        rows=rows), batches=5, calls=10)
        nbytes = (sum(widths) + 1) * count * LANES * 4 + 8
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if rows is None:
            plain_ms = time_ms(lambda: conj.conj_range_scan_tiles_plain(
                shuffled, torch.tensor(lows), torch.tensor(highs), widths, n), batches=3, calls=1)
            line = (f"kernel {ms:.6f} ms, bound {bound_ms:.6f} ms for {nbytes} bytes "
                    f"({100 * bound_ms / ms:.1f}%); plain {plain_ms:.6f} ms")
        else:  # the call zeroes the full-length row first
            line = (f"call {ms:.6f} ms (the row's {b1 * LANES * 4} bytes zeroed, then the "
                    f"kernel: bound {bound_ms:.6f} ms for {nbytes} bytes)")
        print(f"time conj_range_scan flight1 {tuple(widths)} {label} ({count} block rows of "
              f"{b1}): {line}")
    del shuffled
    for label, (d0, d1) in SPAN_DAYS.items():
        start, count = zonemap.prune_span(zmap, d0, d1)
        check(0 < start + count <= b1 and (start > 0 or count < b1),
              f"span {label}: days [{d0}, {d1}) prune to block rows [{start}, {start + count})")
        lows, highs = [d0, 1, 4], [d1, 25, 5]
        zero_launched(kernels.values())
        bits, total = conj.conj_range_scan_tiles(tiles, lows, highs, widths, n,
                                                 rows=(start, count))
        row = bits[start : start + count]
        got_count, got_sum = aggregate.masked_aggregate_tiles(price.tiles, row, 24, n,
                                                              rows=(start, count))
        torch.cuda.synchronize()
        ran = {name: launched(fn) for name, fn in kernels.items()}
        check(ran == {"conj_range_scan": 1, "masked_aggregate": 1},
              f"span {label}: launches {ran}, one of each span kernel")
        pbits, ptotal = conj.conj_range_scan_tiles_plain(
            tiles, torch.tensor(lows), torch.tensor(highs), widths, n, rows=(start, count))
        check(max_abs_err(bits, pbits) == 0 and int(total) == int(ptotal),
              f"span {label}: conjunction words and count ({int(total)}) == the plain "
              "version's over the same span")
        full, _ = conj.conj_range_scan_tiles(tiles, lows, highs, widths, n)
        inside = torch.zeros_like(full)
        inside[start : start + count] = full[start : start + count]
        check(torch.equal(bits, inside),
              f"span {label}: the span's words == the whole-column kernel's there, zeros "
              "elsewhere")
        pcount, psum = aggregate.masked_aggregate_tiles_plain(price.tiles, row, 24, n,
                                                              rows=(start, count))
        check(int(got_count) == int(pcount) == int(total) and int(got_sum) == int(psum),
              f"span {label}: masked sum {int(got_sum)} and count {int(got_count)} == the plain "
              "version's over the same span")
        expr = query.And(query.Range(cols["date"], d0, d1), query.Range(cols["quantity"], 1, 25),
                         query.Eq(cols["discount"], 4))
        zero_launched(kernels.values())
        words, qcount, rows = query.evaluate_pruned(expr, {id(cols["date"]): zmap})
        qsum, qn = aggregate.masked_aggregate_device(price, words, rows=rows)
        torch.cuda.synchronize()
        ran = {name: launched(fn) for name, fn in kernels.items()}
        check(rows == (start, count) and ran == {"conj_range_scan": 1, "masked_aggregate": 1}
              and int(qcount) == int(qn) == int(total) and int(qsum) == int(got_sum),
              f"span {label}: evaluate_pruned and masked_aggregate_device: span {rows}, "
              f"launches {ran}, the same count and sum")
        del bits, row, pbits, full, inside, words
    del cols, tiles, price
    torch.cuda.empty_cache()


def stats_timing_phase(device, arb, rev, zdata, stats_cols, cols, errs: dict) -> dict:
    """The statistics and zone-map kernels and their plain versions at full
    size (H1-H3 on the i % 512 column, H6-H8 the chunked tier on the
    statistics phase's 12-bit, status and flag columns, Z3 on the ends
    column); beside them
    the two histogram algorithms, unpack + ``torch.bincount``, one H5
    window and H5's wall time, and Z2/Z3 against the full-column range
    scan."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch import stats, zonemap
    from shared_simd_scan_tpu_torch.bench.timing import device_ms
    from shared_simd_scan_tpu_torch.ops import _cuda, scan, unpack

    tiles, n = arb.tiles, arb.n
    tile_bytes = tiles.numel() * 4
    lo_t = torch.zeros(1, dtype=torch.int32, device=device)
    zcols, zmaps = zdata["zcols"], zdata["zmaps"]
    et, ct = zcols["ends"].tiles, zcols["clustered"].tiles
    tb = zonemap._pick_tb(et.shape[1], 256)
    live = zdata["live"]
    idx = torch.from_numpy(np.nonzero(live)[0].astype(np.int32)).to(device)
    flag = torch.ones_like(idx)
    lo7, hi8 = scan._bounds_tensor([7], device), scan._bounds_tensor([8], device)
    lo100, hi101 = scan._bounds_tensor([100], device), scan._bounds_tensor([101], device)
    live_rows = int(live.sum()) * tb
    start, span = zdata["spans"]["Z2"]

    def rows_bytes(rows):  # the rows' words read, their bitvector words written, the count
        return rows * LANES * (WIDTH + 1) * 4 + 8

    # Z3: the live steps' words read, idx and flag, the bounds and the count;
    # the row form also writes every word of the row
    z3_counts_bytes = live_rows * LANES * WIDTH * 4 + 8 * idx.numel() + 8 + 8
    z3_bytes = z3_counts_bytes + et.shape[1] * LANES * 4

    pairs = {  # "kernel set" -> (kernel, plain, bytes it must move)
        "histogram_span H1": (lambda: scan._histogram_span_tiles(tiles, 0, DOMAIN, WIDTH, n),
                              lambda: scan._histogram_span_tiles_plain(tiles, 0, DOMAIN, WIDTH, n),
                              tile_bytes + DOMAIN * 8),
        "histogram_dag H2": (lambda: scan._histogram_chunked_tiles(tiles, 100, 40, WIDTH, n),
                             lambda: scan._histogram_chunked_tiles_plain(tiles, 100, 40, WIDTH, n),
                             tile_bytes + 40 * 8),
        **{f"histogram_dag {name}": (
            lambda c=c: scan._histogram_chunked_tiles(c.tiles, 0, 1 << c.width, c.width, c.n),
            lambda c=c: scan._histogram_chunked_tiles_plain(c.tiles, 0, 1 << c.width, c.width,
                                                            c.n),
            c.tiles.numel() * 4 + (8 << c.width))
           for name, c in (("H6", stats_cols["h6"]), ("H7", cols["status"]),
                           ("H8", stats_cols["flags"]))},
        "histogram H3": (lambda: scan.histogram_tiles(tiles, lo_t, DOMAIN, WIDTH, n),
                         lambda: scan.histogram_tiles_plain(tiles, lo_t, DOMAIN, WIDTH, n),
                         tile_bytes + 4 + DOMAIN * 8),
        "histogram_domain H5": (
            lambda: scan._histogram_domain_tiles(rev.tiles, REVENUE_WIDTH, n),
            lambda: scan._histogram_domain_tiles_plain(rev.tiles, REVENUE_WIDTH, n),
            rev.tiles.numel() * 4 + (8 << REVENUE_WIDTH)),
        "zoned_range_scan Z3": (
            lambda: zonemap.zoned_range_tiles(et, idx, flag, lo7, hi8, WIDTH, n, tb),
            lambda: zonemap.zoned_range_tiles_plain(et, idx, flag, lo7, hi8, WIDTH, n, tb),
            z3_bytes),
        "zoned_range_scan Z3 counts": (
            lambda: zonemap.zoned_range_tiles(et, idx, flag, lo7, hi8, WIDTH, n, tb, False),
            lambda: (None, zonemap.zoned_range_tiles_plain(et, idx, flag, lo7, hi8, WIDTH, n,
                                                           tb)[1]),
            z3_counts_bytes),
    }
    for name, (kern, plain, _) in pairs.items():
        kernel = name.split()[0]
        a, b = kern(), plain()
        if isinstance(a, tuple) and a[0] is None:  # the zoned count form
            e = int((a[1] - b[1]).abs().max())
        elif isinstance(a, tuple):
            e = max(max_abs_err(a[0], b[0]), int((a[1] - b[1]).abs().max()))
        else:
            e = max_err(a, b)
        errs[kernel] = max(errs[kernel], e)
        del a, b
        check(errs[kernel] == 0, f"{name} kernel exact against its plain version at full size")

    results = {}
    copy_dst = torch.empty_like(tiles)
    copy_ms = time_ms(lambda: copy_dst.copy_(tiles), batches=5, calls=10)
    copy_rate = 2 * tile_bytes / (copy_ms * 1e-3)
    print(f"copy_ of the i % 512 column ({tile_bytes} bytes): {copy_ms:.6f} ms, "
          f"{copy_rate:.6e} bytes/s")
    for name, (kern, plain, nbytes) in pairs.items():
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rate = nbytes / (ms * 1e-3)
        results[name] = (ms, plain_ms, bound_ms)
        print(f"time {name}: kernel {ms:.6f} ms ({rate:.6e} bytes/s, {rate / copy_rate:.4f} of "
              f"copy, bound {bound_ms:.6f} ms for {nbytes} bytes); plain {plain_ms:.6f} ms")
    print("library: no PyTorch call counts the values of a bit-packed column, so library_ms is "
          "null")
    print(f"time H1 full-domain histogram, the two forms of the bins kernel: span (host lo) "
          f"{results['histogram_span H1'][0]:.6f} ms, runtime lo (H3) "
          f"{results['histogram H3'][0]:.6f} ms")
    print("the bins kernel (width 9), the domain histogram (width 20) and the fold's counts "
          "form (width 1):")
    kernel_report({"histogram_kernelILi9ELb1ELb1E": "bins kernel, width 9",
                   "histogram_domain_kernelILi20EyLb1E": "domain histogram, width 20",
                   "static_fold_kernelILi1ENS_8SpanKeysELi2E": "fold's counts form, width 1"})

    def unpack_bincount():  # the padding's zero values leave bin 0
        vals = unpack.unpack_tiles(tiles, WIDTH)
        counts = torch.bincount(vals.view(-1), minlength=DOMAIN)
        counts[0] -= vals.numel() - n
        return counts

    check(torch.equal(unpack_bincount(), pairs["histogram H3"][0]()),
          "unpack + torch.bincount == the bins kernel's counts")
    ms = time_ms(unpack_bincount, batches=3, calls=3)
    print(f"time H1 composed (unpack kernel + torch.bincount): {ms:.6f} ms")
    ms = time_ms(lambda: scan.histogram_tiles(rev.tiles, lo_t, 4096, REVENUE_WIDTH, n),
                 batches=5, calls=5)
    bound = rev.tiles.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"time H5 one 4096-value window of the bins kernel (revenue): {ms:.6f} ms, bound "
          f"{bound:.6f} ms; 256 such windows, the statistics' launches before the domain "
          f"histogram: {256 * ms:.3f} ms of kernel; the domain histogram "
          f"{results['histogram_domain H5'][0]:.6f} ms in one launch")
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        stats.histogram_full(rev)
        walls.append((time.monotonic() - t0) * 1e3)
    print(f"time H5 stats.histogram_full(revenue) (host clock, host and copy included): median "
          f"{statistics.median(walls[1:]):.6f} ms of {len(walls) - 1} after a warm-up")
    z2 = time_ms(lambda: scan.range_scan_tiles(ct, lo100, hi101, WIDTH, n, rows=(start, span)),
                 batches=5, calls=10)
    full = time_ms(lambda: scan.range_scan_tiles(ct, lo100, hi101, WIDTH, n), batches=5, calls=10)
    zero = time_ms(lambda: torch.zeros((1,) + tuple(ct.shape[1:]), dtype=torch.int32,
                                       device=device), batches=5, calls=10)
    print(f"time Z2 pruned span ({span} of {ct.shape[1]} rows, in place): {z2:.6f} ms (bound "
          f"{rows_bytes(span) / HBM_BYTES_PER_S * 1e3:.6f} ms), full-column range scan "
          f"{full:.6f} ms; the zeroed full-length row alone {zero:.6f} ms")
    full = time_ms(lambda: scan.range_scan_tiles(et, lo7, hi8, WIDTH, n), batches=5, calls=10)
    print(f"time Z3 zoned ({int(live.sum())} of {live.shape[0]} steps): "
          f"{results['zoned_range_scan Z3'][0]:.6f} ms, its count form "
          f"{results['zoned_range_scan Z3 counts'][0]:.6f} ms, full-column range scan "
          f"{full:.6f} ms")
    # every word of the full-size row written: the kernel on a row of -1
    pbits, pcounts = pairs["zoned_range_scan Z3"][1]()
    bits, counts = torch.full_like(pbits, -1), torch.full_like(pcounts, -1)
    _cuda.launch("sss_zoned_range_scan", device, et.data_ptr(), idx.data_ptr(), flag.data_ptr(),
                 idx.numel(), lo7.data_ptr(), hi8.data_ptr(), 1, bits.data_ptr(),
                 counts.data_ptr(), et.shape[1] * LANES, tb * LANES, WIDTH, n)
    errs["zoned_range_scan"] = max(errs["zoned_range_scan"], max_abs_err(bits, pbits),
                                   int((counts - pcounts).abs().max()))
    check(errs["zoned_range_scan"] == 0, "Z3: the zoned call on a row of -1 writes every word, "
          "each equal to the plain version's")
    del pbits, bits
    walls = []
    for _ in range(11):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        zonemap.zoned_eq_scan(zcols["ends"], zmaps["ends"], 7)
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    results["zoned_range_scan Z3 wall"] = (statistics.median(walls), None, None)
    # 256 MiB written before each profiled call: the row's writes reach
    # device memory within the call, not left dirty in the 50 MB L2
    z3 = device_ms(pairs["zoned_range_scan Z3"][0], flush_bytes=256 * 1024 * 1024)
    zoned_dev = sum(v for k, v in z3.items() if "zoned" in k)
    results["zoned_range_scan Z3 device"] = (sum(z3.values()) if z3 else None,
                                             zoned_dev if z3 else None, z3_bytes)
    print(f"time Z3 device (torch.profiler): "
          + (f"{sum(z3.values()):.6f} ms a call in all (the memsets and the kernel), "
             f"{z3_bytes / HBM_BYTES_PER_S * 1e3 / sum(z3.values()):.4f} of the bound; "
             f"{zoned_dev:.6f} ms the zoned kernel ({z3})"
             if z3 else "not measured (the profiler saw no device time)")
          + f"; zoned_eq_scan wall time (host clock, synchronized, median of {len(walls)}) "
          f"{results['zoned_range_scan Z3 wall'][0]:.6f} ms")
    del copy_dst
    return results


# the sharded phase's meshes, all of card 0: one shard, four shards (B1 a
# multiple of 32, block offsets inside the column) and a process group of
# one over NCCL
SHARDED_MESHES = ("S=1", "S=4", "NCCL-1")
SHARDED_REPS = 10  # timed calls a set and mesh, after the one whose launches are counted


@contextlib.contextmanager
def sharded_mesh(label: str, device):
    """The mesh called ``label``; NCCL-1 joins a process group of one over
    NCCL (``dist.initialize`` on a CUDA device; a file:// rendezvous in a
    temporary directory) and leaves it on exit."""
    import torch
    from shared_simd_scan_tpu_torch.parallel import dist

    if label != "NCCL-1":
        yield dist.Mesh((device,) * (4 if label == "S=4" else 1))
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.initialize(init_method=f"file://{tmp}/rendezvous", world_size=1, rank=0,
                        device=device)
        try:
            backend = torch.distributed.get_backend()
            print(f"NCCL-1: a process group of one, backend {backend}")
            check(backend == ("nccl" if device.type == "cuda" else "gloo"),
                  f"the process group of one runs on {backend}, the backend dist.initialize "
                  "names for the card")
            yield dist.make_mesh([device])
        finally:
            torch.distributed.destroy_process_group()


def sharded_sets(n: int, n31: int) -> dict:
    """Set -> (what, the unsharded call on the columns ``c``, the sharded
    call on the sharded columns ``c`` over mesh ``m`` (with ``q1``, this
    mesh's Q1 bits), whether a sharded result ``s`` equals the unsharded
    ``u``): the multi-process demo's sets, then X3, X4, H6, L1 and M1."""
    import torch
    from shared_simd_scan_tpu_torch import stats
    from shared_simd_scan_tpu_torch.ops import member, scan, unpack
    from shared_simd_scan_tpu_torch.parallel import dist, multiproc_demo

    same_scan = multiproc_demo.same_scan(n)
    nwords = (n + 7) // 8 * K // 4
    sets = {name: spec[:4] for name, spec in multiproc_demo.sets(n).items()}
    sets.update({
        "X3": ("sharded_shared_scan(i % 512, S64): the static tier",
               lambda c: scan.shared_scan_device(c["arb"], s64()),
               lambda c, m, q1: dist.sharded_shared_scan(c["arb"], s64(), m), same_scan),
        "X4": ("sharded_unpack(main)",
               lambda c: unpack.unpack_tiles(c["main"].tiles, WIDTH),
               lambda c, m, q1: dist.sharded_unpack(c["main"], m),
               lambda u, s, m: torch.equal(unpack.values_to_flat(dist.fetch_global(s, m), n),
                                           unpack.values_to_flat(u, n))),
        "H6": ("stats.describe(12-bit column, mesh=)",
               lambda c: stats.describe(c["h6"]),
               lambda c, m, q1: stats.describe(c["h6"], mesh=m),
               lambda u, s, m: s == u),
        "L1": ("sharded_linear_scan(main, keys 0..7): the fused interval kernel",
               lambda c: scan.interval_scan_linear_words_tiles(c["main"].tiles, 0, K, WIDTH, n),
               lambda c, m, q1: dist.sharded_linear_scan(c["main"], 0, K, m),
               lambda u, s, m: torch.equal(
                   dist.fetch_global(s[0], m).reshape(-1)[:nwords], u[0])
               and torch.equal(s[1], u[1])),
        "M1": ("sharded_member_scan(31-bit i % 512, w31_list): the chunked window body",
               lambda c: member.member_scan_device(c["w31"], w31_window_list()),
               lambda c, m, q1: dist.sharded_member_scan(c["w31"], w31_window_list(), m),
               multiproc_demo.same_scan(n31)),
    })
    return sets


def sharded_phase(device, dev, arb, cols, rev, h6) -> dict:
    """The sharded surface at full size (``parallel.dist``,
    ``query.evaluate_sharded``, ``stats``' ``mesh=``) on the main path's
    9-bit column, the ``i % 512`` column, the query table with the 20-bit
    ``revenue``, the 12-bit statistics column and a 31-bit ``i % 512``
    column of 512 MiB packed, on the three SHARDED_MESHES.  Each set runs
    unsharded and then on each mesh: once to warm up, once with the launch
    counters set to 0 just before and read just after, then SHARDED_REPS
    more times on the host clock (synchronized, median); each result is
    held bit for bit against the unsharded one (bits and the linear stream
    through ``fetch_global``).  Each sharded call launches its kernels once a
    shard: S=1 and NCCL-1 as the unsharded call, S=4 four times.  Frees
    the shards after each mesh.  Returns each set's report (ms and
    launches by mesh)."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import stats
    from shared_simd_scan_tpu_torch.parallel import dist

    t0 = time.monotonic()
    kernels = wrappers()
    n = dev.n
    _, w31 = wide_member_column(device, 31)
    columns = {"main": dev, "arb": arb, **cols, "revenue": rev, "h6": h6, "w31": w31}
    sets = sharded_sets(n, w31.n)
    smi = nvidia_smi()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(call):
        """(result, launches by kernel, host-clock ms: median of the timed
        calls), after one warm-up call (a first interval scan in a process
        also runs the shift verdict)."""
        call()
        sync()
        zero_launched(kernels.values())
        out = call()
        sync()
        launches = {name: launched(fn) for name, fn in kernels.items() if launched(fn)}
        times = []
        for _ in range(SHARDED_REPS):
            t1 = time.perf_counter()
            call()
            sync()
            times.append((time.perf_counter() - t1) * 1e3)
        return out, launches, statistics.median(times)

    report = {name: {"what": spec[0], "ms": {}, "launches": {}} for name, spec in sets.items()}
    unsharded = {}
    for name, (_, call, _, _) in sets.items():
        if name == "A1":  # Q1's bits, as the unsharded evaluate gave them
            columns["q1"] = unsharded["Q1"][0]
        out, launches, ms = run(lambda call=call: call(columns))
        unsharded[name] = out
        report[name]["launches"]["unsharded"], report[name]["ms"]["unsharded"] = launches, ms
    del columns["q1"]
    torch.cuda.empty_cache()
    print(f"sharded phase: unsharded calls in {time.monotonic() - t0:.1f} s")

    for label in SHARDED_MESHES:
        with sharded_mesh(label, device) as mesh:
            t1 = time.monotonic()
            shards = {name: dist.shard_column(col, mesh) for name, col in columns.items()}
            sync()
            main = shards["main"]
            offsets = [main.block_offset(i) for i in range(len(mesh.devices))]
            print(f"{label}: {mesh.size} shard(s) of B1 {main.local_b1} (main), block offsets "
                  f"{offsets}, sharded in {time.monotonic() - t1:.2f} s")
            if mesh.group is not None:
                backend = torch.distributed.get_backend(mesh.group)
            q1 = None
            for name, (what, _, call, same) in sets.items():
                out, launches, ms = run(lambda call=call: call(shards, mesh, q1))
                if name == "Q1":
                    q1 = out[0]
                report[name]["launches"][label] = launches
                report[name]["ms"][label] = ms
                check(bool(launches), f"{name} {label}: the sharded call launched {launches}")
                check(same(unsharded[name], out, mesh),
                      f"{name} {label}: {what} equals the unsharded result bit for bit")
                del out
            check(np.array_equal(stats.histogram_full(shards["h6"], mesh=mesh),
                                 stats.histogram_full(columns["h6"])),
                  f"H6 {label}: histogram_full(mesh=) equals the unsharded counts")
            del shards, main, q1
            torch.cuda.empty_cache()
    del unsharded, w31
    torch.cuda.empty_cache()

    for name, r in report.items():
        base = r["launches"]["unsharded"]
        check(r["launches"]["S=1"] == base and r["launches"]["NCCL-1"] == base
              and r["launches"]["S=4"] == {k: 4 * c for k, c in base.items()},
              f"{name}: S=1 and NCCL-1 launch as the unsharded call ({base}), S=4 four times")
        ms = ", ".join(f"{label} {r['ms'][label]:.6f}"
                       for label in ("unsharded", *SHARDED_MESHES))
        print(f"sharded {name} {r['what']}: host-clock ms {ms}; launches "
              f"{r['launches']['unsharded']} a call, S=4 {r['launches']['S=4']} ({smi})")
    seconds = time.monotonic() - t0
    print(json.dumps({"sharded": {"card": smi, "backend": backend, "n": n, "seconds": seconds,
                                  "sets": report}}))
    print(f"sharded phase ran in {seconds:.1f} s")
    return report


# the ranks phase: the demo's torchrun form, one rank on card 0, at the main
# path's n; and the child given LOCAL_RANK 1, which dist.initialize() refuses
RANKS_LAUNCH = ("-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1")
RANKS_DEMO = ("-m", "shared_simd_scan_tpu_torch.parallel.multiproc_demo")
RANKS_TIMEOUT = 240  # seconds a child may take
RANKS_SCALING = 8 << 20  # bench_scaling's bytes a slot in the rank


def ranks_phase(n: int, sharded: dict) -> None:
    """The demo launched through ``torch.distributed.run`` as one rank on
    the card (``dist.initialize()`` bound by ``LOCAL_RANK``, ``make_mesh()``
    that card alone, NCCL) at the main path's n, reusing this process's
    built kernels: its line must report LOCAL_RANK 0 on card 0, the mesh
    ``["cuda:0"]``, NCCL, every set equal to its unsharded call, and
    ``bench_scaling`` over the NCCL group its one row, verified.  Then a
    child given ``LOCAL_RANK=1`` on this one-card machine, which
    ``dist.initialize()`` must refuse with its ValueError.  Prints the
    child's host-clock ms a set beside the sharded phase's NCCL-1 ms."""
    import torch
    from shared_simd_scan_tpu_torch.parallel import multiproc_demo

    t0 = time.monotonic()
    root = pathlib.Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(root)
    out = subprocess.run([sys.executable, *RANKS_LAUNCH, *RANKS_DEMO, f"--values={n}",
                          f"--scaling={RANKS_SCALING}"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=RANKS_TIMEOUT)
    if out.returncode != 0:
        print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
    check(out.returncode == 0, f"the torchrun child exits 0 (got {out.returncode})")
    tag = "multiproc rank "  # a launcher may prefix a worker's lines
    lines = [json.loads(line.split(tag, 1)[1]) for line in out.stdout.splitlines() if tag in line]
    check(len(lines) == 1, f"the torchrun child printed one rank line (got {len(lines)})")
    r = lines[0]
    print(f"ranks: the rank's line {json.dumps(r)}")
    check(r["local_rank"] == "0" and r["current_device"] == 0 and r["rank"] == 0,
          "the rank reports LOCAL_RANK 0 and current device 0")
    check(r["mesh"] == ["cuda:0"] and r["mesh_size"] == r["world_size"] == 1,
          "make_mesh() under torchrun is the rank's card alone: ['cuda:0'], size 1")
    check(r["backend"] == "nccl", f"dist.initialize() under torchrun runs on {r['backend']}")
    names = set(multiproc_demo.sets(n))
    check(r["ok"] and r["n"] == n and set(r["ms"]) == names and names <= set(sharded),
          f"every set of the rank at n {n} equals its unsharded call")
    row = [line for line in out.stdout.splitlines() if "sharded shared scan k=8 on" in line]
    print(f"ranks: bench_scaling in the rank: {row}")
    check(r["scaling_rows"] == [1] and "verification: ok" in out.stdout
          and len(row) == 1 and "on 1 device(s)" in row[0],
          "bench_scaling over the rank's NCCL group gives its one row, verified")
    check(r["prebuilt_kernels"] is True, "the child loaded this process's built kernels")

    refused = subprocess.run(
        [sys.executable, *RANKS_DEMO, f"--values={n}"], cwd=root, capture_output=True, text=True,
        env={**env, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "1"},
        timeout=RANKS_TIMEOUT)
    last = (refused.stderr.strip().splitlines() or [""])[-1]
    print(f"ranks: the LOCAL_RANK=1 child exits {refused.returncode}: {last}")
    count = torch.cuda.device_count()
    check(refused.returncode != 0 and last.startswith("ValueError: LOCAL_RANK=1 ")
          and f"torch.cuda.device_count() is {count}" in last,
          f"dist.initialize() refuses LOCAL_RANK=1 on {count} card(s) with its ValueError")
    seconds = time.monotonic() - t0
    smi = nvidia_smi()
    sets = {name: {"ms": ms, "nccl1_ms": sharded[name]["ms"]["NCCL-1"]}
            for name, ms in r["ms"].items()}
    for name, v in sets.items():
        print(f"ranks {name}: host-clock ms torchrun rank {v['ms']:.6f}, sharded phase NCCL-1 "
              f"{v['nccl1_ms']:.6f} ({smi})")
    print(json.dumps({"ranks": {"card": smi, "launcher": " ".join(RANKS_LAUNCH[1:]),
                                "n": n, "rank": r, "refused": last, "seconds": seconds,
                                "sets": sets}}))
    print(f"ranks phase ran in {seconds:.1f} s")


def small_linear_phase(device, errs: dict) -> None:
    """The linear export's kernels against their plain versions at small
    ragged sizes: the interleave at k 1-1024 on random words (ragged byte
    counts, rows of a wider buffer) and the stream interleave with ragged
    M; the fused kernels at every k their tiers admit, widths 1-31, with a
    ``block_offset``, keys past the domain, 0xFFFFFFFF and duplicates."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.ops import linear, scan, unpack

    rng = np.random.default_rng(SEED + 6)

    def words(shape):
        w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(w.view(np.int32)).to(device)

    def note(name, a, b):
        e = max(max_abs_err(a[0], b[0]), int((a[1] - b[1]).abs().max())) \
            if isinstance(a, tuple) else max_abs_err(a, b)
        errs[name] = max(errs[name], e)

    for k in INTERLEAVE_KS:
        for w in (1, 257, 9000):
            bits = words((k, w))
            for nwords in (w * k, -(-(4 * w - 3) * k // 4)):
                note("interleave", linear.interleave_words(bits, nwords),
                     linear.interleave_words_plain(bits, nwords))
            wide = torch.zeros((k, w + 77), dtype=torch.int32, device=device)
            wide[:, :w] = bits
            note("interleave", linear.interleave_words(wide[:, :w], w * k),
                 linear.interleave_words_plain(bits, w * k))
    for m, g in STREAM_CASES:
        for big_m in (1, 1000, 4099):
            streams = words((m, big_m))
            for nwords in (m * big_m - 5, m * big_m + 37):
                if nwords > 0:
                    note("interleave_streams", linear.interleave_streams_words(streams, g, nwords),
                         linear.interleave_streams_words_plain(streams, g, nwords))
    for width in LINEAR_WIDTHS:
        dom = 1 << width
        for n in SMALL_NS:
            vals = torch.from_numpy(rng.integers(0, dom, size=n).astype(np.int32)).to(device)
            tiles = unpack.pack_device_kernel(vals, width).tiles
            for k in FUSED_KS:
                keys = rng.integers(0, dom, size=k).astype(np.uint32)
                keys[1], keys[2], keys[3] = keys[0], min(dom, 0xFFFFFFFF), 0xFFFFFFFF
                kt = torch.from_numpy(keys.view(np.int32)).to(device)
                for bo in ((0, 2) if n == SMALL_NS[1] else (0,)):
                    for lo in (0, max(dom - 5, 0), 0xFFFFFFFF - 2):
                        note("interval_scan_linear",
                             scan._interval_linear_tiles_impl(tiles, lo, k, width, n, bo),
                             scan._interval_linear_tiles_plain(tiles, lo, k, width, n, bo))
                    note("static_scan_linear", scan._static_linear_tiles_impl(tiles, keys, width, n, bo),
                         scan._static_linear_tiles_plain(tiles, keys, width, n, bo))
                    note("bitsliced_scan_linear",
                         scan._bitsliced_linear_tiles_impl(tiles, kt, width, n, bo),
                         scan._bitsliced_linear_tiles_plain(tiles, kt, width, n, bo))
    n = SMALL_NS[1]
    # the fold body (host keys by value, and keys in device memory), every width
    for width in sorted(set(range(1, 32)) - set(LINEAR_WIDTHS)):
        dom = 1 << width
        vals = torch.from_numpy(rng.integers(0, dom, size=n).astype(np.int32)).to(device)
        tiles = unpack.pack_device_kernel(vals, width).tiles
        for k in FUSED_KS:
            keys = rng.integers(0, dom, size=k).astype(np.uint32)
            keys[1], keys[2], keys[-1] = keys[0], min(dom, 0xFFFFFFFF), 0xFFFFFFFF
            kt = torch.from_numpy(keys.view(np.int32)).to(device)
            for bo in (0, 2):
                note("static_scan_linear", scan._static_linear_tiles_impl(tiles, keys, width, n, bo),
                     scan._static_linear_tiles_plain(tiles, keys, width, n, bo))
                note("bitsliced_scan_linear",
                     scan._bitsliced_linear_tiles_impl(tiles, kt, width, n, bo),
                     scan._bitsliced_linear_tiles_plain(tiles, kt, width, n, bo))
    torch.cuda.synchronize()
    for name in LINEAR:
        check(errs[name] == 0, f"{name} kernel bit-exact against its plain version (widths "
              f"{LINEAR_WIDTHS}, n {SMALL_NS}, fused k {FUSED_KS[0]}-{FUSED_KS[-1]}, interleave k "
              f"{INTERLEAVE_KS}, streams {STREAM_CASES}; the static and runtime-key folds at "
              "widths 1-31)")


def deinterleave(lin, k: int, nbytes: int):
    """Linear bytes (uint8, or int32 words) -> uint8 [k, nbytes], row j the
    bitvector bytes of key j."""
    import torch

    return lin.view(torch.uint8)[: nbytes * k].view(nbytes, k).t()


def linear_phase(device, dev, arb) -> dict:
    """The linear export at full size, with the launch counters set to 0
    just before each call and read just after: L1-L4
    ``shared_scan_linear_words_device`` (keys 0..7 on the main path's
    column; S8 host keys, S8 as CUDA keys under
    ``set_sync_debug_mode("error")``, S64 both ways on the i % 512 column),
    L5 ``shared_scan_linear_device`` (keys 0..5, uint8), L6 S64 as eight
    fused groups of 8 joined by ``interleave_streams_words(g=2)``."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch import shared_scan_device, shared_scan_linear_device
    from shared_simd_scan_tpu_torch.ops import linear, scan

    kernels = {name: fn for name, fn in wrappers().items() if name in LINEAR}
    others = {name: fn for name, fn in wrappers().items() if name not in LINEAR}
    n = dev.n
    nbytes = (n + 7) // 8
    s64_keys = s64()
    main_keys, k6 = list(range(K)), list(range(6))
    cuda_s8 = torch.tensor(S8, dtype=torch.int32, device=device)
    cuda_s64 = torch.tensor(s64_keys, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    print(f"linear phase: the main path's column (i % {K}) and the i % {DOMAIN} column, n {n}, "
          f"nbytes {nbytes}")
    sets = {  # name -> (call, keys, column, the kernel its rule names, runtime keys)
        "L1": (lambda: scan.shared_scan_linear_words_device(dev, main_keys), main_keys, dev,
               "interval_scan_linear", False),
        "L2": (lambda: scan.shared_scan_linear_words_device(arb, S8), S8, arb,
               "static_scan_linear", False),
        "L3": (lambda: scan.shared_scan_linear_words_device(arb, cuda_s8), S8, arb,
               "bitsliced_scan_linear", True),
        "L4 host": (lambda: scan.shared_scan_linear_words_device(arb, s64_keys), s64_keys, arb,
                    "static_scan_linear", False),
        "L4 CUDA": (lambda: scan.shared_scan_linear_words_device(arb, cuda_s64), s64_keys, arb,
                    "bitsliced_scan_linear", True),
        "L5": (lambda: shared_scan_linear_device(dev, k6), k6, dev, None, False),
        "L6": (lambda: linear.interleave_streams_words(torch.stack([
            scan.static_scan_linear_words_tiles(arb.tiles, s64_keys[8 * g: 8 * g + 8], WIDTH, n,
                                                flat=False)[0].reshape(-1) for g in range(8)]),
            2, nbytes * 64 // 4), s64_keys, arb, None, False),
    }
    launches = {name: 0 for name in LINEAR}
    for name, (call, keys, col, want, runtime) in sets.items():
        zero_launched((*kernels.values(), *others.values()))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if runtime:  # CUDA-tensor keys: any device-to-host copy raises
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
        ran = {k: launched(fn) for k, fn in {**kernels, **others}.items() if launched(fn)}
        for k_name in LINEAR:
            launches[k_name] += launched(kernels[k_name])
        print(f"{name}: k={len(keys)}, {out.numel() * out.element_size()} bytes, ran {ran}, "
              f"{wall:.3f} ms host clock (first call)")
        if want is not None:
            check(ran == {want: 1}, f"{name}: ran {ran}, the kernel its rule names ({want})")
        elif name == "L5":
            check(ran == {"interval_scan": 1, "interleave": 1},
                  f"L5: ran {ran}: k=6 takes the interval kernel, then the interleave kernel")
        else:
            check(ran == {"static_scan_linear": 8, "interleave_streams": 1},
                  f"L6: ran {ran}: eight fused static groups, then the stream interleave")
        k = len(keys)
        # the counts against their closed form, and the words against the plain twin
        modulus = K if col is dev else DOMAIN
        expect = [(n - 1 - key) // modulus + 1 if key < modulus else 0 for key in keys]
        host = np.asarray(keys, np.uint32)
        if name == "L5":
            bits, counts = shared_scan_device(dev, k6)
            plain, _ = scan.interval_scan_tiles_plain(dev.tiles, 0, 6, WIDTH, n)
            plain = linear.interleave_words_plain(plain.reshape(6, -1), -(-nbytes * 6 // 4))
            plain = plain.view(torch.uint8)[: nbytes * 6]
        else:
            if name == "L1":
                tier = scan.interval_scan_linear_words_tiles(dev.tiles, 0, K, WIDTH, n)
                plain = scan._interval_linear_tiles_plain(dev.tiles, 0, K, WIDTH, n)
            elif runtime:
                kt = cuda_s8 if k == 8 else cuda_s64
                tier = (scan.bitsliced_scan_linear_words_tiles(arb.tiles, kt, WIDTH, n) if k == 8
                        else scan.bitsliced_scan_linear_words_large(arb.tiles, kt, k, WIDTH, n))
                plain = scan._bitsliced_linear_tiles_plain(arb.tiles, kt, WIDTH, n)
            else:
                tier = (scan.static_scan_linear_words_tiles(arb.tiles, keys, WIDTH, n) if k == 8
                        else scan.static_scan_linear_words_large(arb.tiles, keys, WIDTH, n))
                plain = scan._static_linear_tiles_plain(arb.tiles, host, WIDTH, n)
            counts = tier[1]
            check(torch.equal(tier[0], out), f"{name}: the tier function's words == the dispatcher's")
            plain = plain[0].reshape(-1)[: out.numel()]
            del tier
            bits, _ = shared_scan_device(col, keys)
        check(counts.tolist() == expect, f"{name}: counts == closed form")
        check(torch.equal(out, plain), f"{name}: every word equals the plain twin's")
        del plain
        check(torch.equal(deinterleave(out, k, nbytes), bits.view(torch.uint8)[:, :nbytes]),
              f"{name}: the linear bytes de-interleaved == shared_scan_device's bits for the same "
              f"keys")
        del bits
        if name == "L4 host":
            l4 = out
        elif name in ("L4 CUDA", "L6"):
            check(torch.equal(out, l4), f"{name}: every word == L4's (host keys)")
        del out
    del l4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"linear phase launches {launches}")
    return launches


def linear_timing_phase(device, dev, arb, errs: dict) -> tuple[dict, dict]:
    """Each linear kernel and its plain twin at full size, beside a
    ``copy_`` of the packed column; each fused kernel also beside its scan
    body alone (the bits-form kernel) and the two-pass composition (that
    kernel, then the interleave kernel); the interleave beside the one
    PyTorch call that computes the same bytes (the uint8 view's
    ``.t().contiguous()``), the stream interleave beside
    ``transpose(0, 1).contiguous()``.  Returns (times, extras)."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import linear, scan

    n = dev.n
    tiles, atiles = dev.tiles, arb.tiles
    nblocks = tiles.shape[1] * LANES
    tile_bytes = tiles.numel() * 4
    s64_keys = s64()
    kt = {8: torch.tensor(S8, dtype=torch.int32, device=device),
          64: torch.tensor(s64_keys, dtype=torch.int32, device=device)}
    hk = {8: S8, 64: s64_keys}

    def fused_bytes(k, keys_array):  # tiles read, k words per block written, counts, keys
        return tile_bytes + nblocks * k * 4 + k * 8 + (4 * k if keys_array else 0)

    def two_pass(scan_fn, k):  # (the two-pass composition, the scan body alone)
        def run():
            bits, _ = scan_fn()
            return linear.interleave_words(bits.reshape(k, -1), nblocks * k)
        return run, scan_fn

    bits8, _ = scan.interval_scan_tiles(tiles, 0, K, WIDTH, n)
    bits8 = bits8.reshape(K, -1)
    bits6 = scan.interval_scan_tiles(tiles, 0, 6, WIDTH, n)[0].reshape(6, -1)
    streams = torch.stack([scan._static_linear_tiles_impl(
        atiles, np.asarray(s64_keys[8 * g: 8 * g + 8], np.uint32), WIDTH, n)[0].reshape(-1)
        for g in range(8)])
    nw_streams = streams.numel()
    cases = {  # name -> (kernel, plain, bytes, two-pass or library call)
        "interval_scan_linear L1": (
            lambda: scan._interval_linear_tiles_impl(tiles, 0, K, WIDTH, n),
            lambda: scan._interval_linear_tiles_plain(tiles, 0, K, WIDTH, n),
            fused_bytes(K, False), two_pass(lambda: scan.interval_scan_tiles(tiles, 0, K, WIDTH, n), K)),
        "interleave k=8": (
            lambda: linear.interleave_words(bits8, nblocks * K),
            lambda: linear.interleave_words_plain(bits8, nblocks * K),
            2 * bits8.numel() * 4, (lambda: bits8.view(torch.uint8).t().contiguous(), None)),
        "interleave k=6": (
            lambda: linear.interleave_words(bits6, nblocks * 6),
            lambda: linear.interleave_words_plain(bits6, nblocks * 6),
            2 * bits6.numel() * 4, (lambda: bits6.view(torch.uint8).t().contiguous(), None)),
        "interleave_streams L6": (
            lambda: linear.interleave_streams_words(streams, 2, nw_streams),
            lambda: linear.interleave_streams_words_plain(streams, 2, nw_streams),
            2 * nw_streams * 4,
            (lambda: streams.view(8, -1, 2).transpose(0, 1).contiguous(), None)),
    }
    for k, label in ((8, "L2"), (64, "L4")):
        keys_np = np.asarray(hk[k], np.uint32)
        cases[f"static_scan_linear {label}"] = (
            lambda keys_np=keys_np: scan._static_linear_tiles_impl(atiles, keys_np, WIDTH, n),
            lambda keys_np=keys_np: scan._static_linear_tiles_plain(atiles, keys_np, WIDTH, n),
            fused_bytes(k, False), two_pass(lambda k=k: scan.shared_scan_bitsliced_static_tiles(
                atiles, hk[k], WIDTH, n), k))
        cases[f"bitsliced_scan_linear {'L3' if k == 8 else 'L4'}"] = (
            lambda k=k: scan._bitsliced_linear_tiles_impl(atiles, kt[k], WIDTH, n),
            lambda k=k: scan._bitsliced_linear_tiles_plain(atiles, kt[k], WIDTH, n),
            fused_bytes(k, True), two_pass(lambda k=k: scan.shared_scan_bitsliced_tiles(
                atiles, kt[k], WIDTH, n), k))
    for name, (kern, plain, _, (other, _)) in cases.items():
        kernel = name.split()[0]
        a, b = kern(), plain()
        e = max(max_abs_err(a[0], b[0]), int((a[1] - b[1]).abs().max())) \
            if isinstance(a, tuple) else max_abs_err(a, b)
        errs[kernel] = max(errs[kernel], e)
        if kernel == "interleave" or kernel == "interleave_streams":
            lib = other().reshape(-1)
            check(torch.equal(lib.view(torch.int32) if lib.dtype == torch.uint8 else lib, a),
                  f"{name}: the library call gives the kernel's words")
        else:
            check(torch.equal(other(), a[0].reshape(-1)), f"{name}: the two-pass composition "
                  "gives the fused kernel's words")
        del a, b
        torch.cuda.empty_cache()  # the k=64 plain twins take GB-sized blocks in turn
        check(errs[kernel] == 0, f"{name} kernel bit-exact against its plain twin at full size")

    copy_dst = torch.empty_like(tiles)
    copy_ms = time_ms(lambda: copy_dst.copy_(tiles), batches=5, calls=10)
    print(f"copy_ of the packed column ({tile_bytes} bytes): {copy_ms:.6f} ms")
    del copy_dst
    times, extras = {}, {}
    for name, (kern, plain, nbytes, (other, body)) in cases.items():
        ms = time_ms(kern, batches=5, calls=10)
        plain_ms = time_ms(plain, batches=3, calls=2)
        other_ms = time_ms(other, batches=5, calls=5)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        times[name] = (ms, plain_ms, bound_ms)
        kind = "library" if body is None else "two_pass"
        extras[name] = {f"{kind}_ms": other_ms}
        if body is not None:
            extras[name]["body_ms"] = time_ms(body, batches=5, calls=10)
        print(f"time {name}: kernel {ms:.6f} ms (bound {bound_ms:.6f} ms for {nbytes} bytes, "
              f"{bound_ms / ms:.4f} of it); plain {plain_ms:.6f} ms; {kind.replace('_', '-')} "
              f"{other_ms:.6f} ms" + ("" if body is None else
                                     f"; scan body alone {extras[name]['body_ms']:.6f} ms"))
    print("the static fold (width 9):")
    kernel_report({"static_fold_kernelILi9ENS_10LinearKeysELi0E": "static linear fold, width 9",
                   "static_fold_kernelILi9ENS_10DeviceKeysELi0E":
                       "runtime-key linear fold (keys in device memory), width 9"})
    del bits8, bits6, streams
    torch.cuda.empty_cache()
    return times, extras


def small_bench_phase(device, errs: dict) -> None:
    """The benchmark's kernels against their plain versions at small ragged
    sizes: ``memcpy`` at byte counts that are not multiples of 16 and
    around the stages of its ring; the chunked and dynamic scans at every
    width of BENCH_WIDTHS and k of BENCH_KS and around one chunk, with key 0
    over the padding, keys past the domain, 0xFFFFFFFF, duplicates (across
    the chunk boundary, across groups of rows, and across the dynamic
    launch boundary past 1024 keys), a chunk of equal keys, a set of keys
    all past the domain, and a ``block_offset``."""
    import numpy as np
    import torch
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.ops import scan, unpack

    rng = np.random.default_rng(SEED + 7)
    stage = harness.COPY_STAGE_BYTES
    # one stage +- 16 bytes; several stages and a 7-byte tail; past every ring's depth
    copy_bytes = COPY_BYTES + (stage - 16, stage + 16, 5 * stage + 7, 3072 * stage + 7)
    for nbytes in copy_bytes:
        src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=device)
        a = harness.memcpy(src, torch.zeros_like(src))
        p = harness.memcpy_plain(src, torch.zeros_like(src))
        e = int((a.to(torch.int16) - p.to(torch.int16)).abs().max())
        errs["memcpy"] = max(errs["memcpy"], e)
    c, launch = scan.CHUNK_KEYS, scan.MAX_LAUNCH_KEYS
    ks = sorted(set(BENCH_KS) | {c - 1, c, c + 1})
    for width in BENCH_WIDTHS:
        dom = 1 << width
        for n in SMALL_NS:
            vals = torch.from_numpy(rng.integers(0, dom, size=n).astype(np.int32)).to(device)
            tiles = unpack.pack_device_kernel(vals, width).tiles
            key_sets = []
            for k in ks:
                keys = rng.integers(0, dom, size=k).astype(np.uint32)
                keys[0] = 0
                if k >= 8:
                    keys[1], keys[2], keys[3] = min(dom, 0xFFFFFFFF), 0xFFFFFFFF, keys[4]
                if k > c:
                    keys[c - 1] = keys[c] = keys[4]
                    keys[k - 1] = keys[5]
                if k > launch:
                    keys[launch - 1] = keys[launch] = keys[6]
                key_sets.append(keys)
            key_sets.append(np.full(c, rng.integers(0, dom), dtype=np.uint32))
            key_sets.append(np.array([dom, 0xFFFFFFFF, dom + 1, 0xFFFFFFFF], dtype=np.uint32))
            for keys in key_sets:
                kt = torch.from_numpy(keys.view(np.int32)).to(device)
                for bo in ((0, 2) if n == SMALL_NS[1] else (0,)):
                    for name in BENCH[1:]:
                        a = getattr(scan, f"{name}_tiles")(tiles, kt, width, n, bo)
                        p = getattr(scan, f"{name}_tiles_plain")(tiles, kt, width, n, bo)
                        errs[name] = max(errs[name], max_abs_err(a[0], p[0]),
                                         int((a[1] - p[1]).abs().max()))
    torch.cuda.synchronize()
    check(errs["memcpy"] == 0, f"memcpy kernel byte-exact against its plain version (bytes "
          f"{copy_bytes})")
    for name in BENCH[1:]:
        check(errs[name] == 0, f"{name} kernel bit-exact against its plain version (widths "
              f"{BENCH_WIDTHS}, n {SMALL_NS}, k {ks}, {c} equal keys and 4 past the domain)")


def ptxas_usage(fragment: str, spills: bool = False) -> str:
    """ptxas's registers and static shared memory (and with ``spills`` its
    stack and spill bytes) of each kernel whose mangled name holds
    ``fragment``, from the build's log."""
    from shared_simd_scan_tpu_torch.ops import _cuda

    log_path = _cuda.BUILD_DIR / "ptxas.log"
    log = log_path.read_text() if log_path.exists() else ""
    found = [f"{entry}: {line}" for entry, line in ptxas_lines(log)
             if fragment in entry and ("Used" in line or (spills and "spill" in line))]
    return "; ".join(found) or "not in the build log"


def kernel_report(fragments: dict) -> None:
    """ptxas's registers and shared memory, and the SASS report of
    bench/redesign_sweep.py (instructions per atomic of the blocks that
    hold eight or more, the loops that stage rows), of the package's
    kernels whose mangled names hold ``fragments`` (fragment -> label)."""
    from shared_simd_scan_tpu_torch.bench.redesign_sweep import sass_report
    from shared_simd_scan_tpu_torch.ops import _cuda

    log_path = _cuda.BUILD_DIR / "ptxas.log"
    log = log_path.read_text() if log_path.exists() else ""
    names = sorted({entry for entry, _ in ptxas_lines(log) if any(f in entry for f in fragments)})
    for fragment, label in fragments.items():
        print(f"  {label}: {ptxas_usage(fragment)}")
    if names:
        sass_report(_cuda.library_path(), fragments, names)
    else:
        print("  sass: the kernels are not in the build log")


def sweep_regexes():
    """LINE_RE and GBS_RE of scripts/prepare_shared_scan_results.py, the
    sweep script that parses the CLI's rows."""
    path = pathlib.Path(__file__).resolve().parent / "scripts" / "prepare_shared_scan_results.py"
    spec = importlib.util.spec_from_file_location("prepare_shared_scan_results", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.LINE_RE, mod.GBS_RE


def cli_phase(device) -> dict:
    """The benchmark CLI in process (CLI_RUNS), with the launch counters set
    to 0 just before and read just after; checks its output."""
    import torch
    from shared_simd_scan_tpu_torch.bench import cli, harness

    line_re, gbs_re = sweep_regexes()
    roof = harness.hbm_peak_bytes_per_s()
    check(roof is not None, f"the card's data-sheet memory rate is known ({roof} bytes/s)")
    kernels = wrappers()
    zero_launched(kernels.values())
    t0 = time.monotonic()
    runs = []
    for argv, verifications in CLI_RUNS:
        buf = io.StringIO()
        t1 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        print(f"cli.main({argv}) -> {rc} in {time.monotonic() - t1:.1f} s:")
        print(buf.getvalue(), end="")
        runs.append((argv, rc, buf.getvalue(), verifications))
    launches = {name: launched(fn) for name, fn in kernels.items()}
    torch.cuda.empty_cache()
    print(f"CLI phase ran in {time.monotonic() - t0:.1f} s; launches "
          f"{ {k: launches[k] for k in BENCH} }")

    for name in BENCH:
        check(launches[name] > 0, f"the CLI launched the {name} kernel ({launches[name]}x)")
    for argv, rc, out, verifications in runs:
        check(rc == 0, f"cli.main({argv}) returned 0")
        lines = out.splitlines()
        verdicts = [line.split("verification:", 1)[1].strip() for line in lines
                    if "verification:" in line]
        check(verdicts == ["ok"] * verifications, f"{argv}: every verification reads ok "
              f"({len(verdicts)} of {verifications})")
        rows = [i for i, line in enumerate(lines) if line.startswith("* ")]
        check(len(rows) > 0 and all(line_re.match(lines[i]) and i + 1 < len(lines)
                                    and gbs_re.match(lines[i + 1]) for i in rows),
              f"{argv}: all {len(rows)} rows parse with the sweep script's LINE_RE and GBS_RE")
        top = max(float(gbs_re.match(lines[i + 1])["gbs"]) * 1e9 for i in rows)
        check(top <= PEAK_SHARE * roof, f"{argv}: no row above {PEAK_SHARE:.0%} of {roof:.4g} "
              f"bytes/s (the highest {top:.4g})")
    return launches


def bench_timing_phase(device, arb, errs: dict) -> tuple[dict, dict]:
    """The memcpy kernel, its plain version and ``copy_`` on 512 MiB; the
    chunked and dynamic kernels on S64 and S256 of the i % 512 column, each
    checked against its plain twin (32 keys at a time) and the closed-form
    counts, timed beside its plain twin; the runtime bit-sliced kernel
    timed beside them on the same keys (the compare wrapper on them:
    scan_timing_phase).  Returns (times, library times)."""
    import torch
    from shared_simd_scan_tpu_torch.bench import harness
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import _cuda, scan

    t0 = time.monotonic()
    times, library = {}, {}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    src = torch.randint(0, 1 << 31, (DATA_SIZE // 4,), generator=gen, device=device,
                        dtype=torch.int32)
    dst = torch.empty_like(src)
    harness.memcpy(src, dst)
    errs["memcpy"] = max(errs["memcpy"], max_abs_err(dst, src))
    check(errs["memcpy"] == 0, f"memcpy of {DATA_SIZE} bytes gives back every byte")
    ms = time_ms(lambda: harness.memcpy(src, dst), batches=5, calls=10)
    plain_ms = time_ms(lambda: harness.memcpy_plain(src, dst), batches=5, calls=10)
    library["memcpy"] = time_ms(lambda: dst.copy_(src), batches=5, calls=10)
    times["memcpy 512MiB"] = (ms, plain_ms, 2 * DATA_SIZE / HBM_BYTES_PER_S * 1e3)
    src.zero_()
    zeros = (time_ms(lambda: harness.memcpy(src, dst), batches=5, calls=10),
             time_ms(lambda: dst.copy_(src), batches=5, calls=10))
    print(f"time memcpy 512 MiB of random words: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
          f"copy_ {library['memcpy']:.6f} ms, bound {times['memcpy 512MiB'][2]:.6f} ms; of zeros: "
          f"kernel {zeros[0]:.6f} ms, copy_ {zeros[1]:.6f} ms")
    print(f"  memcpy kernel: {ptxas_usage('copy_ring_kernel')}; dynamic shared memory "
          f"{_cuda.lib().sss_copy_smem()} bytes a CTA")
    del src, dst

    tiles, n = arb.tiles, arb.n
    nblocks = tiles.shape[1] * LANES
    for label, keys in (("S64", s64()), ("S256", s256())):
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        expect = [(n - 1 - key) // DOMAIN + 1 for key in keys]
        nbytes = tiles.numel() * 4 + len(keys) * (nblocks * 4 + 8 + 4)
        for name in ("shared_scan_chunked", "shared_scan_dynamic"):
            kern = getattr(scan, f"{name}_tiles")
            plain = getattr(scan, f"{name}_tiles_plain")
            bits, counts = kern(tiles, kt, WIDTH, n)
            check(counts.tolist() == expect, f"{name} {label}: counts == closed form")
            e = 0
            for j0 in range(0, len(keys), 32):
                pbits, pcounts = plain(tiles, kt[j0: j0 + 32], WIDTH, n)
                e = max(e, max_abs_err(bits[j0: j0 + 32], pbits),
                        int((counts[j0: j0 + 32] - pcounts).abs().max()))
                del pbits
            del bits
            errs[name] = max(errs[name], e)
            check(errs[name] == 0, f"{name} {label} kernel bit-exact against its plain twin at "
                  f"full size")
            ms = time_ms(lambda: kern(tiles, kt, WIDTH, n), batches=5, calls=10)
            plain_ms = time_ms(lambda: plain(tiles, kt, WIDTH, n), batches=1 if len(keys) > 64
                               else 2, calls=1)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            times[f"{name} {label}"] = (ms, plain_ms, bound_ms)
            print(f"time {name} {label} (k={len(keys)}): kernel {ms:.6f} ms (bound "
                  f"{bound_ms:.6f} ms for {nbytes} bytes)"
                  + (f"; plain {plain_ms:.6f} ms" if plain_ms is not None else ""))
            print(f"  {name} kernel: {ptxas_usage(f'{name}_kernel')}; dynamic shared memory "
                  f"{getattr(_cuda.lib(), f'sss_{name}_smem')(WIDTH)} bytes a CTA at width "
                  f"{WIDTH}")
            torch.cuda.empty_cache()
        _, counts = scan.shared_scan_bitsliced_tiles(tiles, kt, WIDTH, n)
        check(counts.tolist() == expect, f"shared_scan_bitsliced {label}: counts == closed form")
        ms = time_ms(lambda: scan.shared_scan_bitsliced_tiles(tiles, kt, WIDTH, n), batches=5,
                     calls=10)
        print(f"time shared_scan_bitsliced {label} (k={len(keys)}, beside the compares): kernel "
              f"{ms:.6f} ms")
        torch.cuda.empty_cache()
    print(f"bench timing phase ran in {time.monotonic() - t0:.1f} s")
    return times, library


def scan_timing_phase(device, n: int, dev, arb, errs: dict) -> tuple[dict, dict]:
    """The compare wrapper on k = 1 (key 3 of the main path's column) and on
    S8, S64 and S256 of the i % 512 column as CUDA keys, and the interval
    kernel on keys 0..k-1 of the main path's column for k = 64 and 1024,
    each checked -- the launches by kernel (the compare kernel, or from
    scan._compare_fold_wins the bit-sliced tier's), the counts against the
    closed form, the bits against the plain version (32 keys at a time; k =
    1024 on three slices of the column with their block_offset) -- and
    timed beside its bound and the staged fold on the same keys (the
    runtime tier's fold for CUDA keys, the static tier's for the interval's
    host keys).  Returns (times, the folds' times)."""
    import torch
    from shared_simd_scan_tpu_torch.layout import LANES
    from shared_simd_scan_tpu_torch.ops import scan

    t0 = time.monotonic()
    times, folds = {}, {}
    torch.cuda.empty_cache()
    sets = [("k=1", dev.tiles, [SCAN_KEY], K), ("S8", arb.tiles, S8, DOMAIN),
            ("S64", arb.tiles, s64(), DOMAIN), ("S256", arb.tiles, s256(), DOMAIN)]
    for label, tiles, keys, modk in sets:
        nblocks = tiles.shape[1] * LANES
        kt = torch.tensor(keys, dtype=torch.int32, device=device)
        expect = [(n - 1 - key) // modk + 1 if key < modk else 0 for key in keys]
        before = {name: launched(fn) for name, fn in wrappers().items()}
        bits, counts = scan.shared_scan_tiles(tiles, kt, WIDTH, n)
        torch.cuda.synchronize()
        check(ran_kernels(before) == compare_launches(WIDTH, len(keys)),
              f"shared_scan {label}: ran {ran_kernels(before)}, the kernels "
              f"scan._compare_fold_wins({WIDTH}, {len(keys)}) names")
        check(counts.tolist() == expect, f"shared_scan {label}: counts == closed form")
        e = 0
        for j0 in range(0, len(keys), 32):
            pbits, pcounts = scan.shared_scan_tiles_plain(tiles, kt[j0: j0 + 32], WIDTH, n)
            e = max(e, max_abs_err(bits[j0: j0 + 32], pbits),
                    int((counts[j0: j0 + 32] - pcounts).abs().max()))
            del pbits
        del bits
        errs["shared_scan"] = max(errs["shared_scan"], e)
        check(errs["shared_scan"] == 0, f"shared_scan {label} bit-exact against its plain "
              f"version at full size")
        nbytes = tiles.numel() * 4 + len(keys) * (nblocks * 4 + 8 + 4)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = time_ms(lambda: scan.shared_scan_tiles(tiles, kt, WIDTH, n), batches=5, calls=10)
        fold_ms = time_ms(lambda: scan.shared_scan_bitsliced_tiles(tiles, kt, WIDTH, n),
                          batches=5, calls=10)
        plain_ms = (time_ms(lambda: scan.shared_scan_tiles_plain(tiles, kt, WIDTH, n), batches=2,
                            calls=1) if len(keys) <= 8 else None)
        times[f"shared_scan {label}"] = (ms, plain_ms, bound_ms)
        folds[f"shared_scan {label}"] = fold_ms
        print(f"time shared_scan {label} (k={len(keys)}, CUDA keys; ran "
              f"{compare_launches(WIDTH, len(keys))}): {ms:.6f} ms, bound {bound_ms:.6f} ms for "
              f"{nbytes} bytes ({bound_ms / ms:.4f} of it); the fold on the key tensor "
              f"{fold_ms:.6f} ms" + (f"; plain {plain_ms:.6f} ms" if plain_ms is not None else ""))
        torch.cuda.empty_cache()
    tiles = dev.tiles
    nblocks = tiles.shape[1] * LANES
    b1 = tiles.shape[1]
    for k in INTERVAL_TIMED:
        expect = [(n - 1 - j) // K + 1 if j < K else 0 for j in range(k)]
        before = {name: launched(fn) for name, fn in wrappers().items()}
        bits, counts = scan.interval_scan_tiles(tiles, 0, k, WIDTH, n)
        torch.cuda.synchronize()
        check(ran_kernels(before) == {"interval_scan": 1},
              f"interval k={k}: ran {ran_kernels(before)}, one launch of the interval kernel")
        check(counts.tolist() == expect, f"interval k={k}: counts == closed form")
        if k <= 64:
            p = scan.interval_scan_tiles_plain(tiles, 0, k, WIDTH, n)
            e = max(max_abs_err(bits, p[0]), int((counts - p[1]).abs().max()))
            del p
        else:  # the plain version's int64 words of 1024 keys would not fit: slices of 64 rows
            e = 0
            for a in (0, b1 // 2 - 17, b1 - 64):
                sl = tiles[:, a: a + 64].contiguous()
                p = scan.interval_scan_tiles_plain(sl, 0, k, WIDTH, n, a * LANES)
                e = max(e, max_abs_err(bits[:, a: a + 64].contiguous(), p[0]))
                del p
        del bits, counts
        errs["interval_scan"] = max(errs["interval_scan"], e)
        check(errs["interval_scan"] == 0, f"interval k={k} bit-exact against its plain version "
              f"at full size" + (" (three slices of 64 rows of blocks)" if k > 64 else ""))
        torch.cuda.empty_cache()
        nbytes = tiles.numel() * 4 + k * (nblocks * 4 + 8)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms = time_ms(lambda: scan.interval_scan_tiles(tiles, 0, k, WIDTH, n), batches=5, calls=10)
        torch.cuda.empty_cache()
        fold_ms = time_ms(lambda: scan.shared_scan_bitsliced_static_tiles(
            tiles, list(range(k)), WIDTH, n), batches=5 if k <= 64 else 3, calls=10 if k <= 64
            else 2)
        torch.cuda.empty_cache()
        times[f"interval_scan k={k}"] = (ms, None, bound_ms)
        folds[f"interval_scan k={k}"] = fold_ms
        print(f"time interval_scan k={k}: {ms:.6f} ms, bound {bound_ms:.6f} ms for {nbytes} bytes "
              f"({bound_ms / ms:.4f} of it); the static fold on keys 0..{k - 1} {fold_ms:.6f} ms")
    for fragment in ("interval_scan_kernelILi9E", "shared_scan_kernelILi9E",
                     "interval_scan_kernelILi31E", "shared_scan_kernelILi31E"):
        print(f"  ptxas {ptxas_usage(fragment, spills=True)}")
    print(f"scan timing phase ran in {time.monotonic() - t0:.1f} s")
    return times, folds


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
    if sys.argv[1:] == ["--spans"]:
        span_phase(device)
        return 0
    canary_phase(device, errs)
    small_phase(device, errs)
    small_scan_edge_phase(device, errs)
    small_window_phase(device, errs)
    small_query_phase(device, errs)
    small_member_table_phase(device, errs)
    n, dev, launches = main_path_phase(device)
    arb, arb_launches = arbitrary_key_phase(device)
    launches.update({name: arb_launches[name] for name in ARBITRARY})
    cols, query_launches = query_phase(device, arb)
    launches.update({name: query_launches[name] for name in QUERY})
    encodings_phase(device, n, dev, cols)
    small_aggregate_phase(device, errs)
    small_lookup_phase(device, errs)
    agg_data, agg_launches = aggregate_phase(device, cols)
    launches.update(agg_launches)
    small_stats_phase(device, errs)
    stats_launches, stats_cols = stats_phase(device, arb, cols, agg_data["rev"])
    launches.update(stats_launches)
    zdata, zone_launches = zone_phase(device, cols)
    launches.update({name: zone_launches[name] for name in ZONED})
    span_phase(device)
    small_linear_phase(device, errs)
    launches.update(linear_phase(device, dev, arb))
    times = timing_phase(device, n, dev, arb, errs)
    canary = canary_timing_phase(device, errs)
    times["shift_canary"] = (canary["ms"], canary["plain_ms"], canary["bound_ms"])
    times.update(query_timing_phase(device, cols, arb, errs))
    times.update(aggregate_timing_phase(device, cols, agg_data, errs))
    times.update(stats_timing_phase(device, arb, agg_data["rev"], zdata, stats_cols, cols, errs))
    sharded = sharded_phase(device, dev, arb, cols, agg_data["rev"], stats_cols["h6"])
    # the linear timing phase's plain twins hold int64 words of 64 keys
    # (7.1 GiB): free the query, aggregate and zone-map data before it (and
    # before the ranks phase's child draws its own)
    del cols, agg_data, zdata, stats_cols
    torch.cuda.empty_cache()
    ranks_phase(n, sharded)
    times.update(width20_phase(device, errs))
    wide = width31_phase(device, errs)
    print(f"before the linear timing phase: {torch.cuda.memory_allocated()} bytes allocated, "
          f"{torch.cuda.memory_reserved()} reserved")
    linear_times, extras = linear_timing_phase(device, dev, arb, errs)
    times.update(linear_times)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    small_bench_phase(device, errs)
    bench_times, library = bench_timing_phase(device, arb, errs)
    times.update(bench_times)
    launches.update({k: c for k, c in cli_phase(device).items() if k in BENCH})
    print(f"bench phases ran in {time.monotonic() - t0:.1f} s")
    scan_times, folds = scan_timing_phase(device, n, dev, arb, errs)
    times.update(scan_times)
    check("jax" not in sys.modules, "no jax module was imported")

    def entry(name, src, c_entry, rep):
        # the arbitrary-key kernels report k=8 (S8) and, beside it, k=64
        # (S64); each query-path kernel its own set, the OR-tree S8 and S64;
        # each aggregate kernel its set of the aggregate phase and, beside
        # it, its times on the other keyed sets; the histogram and zoned
        # kernels their H and Z sets; the linear kernels their L set (the
        # interleave k=8), with the two-pass or library time beside it; the
        # chunked and dynamic scans S64 and, beside it, S256; memcpy its
        # 512 MiB copy with copy_ as its library time
        sets = {**AGGREGATE, **HISTOGRAM, **ZONED, **LINEAR, "memcpy": "512MiB"}
        if name in sets:
            key = f"{name} {sets[name]}"
        else:
            key = name if name in times else next(k for k in times if k.split()[0] == name)
        ms, plain_ms, bound_ms = times[key]
        e = {"name": name, "route": "cuda", "source": src, "kernel": c_entry, "replaces": rep,
             "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
             "library_ms": library.get(name)}
        if name == "windowed_scan":  # k = 8 and its W4, keys 0..7: the plane fold
            e["k"] = 64
            e["ms"], e["plain_ms"], e["bound_ms"] = times[f"{name} k=64"]
            e["ms_k8"], e["plain_ms_k8"], e["bound_ms_k8"] = times[f"{name} k=8"]
            for label in ("W4", "keys 0..7"):
                e[f"ms_{label}"], _, e[f"bound_ms_{label}"] = times[f"{name} {label}"]
            e["fold_kernel"], e["fold_source"] = WINDOW_FOLD[1], WINDOW_FOLD[0]
            ms_o, _, bound_o, _, fold_o = wide["windowed_scan w31 k=1024"]
            e.update({"ms_w31_k1024": ms_o, "bound_ms_w31_k1024": bound_o,
                      "fold_ms_w31_k1024": fold_o})
        elif name in ARBITRARY:
            e["k"] = 8
            e["ms_k64"], e["plain_ms_k64"], e["bound_ms_k64"] = times[f"{name} k=64"]
            if name == "bitsliced_scan":  # S256 of a 31-bit column, and the fold on it
                ms_o, plain_o, bound_o, kernel_o, fold_o = wide["bitsliced_scan w31 S256"]
                e.update({"ms_w31_S256": ms_o, "plain_ms_w31_S256": plain_o,
                          "bound_ms_w31_S256": bound_o, "kernel_w31_S256": kernel_o,
                          "fold_ms_w31_S256": fold_o})
        elif " " in key:
            e["set"] = key.split(" ", 1)[1]
        if name in LINEAR:
            e.update(extras[key])
            other = {"static_scan_linear": "L4", "bitsliced_scan_linear": "L4",
                     "interleave": "k=6"}.get(name)
            if other:
                e[f"ms_{other}"], e[f"plain_ms_{other}"], e[f"bound_ms_{other}"] = \
                    times[f"{name} {other}"]
                e.update({f"{k}_{other}": v for k, v in extras[f"{name} {other}"].items()})
        for label in EXTRA_SETS.get(name, ()):
            e[f"ms_{label}"], e[f"plain_ms_{label}"], e[f"bound_ms_{label}"] = \
                times[f"{name} {label}"]
        if name == "shared_scan":  # from scan._compare_fold_wins: the bit-sliced tier's launch
            e["route_kernel"], e["route_source"] = COMPARE_ROUTE[1], COMPARE_ROUTE[0]
            e["route_rule"] = "shared_simd_scan_tpu_torch/ops/scan.py _compare_fold_wins"
            e["fold_ms"] = folds["shared_scan k=1"]
            for label in COMPARE_TIMED:
                e[f"fold_ms_{label}"] = folds[f"shared_scan {label}"]
        if name == "interval_scan":  # k = 8 and beside it k = 64 and 1024, and the static fold
            e["k"] = K
            e["fold_ms"] = times["windowed_scan keys 0..7"][0]
            for k in INTERVAL_TIMED:
                e[f"ms_k{k}"], _, e[f"bound_ms_k{k}"] = times[f"interval_scan k={k}"]
                e[f"fold_ms_k{k}"] = folds[f"interval_scan k={k}"]
        if name == "member_ortree":
            e["ms_s64"], e["plain_ms_s64"], e["bound_ms_s64"] = times["member_ortree S64"]
        if name in WIDTH20:
            e["ms_w20_s64"], e["plain_ms_w20_s64"], e["bound_ms_w20_s64"] = \
                times[f"{name} w20 S64"]
        if name == "shift_canary":  # the verdict; beside it the elementwise canary
            e.update({k: v for k, v in canary.items() if k not in ("ms", "plain_ms", "bound_ms")})
            e["elementwise_kernel"], e["elementwise_source"] = (CANARY_ELEMENTWISE[1],
                                                                CANARY_ELEMENTWISE[0])
            e["library_call"] = "torch.bitwise_left_shift"
        if name == "zoned_range_scan":  # Z3's count form, device time and wall time
            e["ms_counts"], e["plain_ms_counts"], e["bound_ms_counts"] = \
                times["zoned_range_scan Z3 counts"]
            e["device_ms"], e["device_ms_kernel"], _ = times["zoned_range_scan Z3 device"]
            e["wall_ms_zoned_eq_scan"] = times["zoned_range_scan Z3 wall"][0]
        if name == "histogram_dag":  # H8 runs the fold's counts form
            e["fold_kernel"], e["fold_source"] = FOLD_KERNEL[1], FOLD_KERNEL[0]
        if name in AGGREGATE or name == "histogram_dag":
            for other, (ms_o, plain_o, bound_o) in times.items():
                kernel, _, label = other.partition(" ")
                if kernel == name and other != key:
                    e[f"ms_{label}"], e[f"plain_ms_{label}"], e[f"bound_ms_{label}"] = \
                        ms_o, plain_o, bound_o
        return e

    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [entry(name, *spec) for name, spec in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
