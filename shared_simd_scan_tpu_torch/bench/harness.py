"""Benchmark drivers: data synthesis, chained timing drivers, verification.

PyTorch counterpart of ``shared_simd_scan_tpu/bench/harness.py``, the
counterpart of the reference benchmark harness:

- the result printer ``* name: avg ms; [..] ms`` (src/benchmark.cpp:14-36),
  line for line the JAX package's, so ``scripts/prepare_shared_scan_results.py``
  parses both;
- the corpora (:func:`synth_ramp`, :func:`synth_mod5`, :func:`synth_modk`,
  :func:`synth_modk_packed_sliced`);
- one ``chain_*`` driver per JAX driver that reaches a ported kernel:
  ``chain(*args, k)`` makes k launches and returns a device scalar that
  reads the last call's outputs (every key's count, or one word of every
  row).  CUDA runs every launch it is given, so no salt varies the inputs;
- the verifiers run after timing (src/benchmark.cpp:38-140), which hold
  the kernels against the plain torch versions where the JAX package holds
  its Pallas kernels against its XLA tier;
- the ``bench_*`` runners behind ``python -m shared_simd_scan_tpu_torch.bench``.

Every ``bench_*`` runs on ``device`` (default: the card).  The JAX
package's tile-size sweeps collapse to one row per kernel, and its "xla
fused" rows become "torch plain" rows: the plain twins, named as such.
The scaling driver waits for ``parallel.dist`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from shared_simd_scan_tpu_torch import bitvector, layout
from shared_simd_scan_tpu_torch.bench.timing import Measurement, measure_loop, timer_resolution_ns
from shared_simd_scan_tpu_torch.layout import BLOCK_VALUES, LANES, bitvector_words, packed_nbytes
from shared_simd_scan_tpu_torch.ops import _cuda, oracle
from shared_simd_scan_tpu_torch.ops import aggregate as agg_ops
from shared_simd_scan_tpu_torch.ops import conj as conj_ops
from shared_simd_scan_tpu_torch.ops import linear as linear_ops
from shared_simd_scan_tpu_torch.ops import member as member_ops
from shared_simd_scan_tpu_torch.ops import scan as scan_ops
from shared_simd_scan_tpu_torch.ops import unpack as unpack_ops

# Default workload: 500 MiB packed payload, shared scan at 1/8 of that (the
# reference defaults, src/benchmark.hpp:4-5, src/main.cpp:98).
DEFAULT_DATA_SIZE = 500 * 1024 * 1024
DEFAULT_REPETITIONS = 5
DEFAULT_WIDTH = 9

# Data-sheet device-memory rate (bytes/s) by the card's name as
# torch.cuda.get_device_name gives it, lower case, without "nvidia ".
_HBM_PEAK = {
    "h100 80gb hbm3": 3.35e12,  # H100 SXM5
    "h100 pcie": 2.0e12,
    "h100 nvl": 3.9e12,
    "h200": 4.8e12,
    "a100-sxm4-80gb": 2.039e12,
    "a100-sxm4-40gb": 1.555e12,
    "a100 80gb pcie": 1.935e12,
    "a100-pcie-40gb": 1.555e12,
}


def hbm_peak_bytes_per_s(name: str | None = None) -> float | None:
    """The data-sheet device-memory rate of the card called ``name``
    (default: card 0), or None for a card the table does not hold."""
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    key = name.strip().lower().removeprefix("nvidia ")
    return _HBM_PEAK.get(key)


def _roof(device: torch.device) -> float | None:
    """The roofline of a run on ``device``: none for the CPU."""
    return hbm_peak_bytes_per_s() if device.type == "cuda" else None


# ---------------------------------------------------------------------------
# Result printer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BenchResult:
    name: str
    meas: Measurement
    bytes_moved: int  # device-memory traffic per launch (read + write)

    @property
    def bytes_per_s(self) -> float:
        return self.bytes_moved / self.meas.seconds


def print_result(res: BenchResult, roofline: float | None = None) -> None:
    """Stable machine-parsable line format, the JAX package's and the
    reference's (src/benchmark.cpp:14-36), so the sweep scripts parse all
    three."""
    reps = ", ".join(f"{t * 1e3:.6f}" for t in res.meas.per_trial)
    print(f"* {res.name}: {res.meas.millis:.6f} ms; [{reps}] ms")
    gbs = res.bytes_per_s / 1e9
    if roofline:
        pct = 100.0 * res.bytes_per_s / roofline
        print(f"    {gbs:.1f} GB/s ({pct:.1f}% of {roofline / 1e9:.0f} GB/s HBM roofline)")
    else:
        print(f"    {gbs:.1f} GB/s")


# ---------------------------------------------------------------------------
# Data synthesis (reference corpora, src/benchmark.cpp:79-82, 170-174, 274-278)
# ---------------------------------------------------------------------------

# Values made per slice: a column past 2^31 values never holds more than
# this many int64 indices at once (a one-shot arange of 4.2e9 is 33.5 GB).
_SYNTH_SLICE = 1 << 26


def _synth(n: int, fn, device) -> torch.Tensor:
    """int32[n] holding fn(i) for i = 0..n-1 (each below 2^31), on
    ``device`` (default: the card), made from int64 indices in slices."""
    device = layout.resolve_device(device)
    out = torch.empty(n, dtype=torch.int32, device=device)
    for s in range(0, n, _SYNTH_SLICE):
        i = torch.arange(s, min(n, s + _SYNTH_SLICE), dtype=torch.int64, device=device)
        out[s : s + i.shape[0]] = fn(i)
    return out


def synth_ramp(n: int, width: int, *, device=None) -> torch.Tensor:
    """Decompression corpus ``i & (2^width - 1)`` (benchmark.cpp:79-82)."""
    return _synth(n, lambda i: i & ((1 << width) - 1), device)


def synth_mod5(n: int, *, device=None) -> torch.Tensor:
    """Scan corpus ``i % 5``, predicate key 3 (benchmark.cpp:150, 174)."""
    return _synth(n, lambda i: i % 5, device)


def synth_modk(n: int, k: int, width: int, *, device=None) -> torch.Tensor:
    """Shared-scan corpus ``i % k % min(512, 2^width)`` as int32[n]
    (benchmark.cpp:277 uses ``i % k % 512``)."""
    m = min(512, 1 << width)
    return _synth(n, lambda i: i % k % m, device)


def values_for(data_size: int, width: int) -> int:
    """Value count whose packed payload is ~data_size bytes."""
    return max((data_size * 8) // width, layout.BLOCK_VALUES)


def synth_modk_packed_sliced(n: int, k: int, width: int, nslices: int = 8, *,
                             device=None) -> layout.DeviceColumn:
    """synth_modk(n, k, width) packed into a DeviceColumn in slices of block
    rows (at least 512), so no more than one slice's values exist at once:
    narrow widths at hundreds of MiB packed mean n past 2^31 values."""
    device = layout.resolve_device(device)
    b1 = layout.padded_blocks(n) // LANES
    per_slice = -(-b1 // nslices)
    s1 = max(512, -(-per_slice // 512) * 512)  # a multiple of 512 rows
    m = min(512, 1 << width)
    per_row = LANES * BLOCK_VALUES
    tiles = torch.empty((width, b1, LANES), dtype=torch.int32, device=device)
    for r0 in range(0, b1, s1):
        rows = min(s1, b1 - r0)
        i = torch.arange(r0 * per_row, (r0 + rows) * per_row, dtype=torch.int64, device=device)
        v = torch.where(i < n, i % k % m, 0).to(torch.int32)
        tiles[:, r0 : r0 + rows] = unpack_ops.pack_tiles(unpack_ops.flat_to_values(v, rows), width)
    return layout.DeviceColumn(width=width, n=n, tiles=tiles)


# ---------------------------------------------------------------------------
# The bandwidth yardstick: kernel 29
# ---------------------------------------------------------------------------


def memcpy_plain(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain torch version of :func:`memcpy`."""
    return dst.copy_(src)


def memcpy(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Copy every byte of ``src`` into ``dst`` (contiguous, the same dtype
    and size, one device, not overlapping) and return ``dst``.

    Kernel ``sss_copy`` (``csrc/copy.cu``) on CUDA tensors, which must start
    at 16-byte aligned addresses (a misaligned one raises); the plain
    version on CPU tensors."""
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(f"memcpy: {src.dtype}{tuple(src.shape)} into "
                         f"{dst.dtype}{tuple(dst.shape)}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("memcpy: expected contiguous tensors")
    nbytes = src.numel() * src.element_size()
    a, b = src.data_ptr(), dst.data_ptr()
    if nbytes and a < b + nbytes and b < a + nbytes:
        raise ValueError("memcpy: source and destination overlap")
    device = _cuda.kernel_device(src, dst)
    if device is None:
        return memcpy_plain(src, dst)
    if a % 16 or b % 16:
        raise ValueError(f"memcpy: the kernel needs 16-byte aligned tensors, got addresses "
                         f"{a:#x} and {b:#x}")
    _cuda.launch("sss_copy", device, a, b, nbytes)
    memcpy.launches += 1
    return dst


memcpy.launches = 0


# ---------------------------------------------------------------------------
# Chained timing drivers: chain(*args, k) makes k launches
# ---------------------------------------------------------------------------


def _last(k: int, call):
    """Call ``call()`` k times back to back; the last call's result."""
    for _ in range(k):
        out = call()
    return out


def chain_copy(x: torch.Tensor, k: int) -> torch.Tensor:
    """Library bandwidth comparator: k in-place ``add_(1)`` over the whole
    buffer (PyTorch's elementwise kernel, as the JAX rows are XLA's)."""
    for _ in range(k):
        x.add_(1)
    return x[0].to(torch.int64) + x[-1]


def chain_memcpy(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """Explicit-copy comparator (benchmark_misc.cpp:36-52's memcpy row):
    k :func:`memcpy` launches, back and forth between two equal buffers,
    so each reads and writes every byte (the JAX row's in-place alias)."""
    for i in range(k):
        dst = memcpy(x, y) if i % 2 == 0 else memcpy(y, x)
    return dst[0].to(torch.int64) + dst[-1]


def chain_library_copy(x: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """``copy_``, PyTorch's copy, in the pattern of :func:`chain_memcpy`."""
    for i in range(k):
        dst = y.copy_(x) if i % 2 == 0 else x.copy_(y)
    return dst[0].to(torch.int64) + dst[-1]


def chain_unpack(tiles, k, *, width):
    vals = _last(k, lambda: unpack_ops.unpack_tiles(tiles, width))
    return vals[:, 0, 0].sum()


def chain_pack(vals, k, *, width):
    tiles = _last(k, lambda: unpack_ops.pack_tiles(vals, width))
    return tiles[:, 0, 0].sum()


def chain_shared_scan(tiles, keys, k, *, width, n):
    _, counts = _last(k, lambda: scan_ops.shared_scan_tiles(tiles, keys, width, n))
    return counts.sum()


def chain_sequential_shared_scan(tiles, keys, k, *, width, n):
    """The measured sequential shared-scan baseline: one single-key pass
    of the compare kernel per key per iteration (the timed analog of
    shared_scan_128_sequential, src/simd_scan_shared.cpp:9-23)."""
    def passes():
        return torch.cat([scan_ops.shared_scan_tiles(tiles, keys[j : j + 1], width, n)[1]
                          for j in range(keys.shape[0])])

    return _last(k, passes).sum()


def chain_chunked_shared_scan(tiles, keys, k, *, width, n):
    _, counts = _last(k, lambda: scan_ops.shared_scan_chunked_tiles(tiles, keys, width, n))
    return counts.sum()


def chain_dynamic_shared_scan(tiles, keys, k, *, width, n):
    _, counts = _last(k, lambda: scan_ops.shared_scan_dynamic_tiles(tiles, keys, width, n))
    return counts.sum()


def chain_bitsliced_shared_scan(tiles, keys, k, *, width, n):
    _, counts = _last(k, lambda: scan_ops.shared_scan_bitsliced_tiles(tiles, keys, width, n))
    return counts.sum()


def chain_bitsliced_static_shared_scan(tiles, k, *, width, n, keys_tuple):
    _, counts = _last(k, lambda: scan_ops.shared_scan_bitsliced_static_tiles(
        tiles, keys_tuple, width, n))
    return counts.sum()


def chain_windowed_shared_scan(tiles, k, *, width, n, keys_tuple):
    _, counts = _last(k, lambda: scan_ops.windowed_scan_tiles(tiles, keys_tuple, width, n))
    return counts.sum()


def chain_interval_scan(tiles, k, *, width, n, kk):
    _, counts = _last(k, lambda: scan_ops.interval_scan_tiles(tiles, 0, kk, width, n))
    return counts.sum()


def chain_conj_range_scan(tiles, lows, highs, k, *, widths, n):
    """Fused multi-column conjunction (ops/conj.py)."""
    _, count = _last(k, lambda: conj_ops.conj_range_scan_tiles(tiles, lows, highs, widths, n))
    return count


def chain_linear_shared_scan(tiles, k, *, width, n, kk, relayout="dispatch"):
    """Linear (interleaved byte) shared scan of keys 0..kk-1, given as a
    tensor on the tiles' device (runtime keys on the card).  ``relayout``:
    "fused" (the fused interval kernel), "dispatch" (the uint8 entry point),
    "words" (the words entry point), "twokernel" (the bits-form scan, then
    the interleave kernel)."""
    keys = torch.arange(kk, dtype=torch.int32, device=tiles.device)
    dev = layout.DeviceColumn(width=width, n=n, tiles=tiles)
    if relayout == "fused":
        if linear_ops._mxu_supported(kk):
            fn = scan_ops.interval_scan_linear_words_tiles
        elif linear_ops._mxu_large_supported(kk):
            fn = scan_ops.interval_scan_linear_words_large
        else:
            raise ValueError(f"relayout='fused' needs k in 4/8/12/16, k % 8 == 0 in 24..128, or "
                             f"k % 4 == 0 in 20..64, got {kk}")
        out, counts = _last(k, lambda: fn(tiles, 0, kk, width, n))
        return out[-1].to(torch.int64) + counts.sum()
    if relayout == "words":
        call = functools.partial(scan_ops.shared_scan_linear_words_device, dev, keys)
    elif relayout == "twokernel":
        def call():
            bits, _ = scan_ops.shared_scan_device(dev, keys)
            return linear_ops.interleave_device(bits, (n + 7) // 8)
    elif relayout == "dispatch":
        call = functools.partial(scan_ops.shared_scan_linear_device, dev, keys)
    else:
        raise ValueError(f"unknown relayout {relayout!r}")
    return _last(k, call)[-1].to(torch.int64)


def chain_static_linear_shared_scan(tiles, k, *, width, n, keys_tuple):
    """Fused static-DAG linear export of arbitrary host keys."""
    kk = len(keys_tuple)
    if linear_ops._mxu_supported(kk):
        fn = scan_ops.static_scan_linear_words_tiles
    elif linear_ops._mxu_large_supported(kk):
        fn = scan_ops.static_scan_linear_words_large
    else:
        raise ValueError(f"fused static linear needs k in 4/8/12/16, k % 8 == 0 in 24..128, or "
                         f"k % 4 == 0 in 20..64, got {kk}")
    out, counts = _last(k, lambda: fn(tiles, keys_tuple, width, n))
    return out[-1].to(torch.int64) + counts.sum()


def chain_linear_baseline_shared_scan(tiles, k, *, width, n, kk):
    """Comparator for :func:`chain_linear_shared_scan`: the same keys
    through ``shared_scan_device``, the native (k, W) layout; the delta
    between the two rows is the interleave."""
    keys = torch.arange(kk, dtype=torch.int32, device=tiles.device)
    dev = layout.DeviceColumn(width=width, n=n, tiles=tiles)
    bits, _ = _last(k, lambda: scan_ops.shared_scan_device(dev, keys))
    return bits[:, -1].to(torch.int64).sum()


def chain_member_scan(tiles, k, *, width, n, keys_tuple):
    """IN-list membership of host keys (so every host tier dispatches)."""
    _, count = _last(k, lambda: member_ops.member_scan_tiles(tiles, keys_tuple, width, n))
    return count


def chain_aggregate_scan(ptiles, mtiles, k, *, wp, wm, n, kk):
    """Fused filter+aggregate: per-key SUM/COUNT of keys 0..kk-1 through
    the compare kernel."""
    keys = torch.arange(kk, dtype=torch.int32, device=ptiles.device)
    counts, sums = _last(k, lambda: agg_ops.aggregate_scan_tiles(ptiles, mtiles, keys, wp, wm, n))
    return counts.sum() + sums.sum()


def chain_aggregate_bitplane(ptiles, mtiles, k, *, wp, wm, n, kk):
    """Bit-plane aggregate of keys 0..kk-1 as runtime keys."""
    keys = torch.arange(kk, dtype=torch.int32, device=ptiles.device)
    counts, sums = _last(k, lambda: agg_ops.aggregate_bitplane_tiles(
        ptiles, mtiles, keys, wp, wm, n))
    return counts.sum() + sums.sum()


def chain_aggregate_bitplane_static(ptiles, mtiles, k, *, wp, wm, n, keys_tuple):
    """Static (AND-DAG) bit-plane aggregate of host keys."""
    counts, sums = _last(k, lambda: agg_ops.aggregate_bitplane_static_tiles(
        ptiles, mtiles, keys_tuple, wp, wm, n))
    return counts.sum() + sums.sum()


def chain_histogram(tiles, k, *, width, n, kk):
    """Counts-only histogram of kk keys from lo = 0, lo a tensor on the
    tiles' device (the runtime-lo bins kernel)."""
    lo = torch.zeros(1, dtype=torch.int32, device=tiles.device)
    return _last(k, lambda: scan_ops.histogram_tiles(tiles, lo, kk, width, n)).sum()


def chain_histogram_dag(tiles, k, *, width, n, kk, sp=None):
    """Shared-AND-DAG histogram (the host-lo dispatch path); ``sp`` forces
    the single-pass span program (True) or the chunked programs (False)."""
    return _last(k, lambda: scan_ops.histogram_dag_tiles(
        tiles, 0, kk, width, n, single_pass=sp)).sum()


def chain_plain_shared_scan(tiles, keys, k, *, width, n):
    """The plain compare version (the JAX package's XLA row), 32 keys at a
    time so its int64 words stay bounded at large k."""
    def call():
        return torch.cat([scan_ops.shared_scan_tiles_plain(tiles, keys[j0 : j0 + 32], width, n)[1]
                          for j0 in range(0, keys.shape[0], 32)])

    return _last(k, call).sum()


def chain_plain_unpack(tiles, k, *, width):
    vals = _last(k, lambda: unpack_ops.unpack_tiles_plain(tiles, width))
    return vals[:, 0, 0].sum()


def chain_oracle_shared_scan(words, keys, k, *, width, n):
    _, counts = _last(k, lambda: oracle.shared_scan_words(words, keys, width, n))
    return counts.sum()


def chain_oracle_unpack(words, k, *, width, n):
    return _last(k, lambda: oracle.unpack_words(words, width, n))[0]


# ---------------------------------------------------------------------------
# Verifiers (src/benchmark.cpp:38-140), run after timing
# ---------------------------------------------------------------------------


def check_decompression(dev: layout.DeviceColumn, expect: torch.Tensor) -> bool:
    got = unpack_ops.unpack_device(dev)
    ok = torch.equal(got, expect)
    if not ok:
        idx = int((got != expect).nonzero()[0, 0])
        print(f"    VERIFY FAILED: first mismatch at index {idx}")
    return ok


def check_member_scan(dev: layout.DeviceColumn, keys, vals: torch.Tensor) -> bool:
    """Membership: the count against a direct compare of ``vals``, the
    bitvector against the OR of the plain compare version's rows (32 keys
    at a time)."""
    kt = scan_ops._key_tensor(keys, dev.tiles.device)
    bits, count = member_ops.member_scan_tiles(dev.tiles, scan_ops._host_keys(keys), dev.width,
                                               dev.n)
    ok = int(count) == int(torch.isin(vals, kt).sum())
    if ok:
        row = torch.zeros_like(bits)
        for j0 in range(0, kt.shape[0], 32):
            pbits, _ = scan_ops.shared_scan_tiles_plain(dev.tiles, kt[j0 : j0 + 32], dev.width,
                                                        dev.n)
            row = functools.reduce(torch.bitwise_or, pbits, row)
        ok = torch.equal(bits, row)
    if not ok:
        print("    VERIFY FAILED: member scan mismatch")
    return ok


def check_shared_scan(dev: layout.DeviceColumn, keys, vals: torch.Tensor) -> bool:
    """Three-way verification of :func:`shared_scan_device` over the full
    column: counts against a direct compare of ``vals``; every bitvector
    word against the plain compare version (32 keys at a time); and the
    bitvectors of a 2M-value prefix against the gather oracle.  ``keys``
    go to the dispatcher as given (a CUDA tensor as runtime keys); the
    checks read them on the host."""
    bits, counts = scan_ops.shared_scan_device(dev, keys)
    keys = scan_ops._host_keys(keys)
    expect = torch.stack([(vals == int(key)).sum() for key in keys.view("int32")])
    ok = bool((counts.cpu() == expect.cpu()).all())
    for j0 in range(0, keys.shape[0], 32):
        if not ok:
            break
        kt = torch.from_numpy(keys[j0 : j0 + 32].view("int32").copy()).to(dev.tiles.device)
        pbits, pcounts = scan_ops.shared_scan_tiles_plain(dev.tiles, kt, dev.width, dev.n)
        ok = bool((bits[j0 : j0 + 32] == scan_ops.bits_to_canonical(pbits, dev.n)).all())
        ok = ok and bool((counts[j0 : j0 + 32] == pcounts).all())
    if ok:
        n_chk = min(dev.n, 2_000_000)
        w_chk = layout.bitvector_words(n_chk)
        col_chk = layout.pack(vals[:n_chk], dev.width)
        obits, _ = oracle.shared_scan_words(col_chk.words, keys, dev.width, n_chk)
        gbits = bits[:, :w_chk].clone()
        if n_chk % 32:
            gbits[:, -1] &= (1 << (n_chk % 32)) - 1
        ok = bool((gbits == obits).all())
    if not ok:
        print("    VERIFY FAILED: shared scan mismatch")
    return ok


def check_linear_scan(dev: layout.DeviceColumn, k: int) -> bool:
    """Bytes of the linear (interleaved) output of keys 0..k-1 against
    numpy packbits on an 8K-value prefix (only the prefix's block rows
    are unpacked)."""
    keys = np.arange(k, dtype=np.uint32)
    nv = min(dev.n, 8 * 1024)
    pre = layout.DeviceColumn(width=dev.width, n=nv, tiles=dev.tiles[:, :8, :].contiguous())
    vhost = unpack_ops.unpack_device(pre).cpu().numpy().view(np.uint32)
    exp = np.zeros(((nv + 7) // 8) * k, np.uint8)
    for j, key in enumerate(keys):
        exp[j::k] = np.packbits(vhost == key, bitorder="little")
    got = scan_ops.shared_scan_linear_device(dev, keys)[: exp.size]
    return bool((got.cpu().numpy() == exp).all())


# ---------------------------------------------------------------------------
# Benchmark drivers
# ---------------------------------------------------------------------------


def _bench_variants(variants, roof, verify, reps=DEFAULT_REPETITIONS):
    """Time and print each (name, chain, args, static kwargs, bytes) row,
    then print the verification's verdict."""
    results = []
    for name, chain, args, static, traffic in variants:
        meas = measure_loop(functools.partial(chain, **static), args, trials=max(2, reps))
        res = BenchResult(name, meas, traffic)
        print_result(res, roof)
        results.append(res)
    if verify is not None:
        print("    verification:", "ok" if verify() else "FAILED")
    return results


# The oracle gathers per value (words[i*width//32]), far slower than the
# kernels, like the reference's scalar ``*_unvectorized`` baselines; it is
# benchmarked on a capped slice.
ORACLE_CAP = 8 * 1024 * 1024


def bench_memory(data_size: int = DEFAULT_DATA_SIZE, reps: int = DEFAULT_REPETITIONS, *,
                 device=None):
    """Raw copy bandwidth at 1/2/4/8-byte granularity, the memcpy kernel and
    PyTorch's ``copy_`` — the reference's comparator rows
    (benchmark_misc.cpp:9-52) plus the library copy."""
    device = layout.resolve_device(device)
    print(f"host timer resolution: ~{timer_resolution_ns():.0f} ns "
          "(device kernels are timed with CUDA events, not this clock)")
    roof = _roof(device)
    results = []
    for dtype, label in ((torch.uint8, "1 byte"), (torch.int16, "2 bytes"),
                         (torch.int32, "4 bytes"), (torch.int64, "8 bytes")):
        x = torch.zeros(data_size // dtype.itemsize, dtype=dtype, device=device)
        results += _bench_variants([(f"memory copy ({label} at a time)", chain_copy, (x,), {},
                                     2 * x.numel() * dtype.itemsize)], roof, None, reps)
        del x
    x = torch.zeros(data_size // 4, dtype=torch.int32, device=device)
    y = torch.empty_like(x)
    traffic = 2 * x.numel() * 4
    results += _bench_variants([
        ("memory copy (memcpy)", chain_memcpy, (x, y), {}, traffic),
        ("memory copy (torch copy_)", chain_library_copy, (x, y), {}, traffic),
    ], roof, None, reps)
    return results


def bench_decompression(
    data_size: int = DEFAULT_DATA_SIZE,
    reps: int = DEFAULT_REPETITIONS,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Unpack (src/benchmark.cpp:51-108): the kernel, its plain version and
    the oracle (the analog of the reference's ``decompress_unvectorized``)."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    vals = synth_ramp(n, width, device=device)
    dev = unpack_ops.pack_device_kernel(vals, width)
    traffic = packed_nbytes(width, n) + 4 * n
    n_o = values_for(min(data_size, ORACLE_CAP), width)
    col_o = layout.pack(synth_ramp(n_o, width, device=device), width)
    variants = [
        ("cuda unpack", chain_unpack, (dev.tiles,), dict(width=width), traffic),
        ("torch plain unpack", chain_plain_unpack, (dev.tiles,), dict(width=width), traffic),
        (f"torch oracle unpack ({n_o} values)", chain_oracle_unpack, (col_o.words,),
         dict(width=width, n=n_o), packed_nbytes(width, n_o) + 4 * n_o),
    ]
    return _bench_variants(variants, _roof(device), lambda: check_decompression(dev, vals), reps)


def bench_scan(
    data_size: int = DEFAULT_DATA_SIZE,
    reps: int = DEFAULT_REPETITIONS,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Single-predicate scan (src/benchmark.cpp:142-194): corpus i % 5,
    key 3."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    vals = synth_mod5(n, device=device)
    dev = unpack_ops.pack_device_kernel(vals, width)
    keys = torch.tensor([3], dtype=torch.int32, device=device)
    traffic = packed_nbytes(width, n) + bitvector_words(n) * 4
    n_o = values_for(min(data_size, ORACLE_CAP), width)
    col_o = layout.pack(synth_mod5(n_o, device=device), width)
    variants = [
        ("cuda scan", chain_shared_scan, (dev.tiles, keys), dict(width=width, n=n), traffic),
        (f"torch oracle scan ({n_o} values)", chain_oracle_shared_scan, (col_o.words, [3]),
         dict(width=width, n=n_o), packed_nbytes(width, n_o) + bitvector_words(n_o) * 4),
    ]
    return _bench_variants(variants, _roof(device), lambda: check_shared_scan(dev, keys, vals),
                           reps)


def bench_shared_scan(
    data_size: int = DEFAULT_DATA_SIZE // 8,
    reps: int = DEFAULT_REPETITIONS,
    k: int = 8,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Shared scan, k predicates in one pass (src/benchmark.cpp:196-306):
    corpus i % k % 512, predicates 0..k-1.  The compare kernel up to k = 32;
    the chunked and dynamic compares above, as the JAX package benches
    them; then the bit-sliced, interval, sequential, member, plain and
    oracle rows."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    vals = synth_modk(n, k, width, device=device)
    dev = unpack_ops.pack_device_kernel(vals, width)
    keys = torch.arange(k, dtype=torch.int32, device=device)
    scan_args, scan_kw = (dev.tiles, keys), dict(width=width, n=n)
    bits_bytes = bitvector_words(n) * 4
    traffic = packed_nbytes(width, n) + k * bits_bytes
    if k <= 32:
        variants = [(f"cuda shared scan k={k}", chain_shared_scan, scan_args, scan_kw, traffic)]
    else:
        variants = [
            (f"cuda chunked shared scan k={k}", chain_chunked_shared_scan, scan_args, scan_kw,
             traffic),
            (f"cuda dynamic shared scan k={k}", chain_dynamic_shared_scan, scan_args, scan_kw,
             traffic),
        ]
    variants.append((f"cuda bit-sliced shared scan k={k} (spread/runtime-keys tier)",
                     chain_bitsliced_shared_scan, scan_args, scan_kw, traffic))
    if k <= scan_ops.MAX_INTERVAL_KEYS:
        variants.append((f"cuda interval scan k={k} (keys 0..k-1)", chain_interval_scan,
                         (dev.tiles,), dict(width=width, n=n, kk=k), traffic))
    # the measured sequential baseline (src/benchmark.cpp:288-296): k single-key passes
    variants.append((f"sequential shared scan k={k} ({k} single passes)",
                     chain_sequential_shared_scan, scan_args, scan_kw,
                     k * (packed_nbytes(width, n) + bits_bytes)))
    # IN-list membership of the same keys: one fused bitvector
    variants.append((f"cuda IN-list member scan k={k} (one bitvector)", chain_member_scan,
                     (dev.tiles,), dict(width=width, n=n, keys_tuple=tuple(range(k))),
                     packed_nbytes(width, n) + bits_bytes))
    variants.append((f"torch plain shared scan k={k}", chain_plain_shared_scan, scan_args, scan_kw,
                     traffic))
    n_o = values_for(min(data_size, ORACLE_CAP), width)
    col_o = layout.pack(synth_modk(n_o, k, width, device=device), width)
    variants.append((f"torch oracle shared scan k={k} ({n_o} values)", chain_oracle_shared_scan,
                     (col_o.words, list(range(k))), dict(width=width, n=n_o),
                     packed_nbytes(width, n_o) + k * bitvector_words(n_o) * 4))
    return _bench_variants(
        variants, _roof(device),
        lambda: check_shared_scan(dev, keys, vals) and check_member_scan(dev, keys, vals), reps)


def bench_linear(
    data_size: int = DEFAULT_DATA_SIZE // 8,
    reps: int = DEFAULT_REPETITIONS,
    k: int = 8,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Linear (interleaved byte) shared scan (simd_scan_shared_linear.cpp:
    9-82): the fused interval kernel where its k allows, the runtime-key
    dispatch (uint8 view), and the same keys through the bits form, whose
    delta to the dispatch row is the export's cost."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    dev = unpack_ops.pack_device_kernel(synth_modk(n, k, width, device=device), width)
    traffic = packed_nbytes(width, n) + k * bitvector_words(n) * 4
    kw = dict(width=width, n=n, kk=k)
    variants = [(f"cuda fused linear shared scan k={k} (interval keys)", chain_linear_shared_scan,
                 (dev.tiles,), dict(kw, relayout="fused"), traffic)
                ] if linear_ops._mxu_supported(k) else []
    variants += [
        (f"cuda linear shared scan k={k} (runtime-keys dispatch, u8 view)",
         chain_linear_shared_scan, (dev.tiles,), kw, traffic),
        (f"native (k, W) comparator k={k} (same keys, bits form)",
         chain_linear_baseline_shared_scan, (dev.tiles,), kw, traffic),
    ]
    return _bench_variants(variants, _roof(device), lambda: check_linear_scan(dev, k), reps)


def bench_aggregate(
    data_size: int = DEFAULT_DATA_SIZE // 8,
    reps: int = DEFAULT_REPETITIONS,
    k: int = 8,
    width: int = DEFAULT_WIDTH,
    measure_width: int = 16,
    *,
    device=None,
):
    """Fused filter+aggregate: per-key SUM/COUNT over a measure column, one
    pass over two packed columns."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    pv = synth_modk(n, k, width, device=device)
    pdev = unpack_ops.pack_device_kernel(pv, width)
    mask = (1 << measure_width) - 1
    # (i * 2654435761) mod 2^wm, the JAX corpus, without an int64 overflow
    mv = _synth(n, lambda i: ((i & mask) * (2654435761 & mask)) & mask, device)
    mdev = unpack_ops.pack_device_kernel(mv, measure_width)
    traffic = packed_nbytes(width, n) + packed_nbytes(measure_width, n)
    res = _bench_variants(
        [(f"cuda aggregate scan k={k} (SUM+COUNT, wm={measure_width})", chain_aggregate_scan,
          (pdev.tiles, mdev.tiles), dict(wp=width, wm=measure_width, n=n, kk=k), traffic)],
        _roof(device), None, reps)
    sums, counts = agg_ops.aggregate_scan_device(pdev, mdev, np.arange(k, dtype=np.uint32))
    ok = all(int(counts[j]) == int((pv == j).sum()) for j in range(k))
    ok = ok and all(int(sums[j]) == int(mv[pv == j].to(torch.int64).sum())
                    for j in range(min(k, 4)))
    print("    verification:", "ok" if ok else "FAILED")
    return res


def bench_histogram(
    data_size: int = DEFAULT_DATA_SIZE // 8,
    reps: int = DEFAULT_REPETITIONS,
    k: int | None = None,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Counts-only value histogram, no bitvector output: the host-lo
    AND-DAG dispatch path and the runtime-lo bins kernel.  Default k = the
    full domain (2^width, capped at 4096).  Bytes: the packed column read
    once per pass (one per static group for the chunked programs) and k
    int64 counts."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    vals = synth_ramp(n, width, device=device)  # uniform coverage of the whole domain
    dev = unpack_ops.pack_device_kernel(vals, width)
    if k is None:
        k = min(1 << width, scan_ops.MAX_HISTOGRAM_KEYS)
    passes = scan_ops.histogram_dag_passes(k)
    kw = dict(width=width, n=n, kk=k)
    res = _bench_variants([
        (f"cuda histogram k={k} (shared AND-DAG, dispatch path)", chain_histogram_dag,
         (dev.tiles,), kw, passes * packed_nbytes(width, n) + 8 * k),
        (f"cuda histogram k={k} (bins kernel, runtime-lo tier)", chain_histogram, (dev.tiles,),
         kw, packed_nbytes(width, n) + 4 + 8 * k),
    ], _roof(device), None, reps)
    counts = scan_ops.histogram_device(dev, k=k)
    expect = torch.bincount(vals.to(torch.int64), minlength=1 << width)[:k]
    ok = torch.equal(counts, expect)
    print("    verification:", "ok" if ok else "FAILED")
    return res


def bench_member(
    data_size: int = DEFAULT_DATA_SIZE // 8,
    reps: int = DEFAULT_REPETITIONS,
    k: int = 8,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """IN-list membership: one fused bitvector per key set, three key shapes
    for the dispatch tiers: consecutive (range tier), clusters of 8
    (window), spread (compare, OR-tree or bit-sliced by cost)."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    vals = synth_modk(n, k, width, device=device)
    dev = unpack_ops.pack_device_kernel(vals, width)
    traffic = packed_nbytes(width, n) + bitvector_words(n) * 4
    dom = 1 << width
    shapes = [("consecutive", tuple(i % dom for i in range(k)))]
    if k >= 4:
        # at least 2 clusters, so the shape is not a consecutive run
        csize = max(2, min(8, k // 2))
        nclust = (k + csize - 1) // csize
        stride = max(32, dom // nclust)
        shapes.append(("clustered", tuple((c * stride + j) % dom for c in range(nclust)
                                          for j in range(csize))[:k]))
    shapes.append(("spread", tuple(int(x) for x in (np.arange(k) * 61 + 3) % dom)))
    variants = [(f"cuda member scan k={k} ({name} keys)", chain_member_scan, (dev.tiles,),
                 dict(width=width, n=n, keys_tuple=keys), traffic) for name, keys in shapes]
    return _bench_variants(
        variants, _roof(device),
        lambda: all(check_member_scan(dev, keys, vals) for _, keys in shapes), reps)


def bench_conj(
    data_size: int = DEFAULT_DATA_SIZE // 8,
    reps: int = DEFAULT_REPETITIONS,
    m: int = 2,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Multi-column conjunctive scan: AND of m per-column range predicates
    in one fused pass.  ``data_size`` is each column's packed payload;
    bytes are all m columns and one bitvector.  Verified against the same
    WHERE clause evaluated with plain torch on the unpacked values."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    devs = [unpack_ops.pack_device_kernel(synth_modk(n, 8 + 3 * c, width, device=device), width)
            for c in range(m)]
    dom = 1 << width
    lows = np.full(m, dom // 8, np.uint32)
    highs = np.full(m, dom - dom // 8, np.uint32)
    tiles = tuple(d.tiles for d in devs)
    widths = tuple(d.width for d in devs)
    traffic = m * packed_nbytes(width, n) + bitvector_words(n) * 4

    def verify() -> bool:
        bits, count = conj_ops.conj_range_scan_tiles(tiles, lows, highs, widths, n)
        match = torch.ones(n, dtype=torch.bool, device=device)
        for d, lo, hi in zip(devs, lows.tolist(), highs.tolist()):
            v = unpack_ops.unpack_device(d)
            match &= (v >= lo) & (v < hi)
        ok = int(count) == int(match.sum()) and torch.equal(
            scan_ops.bits_to_canonical(bits, n), bitvector.from_bool(match))
        if not ok:
            print("    VERIFY FAILED: conjunction mismatch")
        return ok

    return _bench_variants(
        [(f"cuda conj range scan m={m}", chain_conj_range_scan, (tiles, lows, highs),
          dict(widths=widths, n=n), traffic)], _roof(device), verify, reps)


def bench_pack(
    data_size: int = DEFAULT_DATA_SIZE,
    reps: int = DEFAULT_REPETITIONS,
    width: int = DEFAULT_WIDTH,
    *,
    device=None,
):
    """Device-side compression, the round trip's other half."""
    device = layout.resolve_device(device)
    n = values_for(data_size, width)
    dev = unpack_ops.pack_device_kernel(synth_ramp(n, width, device=device), width)
    vals = unpack_ops.unpack_tiles(dev.tiles, width)  # the device value layout
    return _bench_variants(
        [("cuda pack", chain_pack, (vals,), dict(width=width), 4 * n + packed_nbytes(width, n))],
        _roof(device), lambda: torch.equal(unpack_ops.pack_tiles(vals, width), dev.tiles), reps)
