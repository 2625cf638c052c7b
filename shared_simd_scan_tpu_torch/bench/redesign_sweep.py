"""Time the copy, chunked-scan and dynamic-scan designs side by side on the card.

    python -m shared_simd_scan_tpu_torch.bench.redesign_sweep

Builds ``redesign_sweep.cu`` (beside this file) with nvcc into the package's
``_build/`` and prints its registers and shared memory per kernel.  Then,
with CUDA events (the median of 5 batches of 10 calls, each variant timed
twice, in one order and then in the reverse one):

- the copy on 512 MiB: the per-thread batch kernel, the pipelined
  grid-stride loop at 4 and 8 vectors a thread, the bulk-copy ring on the
  resident grid at three stage sizes and with a CTA for every run of 2-32
  consecutive chunks, the package's ``harness.memcpy`` and ``copy_``, on
  random words, on zeros, and as the CLI's ``memory`` rows run it (back and
  forth between two buffers of zeros); every variant byte-exact first;
- the chunked scan on the reference benchmark's column (9-bit ``i % 512``,
  512 MiB packed): the register compare (16 keys a CTA) against the key
  lookup at C in {32, 64, 128} keys and 128 or 256 threads a CTA, two other
  forms of it at 64 and 256 (a shared atomic per row and warp for the
  counts, each row update right after its lookup; rep and the counts in
  registers) and the package's ``shared_scan_chunked_tiles``, on S64 and
  S256 (the key sets of ``chip_smoke.py``); every variant bit-exact against
  the register compare and its counts equal to the closed form first.
  Beside them, timed only, the package's kernel without its lookups, its
  counts or its row stores;
- the dynamic scan on the same column and key sets: the dynamic compare
  it replaced (values in shared memory, read back for every key) against
  the lookup of each value among a launch's keys at groups of G in {32,
  64} rows and 128 or 256 threads a CTA, the package's
  ``shared_scan_dynamic_tiles`` and ``shared_scan_chunked_tiles``; every
  variant bit-exact against the dynamic compare and its counts equal to
  the closed form first.  Beside them, timed only, the package's dynamic
  kernel without its lookups or its row stores, and the CTAs an SM of
  each dynamic variant and of the chunked kernel.

Needs a CUDA card; prints the card's name and power limit first.  Not on
any path of the package.
"""
from __future__ import annotations

import ctypes
import pathlib
import re
import statistics
import subprocess

import numpy as np
import torch

from shared_simd_scan_tpu_torch.bench import harness
from shared_simd_scan_tpu_torch.layout import LANES
from shared_simd_scan_tpu_torch.ops import _cuda, scan
from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel

SOURCE = pathlib.Path(__file__).with_name("redesign_sweep.cu")
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
WIDTH, DOMAIN = 9, 512
HBM_BYTES_PER_S = 3.35e12


def _library() -> tuple[ctypes.CDLL, str]:
    out = _cuda.BUILD_DIR / "libsss_redesign_sweep.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-shared", str(SOURCE), "-o", str(out)],
                          check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.sweep_copy.argtypes = [i, vp, vp, ll, vp]
    lib.sweep_chunked.argtypes = [i, vp, vp, i, vp, vp, ll, i, ll, ll, vp]
    lib.sweep_dynamic.argtypes = [i, vp, vp, i, vp, vp, ll, i, ll, ll, vp]
    lib.sweep_dynamic_ctas.argtypes = [i, i]
    return lib, proc.stdout + proc.stderr


def _resources(log: str) -> list[str]:
    """ptxas's registers and shared memory of the copy, chunked and dynamic
    kernels."""
    lines, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and "Used" in line and any(w in entry for w in ("copy", "chunked", "dynamic")):
            lines.append(f"  {entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def _time_ms(fn, batches: int = 5, calls: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("redesign_sweep: no CUDA device")
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib, log = _library()
    print("ptxas:")
    print("\n".join(_resources(log)))
    ctas = {name: lib.sweep_dynamic_ctas(v, WIDTH) for v, name in DYNAMIC_NAMES.items() if v}
    ctas["the package's chunked kernel"] = lib.sweep_dynamic_ctas(0, WIDTH)
    print(f"CTAs an SM at width {WIDTH} (occupancy calculator): {ctas}")
    copy_sweep(lib, device)
    n = harness.values_for(512 * 1024 * 1024, WIDTH)
    tiles = pack_device_kernel(harness.synth_modk(n, DOMAIN, WIDTH, device=device), WIDTH).tiles
    scan_sweep("chunked scan", lib.sweep_chunked, CHUNKED_NAMES, ABLATION_NAMES,
               {"shared_scan_chunked_tiles": scan.shared_scan_chunked_tiles}, tiles, n)
    scan_sweep("dynamic scan", lib.sweep_dynamic, DYNAMIC_NAMES, DYNAMIC_ABLATIONS,
               {"shared_scan_dynamic_tiles": scan.shared_scan_dynamic_tiles,
                "shared_scan_chunked_tiles": scan.shared_scan_chunked_tiles}, tiles, n)


if __name__ == "__main__":
    main()
