"""Time four bin-update forms of the runtime-lo histogram on the card.

    python -m shared_simd_scan_tpu_torch.bench.bin_variants

Builds ``bin_variants.cu`` (beside this file) with nvcc into the package's
``_build/`` and times, with CUDA events, each form (see the .cu) beside the
package's ``histogram_tiles`` on four columns of the reference benchmark's
n = 477,218,588: ``i % 512``, uniform 9-bit and sorted 9-bit (k = 512), and
uniform 20-bit (window 0..4095, k = 4096).  Every form's counts are checked
against ``torch.bincount`` first.  Needs a CUDA card; prints one line per
column and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import pathlib
import statistics
import subprocess

import torch

from shared_simd_scan_tpu_torch.layout import LANES
from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.ops.scan import histogram_tiles
from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel

N = 477_218_588
SOURCE = pathlib.Path(__file__).with_name("bin_variants.cu")
NAMES = {0: "match_any groups", 1: "one atomic per value", 2: "ballot, uniform path",
         3: "per-warp bins"}


def _library() -> ctypes.CDLL:
    out = _cuda.BUILD_DIR / "libsss_bin_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-shared", str(SOURCE), "-o", str(out)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.sss_bin_variant.argtypes = [ctypes.c_int, vp, ctypes.c_uint32, ctypes.c_int, vp, ll,
                                    ctypes.c_int, ll, vp]
    return lib


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bin_variants: no CUDA device")
    device = torch.device("cuda")
    lib = _library()
    i = torch.arange(N, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    columns = {  # name -> (width, k, values)
        "i % 512": (9, 512, lambda: (i % 512).to(torch.int32)),
        "uniform 9-bit": (9, 512, lambda: torch.randint(0, 512, (N,), generator=gen,
                                                        device=device, dtype=torch.int32)),
        "sorted 9-bit (i * 512) // n": (9, 512, lambda: (i * 512 // N).to(torch.int32)),
        "uniform 20-bit, window 0..4095": (20, 4096, lambda: torch.randint(
            0, 1 << 20, (N,), generator=gen, device=device, dtype=torch.int32)),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"nvidia-smi: {smi}")
    stream = torch.cuda.current_stream().cuda_stream
    lo = torch.zeros(1, dtype=torch.int32, device=device)
    for name, (width, k, draw) in columns.items():
        values = draw()
        truth = torch.bincount(values[values < k].to(torch.int64), minlength=k)
        dev = pack_device_kernel(values, width)
        del values
        nblocks = dev.tiles.shape[1] * LANES
        counts = torch.zeros(k, dtype=torch.int64, device=device)
        times = {}
        for variant in NAMES:
            if variant == 3 and k > 512:
                continue

            def call(variant=variant):
                counts.zero_()
                rc = lib.sss_bin_variant(variant, dev.tiles.data_ptr(), 0, k, counts.data_ptr(),
                                         nblocks, width, N, stream)
                if rc:
                    raise RuntimeError(f"variant {variant}: CUDA error {rc}")

            call()
            if not torch.equal(counts, truth):
                raise SystemExit(f"{name}: variant {variant} counts differ from torch.bincount")
            times[variant] = _time_ms(call)
        package = _time_ms(lambda: histogram_tiles(dev.tiles, lo, k, width, N))
        bound = dev.tiles.numel() * 4 / 3.35e12 * 1e3
        print(f"{name} (k={k}, bound {bound:.6f} ms): "
              + ", ".join(f"{NAMES[v]} {t:.6f}" for v, t in times.items())
              + f"; histogram_tiles {package:.6f} ms")
        del dev


if __name__ == "__main__":
    main()
