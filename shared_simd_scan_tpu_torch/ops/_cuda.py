"""Build, load and launch plumbing for the package's CUDA sources.

The kernels in ``shared_simd_scan_tpu_torch/csrc/*.cu`` are compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into one shared library
with a plain C interface and loaded with ctypes.  Nothing is compiled or
loaded at import time, so the package imports on machines with no CUDA
toolkit (its CPU tensors take the plain torch versions).

The library goes into ``shared_simd_scan_tpu_torch/_build/`` under a name
keyed by a hash of the sources and flags, so an unchanged tree does not
rebuild.  Builds are serialized by a thread lock and a file lock, and a
finished library is moved into place atomically.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("unpack.cu", "shared_scan.cu", "interval_scan.cu", "bitsliced.cu", "range_scan.cu",
           "conj.cu", "member.cu", "aggregate.cu", "agg_lookup.cu", "histogram.cu", "zoned.cu",
           "linear.cu", "copy.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_ll = ctypes.c_longlong
# C signature of every entry point: (argtypes); all return a cudaError_t.
_SIGNATURES = {
    # tiles, vals, nblocks, width, stream
    "sss_unpack": [_vp, _vp, _ll, ctypes.c_int, _vp],
    # vals, tiles, nblocks, width, stream
    "sss_pack": [_vp, _vp, _ll, ctypes.c_int, _vp],
    # tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream
    "sss_shared_scan": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll, _vp],
    # tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream
    "sss_shared_scan_chunked": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll,
                                _vp],
    "sss_shared_scan_dynamic": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll,
                                _vp],
    # tiles, plan, k, nwin, nd, ndup, bits, counts, nblocks, width, n, block_offset, stream
    "sss_windowed_lookup": [_vp, _vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _vp,
                            _vp, _ll, ctypes.c_int, _ll, _ll, _vp],
    # tiles, lo, k, bits, counts, nblocks, width, n, block_offset, gateless, stream
    "sss_interval_scan": [_vp, ctypes.c_uint32, ctypes.c_int, _vp, _vp, _ll,
                          ctypes.c_int, _ll, _ll, ctypes.c_int, _vp],
    # the fused linear form: out (uint32[nblocks * k]) in place of bits
    "sss_interval_scan_linear": [_vp, ctypes.c_uint32, ctypes.c_int, _vp, _vp, _ll,
                                 ctypes.c_int, _ll, _ll, ctypes.c_int, _vp],
    # base, amounts, out_ptx, out_cxx, count, stream
    "sss_shift_canary": [_vp, _vp, _vp, _vp, ctypes.c_int, _vp],
    # amounts (a host array of count uint32), count, word (host uint32), stream
    "sss_shift_verdict": [_vp, ctypes.c_int, _vp, _vp],
    # tiles, keys (device: the runtime keys, or the host keys copied once), k, bits, counts,
    # nblocks, width, n, block_offset, stream
    "sss_bitsliced_static_fold": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll,
                                  _vp],
    # the fused linear forms: out (uint32[nblocks * k]) in place of bits;
    # keys in device memory, or a host array of k uint32 passed by value
    "sss_bitsliced_scan_linear": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll,
                                  _vp],
    "sss_bitsliced_static_scan_linear": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll,
                                         _ll, _vp],
    # in, ld, in_len, m, granule bytes, seg, out, out_len, stream
    "sss_interleave": [_vp, _ll, _ll, ctypes.c_int, ctypes.c_int, ctypes.c_int, _vp, _ll, _vp],
    # tiles, lows, highs, k, bits, counts, nblocks, ld, width, n, block_offset, stream
    "sss_range_scan": [_vp, _vp, _vp, ctypes.c_int, _vp, _vp, _ll, _ll, ctypes.c_int, _ll, _ll,
                       _vp],
    # tiles, idx, flag, g, lows, highs, k, bits (NULL: the count form), counts, nblocks,
    # step_blocks, width, n, stream
    "sss_zoned_range_scan": [_vp, _vp, _vp, ctypes.c_int, _vp, _vp, ctypes.c_int, _vp, _vp, _ll,
                             _ll, ctypes.c_int, _ll, _vp],
    # tiles, lo (device pointer), k, counts, nblocks, width, n, block_offset, stream
    "sss_histogram": [_vp, _vp, ctypes.c_int, _vp, _ll, ctypes.c_int, _ll, _ll, _vp],
    # tiles, lo (host value), k, counts, nblocks, width, n, block_offset, stream
    "sss_histogram_span": [_vp, ctypes.c_uint32, ctypes.c_int, _vp, _ll, ctypes.c_int, _ll, _ll,
                           _vp],
    # tiles, counts (int64[2^width]), nblocks, width, n, block_offset, stream
    "sss_histogram_domain": [_vp, _vp, _ll, ctypes.c_int, _ll, _ll, _vp],
    # tiles, lo (host value), k, counts, nblocks, width, n, block_offset, stream
    "sss_histogram_fold": [_vp, ctypes.c_uint32, ctypes.c_int, _vp, _ll, ctypes.c_int, _ll, _ll,
                           _vp],
    # tile_ptrs, widths, lows, highs (host arrays of m), m, bits, counts, nblocks, n,
    # block_offset, stream
    "sss_conj_range_scan": [_vp, _vp, _vp, _vp, ctypes.c_int, _vp, _vp, _ll, _ll, _ll, _vp],
    # tiles, keys (or win), k (or nwin), table, size, scratch, bits, counts, nblocks, width, n,
    # block_offset, fused, stream
    "sss_member_compare": [_vp, _vp, ctypes.c_int, _vp, ctypes.c_int, _vp, _vp, _vp, _ll,
                           ctypes.c_int, _ll, _ll, ctypes.c_int, _vp],
    "sss_member_window": [_vp, _vp, ctypes.c_int, _vp, ctypes.c_int, _vp, _vp, _vp, _ll,
                          ctypes.c_int, _ll, _ll, ctypes.c_int, _vp],
    # operand, count, window, width, table, size, scratch, stream
    "sss_member_table": [_vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, _vp, ctypes.c_int, _vp,
                         _vp],
    # tiles, keys, k, bits, counts, nblocks, width, n, block_offset, stream
    "sss_member_domain": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll, _vp],
    # tiles, table, size, bits, counts, nblocks, width, n, block_offset, stream
    "sss_member_lookup": [_vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, _ll, _ll, _vp],
    # ptiles, mtiles, keys, k, counts, sums, nblocks, wp, wm, n, block_offset, stream
    "sss_agg_compare": [_vp, _vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, ctypes.c_int,
                        _ll, _ll, _vp],
    # mtiles, bits, count, sum, nblocks, wm, stream
    "sss_masked_agg": [_vp, _vp, _vp, _vp, _ll, ctypes.c_int, _vp],
    # ptiles, mtiles, keys (a host array of k uint32, passed by value), k, counts, sums,
    # nblocks, wp, wm, n, block_offset, stream
    "sss_agg_lookup": [_vp, _vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int, ctypes.c_int,
                       _ll, _ll, _vp],
    # ptiles, mtiles, keys (device), k, counts, sums, nblocks, wp, wm, n, block_offset, stream
    "sss_agg_device_lookup": [_vp, _vp, _vp, ctypes.c_int, _vp, _vp, _ll, ctypes.c_int,
                              ctypes.c_int, _ll, _ll, _vp],
    # ptiles, mtiles, keys (device), k, counts, mins, maxs, nblocks, wp, wm, n, block_offset,
    # stream
    "sss_minmax_lookup": [_vp, _vp, _vp, ctypes.c_int, _vp, _vp, _vp, _ll, ctypes.c_int,
                          ctypes.c_int, _ll, _ll, _vp],
    # src, dst, nbytes, stream
    "sss_copy": [_vp, _vp, _ll, _vp],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the last build


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = pathlib.Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsss_kernels-{h.hexdigest()[:16]}.so"


def _compile(args: list[str]) -> str:
    proc = subprocess.run(args, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(args)}):\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build() -> pathlib.Path:
    """Compile the CUDA sources into the shared library unless it exists."""
    global build_log
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if lib_path.exists():  # another process built it meanwhile
                return lib_path
            exe = nvcc()
            tmp = BUILD_DIR / f"tmp-{os.getpid()}"
            tmp.mkdir(exist_ok=True)
            objs = [tmp / (pathlib.Path(s).stem + ".o") for s in SOURCES]
            # one nvcc per source, in parallel: the templated kernels dominate
            with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
                logs = list(pool.map(
                    _compile,
                    [[exe, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                     for s, o in zip(SOURCES, objs)],
                ))
            out = tmp / lib_path.name
            logs.append(_compile([exe, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(out)]))
            os.replace(out, lib_path)
            shutil.rmtree(tmp, ignore_errors=True)
            build_log = "".join(logs)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.sss_error_string.argtypes = [ctypes.c_int]
            handle.sss_error_string.restype = ctypes.c_char_p
            # dynamic shared memory a CTA of the copy / the chunked / the
            # dynamic scan takes
            handle.sss_copy_smem.argtypes = []
            handle.sss_copy_smem.restype = ctypes.c_longlong
            for name in ("sss_shared_scan_chunked_smem", "sss_shared_scan_dynamic_smem"):
                getattr(handle, name).argtypes = [ctypes.c_int]
                getattr(handle, name).restype = ctypes.c_longlong
            _lib = handle
        return _lib


def kernel_device(*tensors: torch.Tensor) -> torch.device | None:
    """None when every tensor lies on the CPU (the plain version runs);
    the CUDA device when all lie on one CUDA device (the kernel runs).
    Anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    (device,) = devices
    if device.type == "cpu":
        return None
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}: only CUDA tensors launch kernels")
    return device


def check_int32(name: str, t: torch.Tensor, shape: tuple[int, ...]) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``shape``."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 (uint32 bits), got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(fn: str, device: torch.device, *args) -> None:
    """Call entry point ``fn`` with ``args`` followed by the device's
    current stream; raise if the launch reported a CUDA error."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(handle, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}: {handle.sss_error_string(rc).decode()}")
