"""Timing + profiling (reference src/profiling.{hpp,cpp}).

PyTorch counterpart of ``shared_simd_scan_tpu/utils/profiling.py``.  Three
mechanisms, mirroring the reference's:
  1. ``clock_ns()`` — delta stopwatch (profiling.cpp:6-13 ``_clock``); a
     host stopwatch bounds device work only if the caller waits for the
     results — kernel timing uses CUDA events (``bench.timing``).
  2. ``ProfileSample`` / ``profile_block`` — named accumulating sections
     with a global sample registry (profiling.cpp:15-52, the RAII
     ``ProfileSample`` and ``get_sample``), enabled at runtime by the
     ``SSS_PROFILING=1`` environment variable.
  3. ``trace`` — a ``torch.profiler`` context that records the host and,
     where a card is present, its kernels, and writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

_last_ns: int | None = None


def clock_ns() -> int:
    """Nanoseconds since the previous call (0 on the first call) —
    the reference's static-state delta timer semantics."""
    global _last_ns
    now = time.perf_counter_ns()
    if _last_ns is None:
        _last_ns = now
        return 0
    delta = now - _last_ns
    _last_ns = now
    return delta


def profiling_enabled() -> bool:
    return os.environ.get("SSS_PROFILING", "0") not in ("", "0", "false")


@dataclass
class _Sample:
    total_ns: int = 0
    count: int = 0

    @property
    def avg_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0


_samples: dict[str, _Sample] = defaultdict(_Sample)


def get_sample(name: str) -> _Sample:
    """Accumulated sample for a named section (profiling.cpp ``get_sample``)."""
    return _samples[name]


def reset_samples() -> None:
    _samples.clear()


class ProfileSample:
    """Context manager accumulating wall time under a name; prints the
    running average on exit when profiling is enabled — the reference's
    RAII ``ProfileSample`` (profiling.cpp:25-29), as a ``with`` block.
    ``sync=True`` waits for the card's queued work before stopping, where
    CUDA is initialised in the process."""

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync
        self._t0 = 0

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter_ns() - self._t0
        s = _samples[self.name]
        s.total_ns += dt
        s.count += 1
        if profiling_enabled():
            print(f"[profile] {self.name}: {dt / 1e6:.3f} ms "
                  f"(avg {s.avg_ns / 1e6:.3f} ms over {s.count})")
        return False


@contextlib.contextmanager
def profile_block(name: str):
    """PROFILE_BLOCK_START/END macro analog (profiling.hpp:33-48): a no-op
    unless SSS_PROFILING is set."""
    if not profiling_enabled():
        yield
        return
    with ProfileSample(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` trace context: records the host and, where a card
    is present, its kernels; on exit writes a Chrome trace
    (``*.pt.trace.json``, view in Perfetto or chrome://tracing) into
    ``log_dir`` (default: a new directory under the temporary directory).
    Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="sss_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(log_dir, f"sss_{os.getpid()}_{time.time_ns()}.pt.trace.json"))
