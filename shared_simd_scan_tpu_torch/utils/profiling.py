"""Spans, counters and timing (reference src/profiling.{hpp,cpp}).

PyTorch counterpart of ``shared_simd_scan_tpu/utils/profiling.py``, and the
port's one span-and-counter system:

  1. ``span(name)`` — a host span at a layer boundary.  Always on: each
     span *path* (the names of the enclosing spans, outermost first) keeps
     its count and total nanoseconds in memory, read by ``span_totals()``
     with its self time (the total less its child spans).  While a
     ``torch.profiler`` records, a span is a ``record_function`` range
     named ``"sss." + name`` on the profiler's host timeline instead, the
     outermost one carrying its operation's sequence number as ``args``,
     and stays out of the in-memory totals.  Names are
     ``<layer>.<what>``: ``query.evaluate``, ``scan.pick_tier``,
     ``launch.<entry point>``, ``cuda.build``.
  2. ``count(name, n)`` — one counter set, read by ``counters()``:
     ``launches.<wrapper>`` (kernel launches, as each wrapper counts them),
     ``tier.<tier>`` (the shared scan's dispatch decisions),
     ``query.count.kernel`` / ``query.count.popcount`` (where each
     ``query.evaluate`` took its count from),
     ``cuda.builds`` (kernel libraries compiled in this process) and, read
     from ``cache_info()`` when the set is read,
     ``cache.<function>.hits`` / ``.misses`` of the dispatcher's caches.
  3. ``clock_ns()`` — delta stopwatch (profiling.cpp:6-13 ``_clock``); a
     host stopwatch bounds device work only if the caller waits for the
     results — kernel timing uses CUDA events (``bench.timing``).
  4. ``ProfileSample`` / ``profile_block`` / ``get_sample`` — the
     reference's named accumulating sections (profiling.cpp:15-52, the
     RAII ``ProfileSample`` and ``get_sample``): spans on the same
     registry and stack, kept under a profiler too, printing under the
     ``SSS_PROFILING=1`` environment variable.
  5. ``trace`` — a ``torch.profiler`` context that records the host and,
     where a card is present, its kernels, and writes a Chrome trace.

Spans and counters assume one host thread drives the port.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass

import torch

_clock = time.perf_counter_ns
_profiler_enabled = torch._C._autograd._profiler_enabled
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


class _Node:
    """One span path: its count and total ns, and its child paths."""

    __slots__ = ("parent", "children", "count", "total_ns")

    def __init__(self, parent: _Node | None):
        self.parent = parent
        self.children: dict[str, _Node] = {}
        self.count = 0
        self.total_ns = 0


_root = _Node(None)
_current = _root  # the innermost span open outside the profiler
_traced_depth = 0  # spans open under the profiler
_operations = 0  # outermost spans opened under the profiler
_counters: dict[str, int] = {}
_caches: dict = {}  # name -> lru-cached function
_cache_base: dict[str, tuple[int, int]] = {}  # name -> (hits, misses) at the last reset


class span:
    """``with span(name):`` -- a host span; see the module docstring."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _current
        if _profiler_enabled():
            return self._enter_traced()
        node = _current.children.get(self.name)
        if node is None:
            node = _current.children[self.name] = _Node(_current)
        _current = node
        self._t0 = _clock()
        return self

    def _enter_traced(self):
        global _traced_depth, _operations
        args = None
        if _traced_depth == 0:
            _operations += 1
            args = str(_operations)
        self._range = torch.profiler.record_function("sss." + self.name, args)
        self._range.__enter__()
        self._t0 = None
        _traced_depth += 1
        return self

    def __exit__(self, exc_type, exc, tb):
        global _current, _traced_depth
        t0 = self._t0
        if t0 is None:
            _traced_depth -= 1
            self._range.__exit__(exc_type, exc, tb)
            return False
        node = _current  # spans close innermost first: this one's path
        node.total_ns += _clock() - t0
        node.count += 1
        _current = node.parent
        return False


def span_totals() -> dict[tuple[str, ...], tuple[int, int, int]]:
    """Span path -> (count, total ns, self ns) of every span closed outside
    the profiler since the last ``reset_samples()``."""
    out = {}

    def walk(node: _Node, path: tuple[str, ...]) -> None:
        for name, child in node.children.items():
            p = path + (name,)
            inner = sum(c.total_ns for c in child.children.values())
            out[p] = (child.count, child.total_ns, child.total_ns - inner)
            walk(child, p)

    walk(_root, ())
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def launch_count(wrapper) -> int:
    """The launches kernel wrapper ``wrapper`` has counted
    (``launches.<its name>``)."""
    return _counters.get("launches." + wrapper.__name__, 0)


def watch_cache(fn):
    """Report lru-cached ``fn``'s hits and misses in ``counters()`` as
    ``cache.<name>.hits`` / ``.misses``; returns ``fn``."""
    _caches[fn.__name__] = fn
    return fn


def counters() -> dict[str, int]:
    """The counter set since the last ``reset_samples()``, the watched
    caches' hits and misses included."""
    out = dict(_counters)
    for name, fn in _caches.items():
        info = fn.cache_info()
        hits, misses = _cache_base.get(name, (0, 0))
        out[f"cache.{name}.hits"] = info.hits - hits
        out[f"cache.{name}.misses"] = info.misses - misses
    return out


@dataclass
class _Sample:
    total_ns: int = 0
    count: int = 0

    @property
    def avg_ns(self) -> float:
        return self.total_ns / self.count if self.count else 0.0


def get_sample(name: str) -> _Sample:
    """Accumulated time of every span named ``name``, wherever it nests
    (profiling.cpp ``get_sample``)."""
    s = _Sample()
    for path, (n, total, _) in span_totals().items():
        if path[-1] == name:
            s.total_ns += total
            s.count += n
    return s


def reset_samples() -> None:
    """Clear the spans and the counter set (the caches' hits and misses
    count from here)."""
    _root.children.clear()  # a span open now closes into no path
    _counters.clear()
    for name, fn in _caches.items():
        info = fn.cache_info()
        _cache_base[name] = (info.hits, info.misses)


class ProfileSample(span):
    """A span that is always kept in memory, under a profiler too (where it
    is also the range ``sss.<name>``), and prints its time and running
    average on exit when profiling is enabled — the reference's RAII
    ``ProfileSample`` (profiling.cpp:25-29), as a ``with`` block.
    ``sync=True`` waits for the card's queued work before stopping, where
    CUDA is initialised in the process."""

    __slots__ = ("sync",)

    def __init__(self, name: str, sync: bool = False):
        super().__init__(name)
        self.sync = sync

    def __enter__(self):
        global _current
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function("sss." + self.name)
            self._range.__enter__()
        node = _current.children.get(self.name)
        if node is None:
            node = _current.children[self.name] = _Node(_current)
        _current = node
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        global _current
        if self.sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = _clock() - self._t0
        node = _current
        node.total_ns += dt
        node.count += 1
        _current = node.parent
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if profiling_enabled():
            s = get_sample(self.name)
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
