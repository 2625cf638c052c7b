"""The port's benchmark harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``, its values made by
``configs/<config>.py`` where there is one, else uniform over each column's
domain) and a traffic mix (``traffic/<mix>.json``, read by
``generators/<generator>.py``, checked by ``reference/<generator>.py``).
Its end-to-end metrics are read by ``end_to_end/<metric>.py`` and its
per-layer metrics by ``layer_metrics/<metric>.py``, ``<metric>`` being the
name up to its first ``.`` (``queries_per_s.scan`` is read by
``queries_per_s.py``).  The harness finds each by its name and holds
nothing of any one cell.

A run: set-up (the configuration's columns made on the card from the seed
and packed by the port, the cell's own operations warmed up), then one
closed-loop client for ``--seconds``: each operation is issued when the
previous answer is on the host.  With ``--trace 1`` a slice of the window
runs under ``torch.profiler``.  Once the window has closed, the program's
columns are freed, the raw values are made again from the seed, and the
plain reference checks every answer read on the host and the whole
bitvectors of a few operations sampled from the seed.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from scanbench import roofline, seeds, trace

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = Path(__file__).resolve().parent
PORT = "shared_simd_scan_tpu_torch"
# whole top-level module names that may not be loaded when the result prints
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "shared_simd_scan_tpu"})
WARMUP_OPS = 12
SAMPLED_OPS = 4  # operations whose bitvectors are compared whole
TRACE_LEAD_S = 1.0  # the traced slice starts this far into the window
TRACE_SLICE_S = 2.0


class Refused(Exception):
    """A run that must print no result: exit code 2."""


class Spans:
    """Host time of each call into the port (outside the traced slice) and,
    inside it, a ``torch.profiler`` span ``scanbench.<call>`` around it."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            with torch.profiler.record_function(trace.SPAN_PREFIX + name):
                yield
            return
        t = time.perf_counter()
        yield
        self.seconds.setdefault(name, []).append(time.perf_counter() - t)


@contextlib.contextmanager
def _no_span(name: str):
    yield


@dataclasses.dataclass
class Record:
    op: object
    numbers: np.ndarray  # what the operation read on the host
    latency_s: float  # issue to answer on the host
    queries: int
    traced: bool


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    generator: str
    records: list[Record]
    window_s: float
    setup_s: float
    peak_bytes: int | None
    host_seconds: dict[str, list[float]]
    op_bytes: list[int]  # semantic bytes of each record
    peak_rate: float | None  # the card's data-sheet bytes/s
    slice: trace.Slice | None

    def roofline_pct(self, generator: str) -> float | None:
        """Semantic bytes at the data-sheet rate over the device time the
        traced operations launched, in %; None where not measured."""
        if generator != self.generator or self.slice is None or self.peak_rate is None:
            return None
        traced = [b for b, r in zip(self.op_bytes, self.records) if r.traced]
        pairs = [(b, s) for b, s in zip(traced, self.slice.op_device_s) if s > 0]
        if not pairs:
            return None
        return 100.0 * sum(b for b, _ in pairs) / self.peak_rate / sum(s for _, s in pairs)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module_from_file(path: Path):
    spec = importlib.util.spec_from_file_location(f"scanbench_config_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def _forbidden_modules() -> list[str]:
    return sorted({name.partition(".")[0] for name in sys.modules} & FORBIDDEN)


def _inside(path: str, root: Path) -> bool:
    return os.path.abspath(path).startswith(os.path.abspath(root) + os.sep)


def config_maker(config_file: Path):
    """The configuration's ``make(config, column, rows, seed, device)``: its
    ``.py`` beside the ``.json`` where there is one, else uniform values."""
    code = config_file.with_suffix(".py")
    return _module_from_file(code).make if code.exists() else seeds.uniform


def make_raw(config: dict, make, rows: int, seed: int, device, columns) -> dict:
    """The raw values of ``columns``, made again from the seed."""
    return {c: make(config, c, rows, seed, device) for c in columns}


def make_columns(config: dict, make, rows: int, seed: int, device) -> dict:
    """Every column of the configuration, made from the seed and packed by
    the port (its pack kernel on the card), one column at a time."""
    from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel

    cols = {}
    for c, spec in config["columns"].items():
        raw = make(config, c, rows, seed, device)
        cols[c] = pack_device_kernel(raw, spec["bits"])
        del raw
    return cols


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(call, ops, queries, seconds: float, sample_at: list[float], spans: Spans,
                profile_slice: tuple[float, float] | None, device):
    """One client, one operation at a time, for ``seconds`` -> (records,
    window seconds, sampled [(record index, host words)], profiler or None).

    The copies of the sampled bitvectors to the host are made between
    operations, with the window's clock stopped.  The collector is off in
    the window: the records it keeps would make its passes ever longer."""
    records, sampled, pending = [], [], list(sample_at)
    prof, done = None, profile_slice is None
    paused = 0.0
    gc.disable()
    start = time.perf_counter()
    while True:
        elapsed = time.perf_counter() - start - paused
        if elapsed >= seconds:
            break
        if not done and prof is None and elapsed >= profile_slice[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            spans.profiling = True
        elif prof is not None and not done and elapsed >= profile_slice[1]:
            prof.stop()
            spans.profiling, done = False, True
        op = next(ops)
        # a sample due inside the traced slice waits for its end, so the slice
        # holds no copy of a sample
        take = bool(pending) and elapsed >= pending[0] and not spans.profiling
        while take and pending and elapsed >= pending[0]:
            pending.pop(0)
        traced = spans.profiling
        scope = (torch.profiler.record_function(trace.OP_SPAN) if traced
                 else contextlib.nullcontext())
        t = time.perf_counter()
        with scope:
            numbers, words = call(op, spans)
        latency = time.perf_counter() - t
        records.append(Record(op, np.asarray(numbers), latency, queries(op), traced))
        if take:
            t = time.perf_counter()
            sampled.append((len(records) - 1, [w.to("cpu", copy=True) for w in words]))
            paused += time.perf_counter() - t
        del words
    window_s = time.perf_counter() - start - paused
    gc.enable()
    if prof is not None and not done:
        prof.stop()
        spans.profiling = False
    return records, window_s, sampled, prof


def _read_slice(prof) -> trace.Slice | None:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="scanbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.summarize(path)
    finally:
        os.remove(path)


def check(ref, params, config, raw, records, sampled) -> tuple[dict[str, int], int]:
    """Every answer against the reference, and the sampled operations'
    bitvectors word by word -> ({check: mismatches}, failed queries)."""
    truth = ref.Truth(params, config, raw)
    totals: dict[str, int] = {}
    bad = set()
    for i, rec in enumerate(records):
        for name, n in ref.compare(rec.numbers, truth.numbers(rec.op)).items():
            totals[name] = totals.get(name, 0) + n
            if n:
                bad.add(i)
    words = 0
    for i, got in sampled:
        want = truth.words(records[i].op)
        if len(want) != len(got):  # a bitvector missing or extra: all its words wrong
            words += sum(w.shape[0] for w in (want if len(want) > len(got) else got))
            bad.add(i)
            continue
        for w, g in zip(want, got):
            w = w.cpu()
            n = abs(w.shape[0] - g.shape[0])
            m = min(w.shape[0], g.shape[0])
            n += int((w[:m] != g[:m]).sum())
            words += n
            if n:
                bad.add(i)
    totals["word_mismatches"] = words
    return totals, sum(records[i].queries for i in bad)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, traced: bool, device,
             t0: float, rows: int | None = None, control: bool = False) -> dict:
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config_file = ROOT / entry["file"]
    config = _load_json(config_file)
    make = config_maker(config_file)
    params = _load_json(PACKAGE / "traffic" / f"{cell['traffic']}.json")
    gen = importlib.import_module(f"scanbench.generators.{params['generator']}")
    ref = importlib.import_module(f"scanbench.reference.{params['generator']}")
    nrows = int(rows or config["rows"])

    # set-up: the data, then the cell's own operations warmed up
    if control:
        data = make_raw(config, make, nrows, seed, device, ref.columns(params))

        def call(op, span):
            return ref.control_call(params, config, data, op, span)
    else:
        data = make_columns(config, make, nrows, seed, device)

        def call(op, span):
            return gen.call(params, data, op, span)

    warm = gen.ops(params, config, seeds.host_rng(seed, "warmup"))
    for _ in range(WARMUP_OPS):
        call(next(warm), _no_span)
    if traced:  # the profiler's own first start, outside the window
        with torch.profiler.profile():
            call(next(warm), _no_span)
    _sync(device)
    sample_at = sorted(seeds.host_rng(seed, "samples").uniform(0, seconds, SAMPLED_OPS))
    ops = gen.ops(params, config, seeds.host_rng(seed, "ops"))
    profile_slice = None
    if traced:
        lead = min(TRACE_LEAD_S, seconds / 4)
        profile_slice = (lead, lead + min(TRACE_SLICE_S, seconds / 2))
    spans = Spans()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    records, window_s, sampled, prof = closed_loop(
        call, ops, lambda op: gen.queries(params, op), seconds, sample_at, spans,
        profile_slice, device)

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    piece = _read_slice(prof) if prof is not None else None
    del data, call, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    raw = make_raw(config, make, nrows, seed, device, ref.columns(params))
    checks, failed = check(ref, params, config, raw, records, sampled)
    del raw
    check_s = time.perf_counter() - t

    run = RunData(
        generator=params["generator"], records=records, window_s=window_s,
        setup_s=setup_s, peak_bytes=peak, host_seconds=spans.seconds,
        op_bytes=[gen.semantic_bytes(params, config, nrows, r.op) for r in records],
        peak_rate=roofline.hbm_peak(card) if device.type == "cuda" else None, slice=piece)
    kind = "per_layer" if traced else "end_to_end"
    readers = "layer_metrics" if traced else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if cell["name"] not in m.get("workloads", [cell["name"]]):
            continue
        reader = m["name"].partition(".")[0]
        value = importlib.import_module(f"scanbench.{readers}.{reader}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    lat = np.asarray([r.latency_s for r in records])
    print(f"cell {workload} seed {seed}{' control' if control else ''}: rows {nrows}, "
          f"{len(records)} operations in {window_s:.3f} s, latency median "
          f"{np.median(lat) * 1e3:.4f} ms, p95 {np.percentile(lat, 95) * 1e3:.4f} ms, "
          f"set-up {setup_s:.2f} s, check {check_s:.2f} s, {len(sampled)} sampled",
          file=sys.stderr)
    if piece is not None:
        print(f"traced slice: {sum(r.traced for r in records)} operations "
              f"({len(piece.op_device_s)} spans), {piece.window_s:.4f} s, device busy "
              f"{piece.busy_s:.4f} s; {piece.joined_events} of {piece.device_events} device "
              f"events joined to an operation; device time a traced operation: port calls "
              f"{np.mean(piece.op_device_s) * 1e3:.4f} ms, the client's reads "
              f"{piece.client_device_s / max(1, len(piece.op_device_s)) * 1e3:.4f} ms",
              file=sys.stderr)

    result = {
        "correct": all(v <= 0 for v in checks.values()),
        "attempted": sum(r.queries for r in records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": card,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak or 0)},
    }
    if traced:
        result["device"]["busy_s"] = piece.busy_s if piece else 0.0
        result["device"]["window_s"] = piece.window_s if piece else 0.0
        if piece is not None:
            result["breakdown"] = {"device_ops": piece.device_ops,
                                   "idle_gaps": piece.idle_gaps}
    # the numbers compared, each beside its limit (exact comparisons: 0), last
    result["checks"] = {name: {"value": v, "limit": 0} for name, v in checks.items()}
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(prog="scanbench/run.py", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the reference, with one guarantee broken, in the program's place "
                        "(proves the comparison; the benchmark's runs never set it)")
    return p.parse_args(argv)


def main(argv, *, t0: float | None = None, device=None, rows: int | None = None,
         bench_file: Path | None = None) -> int:
    """The command.  ``device``, ``rows`` and ``bench_file`` are for the
    tests' CPU rehearsals: a CPU device skips the look for a card."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    try:
        bench = _load_json(bench_file or ROOT / "BENCHMARK.json")
        cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
        if cell is None:
            raise Refused(f"no workload {args.workload!r} in BENCHMARK.json")
        try:
            port = importlib.import_module(PORT)
        except ImportError as e:
            raise Refused(f"the program under test ({PORT}) does not import: {e}") from e
        if not _inside(port.__file__, ROOT):
            raise Refused(f"{PORT} comes from {port.__file__}, outside the checkout {ROOT}")
        if device is None:
            if not torch.cuda.is_available():
                raise Refused("no CUDA device: the benchmark runs only on the card")
            if torch.cuda.device_count() < int(cell["chips"]):
                raise Refused(f"the cell needs {cell['chips']} cards, "
                              f"{torch.cuda.device_count()} found")
            device = torch.device("cuda", 0)
            torch.cuda.set_device(device)
            print(f"card: {_card_line()}", file=sys.stderr)
        device = torch.device(device)
        result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          device, t0, rows=rows, control=args.control)
        found = _forbidden_modules()
        if found:
            raise Refused(f"modules loaded that the port may not use: {', '.join(found)}")
    except Refused as e:
        print(f"scanbench: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
