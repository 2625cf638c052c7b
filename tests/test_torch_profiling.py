"""The port's spans and counter set (``utils.profiling``) on the CPU.

Spans nest into paths with their self time, stay in memory with no
profiler and make no ``record_function`` then; under ``torch.profiler``
they are ``sss.*`` ranges on the host timeline that enclose what they
launched.  Each kernel wrapper counts ``launches.<wrapper>``, the
dispatcher ``tier.<tier>``; the dispatcher's caches report their hits and
misses.  The benchmark's readers of the spans (``scanbench/layer_metrics``)
return a number on a CPU rehearsal of their cell and None where their span
is absent.  No JAX.
"""
import ast
import contextlib
import importlib
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from scanbench.tests.rehearse import last_line, rehearse
from shared_simd_scan_tpu_torch import query
from shared_simd_scan_tpu_torch.ops import _cuda, conj, scan
from shared_simd_scan_tpu_torch.ops.unpack import pack_device_kernel
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)

PORT = pathlib.Path(profiling.__file__).resolve().parents[1]


@pytest.fixture
def clean():
    profiling.reset_samples()
    yield
    profiling.reset_samples()


def _column(width, n=3000, seed=0):
    values = np.random.default_rng(seed).integers(0, 1 << width, n).astype(np.int32)
    return pack_device_kernel(torch.from_numpy(values), width)


def _reader(name):
    return importlib.import_module(f"scanbench.layer_metrics.{name}").read


def test_span_paths_counts_and_self_time(clean):
    for _ in range(3):
        with profiling.span("a.outer"):
            with profiling.span("b.inner"):
                torch.ones(100).sum()
            with profiling.span("b.inner"):
                with profiling.span("c.leaf"):
                    pass
    with profiling.span("b.inner"):
        pass
    totals = profiling.span_totals()
    assert set(totals) == {("a.outer",), ("a.outer", "b.inner"), ("a.outer", "b.inner", "c.leaf"),
                           ("b.inner",)}
    assert [totals[p][0] for p in sorted(totals)] == [3, 6, 3, 1]
    for path, (count, total, self_ns) in totals.items():
        inner = sum(t for p, (_, t, _) in totals.items() if p[:-1] == path)
        assert self_ns == total - inner >= 0, path
    assert profiling.get_sample("b.inner").count == 7
    with pytest.raises(ZeroDivisionError):  # a raising block still closes its span
        with profiling.span("a.outer"):
            1 / 0
    assert profiling.span_totals()[("a.outer",)][0] == 4
    with profiling.span("d.after"):
        pass
    assert ("d.after",) in profiling.span_totals()  # the stack unwound to the top


def test_profile_sample_is_a_span_on_the_same_stack(clean, monkeypatch, capsys):
    monkeypatch.setenv("SSS_PROFILING", "1")
    with profiling.ProfileSample("step"):
        with profiling.span("query.plan"):
            pass
    assert set(profiling.span_totals()) == {("step",), ("step", "query.plan")}
    assert capsys.readouterr().out.startswith("[profile] step: ")
    profiling.reset_samples()
    assert profiling.span_totals() == {}
    # unlike a span, a sample is kept under the profiler too, and is its range there
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.ProfileSample("step"):
            with profiling.span("query.plan"):
                pass
    assert profiling.get_sample("step").count == 1 and set(profiling.span_totals()) == {("step",)}
    names = {e.name for e in prof.events()}
    assert {"sss.step", "sss.query.plan"} <= names


def test_no_profiler_no_record_function(clean, monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: made.append(a))
    with profiling.span("query.evaluate"):
        with profiling.span("query.plan"):
            pass
    assert made == []
    assert profiling.span_totals()[("query.evaluate", "query.plan")][0] == 1


def test_query_spans_on_the_profiler_timeline(clean, tmp_path):
    cols = [_column(w, seed=i) for i, w in enumerate((12, 6, 4))]
    expr = query.And(query.Range(cols[0], 10, 2000), query.Range(cols[1], 1, 25),
                     query.Eq(cols[2], 3))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        bits, count = query.evaluate(expr)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    program = [e for e in events if e.get("cat") == "user_annotation"]
    assert program and all(e["name"].startswith("sss.") for e in program)
    assert not any(e["name"].startswith("scanbench.") for e in events)
    (outer,) = [e for e in program if e["name"] == "sss.query.evaluate"]
    inside = {e["name"] for e in program if e is not outer and outer["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]}
    assert {"sss.query.plan", "sss.conj.conj_range_scan_device", "sss.query.compose",
            "sss.query.popcount"} <= inside
    assert profiling.span_totals() == {}  # the traced spans stay out of the totals
    profiling.reset_samples()
    again, n = query.evaluate(expr)
    assert torch.equal(again, bits) and int(n) == int(count)
    totals = profiling.span_totals()
    assert {p[-1] for p in totals if p[0] == "query.evaluate"} == {
        "query.evaluate", "query.plan", "conj.conj_range_scan_device", "query.compose",
        "query.popcount"}
    assert _reader("plan_host_ms")(None) > 0 and _reader("popcount_host_ms")(None) > 0


def _span_names():
    """Every literal span name in the port -> the files that open it."""
    names = {}
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"
                    and getattr(node.func.value, "id", None) == "profiling"):
                arg = node.args[0]
                if isinstance(arg, ast.Constant):
                    names.setdefault(arg.value, set()).add(path.name)
                else:  # "launch." + fn
                    assert isinstance(arg, ast.BinOp) and arg.left.value == "launch.", path
    return names


def test_span_names_are_layer_dot_what():
    names = _span_names()
    assert {"query.evaluate", "query.plan", "query.compose", "query.popcount",
            "scan.shared_scan_device", "scan.pick_tier", "scan.program",
            "scan.range_scan_device", "conj.conj_range_scan_device",
            "agg.masked_aggregate_device", "member.member_scan_device",
            "zonemap.pruned_range_scan", "cuda.build"} <= set(names)
    for name in names:
        assert re.fullmatch(r"[a-z]+\.[a-z_]+", name), name
        assert not name.startswith("scanbench"), name


def test_each_launch_counter_names_a_wrapper():
    for path in PORT.rglob("*.py"):
        source = path.read_text()
        functions = {n.name for n in ast.walk(ast.parse(source)) if isinstance(n, ast.FunctionDef)}
        for name in re.findall(r'profiling\.count\("launches\.(\w+)"', source):
            assert name in functions, (path.name, name)


@contextlib.contextmanager
def _fake_card(monkeypatch):
    """The CUDA branches on CPU tensors, each entry point a no-op that
    succeeds: the launch path runs, its outputs stay unwritten."""
    calls = []

    class Handle:
        def __getattr__(self, fn):
            return lambda *args: calls.append(fn) or 0

    monkeypatch.setattr(_cuda, "kernel_device", lambda *ts: torch.device("cpu"))
    monkeypatch.setattr(_cuda, "lib", Handle)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    yield calls


def test_launch_spans_and_counters_on_the_launch_path(clean, monkeypatch):
    cols = [_column(w, seed=i) for i, w in enumerate((12, 6))]
    tiles = cols[0].tiles
    keys = torch.zeros(2100, dtype=torch.int32)
    with _fake_card(monkeypatch) as calls:
        pack_device_kernel(torch.arange(500, dtype=torch.int32), 9)  # a top-level launch
        assert _reader("launch_host_ms")(None) is None
        conj.conj_range_scan_device(cols, [1, 2], [900, 40])
        scan.shared_scan_dynamic_tiles(tiles, keys, 12, 3000)  # one call, three launches
        scan.range_scan_tiles(tiles, keys[:3], keys[:3], 12, 3000)
    assert calls == ["sss_pack", "sss_conj_range_scan", "sss_shared_scan_dynamic",
                     "sss_range_scan"]
    counts = profiling.counters()
    assert {k: v for k, v in counts.items() if k.startswith("launches.")} == {
        "launches.pack_tiles": 1, "launches.conj_range_scan_tiles": 1,
        "launches.shared_scan_dynamic_tiles": 3, "launches.range_scan_tiles": 1}
    totals = profiling.span_totals()
    assert totals[("launch.sss_pack",)][0] == 1
    assert totals[("conj.conj_range_scan_device", "launch.sss_conj_range_scan")][0] == 1
    assert _reader("launch_host_ms")(None) > 0  # the nested launch alone


@pytest.mark.parametrize("keys, tier", [
    ([5, 6, 7, 8], "interval"),
    ([3, 100, 200, 411, 6, 77, 300, 500], "fold"),
    (list(range(0, 512, 8)), "fold"),
    ([3, 100], "compare"),
])
def test_tier_counters_name_the_dispatch_decision(clean, keys, tier):
    dev = _column(9, n=2000)
    scan.shared_scan_device(dev, keys)
    counts = profiling.counters()
    assert {k: v for k, v in counts.items() if k.startswith("tier.")} == {f"tier.{tier}": 1}
    totals = profiling.span_totals()
    # the interval check, then (past it) the route of shared_scan_tiles
    assert totals[("scan.shared_scan_device", "scan.pick_tier")][0] == \
        (1 if tier == "interval" else 2)
    assert _reader("pricing_host_ms")(None) > 0 and _reader("dispatch_host_ms")(None) > 0


def test_cache_counters_count_from_a_reset(clean):
    scan._compare_fold_wins.cache_clear()  # a pure rule: clearing it costs time alone
    scan._compare_fold_wins(9, 777)
    profiling.reset_samples()
    before = profiling.counters()
    assert before["cache._compare_fold_wins.hits"] == 0
    assert before["cache._compare_fold_wins.misses"] == 0
    scan._compare_fold_wins(9, 777)
    scan._compare_fold_wins(9, 779)
    after = profiling.counters()
    assert after["cache._compare_fold_wins.hits"] == 1
    assert after["cache._compare_fold_wins.misses"] == 1
    assert {"cache._static_keys_on.hits", "cache._window_tables_on.misses"} <= set(after)


@pytest.mark.parametrize("reader", ["dispatch_host_ms", "pricing_host_ms", "launch_host_ms",
                                    "plan_host_ms", "popcount_host_ms"])
def test_reader_is_none_without_its_span(clean, reader):
    with profiling.span("other.span"):
        pass
    assert _reader(reader)(None) is None


@pytest.mark.parametrize("cell, present, absent", [
    ("simdscan_9bit.interval8", ("dispatch_host_ms", "pricing_host_ms"), ("launch_host_ms.scan",)),
    ("ssb_sf100.flight1", ("plan_host_ms", "popcount_host_ms"), ("launch_host_ms.query",)),
])
def test_readers_on_a_cpu_rehearsal(cell, present, absent):
    # the CPU runs the plain versions: no kernel, so no launch span to read
    rc, out, err = rehearse(cell, trace=1, seconds=0.3, rows=4096)
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is True
    for name in present:
        assert line["metrics"][name]["value"] > 0, name
    assert not set(absent) & set(line["metrics"])
