"""The harness on the CPU: finding its pieces by name, the reference, the
yardstick, the result line, and what a run may not load."""
from __future__ import annotations

import ast
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from scanbench import harness, roofline
from scanbench.tests.rehearse import CONTRACT_KEYS, ROOT, ROWS, last_line, rehearse

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW_CELLS = [  # cells a later PR adds as a BENCHMARK.json entry alone
    {"name": "simdscan_9bit.any64", "config": "simdscan_9bit", "traffic": "any64", "chips": 1,
     "why": "64 distinct keys a batch"},
    {"name": "ssb_sf100.dates64", "config": "ssb_sf100", "traffic": "dates64", "chips": 1,
     "why": "64 distinct days a batch"},
]


def _traffic(cell: dict) -> dict:
    return json.loads((ROOT / "scanbench" / "traffic" / f"{cell['traffic']}.json").read_text())


@pytest.mark.parametrize("cell", BENCH["workloads"] + NEW_CELLS, ids=lambda c: c["name"])
def test_pieces_found_by_name(cell):
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == cell["config"]
    assert callable(harness.config_maker(ROOT / entry["file"]))
    generator = _traffic(cell)["generator"]
    for part, names in (("generators", ("ops", "queries", "call", "semantic_bytes")),
                        ("reference", ("Truth", "compare", "control_call"))):
        module = importlib.import_module(f"scanbench.{part}.{generator}")
        assert all(hasattr(module, n) for n in names)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_readers_found_by_name(metric):
    folder = "end_to_end" if metric in BENCH["end_to_end"] else "layer_metrics"
    reader = metric["name"].partition(".")[0]
    assert callable(importlib.import_module(f"scanbench.{folder}.{reader}").read)


@pytest.mark.parametrize("cell", NEW_CELLS, ids=lambda c: c["name"])
def test_new_cell_runs_from_an_entry_alone(cell, tmp_path):
    bench = dict(BENCH, workloads=BENCH["workloads"] + [cell])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    rc, out, err = rehearse(cell["name"], bench=path)
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0


def _brute(generator, params, config, raw, op):
    """Counts, sums and words by numpy, row by row in bulk."""
    if generator == "shared_scan":
        v = raw[params["column"]].numpy()
        masks = [v == int(key) for key in op]
        numbers = [int(m.sum()) for m in masks]
    else:
        date, qty, disc, price = (raw[params[c]].numpy().astype(np.int64) for c in (
            "date_column", "quantity_column", "discount_column", "measure_column"))
        (d0, d1), (q0, q1) = op["date"], op["quantity"]
        where = (date >= d0) & (date < d1) & (qty >= q0) & (qty < q1)
        masks = [where & (disc == v) for v in op["discounts"]]
        revenue = int(sum(int(price[m].sum()) * v for m, v in zip(masks, op["discounts"])))
        numbers = [revenue] + [int(m.sum()) for m in masks] * 2
    words = [np.packbits(np.concatenate([m, np.zeros(-len(m) % 32, bool)]),
                         bitorder="little").view("<u4").view(np.int32) for m in masks]
    return np.asarray(numbers, np.int64), words


@pytest.mark.parametrize("cell", BENCH["workloads"] + NEW_CELLS, ids=lambda c: c["name"])
def test_reference_agrees_with_brute_force_and_catches_a_flipped_bit(cell):
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    make = harness.config_maker(ROOT / entry["file"])
    params = _traffic(cell)
    gen = importlib.import_module(f"scanbench.generators.{params['generator']}")
    ref = importlib.import_module(f"scanbench.reference.{params['generator']}")
    rows, device = ROWS[cell["config"]], torch.device("cpu")
    raw = harness.make_raw(config, make, rows, 2147483659, device, ref.columns(params))
    truth = ref.Truth(params, config, raw)
    ops = gen.ops(params, config, np.random.default_rng(7))
    batch = [next(ops) for _ in range(6)]
    for op in batch:
        numbers, words = _brute(params["generator"], params, config, raw, op)
        assert all(v == 0 for v in ref.compare(numbers, truth.numbers(op)).values())
        for want, got in zip(truth.words(op), words):
            assert torch.equal(want, torch.from_numpy(got))
    # the program on a column with the lowest bit of row 0 flipped, asked about row 0,
    # disagrees with the reference
    if params["generator"] == "shared_scan":
        column = params["column"]
        v0, top = int(raw[column][0]), config["columns"][column]["max"]
        start = min(v0, top + 1 - params["k"])
        op = np.arange(start, start + params["k"], dtype=np.uint32)
    else:
        column = params["discount_column"]
        d0, q0, v0 = (int(raw[params[c]][0]) for c in ("date_column", "quantity_column",
                                                        "discount_column"))
        op = {"template": "row 0", "date": (d0, d0 + 1), "quantity": (q0, q0 + 1),
              "discounts": (v0,)}
    cols = harness.make_columns(config, make, rows, 2147483659, device)
    numbers, words = gen.call(params, cols, op, harness._no_span)
    assert sum(ref.compare(numbers, truth.numbers(op)).values()) == 0
    cols[column].tiles.view(-1)[0] ^= 1
    numbers, words = gen.call(params, cols, op, harness._no_span)
    assert sum(ref.compare(numbers, truth.numbers(op)).values()) > 0
    assert any(not torch.equal(w, g) for w, g in zip(truth.words(op), words))


def test_semantic_bytes_from_shapes():
    assert roofline.shared_scan_bytes(466033777, 9, 8) == 990321856
    assert roofline.packed_bytes(466033777, 9) == 500 << 20
    assert roofline.query_bytes(600000000, [12, 6, 4, 24]) == 3450000008
    peak = roofline.hbm_peak("NVIDIA H100 80GB HBM3")
    assert peak == 3.35e12
    assert abs(990321856 / peak * 1e3 - 0.2956) < 1e-4
    assert abs(3450000008 / peak * 1e3 - 1.0299) < 1e-4
    assert roofline.hbm_peak("NVIDIA GeForce RTX 4090") is None


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "scanbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        tops = {name.partition(".")[0] for name in names}
        assert not tops & {"shared_simd_scan_tpu_torch", "shared_simd_scan_tpu", "jax", "jaxlib"}, path


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_and_loaded_modules(trace):
    setup = ("import atexit, json\n"
             "atexit.register(lambda: print(json.dumps(sorted({m.partition('.')[0] for m in "
             "sys.modules} & {'jax', 'jaxlib', 'flax', 'shared_simd_scan_tpu'})), "
             "file=sys.stderr))")
    rc, out, err = rehearse("simdscan_9bit.interval8", trace=trace, seconds=2.0, setup=setup)
    assert rc == 0, err[-3000:]
    assert err.strip().splitlines()[-1] == "[]"  # no JAX, nor the JAX package, loaded
    line = last_line(out)
    assert set(line) == CONTRACT_KEYS | ({"breakdown"} if trace else set())
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    names = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"queries_per_s.scan", "latency_p95_ms.scan", "setup_s"} <= set(line["metrics"])
    checks = line["checks"]
    assert checks and all(set(c) == {"value", "limit"} for c in checks.values())
    tail = err.strip().splitlines()[-1 - len(checks):-1]  # the checks end standard error
    assert tail == [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]


def test_refused_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "scanbench/run.py", "--workload",
                           "simdscan_9bit.interval8", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_refused_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "scanbench", tmp_path / "scanbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "scanbench/run.py", "--workload",
                           "simdscan_9bit.interval8", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "shared_simd_scan_tpu_torch" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "scanbench/run.py", "--workload", cell, "--seed",
                           "2147483659", "--seconds", "3", "--trace", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = last_line(proc.stdout)
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_values_fit_their_columns(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    make = harness.config_maker(ROOT / entry["file"])
    rows, device = ROWS[entry["name"]], torch.device("cpu")
    raw = harness.make_raw(config, make, rows, 2147483659, device, config["columns"])
    for name, spec in config["columns"].items():
        values = raw[name]
        assert values.dtype == torch.int32 and values.shape == (rows,), name
        assert spec["max"] < 1 << spec["bits"], name
        assert spec["min"] <= int(values.min()) and int(values.max()) <= spec["max"], name
    if entry["name"] == "ssb_sf100":  # the columns TPC-H and SSB derive from others
        price, disc = (raw[c].to(torch.int64) for c in ("lo_extendedprice", "lo_discount"))
        assert torch.equal(raw["lo_revenue"].to(torch.int64), price * (100 - disc) // 100)
        assert torch.equal(price % raw["lo_quantity"], torch.zeros_like(price))
        lag = raw["lo_commitdate"] - raw["lo_orderdate"]
        assert int(lag.min()) >= 30 and int(lag.max()) <= 90
        assert int(((raw["lo_orderkey"] - 1) % 32).max()) < 8
