"""The port's benchmark CLI and drivers, on the CPU at tiny sizes.

The corpora, the result line and the size parser are held against the JAX
package's; every ``bench_*`` runner runs on CPU tensors (its kernel
wrappers take their plain versions) and must print parsable rows and an
``ok`` verification; without a CUDA card the CLI refuses to run.
"""
import contextlib
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.bench import cli as jcli
from shared_simd_scan_tpu.bench import harness as jharness
from shared_simd_scan_tpu.bench import timing as jtiming
import shared_simd_scan_tpu_torch as port
from shared_simd_scan_tpu_torch.bench import cli, harness, timing
from shared_simd_scan_tpu_torch.ops import aggregate, unpack

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "prepare_shared_scan_results", REPO / "scripts" / "prepare_shared_scan_results.py")
sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep)

SIZE = 8192  # packed bytes: 7281 values at 9 bits, b1 = 8


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("n,width", [(10_000, 1), (4241, 9), (777, 31)])
def test_corpora_match_jax(monkeypatch, n, width):
    monkeypatch.setattr(harness, "_SYNTH_SLICE", 1000)  # several slices
    np.testing.assert_array_equal(_u32(harness.synth_ramp(n, width, device="cpu")),
                                  np.asarray(jharness.synth_ramp(n, width)))
    np.testing.assert_array_equal(_u32(harness.synth_mod5(n, device="cpu")),
                                  np.asarray(jharness.synth_mod5(n)))
    for k in (1, 8, 700):
        np.testing.assert_array_equal(_u32(harness.synth_modk(n, k, width, device="cpu")),
                                      np.asarray(jharness.synth_modk(n, k, width)))


@pytest.mark.parametrize("n,k,width", [(5000, 8, 9), (2_200_000, 7, 5)])
def test_sliced_corpus_matches_jax(n, k, width):
    # 2.2M values make 576 block rows: two slices of at most 512
    dev = harness.synth_modk_packed_sliced(n, k, width, device="cpu")
    jdev = jlayout.pack_device(np.asarray(jharness.synth_modk(n, k, width)), width)
    assert dev.n == n and dev.width == width
    np.testing.assert_array_equal(dev.to_numpy(), np.asarray(jdev.tiles))


def test_result_line_matches_jax_and_parses():
    per = [1.25e-3, 1.5e-3, 1.0e-3]
    res = harness.BenchResult("cuda scan", timing.Measurement(1.25e-3, per, 40, "cuda events"),
                              500_000_000)
    jres = jharness.BenchResult("cuda scan", jtiming.Measurement(1.25e-3, per, 8, 136),
                                500_000_000)
    for roof in (None, 3.35e12):
        outs = []
        for fn, r in ((harness.print_result, res), (jharness.print_result, jres)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fn(r, roof)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]
        first, second = outs[0].splitlines()
        m = sweep.LINE_RE.match(first)
        assert m and m["name"] == "cuda scan" and float(m["avg"]) == 1.25
        assert float(sweep.GBS_RE.match(second)["gbs"]) == 400.0


def test_parse_size_matches_jax():
    for s in ("512m", "64k", "2g", "1000", "7M", "3K"):
        assert cli.parse_size(s) == jcli._parse_size(s)
    with pytest.raises(ValueError):
        cli.parse_size("12x")


def test_memcpy_plain_is_byte_exact():
    rng = np.random.default_rng(0)
    for nbytes in (1, 15, 17, 4097):
        src = torch.from_numpy(rng.integers(0, 256, size=nbytes, dtype=np.uint8))
        dst = torch.zeros_like(src)
        assert harness.memcpy(src, dst) is dst
        assert torch.equal(dst, src)
    x = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        harness.memcpy(x[:32], x[16:48])  # overlapping
    with pytest.raises(ValueError):
        harness.memcpy(x, torch.empty(63, dtype=torch.int32))
    assert int(harness.chain_memcpy(x.clone(), torch.empty_like(x), 3)) == 63


def test_hbm_peak_by_card_name():
    assert harness.hbm_peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert harness.hbm_peak_bytes_per_s("nvidia h100 80gb hbm3") == 3.35e12
    assert harness.hbm_peak_bytes_per_s("NVIDIA H200") == 4.8e12
    assert harness.hbm_peak_bytes_per_s("NVIDIA GH200 480GB") is None
    assert harness.hbm_peak_bytes_per_s("TPU v5 lite") is None


def test_cli_arguments():
    d, r = harness.DEFAULT_DATA_SIZE, harness.DEFAULT_REPETITIONS
    assert cli.parse_args([]) == (d, r, None, [], 9)
    assert cli.parse_args(["_", "_", "sharedscan", "64", "--width=5"]) == \
        (d, r, "sharedscan", ["64"], 5)
    assert cli.parse_args(["64m", "3", "all"]) == (64 << 20, 3, "all", [], 9)


def test_cli_refusals(capsys):
    assert cli.main(["_", "3", "nosuch"]) == 1
    assert "unknown bench 'nosuch'" in capsys.readouterr().err
    assert cli.main(["_", "3", "scaling", "8"]) == 1
    assert "ROADMAP Queue 1 item 12" in capsys.readouterr().err
    assert cli.main(["12x"]) == 1
    assert cli.main(["_", "two"]) == 1
    capsys.readouterr()
    if not torch.cuda.is_available():
        assert cli.main(["64k", "1", "memory"]) == 1
        out = capsys.readouterr()
        assert "no CUDA device" in out.err and "* " not in out.out


def _check_output(out: str, rows: int) -> None:
    lines = out.splitlines()
    starred = [i for i, line in enumerate(lines) if line.startswith("* ")]
    assert len(starred) == rows, out
    for i in starred:
        assert sweep.LINE_RE.match(lines[i]) and sweep.GBS_RE.match(lines[i + 1]), out
    for line in lines:
        if "verification:" in line:
            assert line.split("verification:")[1].strip() == "ok", out
        assert "FAILED" not in line, out


BENCHES = [  # (runner, keyword arguments, rows printed, verifications printed)
    (harness.bench_memory, dict(data_size=64 * 1024), 6, 0),
    (harness.bench_decompression, dict(), 3, 1),
    (harness.bench_scan, dict(), 2, 1),
    (harness.bench_shared_scan, dict(k=8), 7, 1),
    (harness.bench_shared_scan, dict(k=40), 8, 1),
    (harness.bench_linear, dict(k=8), 3, 1),
    (harness.bench_linear, dict(k=6), 2, 1),
    (harness.bench_aggregate, dict(), 1, 1),
    (harness.bench_histogram, dict(), 2, 1),
    (harness.bench_member, dict(), 3, 1),
    (harness.bench_conj, dict(m=3), 1, 1),
    (harness.bench_pack, dict(), 1, 1),
]


@pytest.mark.parametrize("runner,kw,rows,verifications", BENCHES,
                         ids=[f"{b[0].__name__}-{'-'.join(map(str, b[1].values()))}"
                              for b in BENCHES])
def test_bench_runs_on_cpu(capsys, runner, kw, rows, verifications):
    kw = dict(dict(data_size=SIZE, reps=2), **kw)
    results = runner(**kw, device="cpu")
    out = capsys.readouterr().out
    _check_output(out, rows)
    assert out.count("verification: ok") == verifications
    assert len(results) == rows
    assert all(r.meas.clock == "host" and r.meas.seconds > 0 for r in results)


def test_chain_drivers_return_the_last_calls_outputs():
    width, n = 9, 5000
    values = harness.synth_modk(n, 512, width, device="cpu")
    dev = unpack.pack_device_kernel(values, width)
    mdev = unpack.pack_device_kernel(harness.synth_ramp(n, 12, device="cpu"), 12)
    keys = (3, 70, 141, 200, 262, 333, 400, 511)
    count = sum((n - 1 - key) // 512 + 1 for key in keys)
    kt = torch.tensor(keys, dtype=torch.int32)
    t = dev.tiles
    for chain, args, kw in (
        (harness.chain_shared_scan, (t, kt), dict(width=width, n=n)),
        (harness.chain_chunked_shared_scan, (t, kt), dict(width=width, n=n)),
        (harness.chain_dynamic_shared_scan, (t, kt), dict(width=width, n=n)),
        (harness.chain_bitsliced_shared_scan, (t, kt), dict(width=width, n=n)),
        (harness.chain_sequential_shared_scan, (t, kt), dict(width=width, n=n)),
        (harness.chain_plain_shared_scan, (t, kt), dict(width=width, n=n)),
        (harness.chain_bitsliced_static_shared_scan, (t,), dict(width=width, n=n,
                                                               keys_tuple=keys)),
        (harness.chain_windowed_shared_scan, (t,), dict(width=width, n=n, keys_tuple=keys)),
        (harness.chain_member_scan, (t,), dict(width=width, n=n, keys_tuple=keys)),
    ):
        assert int(chain(*args, 2, **kw)) == count, chain.__name__
    assert int(harness.chain_interval_scan(t, 2, width=width, n=n, kk=8)) == \
        sum((n - 1 - key) // 512 + 1 for key in range(8))
    for sp in (None, True, False):
        assert int(harness.chain_histogram_dag(t, 2, width=width, n=n, kk=64, sp=sp)) == \
            int((values < 64).sum())
    assert int(harness.chain_histogram(t, 2, width=width, n=n, kk=64)) == int((values < 64).sum())
    sums, counts = aggregate.aggregate_scan_device(dev, mdev, np.arange(8, dtype=np.uint32))
    want = int(sums.sum() + counts.sum())
    for chain, kw in ((harness.chain_aggregate_scan, dict(kk=8)),
                      (harness.chain_aggregate_bitplane, dict(kk=8)),
                      (harness.chain_aggregate_bitplane_static, dict(keys_tuple=tuple(range(8))))):
        assert int(chain(t, mdev.tiles, 2, wp=width, wm=12, n=n, **kw)) == want, chain.__name__


@pytest.mark.parametrize("kk", [8, 24])
def test_linear_chain_relayouts_agree(kk):
    width, n = 9, 5000
    dev = unpack.pack_device_kernel(harness.synth_modk(n, kk, width, device="cpu"), width)
    lin = port.shared_scan_linear_device(dev, list(range(kk)))
    _, counts = port.shared_scan_device(dev, list(range(kk)))
    last_word = int(lin.view(torch.int32)[-1])
    want = {"fused": last_word + int(counts.sum()), "words": last_word,
            "twokernel": int(lin[-1]), "dispatch": int(lin[-1])}
    for relayout, value in want.items():
        got = harness.chain_linear_shared_scan(dev.tiles, 2, width=width, n=n, kk=kk,
                                               relayout=relayout)
        assert int(got) == value, relayout
    got = harness.chain_static_linear_shared_scan(dev.tiles, 2, width=width, n=n,
                                                  keys_tuple=tuple(range(kk)))
    assert int(got) == last_word + int(counts.sum())
    with pytest.raises(ValueError):
        harness.chain_linear_shared_scan(dev.tiles, 1, width=width, n=n, kk=6, relayout="fused")
    assert harness.check_linear_scan(dev, kk)


def test_cli_exits_non_zero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-m", "shared_simd_scan_tpu_torch.bench", "64k", "1",
                           "memory"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert not any(line.startswith("* ") for line in proc.stdout.splitlines())


def test_device_ms_reads_no_device_time_on_the_cpu():
    # the profiler helper names device operations only: a CPU run has none,
    # and its callers then write "not measured"
    calls = []
    assert timing.device_ms(lambda: calls.append(torch.ones(4) + 1), calls=3) == {}
    assert len(calls) == 4  # a warm-up call, then the profiled ones


def test_device_ms_writes_no_flush_buffer_on_the_cpu():
    # the L2 flush is a card's: on the CPU the helper still calls fn once to
    # warm up and then `calls` times, and reads no device time
    calls = []
    got = timing.device_ms(lambda: calls.append(torch.ones(4) + 1), calls=2,
                           flush_bytes=1 << 20)
    assert got == {} and len(calls) == 3
