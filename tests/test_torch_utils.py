"""The port's utilities: debug dumps against the JAX package, and the
profiling tools on the CPU.

``dump_byte`` and ``dump_memory`` must print the JAX strings for the same
bytes, given as bytes, numpy, or an int32 tensor against a uint32 jax
array.  ``clock_ns``, ``ProfileSample`` (its line under ``SSS_PROFILING``),
``profile_block`` (a no-op without it) and ``trace`` (a Chrome trace file,
here of the CPU alone) are held to their contracts.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu.utils import debug as jdebug
from shared_simd_scan_tpu_torch import utils
from shared_simd_scan_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_dump_byte_matches_jax():
    for b in range(256):
        assert utils.dump_byte(b) == jdebug.dump_byte(b)
    assert utils.dump_byte(5) == "10100000"


@pytest.mark.parametrize("max_bytes", [0, 5, 8, 64, 1000])
def test_dump_memory_matches_jax(max_bytes):
    words = np.random.default_rng(max_bytes).integers(0, 1 << 32, 37, dtype=np.uint64)
    words = words.astype(np.uint32)
    want = jdebug.dump_memory(jnp.asarray(words), max_bytes=max_bytes)
    assert utils.dump_memory(torch.from_numpy(words.view(np.int32)), max_bytes=max_bytes) == want
    assert utils.dump_memory(words, max_bytes=max_bytes) == want
    assert utils.dump_memory(words.tobytes(), max_bytes=max_bytes) == want
    assert utils.dump_memory(bytearray(words.tobytes()), max_bytes=max_bytes) == \
        jdebug.dump_memory(bytearray(words.tobytes()), max_bytes=max_bytes)
    u8 = words.view(np.uint8)[:11]
    assert utils.dump_memory(torch.from_numpy(u8.copy()), max_bytes=max_bytes) == \
        jdebug.dump_memory(u8, max_bytes=max_bytes)


def test_dump_memory_reads_a_view_of_a_wide_tensor():
    t = torch.arange(64, dtype=torch.int64).reshape(8, 8).t()  # not contiguous
    assert utils.dump_memory(t, max_bytes=24) == \
        jdebug.dump_memory(np.ascontiguousarray(t.numpy()), max_bytes=24)


def test_clock_ns_is_a_delta_timer(monkeypatch):
    monkeypatch.setattr(profiling, "_last_ns", None)
    assert utils.clock_ns() == 0
    total = sum(utils.clock_ns() for _ in range(3))
    assert total >= 0 and profiling._last_ns is not None


def test_profile_sample_accumulates_and_prints(monkeypatch, capsys):
    utils.reset_samples()
    monkeypatch.setenv("SSS_PROFILING", "1")
    assert utils.profiling_enabled()
    for _ in range(2):
        with utils.ProfileSample("step", sync=True):
            torch.ones(10).sum()
    s = utils.get_sample("step")
    assert s.count == 2 and s.total_ns > 0 and s.avg_ns == s.total_ns / 2
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[1].startswith("[profile] step: ") and "over 2)" in out[1]
    with utils.profile_block("block"):
        pass
    assert utils.get_sample("block").count == 1
    utils.reset_samples()
    assert utils.get_sample("step").count == 0


@pytest.mark.parametrize("value", ["", "0", "false"])
def test_profile_block_is_a_no_op_without_the_switch(monkeypatch, capsys, value):
    utils.reset_samples()
    monkeypatch.setenv("SSS_PROFILING", value)
    assert not utils.profiling_enabled()
    with utils.profile_block("quiet"):
        pass
    with utils.ProfileSample("counted"):
        pass
    assert utils.get_sample("quiet").count == 0
    assert utils.get_sample("counted").count == 1
    assert capsys.readouterr().out == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with utils.trace(str(log_dir)) as d:
        assert d == str(log_dir)
        torch.ones(1000).cumsum(0)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
