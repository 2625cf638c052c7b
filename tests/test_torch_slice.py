"""The port's main path end to end against the JAX package, state carried
across the two packages, and the port's import boundary.

The slice: pack -> tile layout -> shared_scan_device keys 0..7 (interval
tier) -> scan_device (compare tier) -> unpack_device.  On the CPU the port
runs its plain versions and the JAX package its Pallas kernels in interpret
mode.  Integer results, tolerance 0.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.bench import harness as jharness
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu.ops import unpack as junpack
import shared_simd_scan_tpu_torch as port
from shared_simd_scan_tpu_torch.bench import harness as tharness

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _jax_slice(values, width):
    jdev = junpack.pack_device_kernel(jnp.asarray(values), width, interpret=True)
    bits8, counts8 = jscan.shared_scan_device(jdev, np.arange(8, dtype=np.uint32), interpret=True)
    bits1, count1 = jscan.scan_device(jdev, 3, interpret=True)
    back = junpack.unpack_device(jdev, interpret=True)
    return jdev, bits8, counts8, bits1, count1, back


@pytest.mark.parametrize("width,n,corpus", [(9, 32_000, "modk"), (9, 4241, "random"),
                                            (5, 20_000, "random"), (13, 777, "modk")])
def test_slice_matches_jax(width, n, corpus):
    if corpus == "modk":
        values = np.array(jharness.synth_modk(n, 8, width))
        np.testing.assert_array_equal(_u32(tharness.synth_modk(n, 8, width, device="cpu")), values)
    else:
        values = np.random.default_rng(n).integers(0, 1 << width, size=n).astype(np.uint32)
    jdev, jbits8, jcounts8, jbits1, jcount1, jback = _jax_slice(values, width)

    tdev = port.pack_device_kernel(torch.from_numpy(values.view(np.int32)), width)
    np.testing.assert_array_equal(tdev.to_numpy(), np.asarray(jdev.tiles))
    col_dev = port.to_device(port.pack(values, width, device="cpu"))
    np.testing.assert_array_equal(col_dev.to_numpy(), np.asarray(jdev.tiles))
    bits8, counts8 = port.shared_scan_device(tdev, list(range(8)))
    bits1, count1 = port.scan_device(tdev, 3)
    back = port.unpack_device(tdev)
    np.testing.assert_array_equal(_u32(bits8), np.asarray(jbits8))
    np.testing.assert_array_equal(counts8.numpy(), np.asarray(jcounts8))
    np.testing.assert_array_equal(_u32(bits1), np.asarray(jbits1))
    assert int(count1) == int(jcount1) == int(np.sum(values == 3))
    np.testing.assert_array_equal(_u32(back), np.asarray(jback))
    np.testing.assert_array_equal(_u32(back), values)
    assert tharness.check_shared_scan(tdev, np.arange(8), torch.from_numpy(values.view(np.int32)))


def test_jax_column_scans_the_same_in_the_port():
    width, n = 9, 30_001
    values = np.random.default_rng(5).integers(0, 1 << width, size=n).astype(np.uint32)
    jdev = jlayout.pack_device(values, width)
    tdev = port.from_jax_numpy(width, n, np.asarray(jdev.tiles), device="cpu")
    for keys in (np.arange(8, dtype=np.uint32), np.array([0], np.uint32),
                 np.array([7, 300, 511], np.uint32)):
        jbits, jcounts = jscan.shared_scan_device(jdev, keys, interpret=True)
        tbits, tcounts = port.shared_scan_device(tdev, keys)
        np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))


def test_port_column_scans_the_same_in_jax():
    width, n = 11, 25_000
    values = np.random.default_rng(6).integers(0, 1 << width, size=n).astype(np.uint32)
    tdev = port.pack_device_kernel(torch.from_numpy(values.view(np.int32)), width)
    jdev = jlayout.DeviceColumn(width=width, n=n, tiles=jnp.asarray(tdev.to_numpy()))
    keys = np.arange(100, 120, dtype=np.uint32)
    jbits, jcounts = jscan.shared_scan_device(jdev, keys, interpret=True)
    tbits, tcounts = port.shared_scan_device(tdev, keys)
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(np.asarray(junpack.unpack_device(jdev, interpret=True)), values)


def test_scan_device_takes_host_keys_in_every_form():
    width, n = 9, 3000
    values = np.random.default_rng(8).integers(0, 1 << width, size=n).astype(np.uint32)
    tdev = port.pack_device(values, width, device="cpu")
    want = int(np.sum(values == values[0]))
    for key in (int(values[0]), np.uint32(values[0]), [int(values[0])],
                torch.tensor(int(values[0])), torch.tensor([int(values[0])], dtype=torch.int32)):
        _, count = port.scan_device(tdev, key)
        assert int(count) == want
    with pytest.raises(ValueError):
        port.scan_device(tdev, [1, 2])


def test_values_for_matches_jax():
    for size in (1, 64, 500 * 1024 * 1024, 512 * 1024 * 1024):
        for width in (1, 9, 31):
            assert tharness.values_for(size, width) == jharness.values_for(size, width)


def _run(args, cwd, env_extra=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import shared_simd_scan_tpu_torch\n"
        "from shared_simd_scan_tpu_torch import bitvector, layout\n"
        "from shared_simd_scan_tpu_torch.ops import _cuda, oracle, scan, unpack\n"
        "from shared_simd_scan_tpu_torch.bench import cli, harness, timing\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'shared_simd_scan_tpu' not in sys.modules\n"
        "print('ok')\n"
    )
    proc = _run(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_a_card(tmp_path):
    # without CUDA the script exits non-zero and prints no result line
    proc = _run([str(REPO / "chip_smoke.py")], cwd=REPO, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    # alone in a directory, without the package, it fails too
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([str(tmp_path / "chip_smoke.py")], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
