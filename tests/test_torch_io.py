"""The port's persistence against the JAX package: one file format.

The same data (from a numpy seed) is saved by both packages.  The files
must be byte-identical (``MANIFEST.json`` included), a column, a table and
a bitvector written by either package must load in the other with equal
words, and every refusal must raise the JAX package's exception type and
message.  No kernel runs.
"""
import json

import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import bitvector as jbitvector
from shared_simd_scan_tpu import io as jio
from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu_torch import bitvector as tbitvector
from shared_simd_scan_tpu_torch import io as tio
from shared_simd_scan_tpu_torch import layout as tlayout

torch.set_num_threads(1)

N = 5001  # ragged: neither the column nor the bitvector ends on a word


def _values(width, seed, n=N):
    return np.random.default_rng(seed).integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)


def _words(col):
    """A column's canonical words as uint32 numpy, from either package."""
    if isinstance(col, tlayout.PackedColumn):
        return col.words.numpy().view(np.uint32)
    return np.asarray(col.words)


@pytest.mark.parametrize("width", [1, 9, 31])
def test_column_crosses_both_ways_byte_identical(tmp_path, width):
    vals = _values(width, seed=width)
    jcol = jlayout.pack(vals, width)
    tcol = tlayout.pack(vals, width, device="cpu")
    jio.save_column(jcol, tmp_path / "j.sss")
    tio.save_column(tcol, tmp_path / "t.sss")
    data = (tmp_path / "t.sss").read_bytes()
    assert data == (tmp_path / "j.sss").read_bytes()
    assert len(data) == 16 + tlayout.packed_nbytes(width, N)
    from_jax = tio.load_column(tmp_path / "j.sss", device="cpu")
    from_port = jio.load_column(tmp_path / "t.sss")
    assert (from_jax.width, from_jax.n) == (from_port.width, from_port.n) == (width, N)
    np.testing.assert_array_equal(_words(from_jax), _words(jcol))
    np.testing.assert_array_equal(_words(from_port), _words(tcol))
    assert from_jax.words.device.type == "cpu"


def test_table_crosses_both_ways_byte_identical(tmp_path):
    widths = {"price": 9, "region": 5, "status": 4}
    vals = {name: _values(w, seed=i) for i, (name, w) in enumerate(widths.items())}
    jio.save_table({k: jlayout.pack(v, widths[k]) for k, v in vals.items()}, tmp_path / "j")
    tio.save_table({k: tlayout.pack(v, widths[k], device="cpu") for k, v in vals.items()},
                   tmp_path / "t")
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "MANIFEST.json" in names
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    from_jax = tio.load_table(tmp_path / "j", device="cpu")
    from_port = jio.load_table(tmp_path / "t")
    assert list(from_jax) == list(from_port) == list(widths)
    for name, width in widths.items():
        assert from_jax[name].width == from_port[name].width == width
        np.testing.assert_array_equal(_words(from_jax[name]), _words(from_port[name]))


@pytest.mark.parametrize("n", [1, 32, N])
def test_bitvector_crosses_both_ways_byte_identical(tmp_path, n):
    mask = np.random.default_rng(n).random(n) < 0.3
    jbits = jbitvector.from_bool(mask)
    tbits = tbitvector.from_bool(torch.from_numpy(mask))
    jio.save_bitvector(jbits, n, tmp_path / "j.sss")
    tio.save_bitvector(tbits, n, tmp_path / "t.sss")
    assert (tmp_path / "t.sss").read_bytes() == (tmp_path / "j.sss").read_bytes()
    from_jax, n1 = tio.load_bitvector(tmp_path / "j.sss", device="cpu")
    from_port, n2 = jio.load_bitvector(tmp_path / "t.sss")
    assert n1 == n2 == n
    assert from_jax.dtype == torch.int32
    np.testing.assert_array_equal(from_jax.numpy().view(np.uint32), np.asarray(from_port))
    np.testing.assert_array_equal(from_jax.numpy().view(np.uint32), np.asarray(jbits))


def _column_file(tmp_path):
    col = jlayout.pack(_values(9, seed=3, n=5000), 9)
    jio.save_column(col, tmp_path / "col.sss")
    return tmp_path / "col.sss"


def _truncated_column(tmp_path):
    p = _column_file(tmp_path)
    p.write_bytes(p.read_bytes()[:-100])
    return lambda io, **kw: io.load_column(p, **kw)


def _truncated_bitvector(tmp_path):
    p = tmp_path / "bits.sss"
    jio.save_bitvector(jbitvector.from_bool(np.arange(10_000) % 3 == 0), 10_000, p)
    p.write_bytes(p.read_bytes()[:-10])
    return lambda io, **kw: io.load_bitvector(p, **kw)


def _wrong_kind(tmp_path):
    p = _column_file(tmp_path)
    return lambda io, **kw: io.load_bitvector(p, **kw)


def _wrong_kind_column(tmp_path):
    p = tmp_path / "bits.sss"
    jio.save_bitvector(jbitvector.from_bool(np.ones(64, bool)), 64, p)
    return lambda io, **kw: io.load_column(p, **kw)


def _mixed_n(tmp_path):
    def run(io, **kw):
        pk = jlayout.pack if io is jio else (lambda v, w: tlayout.pack(v, w, device="cpu"))
        io.save_table({"a": pk(np.arange(100, dtype=np.uint32) % 8, 3),
                       "b": pk(np.arange(200, dtype=np.uint32) % 8, 3)}, tmp_path / "t")
    return run


def _bad_name(tmp_path):
    def run(io, **kw):
        pk = jlayout.pack if io is jio else (lambda v, w: tlayout.pack(v, w, device="cpu"))
        io.save_table({".hidden": pk(np.arange(64, dtype=np.uint32) % 8, 3)}, tmp_path / "t")
    return run


def _escaping_manifest(tmp_path):
    jio.save_table({"a": jlayout.pack(np.arange(64, dtype=np.uint32) % 8, 3)}, tmp_path / "t")
    m = json.loads((tmp_path / "t" / "MANIFEST.json").read_text())
    m["../escape"] = m.pop("a")
    (tmp_path / "t" / "MANIFEST.json").write_text(json.dumps(m))
    return lambda io, **kw: io.load_table(tmp_path / "t", **kw)


def _manifest_disagrees(tmp_path):
    jio.save_table({"a": jlayout.pack(np.arange(64, dtype=np.uint32) % 8, 3)}, tmp_path / "t")
    jio.save_column(jlayout.pack(np.arange(64, dtype=np.uint32) % 8, 4), tmp_path / "t" / "a.sss")
    return lambda io, **kw: io.load_table(tmp_path / "t", **kw)


REFUSALS = {"truncated column": _truncated_column, "truncated bitvector": _truncated_bitvector,
            "bitvector file read as a column": _wrong_kind_column,
            "column file read as a bitvector": _wrong_kind, "mixed n": _mixed_n,
            "bad name": _bad_name, "escaping manifest": _escaping_manifest,
            "manifest disagrees": _manifest_disagrees}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(tmp_path, case):
    run = REFUSALS[case](tmp_path)
    with pytest.raises(Exception) as jerr:
        run(jio)
    with pytest.raises(Exception) as terr:
        run(tio, **({} if case in ("mixed n", "bad name") else {"device": "cpu"}))
    assert type(terr.value) is type(jerr.value) is ValueError
    assert str(terr.value) == str(jerr.value)
