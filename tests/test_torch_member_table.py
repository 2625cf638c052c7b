"""The member compare and window bodies as one lookup a value in a table
built from their operand: the port's plain table build against the JAX
package's set table and bodies.

``member_operand_table_plain`` is the plain version of the table the CUDA
kernels build on the card from keys or windows in device memory
(``csrc/member.cu``).  It must hold the set each JAX body matches (keys,
or ``_onehot32(v - base) & popmask`` for each window) in
``member_set_table``'s layout: the bitmap up to width 16; past it sorted
bases padded with 0xFFFFFFFF to a power of two set by the row count, each
run's OR of popmasks in its last entry.  The lookup of that table and the
four wrappers' plain versions must give the JAX bodies' words and counts
(interpret mode), bit for bit.  The kernels are held against these plain
versions on the card in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import member as jmember
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import member as tmember
from shared_simd_scan_tpu_torch.ops.scan import _block_values_plain

torch.set_num_threads(1)

N = 4241  # b1 = 8: the last block holds 17 values, then padding blocks
U32 = 0xFFFFFFFF


def _t32(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.uint64).astype(np.uint32).view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _column(width, seed):
    values = np.random.default_rng(seed).integers(0, 1 << width, size=N, dtype=np.uint64)
    values = values.astype(np.uint32)
    jdev = jlayout.pack_device(values, width)
    return values, jdev, tlayout.from_jax_numpy(width, N, np.asarray(jdev.tiles), "cpu")


def _edge_keys(width, values, k=4, seed=0):
    """Drawn keys, a duplicate, key 0, keys at and past 2^width, 0xFFFFFFFF
    and two of the column's values, unsorted."""
    dom = 1 << width
    keys = np.random.default_rng(seed).integers(0, dom, size=k).tolist()
    keys += [keys[0], 0, dom - 1, dom, dom + 33, U32, int(values[3]), int(values[8])]
    return np.random.default_rng(seed + 1).permutation(np.asarray(keys, np.uint64)).tolist()


def _edge_windows(width, values, seed=0):
    """Windows (base, popmask), unsorted: aligned and unaligned bases, a row
    straddling 2^width, one past the domain, one near 2^32 whose popmask
    wraps to the lowest values, a base given twice, and zero-popmask
    padding."""
    dom = 1 << width
    rng = np.random.default_rng(seed)
    v = [int(x) for x in values[:6]]
    win = [(v[0] & ~31, 1 << (v[0] & 31)),          # aligned, hits a column value
           (v[1], 0b1011),                            # unaligned at the value itself
           (max(v[2] - 5, 0), 0xF0F0F0F1),            # unaligned, past the next word
           ((dom - 7) % (1 << 32), 0xFFFF),           # straddles 2^width
           (dom + 64, 0xFFFFFFFF),                     # past the domain
           (U32 - 15, (1 << 20) | (1 << 3)),          # wraps: bit 20 is value 4
           (v[1], 1 << 4),                             # the same base again
           (int(rng.integers(0, dom)), int(rng.integers(1, 1 << 32))),
           (0, 0), (v[3], 0)]                          # zero popmasks: padding
    order = np.random.default_rng(seed + 1).permutation(len(win))
    return np.asarray([win[i] for i in order], np.uint64)


def _keys_rows(width, rows, seed):
    """``rows`` keys: spread over twice the domain, with duplicates."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 << width, size=rows)
    keys[rows // 2:: 97] = keys[0]
    return keys.astype(np.uint64)


def _windows_rows(width, rows, seed):
    """``rows`` windows with any base below 2^width + 64 and any popmask
    (some empty), duplicate bases among them."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, (1 << width) + 64, size=rows)
    bases[rows // 2:: 89] = bases[0]
    pops = rng.integers(0, 1 << 32, size=rows)
    pops[:: 13] = 0
    return np.stack([bases, pops], axis=1).astype(np.uint64)


def _matched(width, keys=None, win=None) -> list:
    """The values below 2^width the JAX bodies match: the keys, or
    ``(base + j) mod 2^32`` for each bit j of each window's popmask."""
    dom = 1 << width
    if keys is not None:
        return sorted({int(k) for k in keys if int(k) < dom})
    out = set()
    for base, pop in np.asarray(win, np.uint64).tolist():
        out.update((base + j) % (1 << 32) for j in range(32) if pop >> j & 1)
    return sorted(v for v in out if v < dom)


def _assert_layout(width, table, matched, nrows):
    """``table`` is member_set_table's of the matched set: the same bitmap;
    past width 16 the same windows, each in the last entry of its run,
    sorted bases padded with 0xFFFFFFFF to P (from the row count), 0
    popmasks elsewhere."""
    want = _u32(tmember.member_set_table(width, matched))
    got = _u32(table)
    if width <= tmember.MAX_DOMAIN_WIDTH:
        np.testing.assert_array_equal(got, want)
        return
    p = 1 << max(0, nrows - 1).bit_length()
    assert got.shape == (2, p)
    bases, pops = got[0].astype(np.int64), got[1]
    assert (np.diff(bases) >= 0).all()
    last = np.append(bases[1:] != bases[:-1], True) & (bases != U32)
    m = int((want[0] != U32).sum())
    np.testing.assert_array_equal(bases[last], want[0, :m])
    np.testing.assert_array_equal(pops[last], want[1, :m])
    assert not pops[~last].any()
    assert (bases[np.flatnonzero(last)[-1] + 1 if m else 0:] == U32).all()


def _lookup(tiles, width, table, block_offset=0):
    """The plain lookup of a table (bitmap, or the search's last base at or
    below v & ~31), as the kernels do it."""
    vals = _block_values_plain(tiles, width)
    row = tmember._bitmap_row_plain if width <= tmember.MAX_DOMAIN_WIDTH \
        else tmember._search_row_plain
    return tmember._member_finish(row(vals, table), N, block_offset)


def _assert_same(tout, jout):
    np.testing.assert_array_equal(_u32(tout[0]), np.asarray(jout[0]))
    assert int(tout[1]) == int(jout[1])


# ---------------------------------------------------------------------------
# the plain table build against member_set_table
# ---------------------------------------------------------------------------

TABLE_WIDTHS = [1, 5, 16, 17, 20, 31]
OPERANDS = ["edge keys", "edge windows", "1 key", "1 window", "4096 keys", "4097 keys",
            "4096 windows", "4097 windows"]


def _operand(kind, width, values):
    """(keys, win): one of them an array."""
    count = int(kind.split()[0]) if kind[0].isdigit() else None
    if kind == "edge keys":
        return _edge_keys(width, values), None
    if kind == "edge windows":
        return None, _edge_windows(width, values)
    if kind == "1 key":
        return [int(values[5])], None
    if kind == "1 window":
        return None, np.asarray([[int(values[5]) - 3 & U32, 0b11000]], np.uint64)
    if kind.endswith("keys"):
        return _keys_rows(width, count, count + width), None
    return None, _windows_rows(width, count, count + width)


@pytest.mark.parametrize("kind", OPERANDS)
@pytest.mark.parametrize("width", TABLE_WIDTHS)
def test_operand_table_plain_matches_member_set_table(width, kind):
    values = np.random.default_rng(width).integers(0, 1 << width, size=64).astype(np.uint32)
    keys, win = _operand(kind, width, values)
    if keys is not None:
        table = tmember.member_operand_table(width, keys=_t32(keys))  # CPU: the plain build
        nrows = len(keys)
    else:
        table = tmember.member_operand_table(width, win=_t32(win).reshape(-1, 2))
        nrows = 2 * len(win)
    matched = _matched(width, keys, win)
    _assert_layout(width, table, matched, nrows)
    if width <= tmember.MAX_DOMAIN_WIDTH:
        want = np.asarray(jmember.domain_table(np.asarray(matched, np.uint32), width)).reshape(-1)
        np.testing.assert_array_equal(_u32(table), want)


def test_operand_table_sizes_come_from_the_shape():
    # one row more doubles P past width 16: the duplicate halves of
    # unaligned windows count, whatever the operand holds
    for width, nrows, size in ((9, 3, 16), (16, 9000, 2048), (17, 1, 1), (17, 2, 2), (17, 3, 4),
                               (20, 4096, 4096), (20, 4097, 8192), (31, 8194, 16384)):
        assert tmember._operand_table_size(width, nrows) == size
    zeros = _t32(np.zeros((5, 2), np.uint64))
    table = tmember.member_operand_table_plain(20, win=zeros)
    assert table.shape == (2, 16) and (_u32(table[0]) == U32).all() and not table[1].any()


# ---------------------------------------------------------------------------
# the four bodies: the table's lookup and the wrappers' plain versions
# against the JAX bodies (interpret mode)
# ---------------------------------------------------------------------------

BODY_CASES = [
    # body, width, block_offset: both sides of the 16/17 switch
    ("compare", 1, 0), ("compare", 31, 7), ("chunked_compare", 17, 3),
    ("window", 16, 7), ("window", 20, 0), ("chunked_window", 17, 5),
]


@pytest.mark.parametrize("body,width,bo", BODY_CASES)
def test_bodies_as_table_lookups_match_jax(body, width, bo):
    values, jdev, tdev = _column(width, seed=width + 40)
    if body.endswith("compare"):
        keys = _edge_keys(width, values, seed=width)
        if body == "chunked_compare":  # chunks of 8, a duplicate across them, padding
            keys = keys + [keys[2]] + [U32] * ((-(len(keys) + 1)) % 8)
        operand = _t32(keys)
        j_operand = jnp.asarray(np.asarray(keys, np.uint32).reshape(-1, 1))
        table = tmember.member_operand_table_plain(width, keys=operand)
        matched = _matched(width, keys=keys)
    else:
        win = _edge_windows(width, values, seed=width)
        if body == "chunked_window":  # chunks of 4: a base repeated across two
            win = np.concatenate([win, win[[1, 3]], np.zeros((4, 2), np.uint64)])
        operand = _t32(win).reshape(-1, 2)
        j_operand = jnp.asarray(win.astype(np.uint32))
        table = tmember.member_operand_table_plain(width, win=operand)
        matched = _matched(width, win=win)
    gateless = jscan.shift_saturates(interpret=True)
    if body == "compare":
        jout = jmember._member_compare_tiles(jdev.tiles, j_operand, width, N, None, True, bo)
        tout = tmember._member_compare_tiles(tdev.tiles, operand, width, N, bo)
    elif body == "chunked_compare":
        jout = jmember._member_chunked_compare_tiles(jdev.tiles, j_operand, width, N, None, True,
                                                     8, bo)
        tout = tmember._member_chunked_compare_tiles(tdev.tiles, operand, width, N, 8, bo)
    elif body == "window":
        jout = jmember._member_window_tiles(jdev.tiles, j_operand, width, N, None, True,
                                            gateless, bo)
        tout = tmember._member_window_tiles(tdev.tiles, operand, width, N, bo)
    else:
        jout = jmember._member_chunked_window_tiles(jdev.tiles, j_operand, width, N, None, True,
                                                    4, gateless, bo)
        tout = tmember._member_chunked_window_tiles(tdev.tiles, operand, width, N, 4, bo)
    _assert_same(tout, jout)
    _assert_same(_lookup(tdev.tiles, width, table, bo), jout)
    if bo == 0:
        assert int(tout[1]) == int(np.isin(values, np.asarray(matched, np.uint32)).sum()) >= 1


LARGE_CASES = [(16, "keys", 4097), (20, "keys", 4097), (17, "windows", 4097),
               (9, "windows", 1), (20, "keys", 1)]


@pytest.mark.parametrize("width,kind,rows", LARGE_CASES)
def test_large_operands_match_the_plain_bodies(width, kind, rows):
    # past 4096 rows (the build's sort in chunks on the card): the table's
    # lookup equals the wrapper's plain version, one compare or one-hot
    # per key or window, and the matched values' count
    values, _, tdev = _column(width, seed=width + 50)
    if kind == "keys":
        keys = np.concatenate([_keys_rows(width, rows - 1, rows) if rows > 1 else [],
                               values[[9]]]).astype(np.uint64)
        operand = _t32(keys)
        table = tmember.member_operand_table_plain(width, keys=operand)
        plain = tmember._member_compare_tiles(tdev.tiles, operand, width, N, 1)
        matched = _matched(width, keys=keys)
    else:
        win = _windows_rows(width, rows, rows + width)
        win[-1] = (int(values[4]) - 2, 0b100)
        operand = _t32(win).reshape(-1, 2)
        table = tmember.member_operand_table_plain(width, win=operand)
        plain = tmember._member_window_tiles(tdev.tiles, operand, width, N, 1)
        matched = _matched(width, win=win)
    got = _lookup(tdev.tiles, width, table, 1)
    assert torch.equal(got[0], plain[0]) and int(got[1]) == int(plain[1])
    got0 = _lookup(tdev.tiles, width, table)
    assert int(got0[1]) == int(np.isin(values, np.asarray(matched, np.uint32)).sum()) >= 1
