"""The port's windowed tier, its planners, and the full dispatcher against
the JAX package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same inputs from a numpy seed and must agree bit for bit (integer
words and counts, tolerance 0).  Each interpret-mode call compiles per key
set, so there are few of them.  The CUDA kernel is held against the plain
version in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _columns(width, n, seed):
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    return values, jlayout.pack_device(values, width), tlayout.pack_device(values, width, device="cpu")


def _assert_same(tout, jout):
    tbits, tcounts = tout
    jbits, jcounts = jout
    np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts).astype(np.int64))


def _sweep_sets(rng):
    for width in (1, 3, 9, 16, 31):
        dom = 1 << width
        for k in range(1, 301, 7):
            lo = int(rng.integers(0, dom))
            yield (lo + rng.integers(0, 40, size=k)) % dom                     # clustered
            yield rng.integers(0, dom, size=k)                                   # spread
            yield (lo + np.arange(k)[::-1]) % dom                                # reversed
            yield np.where(rng.random(k) < 0.3, dom + rng.integers(0, 99, size=k),
                           np.repeat(rng.integers(0, dom, size=k), 1))           # out of domain
            yield np.repeat(rng.integers(0, dom, size=(k + 1) // 2), 2)[:k]      # duplicates


def test_window_planners_match_jax():
    rng = np.random.default_rng(0)
    for keys in _sweep_sets(rng):
        keys = keys.astype(np.uint32)
        assert tscan._window_plan(keys) == jscan._window_plan(keys)
        assert tscan._window_chunks(keys) == jscan._window_chunks(keys)
        assert tscan.windowed_cost(keys) == jscan.windowed_cost(keys)


def _walk_tables(vals, valid, plan, k, nwin, nd, ndup, width):
    """What sss_windowed_lookup does with one launch's tables, in torch:
    each value's window slot (the direct table up to width 17, else the
    fixed-trip binary search of the padded windows) and from the slot's
    mask and first index the first row holding its key; then the rows a
    group of 64 at a time, last group first: row j is the row of rep[j]
    while that lies in the group (else zero), and the group's list of later
    duplicates stores theirs; each row counted, a duplicate by its first."""
    p = torch.from_numpy(plan.view(np.uint32).astype(np.int64))
    ngroups = -(-k // 64)
    win, mask, first = p[:nwin], p[nwin : 2 * nwin], p[2 * nwin : 3 * nwin]
    lst = p[3 * nwin : 3 * nwin + nd]
    rep = p[3 * nwin + nd : 3 * nwin + nd + k]
    dstart = p[3 * nwin + nd + k : 3 * nwin + nd + k + ngroups + 1]
    dlist = p[3 * nwin + nd + k + ngroups + 1 :]
    assert dlist.shape[0] == ndup
    wm_mask = torch.cat([mask, torch.zeros(1, dtype=torch.int64)])  # slot nwin: no window
    wm_first = torch.cat([first, torch.zeros(1, dtype=torch.int64)])
    if width <= 17:
        table = torch.full((max(1 << max(width - 5, 0), 1),), nwin, dtype=torch.int64)
        table[win] = torch.arange(nwin)
    else:
        span = 1
        while span < nwin:
            span <<= 1
        padded = torch.cat([win, torch.full((span - nwin,), 0xFFFFFFFF, dtype=torch.int64)])
    zr = min(k, 64)
    rows = torch.zeros((k + 1,) + tuple(vals[0].shape), dtype=torch.int64)  # row k: no key
    for r, v in enumerate(vals):
        w = v >> 5
        if width <= 17:
            slot = table[w]
        else:
            slot = torch.zeros_like(w)
            half = span >> 1
            while half:
                slot += half * (padded[slot + half - 1] < w)
                half >>= 1
            slot = torch.where(padded[slot] == w, slot, nwin)
        o = v & 31
        m = wm_mask[slot]
        below = m & ((1 << o) - 1)
        pop = sum((below >> i) & 1 for i in range(32))
        at = (wm_first[slot] + pop).clamp(max=max(nd - 1, 0))
        idx = torch.where((m >> o) & 1 == 1, lst[at] if nd else torch.zeros_like(v), k)
        rows.scatter_add_(0, idx[None], torch.full(idx[None].shape, 1 << r, dtype=torch.int64))
    out, cnt = [None] * k, [0] * k
    for g0 in range((k - 1) // 64 * 64, -1, -64):
        for j in range(g0, min(g0 + 64, k)):
            slot = int(rep[j]) - g0
            word = rows[int(rep[j])] if 0 <= slot < zr else torch.zeros_like(rows[0])
            out[j] = word & valid
            cnt[j] = int(tscan.popcount_words(out[j]).sum())
        gi = g0 // 64
        for i in range(int(dstart[gi]), int(dstart[gi + 1])):
            j = int(dlist[i])
            out[j] = rows[int(rep[j])] & valid
    counts = [cnt[int(r)] if int(r) != tscan._NO_ROW else 0 for r in rep]
    return torch.stack(out), counts


@pytest.mark.parametrize("width,k", [(3, 4), (9, 48), (17, 65), (18, 300), (31, 2100)])
def test_window_tables_compute_the_plain_rows(width, k):
    # each launch's tables, walked as the kernel walks them, give the plain
    # version's words and counts: the direct table (widths 3-17) and the
    # search (18, 31), one pass (k <= 64) and passes of 64 rows, launches of
    # 1024; every case holds duplicates (across passes and launches) and
    # keys >= 2^width
    n = 4241
    values, _, tdev = _columns(width, n, seed=k)
    rng = np.random.default_rng(k)
    near = (int(values[0]) + rng.integers(0, min(1 << width, 3000), size=k)) % (1 << width)
    keys = np.where(rng.random(k) < 0.5, values[rng.integers(0, n, size=k)], near).tolist()
    keys[k // 2] = keys[-1] = keys[0]  # across passes of 64 rows, and launches
    keys[1] = 1 << width
    keys[2] = 0xFFFFFFFF
    vals = tscan._block_values_plain(tdev.tiles, width)
    valid = tscan._valid_words(tdev.tiles.shape[1], n, 0, "cpu")
    launches = tscan._window_tables_on(tuple(keys), width, torch.device("cpu"))
    assert [r0 for r0, *_ in launches] == list(range(0, k, tscan.MAX_LAUNCH_KEYS))
    words, counts = [], []
    for r0, rows, plan, nwin, nd, ndup in launches:
        got_w, got_c = _walk_tables(vals, valid, plan.numpy(), rows, nwin, nd, ndup, width)
        words.append(got_w)
        counts += got_c
    want = tscan.windowed_scan_tiles_plain(tdev.tiles, keys, width, n)
    np.testing.assert_array_equal(_u32(tlayout.i32(torch.cat(words))), _u32(want[0]))
    assert counts == want[1].tolist()


WINDOWED_CASES = [
    # width, n, keys, block_offset
    (9, 4241, [0, 2, 4, 6], 0),
    (9, 30_000, [7, 6, 5, 4, 3, 2, 1, 0], 8 * 128 * 3 - 200),  # reversed run, a shard's end
    (3, 4241, [1, 1, 5, 8, 9, 1 << 31, 0xFFFFFFFF], 0),       # duplicates, out of domain
    (17, 4241, "clustered20", 0),
    (9, 4241, "clustered64", 0),                                # k > 48: the chunked kernel
    (17, 4241, "clustered50", 0),     # the card's direct window table; k > 48 in JAX
    (31, 4241, "clustered40", 0),     # the card's search of the sorted windows
]


@pytest.mark.parametrize("width,n,keys,offset", WINDOWED_CASES)
def test_windowed_tiles_matches_jax(width, n, keys, offset):
    values, jdev, tdev = _columns(width, n, seed=width + n)
    if isinstance(keys, str):
        k = int(keys[len("clustered"):])
        rng = np.random.default_rng(k)
        keys = ((int(values[0]) + rng.integers(0, 70, size=k)) % (1 << width)).tolist()
        keys[-1] = 1 << width
    jout = jscan.windowed_scan_tiles(jdev.tiles, keys, width, n, interpret=True,
                                     block_offset=offset)
    tout = tscan.windowed_scan_tiles(tdev.tiles, keys, width, n, offset)
    _assert_same(tout, jout)
    if offset == 0:
        assert tout[1].tolist() == [int(np.sum(values == np.uint32(key))) for key in keys]


# ---------------------------------------------------------------------------
# the full dispatcher
# ---------------------------------------------------------------------------

DEVICE_SETS = [
    ("interval", list(range(100, 120))),
    ("windowed", [0, 1, 2, 4, 5, 6, 7, 7]),                                    # duplicate
    ("bitsliced_static", [3, 70, 141, 200, 262, 333, 400, 511, 70, 1 << 31]),  # out of domain
    ("compare", [5, 300, 0xFFFFFFFF]),
]


@pytest.mark.parametrize("tier,keys", DEVICE_SETS)
def test_shared_scan_device_matches_jax_for_every_tier(tier, keys):
    width, n = 9, 20_001
    values, jdev, tdev = _columns(width, n, seed=len(keys))
    arr = np.asarray(keys, np.uint32)
    assert tscan.pick_concrete_tier(width, arr) == jscan.pick_concrete_tier(width, arr)
    assert tscan.pick_concrete_tier(width, arr)[0] == tier
    jbits, jcounts = jscan.shared_scan_device(jdev, arr, interpret=True)
    for given in (keys, arr, torch.from_numpy(arr.view(np.int32))):  # every host form
        tbits, tcounts = tscan.shared_scan_device(tdev, given)
        np.testing.assert_array_equal(_u32(tbits), np.asarray(jbits))
        np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.tolist() == [int(np.sum(values == key)) for key in arr]
