"""The port's linear (interleaved) export against the JAX package.

On CPU tensors the port's wrappers run their plain torch versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_kernels.py
does, on that file's own cases.  Both get the same columns from a numpy
seed and must agree byte for byte (tolerance 0): the port's words read as
uint32 equal the JAX words, and its uint8 form the JAX uint8 form.  The
planners and both dispatchers' routes must make the JAX package's
decision on every k of the sweep; the routes are recorded by replacing the
tier functions of both packages.  Interpret-mode calls are few: each
compiles its kernel.  The CUDA kernels are held against the plain versions
in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shared_simd_scan_tpu import layout as jlayout
from shared_simd_scan_tpu.ops import linear as jlinear
from shared_simd_scan_tpu.ops import oracle as joracle
from shared_simd_scan_tpu.ops import scan as jscan
from shared_simd_scan_tpu_torch import layout as tlayout
from shared_simd_scan_tpu_torch.ops import linear as tlinear
from shared_simd_scan_tpu_torch.ops import oracle as toracle
from shared_simd_scan_tpu_torch.ops import scan as tscan

torch.set_num_threads(1)

N = 32 * 1024 - 5  # B1 = 8; the last block holds 27 values
INTERLEAVE_KS = (1, 3, 4, 6, 8, 12, 16, 24, 33, 64, 1024)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _column(width, n, seed):
    """(values, JAX DeviceColumn, port DeviceColumn crossed with from_jax_numpy)."""
    values = np.random.default_rng(seed).integers(0, 1 << width, size=n, dtype=np.uint64)
    values = values.astype(np.uint32)
    jdev = jlayout.pack_device(values, width)
    return values, jdev, tlayout.from_jax_numpy(width, n, np.asarray(jdev.tiles), "cpu")


def _linear_bytes(values, keys, width) -> np.ndarray:
    """numpy ground truth: byte g*k + j = byte g of key j's bitvector."""
    n, k = values.size, len(keys)
    nbytes = (n + 7) // 8
    eb = np.zeros((k, nbytes * 8), np.uint8)
    for j, key in enumerate(keys):
        if int(key) < 1 << width:
            eb[j, :n] = values == key
    return np.packbits(eb.reshape(k, nbytes, 8), axis=-1, bitorder="little").reshape(k, nbytes).T.reshape(-1)


def _assert_same(tout, jout):
    np.testing.assert_array_equal(_u32(tout[0]), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]).astype(np.int64))


# ---------------------------------------------------------------------------
# planners, oracle, interleave
# ---------------------------------------------------------------------------


def test_planners_match_jax():
    for k in range(1, 1101):
        assert tlinear._mxu_supported(k) == jlinear._mxu_supported(k), k
        assert tlinear._mxu_large_supported(k) == jlinear._mxu_large_supported(k), k
        assert tlinear._hier_group(k) == jlinear._hier_group(k), k
        run = (np.arange(k, dtype=np.uint32) + np.uint32(300)).astype(np.uint32)
        wrapped = (np.arange(k, dtype=np.uint64) + 0xFFFFFFFF - k // 2).astype(np.uint32)
        broken = run.copy()
        broken[-1] += np.uint32(2)
        for keys in (run, wrapped, broken, run[::-1].copy()):
            assert tscan._consecutive_lo(keys) == jscan._consecutive_lo(keys), (k, keys[:3])


@pytest.mark.parametrize("width", [1, 9, 13, 31])
def test_oracle_linear_matches_jax(width):
    rng = np.random.default_rng(width)
    n = 5003  # ragged: nbytes = 626, the last byte half full
    values = rng.integers(0, 1 << width, size=n, dtype=np.uint64).astype(np.uint32)
    jcol = jlayout.pack(values, width)
    tcol = tlayout.pack(values, width, device="cpu")
    for k in (1, 3, 6, 8, 24):
        keys = rng.integers(0, 1 << width, size=k).astype(np.uint32)
        keys[0] = values[0]
        if k > 2:
            keys[1] = keys[2]  # a duplicate
            keys[-1] = np.uint32(min((1 << width) + 1, 0xFFFFFFFF))  # out of the domain
        got = toracle.shared_scan_linear(tcol, keys)
        assert got.dtype == torch.uint8 and got.numel() == (n + 7) // 8 * k
        np.testing.assert_array_equal(got.numpy(), np.asarray(joracle.shared_scan_linear(jcol, keys)))
        np.testing.assert_array_equal(got.numpy(), _linear_bytes(values, keys, width))


@pytest.mark.parametrize("k", INTERLEAVE_KS)
def test_interleave_plain_matches_byte_transpose(k):
    # tests/test_kernels.py's numpy byte transpose, ragged word and byte counts
    rng = np.random.default_rng(k)
    for w in (1, 77, 257):
        bits = rng.integers(0, 2**32, size=(k, w), dtype=np.uint64).astype(np.uint32)
        tb = torch.from_numpy(bits.view(np.int32))
        for nbytes in (4 * w, 4 * w - 3):
            exp = bits.view(np.uint8).reshape(k, -1)[:, :nbytes].T.reshape(-1)
            total = nbytes * k
            words = tlinear.interleave_words(tb, -(-total // 4))
            assert words.dtype == torch.int32 and words.numel() == -(-total // 4)
            np.testing.assert_array_equal(words.numpy().view(np.uint8)[:total], exp)
            for out in (tlinear.interleave_tiles(tb, nbytes), tlinear.interleave_device(tb, nbytes)):
                np.testing.assert_array_equal(out.numpy(), exp)
        # rows of a wider buffer (the bits_to_canonical view) read in place
        wide = torch.zeros((k, w + 5), dtype=torch.int32)
        wide[:, :w] = tb
        np.testing.assert_array_equal(tlinear.interleave_words(wide[:, :w], w * k).numpy(),
                                      tlinear.interleave_words(tb, w * k).numpy())
    if tlinear._mxu_large_supported(k):
        np.testing.assert_array_equal(tlinear.interleave_words_large(tb, 4 * w).numpy(),
                                      tlinear.interleave_words(tb, w * k).numpy())
    else:
        with pytest.raises(ValueError, match="two-level interleave"):
            tlinear.interleave_words_large(tb, 4 * w)


@pytest.mark.parametrize("m,g", [(4, 2), (3, 2), (8, 2), (4, 128)])
def test_interleave_streams_plain_matches_numpy(m, g):
    # tests/test_kernels.py's stream interleave oracle, ragged M
    rng = np.random.default_rng(23)
    M = 1000
    streams = rng.integers(0, 2**32, size=(m, M), dtype=np.uint64).astype(np.uint32)
    Mp = -(-M // g) * g
    sp = np.zeros((m, Mp), np.uint32)
    sp[:, :M] = streams
    for nwords in (m * M - 5, m * Mp):
        exp = sp.reshape(m, Mp // g, g).transpose(1, 0, 2).reshape(-1)[:nwords]
        got = tlinear.interleave_streams_words(torch.from_numpy(streams.view(np.int32)), g, nwords)
        np.testing.assert_array_equal(_u32(got), exp)


# ---------------------------------------------------------------------------
# fused tiers: the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


def test_fused_interval_matches_jax():
    # k = 16 at lo = 500: keys 512..515 spill past the 9-bit domain; the
    # padded (B1, 128k) form under a block_offset that puts n's tail inside
    values, jdev, tdev = _column(9, N, 31)
    bo = 128
    jout = jscan.interval_scan_linear_words_tiles(jdev.tiles, 500, 16, 9, N + bo * 32,
                                                  interpret=True, block_offset=bo, flat=False)
    tout = tscan.interval_scan_linear_words_tiles(tdev.tiles, 500, 16, 9, N + bo * 32,
                                                  block_offset=bo, flat=False)
    assert tuple(tout[0].shape) == (8, 128 * 16) == tuple(jout[0].shape)
    _assert_same(tout, jout)
    words, counts = tscan.interval_scan_linear_words_tiles(tdev.tiles, 500, 16, 9, N)
    keys = np.arange(500, 516, dtype=np.uint32)
    np.testing.assert_array_equal(words.numpy().view(np.uint8), _linear_bytes(values, keys, 9))
    assert counts.tolist() == [int((values == key).sum()) for key in keys]


def test_fused_static_matches_jax():
    # k = 8 at width 13, spread keys, the last one out of the domain
    width = 13
    values, jdev, tdev = _column(width, N, 33)
    keys = (np.arange(8, dtype=np.uint32) * 97 + 11) % (1 << width)
    keys[-1] = (1 << width) + 3
    jout = jscan.static_scan_linear_words_tiles(jdev.tiles, keys, width, N, interpret=True)
    tout = tscan.static_scan_linear_words_tiles(tdev.tiles, keys, width, N)
    _assert_same(tout, jout)
    np.testing.assert_array_equal(tout[0].numpy().view(np.uint8), _linear_bytes(values, keys, width))
    flat, _ = tscan.static_scan_linear_words_tiles(tdev.tiles, keys, width, N, flat=False)
    np.testing.assert_array_equal(flat.reshape(-1)[: tout[0].numel()].numpy(), tout[0].numpy())


def test_fused_traced_matches_jax():
    # traced keys at k = 12, key 700 past the domain, under a block_offset
    values, jdev, tdev = _column(9, N, 39)
    keys = (np.arange(12, dtype=np.uint32) * 73 + 19) % 512
    keys[0] = 700
    bo, n = 128, N + 128 * 32
    jout = jax.jit(lambda kv: jscan.bitsliced_scan_linear_words_tiles(
        jdev.tiles, kv, 9, n, interpret=True, block_offset=bo))(jnp.asarray(keys))
    tout = tscan.bitsliced_scan_linear_words_tiles(
        tdev.tiles, torch.from_numpy(keys.view(np.int32)), 9, n, block_offset=bo)
    _assert_same(tout, jout)
    # host keys go to the same kernel (placed on the tiles' device)
    np.testing.assert_array_equal(
        tscan.bitsliced_scan_linear_words_tiles(tdev.tiles, keys, 9, n, block_offset=bo)[0].numpy(),
        tout[0].numpy())


def test_fused_static_large_matches_jax():
    # k = 24 shuffled (caller order kept): the JAX package's two-level
    # export, the port's one pass
    rng = np.random.default_rng(35)
    values, jdev, tdev = _column(9, N, 35)
    keys = np.unique(rng.integers(0, 512, 96, dtype=np.uint32))[:24]
    rng.shuffle(keys)
    jout = jscan.static_scan_linear_words_large(jdev.tiles, keys, 9, N, interpret=True)
    tout = tscan.static_scan_linear_words_large(tdev.tiles, keys, 9, N)
    _assert_same(tout, jout)
    # the other large forms give the same bytes for the same keys
    tkeys = torch.from_numpy(keys.view(np.int32))
    words, counts = tscan.bitsliced_scan_linear_words_large(tdev.tiles, tkeys, 24, 9, N)
    assert torch.equal(words, tout[0]) and torch.equal(counts, tout[1])
    run = np.arange(488, 512, dtype=np.uint32)
    words, _ = tscan.interval_scan_linear_words_large(tdev.tiles, 488, 24, 9, N)
    np.testing.assert_array_equal(words.numpy().view(np.uint8), _linear_bytes(values, run, 9))


def test_uint8_export_k6_and_words_refusal_match_jax():
    values, jdev, tdev = _column(9, N, 41)
    keys = np.arange(6, dtype=np.uint32)
    jout = np.asarray(jscan.shared_scan_linear_device(jdev, keys, interpret=True))
    tout = tscan.shared_scan_linear_device(tdev, keys)
    assert tout.dtype == torch.uint8 and jout.dtype == np.uint8
    np.testing.assert_array_equal(tout.numpy(), jout)
    np.testing.assert_array_equal(tout.numpy(), _linear_bytes(values, keys, 9))
    with pytest.raises(ValueError) as jerr:
        jscan.shared_scan_linear_words_device(jdev, keys)
    with pytest.raises(ValueError) as terr:
        tscan.shared_scan_linear_words_device(tdev, keys)
    assert str(terr.value) == str(jerr.value) == "words view needs k % 4 == 0; use the uint8 form"


def test_fused_refusals_match_jax():
    _, jdev, tdev = _column(9, 1000, 43)
    for k in (3, 20, 24):
        keys = np.arange(k, dtype=np.uint32)
        for jfn, tfn, args in (
            (jscan.interval_scan_linear_words_tiles, tscan.interval_scan_linear_words_tiles,
             (0, k, 9, 1000)),
            (jscan.static_scan_linear_words_tiles, tscan.static_scan_linear_words_tiles,
             (keys, 9, 1000)),
            (jscan.bitsliced_scan_linear_words_tiles, tscan.bitsliced_scan_linear_words_tiles,
             (keys, 9, 1000)),
        ):
            with pytest.raises(ValueError) as jerr:
                jfn(jdev.tiles, *args)
            with pytest.raises(ValueError) as terr:
                tfn(tdev.tiles, *args)
            assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="two-level"):
        tscan.static_scan_linear_words_large(tdev.tiles, np.arange(16, dtype=np.uint32), 9, 1000)


# ---------------------------------------------------------------------------
# dispatch: routes recorded in both packages
# ---------------------------------------------------------------------------

FUSED = ("interval_scan_linear_words_tiles", "interval_scan_linear_words_large",
         "static_scan_linear_words_tiles", "static_scan_linear_words_large",
         "bitsliced_scan_linear_words_tiles", "bitsliced_scan_linear_words_large")
ROUTE_KS = list(range(1, 37)) + [40, 44, 48, 60, 64, 68, 72, 96, 124, 128, 132, 136, 256]


class _Routes:
    """Replaces the tier functions of both dispatchers with recorders that
    return zeros of the right shape; ``take`` gives the recorded names."""

    def __init__(self, monkeypatch, n):
        self.log = []
        nbytes, w = (n + 7) // 8, (n + 31) // 32

        def rec(name, out):
            def fn(*args, **kwargs):
                self.log.append(name)
                # interval tiers take (tiles, lo, k, ...); the others keys second
                return out(int(args[2]) if name.startswith("interval") else int(args[1].shape[0]))
            return fn

        for name in FUSED:
            monkeypatch.setattr(jscan, name, rec(name, lambda k: (
                jnp.zeros(nbytes * k // 4, jnp.uint32), jnp.zeros(k, jnp.uint32))))
            monkeypatch.setattr(tscan, name, rec(name, lambda k: (
                torch.zeros(nbytes * k // 4, dtype=torch.int32), torch.zeros(k, dtype=torch.int64))))
        monkeypatch.setattr(jscan, "shared_scan_device", rec("shared_scan_device", lambda k: (
            jnp.zeros((k, w), jnp.uint32), jnp.zeros(k, jnp.uint32))))
        monkeypatch.setattr(tscan, "shared_scan_device", rec("shared_scan_device", lambda k: (
            torch.zeros((k, w), dtype=torch.int32), torch.zeros(k, dtype=torch.int64))))

        def relayout(name, out):
            def fn(bits, size, **kwargs):
                self.log.append(name)
                return out(int(bits.shape[0]), int(size))
            return fn

        # the JAX words fallback's relayout and the port's, then both uint8 ones
        monkeypatch.setattr(jlinear, "interleave_xla_stack", relayout(
            "interleave", lambda k, nb: jnp.zeros(nb * k, jnp.uint8)))
        monkeypatch.setattr(tlinear, "interleave_words", relayout(
            "interleave", lambda k, nw: torch.zeros(nw, dtype=torch.int32)))
        monkeypatch.setattr(jlinear, "interleave_device", relayout(
            "interleave_device", lambda k, nb: jnp.zeros(nb * k, jnp.uint8)))
        monkeypatch.setattr(tlinear, "interleave_device", relayout(
            "interleave_device", lambda k, nb: torch.zeros(nb * k, dtype=torch.uint8)))
        # a CPU tensor of keys stands for the port's CUDA-tensor keys here
        monkeypatch.setattr(tscan, "_is_runtime_keys", lambda keys: isinstance(keys, torch.Tensor))

    def take(self):
        out, self.log = self.log, []
        return out


def _route_keys(kind, k):
    if kind == "consecutive":
        return np.arange(5, 5 + k, dtype=np.uint32)
    return ((np.arange(k, dtype=np.uint32) * 37 + 11) % 512).astype(np.uint32)


@pytest.mark.parametrize("kind", ["consecutive", "spread", "runtime"])
def test_dispatch_routes_match_jax(kind, monkeypatch):
    n = 1000
    _, jdev, tdev = _column(9, n, 45)
    routes = _Routes(monkeypatch, n)
    for k in ROUTE_KS:
        keys = _route_keys("spread" if kind == "runtime" else kind, k)
        if kind == "runtime":
            tkeys = torch.from_numpy(keys.view(np.int32))

            def jwords(kv):
                return jscan.shared_scan_linear_words_device(jdev, kv)

            def jbytes(kv):
                return jscan.shared_scan_linear_device(jdev, kv)

            jcall = [lambda: jax.jit(jwords)(jnp.asarray(keys)),
                     lambda: jax.jit(jbytes)(jnp.asarray(keys))]
        else:
            tkeys = keys
            jcall = [lambda: jscan.shared_scan_linear_words_device(jdev, keys),
                     lambda: jscan.shared_scan_linear_device(jdev, keys)]
        tcall = [lambda: tscan.shared_scan_linear_words_device(tdev, tkeys),
                 lambda: tscan.shared_scan_linear_device(tdev, tkeys)]
        for form, (jc, tc) in enumerate(zip(jcall, tcall)):
            if form == 0 and k % 4:
                with pytest.raises(ValueError, match="k % 4 == 0"):
                    jc()
                with pytest.raises(ValueError, match="k % 4 == 0"):
                    tc()
                continue
            jout = jc()
            jroute = routes.take()
            tout = tc()
            troute = routes.take()
            assert troute == jroute and troute, (kind, k, form)
            assert tout.numel() * tout.element_size() == np.asarray(jout).nbytes, (kind, k, form)


def test_dispatch_matches_oracle_on_the_cpu():
    # every route end to end through the plain versions, against the oracle
    rng = np.random.default_rng(47)
    n = 20_001
    values = rng.integers(0, 512, size=n, dtype=np.uint64).astype(np.uint32)
    tcol = tlayout.pack(values, 9, device="cpu")
    tdev = tlayout.to_device(tcol)
    for keys in (list(range(8)), list(range(6)), [3, 70, 141, 200, 262, 333, 400, 511],
                 list(range(40, 64)), rng.choice(512, 20, replace=False).tolist(),
                 list(range(510, 514)) + [0xFFFFFFFF] * 4, rng.integers(0, 600, 132).tolist(), [9]):
        want = toracle.shared_scan_linear(tcol, keys)
        got = tscan.shared_scan_linear_device(tdev, keys)
        assert torch.equal(got, want), keys
        if len(keys) % 4 == 0:
            words = tscan.shared_scan_linear_words_device(tdev, keys)
            assert torch.equal(words.view(torch.uint8), want), keys
