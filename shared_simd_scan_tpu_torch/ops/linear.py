"""The linear (interleaved) output layout: the byte interleave.

PyTorch counterpart of ``shared_simd_scan_tpu/ops/linear.py``.  The linear
layout stores, for every 8-value group g, the k match bytes contiguously:
out byte ``g*k + j`` = byte g of key j's bitvector, the byte order of the
reference's ``shared_scan_128_linear_standard``.  The words form is the
same bytes read as little-endian uint32 words, and the uint8 form is a
free ``.view(torch.uint8)`` of it.

One kernel, ``sss_interleave`` (``csrc/linear.cu``), interleaves m byte
streams at a granularity of G bytes: G = 1, m = k turns (k, W) bitvectors
into the linear bytes for any k (:func:`interleave_words`), G = 4g
interleaves m word streams g words at a time
(:func:`interleave_streams_words`).  It replaces both TPU kernels of the
JAX module, the byte-level relayout and the stream interleave of its
two-level hierarchy.

Not ported, because they work around a TPU limit and are no kernel:
``_perm_matrix``, ``_word_perm_matrix``, ``_plane_dot_interleave`` (the
TPU's vector unit cannot spread 16 lanes to stride k, so the JAX package
places bytes with a 0/1 permutation matmul), ``interleave_xla_mxu*`` and
``interleave_xla_stack``.  For the same reason the functions here take no
``dot`` (the matmul's number format), ``tw`` (the VMEM tile) or
``interpret`` argument, and :func:`interleave_words_large` is the same
kernel in one pass instead of a hierarchy.  The planners
(:func:`_mxu_supported`, :func:`_mxu_large_supported`, :func:`_hier_group`)
are copied under their JAX names: they decide which k take the fused
scan-and-interleave kernels (``ops/scan.py``), so the two packages route
alike.
"""
from __future__ import annotations

import math

import torch

from shared_simd_scan_tpu_torch.ops import _cuda
from shared_simd_scan_tpu_torch.utils import profiling


def _mxu_supported(k: int) -> bool:
    """k of the JAX package's single-level fused tier: k % 4 == 0 and
    4 <= k <= 16."""
    return k % 4 == 0 and 4 <= k <= 16


def _hier_group(k: int) -> int:
    """Key-group size of the JAX package's two-level interleave: 8 when
    k % 8 == 0, else 4."""
    return 8 if k % 8 == 0 else 4


def _mxu_large_supported(k: int) -> bool:
    """k of the JAX package's two-level fused tier: k % 8 == 0 with
    24 <= k <= 128, or k % 4 == 0 with 20 <= k <= 64."""
    if k % 8 == 0:
        return 24 <= k <= 128
    return k % 4 == 0 and 20 <= k <= 64


# Staging of one sss_interleave CTA: about 32 KB of row segments, at most
# kInterleaveMaxSmem (csrc/linear.cu).
_STAGE_WORDS = 8192
_MAX_STAGE_BYTES = 200 * 1024


def _interleave_seg(m: int, granule: int) -> int:
    """Words of each row segment one ``sss_interleave`` CTA stages: a
    multiple of 4 (whole 16-byte output chunks) and of granule/4 (whole
    groups), about _STAGE_WORDS over the m rows."""
    unit = 4 if granule == 1 else math.lcm(4, granule // 4)
    seg = max(unit, (_STAGE_WORDS // m) // unit * unit)
    if m * (seg + 1) * 4 > _MAX_STAGE_BYTES:
        raise ValueError(f"interleave of {m} streams at {granule} bytes needs "
                         f"{m * (seg + 1) * 4} bytes of shared memory, more than {_MAX_STAGE_BYTES}")
    return seg


def _check_streams(name: str, src: torch.Tensor) -> tuple[int, int]:
    if src.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 (uint32 bits), got {src.dtype}")
    if src.ndim != 2 or src.shape[0] < 1:
        raise ValueError(f"{name}: expected a 2-D tensor of at least one row, got shape "
                         f"{tuple(src.shape)}")
    if src.stride(1) != 1 and src.shape[1] > 1:
        raise ValueError(f"{name}: rows must be contiguous")
    return int(src.shape[0]), int(src.shape[1])


def _interleave_plain(src: torch.Tensor, granule: int, nwords: int) -> torch.Tensor:
    """Plain torch interleave of the rows of ``src`` (int32 [m, L]) at
    ``granule`` bytes -> int32[nwords]: the byte transpose, rows
    zero-padded past their end."""
    m = src.shape[0]
    b = src.contiguous().view(torch.uint8)  # [m, 4L], little-endian
    nq = -(-4 * nwords // (m * granule))
    span = nq * granule
    if b.shape[1] < span:
        b = torch.cat([b, b.new_zeros((m, span - b.shape[1]))], dim=1)
    out = b[:, :span].reshape(m, nq, granule).transpose(0, 1).reshape(-1)[: 4 * nwords]
    return out.contiguous().view(torch.int32)


def _interleave(src: torch.Tensor, granule: int, nwords: int, device) -> torch.Tensor:
    """Launch ``sss_interleave`` on the rows of ``src`` -> int32[nwords]."""
    m, length = _check_streams("streams", src)
    out = torch.empty(nwords, dtype=torch.int32, device=device)
    _cuda.launch(
        "sss_interleave", device, src.data_ptr(), src.stride(0) * 4, length * 4, m, granule,
        _interleave_seg(m, granule), out.data_ptr(), nwords * 4,
    )
    return out


def interleave_words_plain(bits: torch.Tensor, nwords: int) -> torch.Tensor:
    """Plain torch version of :func:`interleave_words`:
    ``bits.view(torch.uint8).reshape(k, -1)[:, :nbytes].t()``, flattened."""
    _check_streams("bits", bits)
    return _interleave_plain(bits, 1, nwords)


def interleave_words(bits: torch.Tensor, nwords: int) -> torch.Tensor:
    """(k, W) int32 bitvectors (uint32 bits; rows contiguous, any row
    stride) -> int32[nwords] of the linear layout, for any k >= 1; bytes
    past the bitvectors' end are zero.

    Counterpart of the JAX package's ``interleave_mxu_words``, which takes
    4 <= k <= 16 with k % 4 == 0 only.  Kernel ``sss_interleave``
    (``csrc/linear.cu``) with G = 1 on CUDA tensors; the plain version on
    CPU tensors."""
    _check_streams("bits", bits)
    nwords = int(nwords)
    device = _cuda.kernel_device(bits)
    if device is None:
        return _interleave_plain(bits, 1, nwords)
    out = _interleave(bits, 1, nwords, device)
    profiling.count("launches.interleave_words")
    return out


def interleave_tiles(bits: torch.Tensor, nbytes: int) -> torch.Tensor:
    """uint8[nbytes * k] view of :func:`interleave_words`: out byte g*k + j
    = byte g of row j (the JAX package's ``interleave_mxu_tiles``)."""
    total = int(nbytes) * int(bits.shape[0])
    return interleave_words(bits, -(-total // 4)).view(torch.uint8)[:total]


def interleave_words_large(bits: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(k, W) bitvectors -> int32[nbytes*k/4] linear words for the k of the
    JAX package's two-level ``interleave_mxu_words_large``
    (:func:`_mxu_large_supported`); here the same kernel in one pass."""
    k = int(bits.shape[0])
    if not _mxu_large_supported(k):
        raise ValueError(f"two-level interleave needs k % 8 == 0 in 24..128 or k % 4 == 0 "
                         f"in 20..64, got {k}")
    return interleave_words(bits, int(nbytes) * k // 4)


def interleave_streams_words_plain(streams: torch.Tensor, g: int, nwords: int) -> torch.Tensor:
    """Plain torch version of :func:`interleave_streams_words`."""
    _check_streams("streams", streams)
    return _interleave_plain(streams, 4 * int(g), int(nwords))


def interleave_streams_words(streams: torch.Tensor, g: int, nwords: int) -> torch.Tensor:
    """(m, M) int32 word streams -> int32[nwords]: out word q*(m*g) + s*g +
    r = stream s word q*g + r, zero past a stream's M words (the JAX
    package's ``interleave_streams_mxu_words``, the second level of its
    two-level interleave).

    Kernel ``sss_interleave`` (``csrc/linear.cu``) with G = 4g on CUDA
    tensors; the plain version on CPU tensors."""
    _check_streams("streams", streams)
    g, nwords = int(g), int(nwords)
    if g < 1:
        raise ValueError(f"g must be >= 1, got {g}")
    device = _cuda.kernel_device(streams)
    if device is None:
        return _interleave_plain(streams, 4 * g, nwords)
    out = _interleave(streams, 4 * g, nwords, device)
    profiling.count("launches.interleave_streams_words")
    return out


def interleave_device(bits: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(k, W) bitvectors -> uint8[nbytes * k] linear bytes, any k.  Routes
    as the JAX package's ``interleave_device`` does (single-level k, the
    two-level k, every other k), though every route here is the one
    kernel."""
    k = int(bits.shape[0])
    if _mxu_large_supported(k):
        return interleave_words_large(bits, nbytes).view(torch.uint8)[: int(nbytes) * k]
    return interleave_tiles(bits, nbytes)


__all__ = [
    "interleave_words",
    "interleave_tiles",
    "interleave_words_large",
    "interleave_streams_words",
    "interleave_device",
]
