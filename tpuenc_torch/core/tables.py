"""Static coding tables: zigzag, quantization presets, Huffman tables.

Copy of ``tpuenc.core.tables`` (pure numpy): the reference's table layer
(``src/quantization.rs``, ``src/huffman.rs``,
zigzag at ``writer.rs:64-68``):

* Quantization presets are the standard published tables (ITU T.81 Annex K
  and the mozjpeg jcparam.c perceptual variants) with libjpeg quality
  scaling.  Values are premultiplied by 8 to cancel the x8 DCT output scale
  and converted to (reciprocal, correction) pairs for exact integer division
  via multiply-shift (quantization.rs:185-207) — two int32 vectors
  consumed by the quantize kernel.
* Huffman tables are the Annex K.3 defaults plus the Annex K.2 optimized
  construction (huffman.rs:99-221), including the 16-bit length limit.  Tables are
  exported both as (size,code) numpy lookup vectors for device-side symbol
  sizing and as (lengths, values) for DHT segment emission.

All table construction is cold-path host code; only the resulting constant
arrays touch the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np

# Figure A.6 zigzag order (reference writer.rs:64-68): ZIGZAG[i] is the
# natural (row-major) index of the i-th coefficient in zigzag order.
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# -----------------------------------------------------------------------------
# Quantization presets (ITU T.81 Annex K + mozjpeg jcparam.c variants).
# Order matches the reference's QuantizationTableType::index()
# (quantization.rs:42-59).
# -----------------------------------------------------------------------------

QUANT_PRESET_NAMES = (
    "default",
    "flat",
    "custom_ms_ssim",
    "custom_psnr_hvs",
    "image_magick",
    "klein_silverstein_carney",
    "dental_x_rays",
    "visual_detection_model",
    "improved_detection_model",
)

_ANNEX_K_LUMA = [
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
]
_ANNEX_K_CHROMA = [
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
]
_FLAT = [16] * 64
_MS_SSIM_LUMA = [
    12, 17, 20, 21, 30, 34, 56, 63, 18, 20, 20, 26, 28, 51, 61, 55,
    19, 20, 21, 26, 33, 58, 69, 55, 26, 26, 26, 30, 46, 87, 86, 66,
    31, 33, 36, 40, 46, 96, 100, 73, 40, 35, 46, 62, 81, 100, 111, 91,
    46, 66, 76, 86, 102, 121, 120, 101, 68, 90, 90, 96, 113, 102, 105, 103,
]
_MS_SSIM_CHROMA = [
    8, 12, 15, 15, 86, 96, 96, 98, 13, 13, 15, 26, 90, 96, 99, 98,
    12, 15, 18, 96, 99, 99, 99, 99, 17, 16, 90, 96, 99, 99, 99, 99,
    96, 96, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
]
_PSNR_HVS_LUMA = [
    9, 10, 12, 14, 27, 32, 51, 62, 11, 12, 14, 19, 27, 44, 59, 73,
    12, 14, 18, 25, 42, 59, 79, 78, 17, 18, 25, 42, 61, 92, 87, 92,
    23, 28, 42, 75, 79, 112, 112, 99, 40, 42, 59, 84, 88, 124, 132, 111,
    42, 64, 78, 95, 105, 126, 125, 99, 70, 75, 100, 102, 116, 100, 107, 98,
]
_PSNR_HVS_CHROMA = [
    9, 10, 17, 19, 62, 89, 91, 97, 12, 13, 18, 29, 84, 91, 88, 98,
    14, 19, 29, 93, 95, 95, 98, 97, 20, 26, 84, 88, 95, 95, 98, 94,
    26, 86, 91, 93, 97, 99, 98, 99, 99, 100, 98, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 97, 97, 99, 99, 99, 99, 97, 99,
]
_IMAGE_MAGICK = [
    16, 16, 16, 18, 25, 37, 56, 85, 16, 17, 20, 27, 34, 40, 53, 75,
    16, 20, 24, 31, 43, 62, 91, 135, 18, 27, 31, 40, 53, 74, 106, 156,
    25, 34, 43, 53, 69, 94, 131, 189, 37, 40, 62, 74, 94, 124, 169, 238,
    56, 53, 91, 106, 131, 169, 226, 311, 85, 75, 135, 156, 189, 238, 311, 418,
]
_KLEIN = [
    10, 12, 14, 19, 26, 38, 57, 86, 12, 18, 21, 28, 35, 41, 54, 76,
    14, 21, 25, 32, 44, 63, 92, 136, 19, 28, 32, 41, 54, 75, 107, 157,
    26, 35, 44, 54, 70, 95, 132, 190, 38, 41, 63, 75, 95, 125, 170, 239,
    57, 54, 92, 107, 132, 170, 227, 312, 86, 76, 136, 157, 190, 239, 312, 419,
]
_DENTAL = [
    7, 8, 10, 14, 23, 44, 95, 241, 8, 8, 11, 15, 25, 47, 102, 255,
    10, 11, 13, 19, 31, 58, 127, 255, 14, 15, 19, 27, 44, 83, 181, 255,
    23, 25, 31, 44, 72, 136, 255, 255, 44, 47, 58, 83, 136, 255, 255, 255,
    95, 102, 127, 181, 255, 255, 255, 255, 241, 255, 255, 255, 255, 255, 255, 255,
]
_VISUAL = [
    15, 11, 11, 12, 15, 19, 25, 32, 11, 13, 10, 10, 12, 15, 19, 24,
    11, 10, 14, 14, 16, 18, 22, 27, 12, 10, 14, 18, 21, 24, 28, 33,
    15, 12, 16, 21, 26, 31, 36, 42, 19, 15, 18, 24, 31, 38, 45, 53,
    25, 19, 22, 28, 36, 45, 55, 65, 32, 24, 27, 33, 42, 53, 65, 77,
]
_IMPROVED = [
    14, 10, 11, 14, 19, 25, 34, 45, 10, 11, 11, 12, 15, 20, 26, 33,
    11, 11, 15, 18, 21, 25, 31, 38, 14, 12, 18, 24, 28, 33, 39, 47,
    19, 15, 21, 28, 36, 43, 51, 59, 25, 20, 25, 33, 43, 54, 64, 74,
    34, 26, 31, 39, 51, 64, 77, 91, 45, 33, 38, 47, 59, 74, 91, 108,
]

LUMA_PRESETS = {
    "default": _ANNEX_K_LUMA,
    "flat": _FLAT,
    "custom_ms_ssim": _MS_SSIM_LUMA,
    "custom_psnr_hvs": _PSNR_HVS_LUMA,
    "image_magick": _IMAGE_MAGICK,
    "klein_silverstein_carney": _KLEIN,
    "dental_x_rays": _DENTAL,
    "visual_detection_model": _VISUAL,
    "improved_detection_model": _IMPROVED,
}
CHROMA_PRESETS = {
    "default": _ANNEX_K_CHROMA,
    "flat": _FLAT,
    "custom_ms_ssim": _MS_SSIM_CHROMA,
    "custom_psnr_hvs": _PSNR_HVS_CHROMA,
    "image_magick": _IMAGE_MAGICK,
    "klein_silverstein_carney": _KLEIN,
    "dental_x_rays": _DENTAL,
    "visual_detection_model": _VISUAL,
    "improved_detection_model": _IMPROVED,
}

# Multiply-shift exact division: SHIFT = 2*8-1 (quantization.rs:185).
QUANT_SHIFT = 15


def _compute_reciprocal(divisor: int) -> Tuple[int, int]:
    """Exact (reciprocal, correction) pair for round-half-away division
    (reference quantization.rs:187-207)."""
    if divisor <= 1:
        return 1, 0
    reciprocal = (1 << QUANT_SHIFT) // divisor
    fractional = (1 << QUANT_SHIFT) % divisor
    correction = divisor // 2
    if fractional != 0:
        if fractional <= correction:
            correction += 1
        else:
            reciprocal += 1
    return reciprocal, correction


@dataclass(frozen=True)
class QuantizationTable:
    """A resolved quantization table: x8-premultiplied values in natural
    (row-major) order plus exact-division companion vectors.

    ``values`` here are the premultiplied divisors (reference keeps them the
    same way; the DQT segment emits ``values >> 3``).
    """

    values: np.ndarray       # (64,) int32, natural order, premultiplied x8
    reciprocals: np.ndarray  # (64,) int32
    corrections: np.ndarray  # (64,) int32

    def dqt_values(self) -> np.ndarray:
        """8-bit table values as emitted in DQT (natural order)."""
        return (self.values >> 3).astype(np.uint8)


def _finish_table(premult: np.ndarray) -> QuantizationTable:
    recips = np.empty(64, dtype=np.int32)
    corrs = np.empty(64, dtype=np.int32)
    for i, d in enumerate(premult):
        r, c = _compute_reciprocal(int(d))
        recips[i] = r
        corrs[i] = c
    return QuantizationTable(
        values=premult.astype(np.int32), reciprocals=recips, corrections=corrs
    )


def quantization_table(spec, quality: int, luma: bool) -> QuantizationTable:
    """Resolve a preset name or custom 64-tuple into a QuantizationTable.

    Quality scaling follows libjpeg (reference quantization.rs:261-283):
    ``scale = 5000/q`` below 50 else ``200-2q``; each value
    ``(v*scale+50)/100`` clamped to 1..255, then premultiplied by 8.
    Custom tables skip quality scaling and clamp to 1..2048 before the x8
    premultiply (quantization.rs:250-259).
    """
    if isinstance(spec, (tuple, list, np.ndarray)):
        vals = np.asarray(spec, dtype=np.int64)
        if vals.shape != (64,):
            raise ValueError("custom quantization table must have 64 entries")
        premult = np.clip(vals, 1, 2 << 10) << 3
        return _finish_table(premult)

    presets = LUMA_PRESETS if luma else CHROMA_PRESETS
    if spec not in presets:
        raise ValueError(f"unknown quantization table preset: {spec!r}")
    base = np.asarray(presets[spec], dtype=np.int64)
    q = int(np.clip(quality, 1, 100))
    scale = (5000 // q) if q < 50 else (200 - q * 2)
    scaled = np.clip((base * scale + 50) // 100, 1, 255)
    return _finish_table(scaled << 3)


# -----------------------------------------------------------------------------
# Huffman tables (Annex K.3 defaults, Annex C code construction, K.2 build)
# -----------------------------------------------------------------------------

# Annex K.3 typical tables for 8-bit precision (huffman.rs:14-64).
DEFAULT_LUMA_DC_LENGTHS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DEFAULT_LUMA_DC_VALUES = list(range(12))

DEFAULT_CHROMA_DC_LENGTHS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
DEFAULT_CHROMA_DC_VALUES = list(range(12))

DEFAULT_LUMA_AC_LENGTHS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
DEFAULT_LUMA_AC_VALUES = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]

DEFAULT_CHROMA_AC_LENGTHS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
DEFAULT_CHROMA_AC_VALUES = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


@dataclass(frozen=True)
class HuffmanTable:
    """A Huffman table in both emission form (lengths+values for DHT) and
    lookup form: ``sizes[sym]``/``codes[sym]`` vectors consumed directly by
    the vectorized entropy path (reference huffman.rs:66-96, 223-236)."""

    lengths: Tuple[int, ...]  # 16 code-length counts (DHT "BITS")
    values: Tuple[int, ...]   # symbol values sorted by code length ("HUFFVAL")
    sizes: np.ndarray         # (256,) uint8: code size per symbol (0 = absent)
    codes: np.ndarray         # (256,) uint16: code bits per symbol


def _build_lookup(lengths: Sequence[int], values: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Annex C figures C.1-C.3: expand (BITS, HUFFVAL) into per-symbol
    (size, code) lookup vectors (reference huffman.rs:239-288)."""
    sizes_list = []
    for i, count in enumerate(lengths):
        sizes_list.extend([i + 1] * count)

    codes_list = []
    code = 0
    prev_size = sizes_list[0] if sizes_list else 0
    for size in sizes_list:
        if size != prev_size:
            code <<= size - prev_size
            prev_size = size
        codes_list.append(code)
        code += 1

    sizes = np.zeros(256, dtype=np.uint8)
    codes = np.zeros(256, dtype=np.uint16)
    for i, v in enumerate(values):
        sizes[v] = sizes_list[i]
        codes[v] = codes_list[i]
    return sizes, codes


def huffman_table(lengths: Sequence[int], values: Sequence[int]) -> HuffmanTable:
    sizes, codes = _build_lookup(lengths, values)
    return HuffmanTable(
        lengths=tuple(int(x) for x in lengths),
        values=tuple(int(x) for x in values),
        sizes=sizes,
        codes=codes,
    )


@lru_cache(maxsize=None)
def default_tables() -> Tuple[Tuple[HuffmanTable, HuffmanTable], Tuple[HuffmanTable, HuffmanTable]]:
    """((luma_dc, luma_ac), (chroma_dc, chroma_ac)) K.3 defaults."""
    return (
        (
            huffman_table(DEFAULT_LUMA_DC_LENGTHS, DEFAULT_LUMA_DC_VALUES),
            huffman_table(DEFAULT_LUMA_AC_LENGTHS, DEFAULT_LUMA_AC_VALUES),
        ),
        (
            huffman_table(DEFAULT_CHROMA_DC_LENGTHS, DEFAULT_CHROMA_DC_VALUES),
            huffman_table(DEFAULT_CHROMA_AC_LENGTHS, DEFAULT_CHROMA_AC_VALUES),
        ),
    )


def optimized_huffman_table(freq: np.ndarray) -> HuffmanTable:
    """Annex K.2 optimized table build from a 257-bin symbol histogram.

    Implements figures K.1 (code-size finding via pairwise merge), K.2 (bits
    counting), K.3 (16-bit length limiting) and K.4 (value sorting), matching
    the reference's tie-breaking exactly (huffman.rs:99-221): the merge picks
    the *largest* index among minimum-frequency nonzero bins.  Bin 256 is the
    reserved symbol guaranteeing no code is all ones.

    The build runs in native C++ (``native.build_k2``): it sits on the
    two-pass critical path between the histogram fetch and the pack.  The
    Python build runs only where the native one reports a degenerate
    histogram, as in ``tpuenc``; both give identical tables.
    """
    from ..entropy import native

    nk = native.build_k2(np.asarray(freq, dtype=np.int64))
    if nk is not None:
        return huffman_table(*nk)
    return _optimized_huffman_table_py(freq)


def _optimized_huffman_table_py(freq: np.ndarray) -> HuffmanTable:
    """Pure-Python K.2 build: the oracle of the native build, and the
    build of the degenerate histograms it declines."""
    freq = [int(f) for f in np.asarray(freq, dtype=np.int64)]
    assert len(freq) == 257
    others = [-1] * 257
    codesize = [0] * 257

    # Lazy-deletion min-heap keyed (freq, -index): pop order is exactly the
    # reference's scan rule — minimum frequency, ties broken by the LARGEST
    # index ("<= keeps last" in the linear scan).  Entries go stale when a
    # merge raises freq[i] (strictly, since merged-in freqs are positive) or
    # zeroes it, so a popped (f, i) is live iff freq[i] == f > 0.
    import heapq

    heap = [(f, -i) for i, f in enumerate(freq) if f > 0]
    heapq.heapify(heap)

    def pop_live():
        while heap:
            f, ni = heapq.heappop(heap)
            i = -ni
            if freq[i] == f and f > 0:
                return i
        return -1

    while True:
        v1 = pop_live()
        if v1 < 0:
            break
        v2 = pop_live()
        if v2 < 0:
            break

        freq[v1] += freq[v2]
        freq[v2] = 0
        heapq.heappush(heap, (freq[v1], -v1))

        codesize[v1] += 1
        while others[v1] >= 0:
            v1 = others[v1]
            codesize[v1] += 1
        others[v1] = v2
        codesize[v2] += 1
        while others[v2] >= 0:
            v2 = others[v2]
            codesize[v2] += 1

    cs = np.asarray(codesize, dtype=np.int64)
    bits = np.zeros(33, dtype=np.int64)
    nz_sizes = cs[cs > 0]
    np.add.at(bits, nz_sizes, 1)

    # Figure K.3: limit code lengths to 16 bits.
    i = 32
    while i > 16:
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
        i -= 1
    while bits[i] == 0:
        assert i > 0, "Error creating codesizes"
        i -= 1
    bits[i] -= 1  # remove the reserved symbol's code

    # Figure K.4: sort symbol values by code size (stable keeps the
    # ascending-symbol order within each size, matching the scan loop).
    syms = np.nonzero(cs[:256] > 0)[0]
    huffval = syms[np.argsort(cs[:256][syms], kind="stable")].tolist()

    lengths = [int(bits[i + 1]) for i in range(16)]
    return huffman_table(lengths, huffval)
