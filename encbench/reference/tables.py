"""Coding tables of the plain reference encoder (pure Python and numpy).

The published tables and constructions that vstroebel/jpeg-encoder v0.7.0
uses: the ITU T.81 Annex K quantization tables with libjpeg's quality
scaling (quantization.rs:261-283), the exact reciprocal division it
quantizes with (quantization.rs:185-207), the Annex K.3 default Huffman
tables, the Annex C code assignment and the Annex K.2 optimized table build
with the reference's tie-breaking (huffman.rs:99-288).
"""

from __future__ import annotations

import heapq

import numpy as np

# Figure A.6: ZIGZAG[i] is the row-major index of the i-th coefficient.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# Annex K, tables K.1 and K.2 (row-major).
LUMA_QUANT = [
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
]
CHROMA_QUANT = [
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32

# Annex K.3: (BITS, HUFFVAL) of the four typical tables.
LUMA_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
CHROMA_DC = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
LUMA_AC = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
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
])
CHROMA_AC = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
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
])


def quant_table(base, quality: int) -> np.ndarray:
    """libjpeg quality scaling of an Annex K table, clamped to 1..255:
    the 8-bit values the DQT segment carries (row-major, int64)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((np.asarray(base, np.int64) * scale + 50) // 100, 1, 255)


def reciprocal(divisor: int):
    """(reciprocal, correction) with which ``((|v| + correction) *
    reciprocal) >> 15`` divides by ``divisor`` as the reference does."""
    if divisor <= 1:
        return 1, 0
    rec, frac = divmod(1 << 15, divisor)
    corr = divisor // 2
    if frac:
        if frac <= corr:
            corr += 1
        else:
            rec += 1
    return rec, corr


def code_table(bits, values):
    """Annex C: per-symbol (code length, code) arrays of 256 entries from
    (BITS, HUFFVAL)."""
    lengths = [n + 1 for n, count in enumerate(bits) for _ in range(count)]
    sizes = np.zeros(256, np.int64)
    codes = np.zeros(256, np.int64)
    code, prev = 0, lengths[0] if lengths else 0
    for sym, size in zip(values, lengths):
        code <<= size - prev
        prev = size
        sizes[sym], codes[sym] = size, code
        code += 1
    return sizes, codes


def optimized_table(freq):
    """Annex K.2 (figures K.1-K.4) from a 257-bin histogram whose bin 256
    is the reserved symbol: (BITS, HUFFVAL).  The merge takes the largest
    index among the least nonzero frequencies, as the reference does."""
    freq = [int(f) for f in freq]
    others = [-1] * 257
    size = [0] * 257
    heap = [(f, -i) for i, f in enumerate(freq) if f > 0]
    heapq.heapify(heap)

    def pop():
        while heap:
            f, i = heapq.heappop(heap)
            if freq[-i] == f:
                return -i
        return -1

    while True:
        v1 = pop()
        v2 = pop() if v1 >= 0 else -1
        if v2 < 0:
            break
        freq[v1] += freq[v2]
        freq[v2] = 0
        heapq.heappush(heap, (freq[v1], -v1))
        for v in (v1, v2):
            size[v] += 1
            while others[v] >= 0:
                v = others[v]
                size[v] += 1
        v = v1
        while others[v] >= 0:
            v = others[v]
        others[v] = v2

    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):  # figure K.3: no code longer than 16
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    values = sorted((s for s in range(256) if size[s]), key=lambda s: size[s])
    return bits[1:17], values
