"""Vectorized entropy symbolization, numpy.

Counterpart of ``tpuenc/entropy/symbols.py``.  The reference derives
Huffman symbols one coefficient at a time inside the bit-writer loop
(``writer.rs:331-388``, ``get_code`` at writer.rs:455-470).  Here the same
quantities are computed as whole-array operations over all blocks at once,
the form the host histogram code (``huffopt``, encoder.rs:1086-1200)
consumes:

* ``bit_length``/``get_code`` — magnitude category + complement-coded extra
  bits (branch-free, identical to writer.rs:455-470).
* ``ac_symbols`` — per-coefficient zero-run lengths via a running maximum of
  the last-nonzero index, ZRL counts, (run<<4|size) symbols and EOB flags for
  an arbitrary spectral band [start, end) — covering baseline and
  progressive band scans alike (writer.rs:356-388).

The device counts the same symbols in PyTorch and in the K7/K9 kernels
(``entropy.device``, ``entropy.pallas_hist``); these functions are their
host oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Bit-length lookup for |v| <= 32768 (max DC diff magnitude is 2*8*255*8).
_NBITS_LUT = np.zeros(1 << 16, dtype=np.uint8)
for _n in range(1, 17):
    _NBITS_LUT[1 << (_n - 1): 1 << _n] = _n


def bit_length(values: np.ndarray) -> np.ndarray:
    """Magnitude category: number of bits of |v| (0 for v == 0).

    Matches reference ``get_num_bits`` (encoder.rs:1244-1257) and the
    ``get_code`` size (writer.rs:455-470).
    """
    return _NBITS_LUT[np.abs(values.astype(np.int32))]


def get_code(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size, extra_bits) per value, complement coding for negatives
    (reference writer.rs:455-470)."""
    v = values.astype(np.int32)
    size = bit_length(v).astype(np.int32)
    temp = v - (v < 0).astype(np.int32)
    extra = temp & ((1 << size) - 1)
    return size, extra.astype(np.uint32)


def ac_symbols(blocks: np.ndarray, start: int, end: int):
    """Run-length symbolization of the spectral band [start, end).

    ``blocks``: (B, 64) int16 zigzag-ordered quantized coefficients.

    Returns a dict of (B, L) arrays (L = end - start):
      nz    — nonzero mask
      zrl   — number of ZRL (0xF0) symbols to emit before this coefficient
      sym   — (run<<4 | size) Huffman symbol (valid where nz)
      size  — magnitude category (valid where nz)
      extra — complement-coded magnitude bits (valid where nz)
    plus (B,) ``eob`` — whether the block emits an EOB (trailing zeros exist,
    including the all-zero band case; reference writer.rs:383-385).
    """
    band = blocks[:, start:end].astype(np.int32)
    B, L = band.shape
    nz = band != 0

    if L == 0:
        # Empty spectral band (reference band math encoder.rs:926-936
        # yields band [1, 1) for scans >= 34): write_ac_block over an
        # empty range emits nothing — not even EOB (writer.rs:364-384).
        return {
            "nz": nz,
            "zrl": np.zeros((B, 0), np.int32),
            "sym": np.zeros((B, 0), np.int32),
            "size": np.zeros((B, 0), np.int32),
            "extra": np.zeros((B, 0), np.int32),
            "eob": np.zeros((B,), bool),
        }

    idx = np.arange(L, dtype=np.int32)
    lastnz = np.maximum.accumulate(np.where(nz, idx, -1), axis=1)
    prev = np.concatenate(
        [np.full((B, 1), -1, dtype=np.int32), lastnz[:, :-1]], axis=1
    )
    run = idx - prev - 1  # zeros since previous nonzero (valid where nz)

    size, extra = get_code(band)
    sym = ((run & 15) << 4) | size
    zrl = np.where(nz, run >> 4, 0)
    eob = lastnz[:, -1] < (L - 1)

    return {
        "nz": nz,
        "zrl": zrl.astype(np.int32),
        "sym": sym.astype(np.int32),
        "size": size,
        "extra": extra,
        "eob": eob,
    }


def dc_diffs(dc: np.ndarray, reset_every: int = 0) -> np.ndarray:
    """DC differentials with predictor reset every ``reset_every`` blocks
    (0 = never reset; predictor starts at 0)."""
    dc = dc.astype(np.int32)
    prev = np.empty_like(dc)
    prev[0] = 0
    prev[1:] = dc[:-1]
    if reset_every > 0:
        prev[::reset_every] = 0
    return dc - prev
