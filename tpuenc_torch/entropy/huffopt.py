"""Two-pass optimized Huffman table construction.

Counterpart of ``tpuenc/entropy/huffopt.py``, numpy on the host.
Replicates the reference's histogram pass (``encoder.rs:1086-1200``) with
vectorized numpy reductions, then builds tables via the Annex K.2
algorithm (``tables.optimized_huffman_table``):

* One (DC, AC) table pair per table id 0..min(num_components,2)-1, with the
  257-bin histograms seeded by the reserved symbol (freq[256] = 1, K.2).
* DC histogram = bit lengths of DC differentials chained over each
  component's full block stream.  Note: the reference does *not* reset the
  DC predictor at restart intervals during histogramming (encoder.rs:
  1100-1117) even though the actual scan does — replicated here for byte
  parity.
* AC histogram mirrors the real scans exactly: full band [1,64) for
  sequential, per-scan spectral bands for progressive so EOB counts match
  (encoder.rs:1119-1189).

The encode path counts the histograms on the device
(``entropy.device.scan_histograms``) and uses only the table build,
:func:`exact_stream_bits` and :func:`budget_hint_from_bits` from here;
:func:`build_histograms` is the host oracle of those counts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.tables import HuffmanTable, optimized_huffman_table
from ..core.types import Component
from .symbols import ac_symbols, bit_length


def progressive_bands(scans: int) -> List[Tuple[int, int]]:
    """AC spectral bands for an N-scan progressive encode
    (reference encoder.rs:924-936): scans-1 AC bands; band k covers
    [max(1, k*vps), (k+1)*vps) with the last band padded to 64."""
    n = scans - 1
    vps = 64 // n
    bands = []
    for scan in range(n):
        start = max(scan * vps, 1)
        end = 64 if scan == n - 1 else (scan + 1) * vps
        bands.append((start, end))
    return bands


def ac_histogram(blocks: np.ndarray, start: int, end: int) -> np.ndarray:
    """257-bin AC symbol frequency histogram for one spectral band."""
    freq = np.zeros(257, dtype=np.int64)
    sym = ac_symbols(blocks, start, end)
    nz = sym["nz"]
    freq[:256] += np.bincount(sym["sym"][nz].ravel(), minlength=256)[:256]
    freq[0xF0] += int(sym["zrl"][nz].sum())
    freq[0x00] += int(sym["eob"].sum())
    return freq


def dc_histogram(blocks: np.ndarray) -> np.ndarray:
    """257-bin DC size histogram over one component's block stream (no
    restart resets, matching encoder.rs:1100-1117)."""
    freq = np.zeros(257, dtype=np.int64)
    dc = blocks[:, 0].astype(np.int32)
    prev = np.concatenate([[0], dc[:-1]])
    sizes = bit_length(dc - prev)
    freq[:256] += np.bincount(sizes.ravel(), minlength=256)[:256]
    return freq


def build_histograms(
    comp_blocks: Sequence[np.ndarray],
    components: Sequence[Component],
    progressive_scans: Optional[int],
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(dc_freq, ac_freq) histograms per table id (encoder.rs:1086-1193)."""
    max_tables = min(len(components), 2)
    out = []
    for table in range(max_tables):
        dc_freq = np.zeros(257, dtype=np.int64)
        dc_freq[256] = 1
        ac_freq = np.zeros(257, dtype=np.int64)
        ac_freq[256] = 1
        had_dc = had_ac = False

        for comp, blocks in zip(components, comp_blocks):
            if comp.dc_huffman_table == table:
                had_dc = True
                dc_freq += dc_histogram(blocks)
            if comp.ac_huffman_table == table:
                had_ac = True
                if progressive_scans is not None:
                    for start, end in progressive_bands(progressive_scans):
                        ac_freq += ac_histogram(blocks, start, end)
                else:
                    ac_freq += ac_histogram(blocks, 1, 64)

        if not (had_dc and had_ac):
            raise ValueError(f"no component codes with table {table}")
        out.append((dc_freq, ac_freq))
    return out


def optimize_tables(
    comp_blocks: Sequence[np.ndarray],
    components: Sequence[Component],
    progressive_scans: Optional[int],
) -> List[Tuple[HuffmanTable, HuffmanTable]]:
    """Histogram + K.2 build: optimized (dc, ac) table pair per table id."""
    return [
        (optimized_huffman_table(dc), optimized_huffman_table(ac))
        for dc, ac in build_histograms(comp_blocks, components, progressive_scans)
    ]


def tables_from_histograms(
    hist_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> List[Tuple[HuffmanTable, HuffmanTable]]:
    """K.2 table build from (dc, ac) histograms counted on the device:
    only the 2 x 2 x 257 counts reach the host, and the (tiny, serial)
    Annex K.2 build runs here.  Seeds the reserved symbol 256 with
    frequency 1 (encoder.rs:1092-1095) exactly once, on the host."""
    out = []
    for dc, ac in hist_pairs:
        dcf = np.asarray(dc, dtype=np.int64).copy()
        acf = np.asarray(ac, dtype=np.int64).copy()
        dcf[256] = 1
        acf[256] = 1
        out.append((optimized_huffman_table(dcf), optimized_huffman_table(acf)))
    return out


def exact_stream_bits(
    hist_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    tables: Sequence[Sequence[HuffmanTable]],
) -> int:
    """EXACT total entropy-coded bit count of all scans, from the
    two-pass histograms and the tables that will encode them: every DC
    symbol of size s costs code_size(s) + s magnitude bits, every AC
    symbol (run<<4|size) costs code_size(sym) + (sym & 15) magnitude
    bits (ZRL 0xF0 and EOB 0x00 carry no magnitude bits and are already
    counted in the histogram).  Segment byte-padding is not included
    (< 7 bits per restart segment).

    Lets the optimized-table flow size its aggregate pack budget from
    content instead of probing the ladder.
    """
    total = 0
    syms = np.arange(256, dtype=np.int64)
    extra = syms & 15
    for (dcf, acf), (dct, act) in zip(hist_pairs, tables):
        dcf = np.asarray(dcf, dtype=np.int64)[:256]
        acf = np.asarray(acf, dtype=np.int64)[:256]
        dc_cost = np.asarray(dct.sizes[:256], np.int64) + syms
        ac_cost = np.asarray(act.sizes[:256], np.int64) + extra
        total += int((dcf * dc_cost).sum()) + int((acf * ac_cost).sum())
    return total


def budget_hint_from_bits(total_bits: int, plan_rows: int) -> int:
    """Aggregate-budget starting rung from exact content bits: average
    packed words per (scan, block) pack row with a small safety factor.
    ``tpuenc`` measured fit-rung/average ratios of 1.12-1.14 on dense
    q100 content, so 1.05 starts at most one rung low; the ladder's
    escalation (one extra pack, memoized) covers the rest."""
    if plan_rows <= 0:
        return 0
    avg = total_bits / 32.0 / plan_rows
    return int(np.ceil(avg * 1.05))
