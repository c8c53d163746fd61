"""Entropy statistics on the encode device, plain PyTorch.

Counterpart of ``tpuenc/entropy/device.py`` for coefficient-major (64, B)
streams: the symbol histograms of the two-pass optimized-table mode
(reference ``encoder.rs:1086-1200``), counted where the coefficients live
so that only 2 x 2 x 257 counts cross to the host.  :func:`scan_histograms`
runs the AC counts through K7 (``pallas_hist.hist_count``);
:func:`ac_histogram` is the same count in plain tensor code, the
formulation ``tpuenc`` keeps beside its kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .huffopt import progressive_bands
from .pallas_hist import _count, _fold, fold_counts, hist_count
from .pallas_pack import _bit_length


def bit_length(v):
    """Magnitude category of int values (0 for 0), elementwise, int64:
    ``tpuenc``'s count of the thresholds |v| >= 2^k for k < 16, which is
    the bit length capped at 16."""
    return _bit_length(v.to(torch.int64).abs()).clamp(max=16)


def ac_stats(blocks, start: int, end: int):
    """Run-length statistics of band [start, end) of a (64, B) stream:
    ``(nz, zrl, sym, size, eob)``, the first four (end - start, B), eob
    (B,); the counterpart of ``symbols.ac_symbols``."""
    band = blocks[start:end].to(torch.int64)
    L, B = band.shape
    nz = band != 0
    if L == 0:
        # Empty band ([1, 1) for plans of 34 or more scans,
        # encoder.rs:926-936): no symbols and no EOB (writer.rs:364-384).
        zero = torch.zeros_like(band)
        return nz, zero, zero, zero, torch.zeros(B, dtype=torch.bool,
                                                 device=blocks.device)
    idx = torch.arange(L, device=blocks.device)[:, None].expand(L, B)
    lastnz = torch.where(nz, idx, -1).cummax(dim=0).values
    prev = torch.cat([torch.full((1, B), -1, dtype=torch.int64,
                                 device=blocks.device), lastnz[:-1]])
    run = idx - prev - 1
    size = bit_length(band)
    sym = ((run & 15) << 4) | size
    zrl = torch.where(nz, run >> 4, 0)
    return nz, zrl, sym, size, lastnz[-1] < L - 1


def ac_histogram(blocks, start: int, end: int):
    """257-bin AC symbol histogram (int64) of one band, plain PyTorch:
    the (run & 15, size) pairs of the nonzeros counted as
    ``(sym >> 4) & 15`` by size (17 columns, the size-16 column aliased
    into bin ``(run + 1) << 4`` as ``np.bincount`` does on the host), then
    the ZRL total and the EOB count."""
    nz, zrl, sym, size, eob = ac_stats(blocks, start, end)
    joint = _count(torch.where(nz, ((sym >> 4) & 15) * 17 + size, 272), 272)
    return _fold(joint, zrl.sum(), eob.sum())


def dc_histogram(blocks):
    """257-bin DC size histogram (int64) over one component stream.  The
    DC differences chain over the whole stream with no restart reset
    (encoder.rs:1100-1117), although the scan's own differences do
    reset."""
    dc = blocks[0].to(torch.int64)
    prev = torch.cat([torch.zeros(1, dtype=torch.int64, device=dc.device),
                      dc[:-1]])
    sizes = bit_length(dc - prev)
    # A compare-and-sum over the 17 categories: no device sync, unlike
    # torch.bincount.
    bins = torch.arange(17, device=dc.device)
    counts = (sizes[None, :] == bins[:, None]).sum(1)
    return torch.nn.functional.pad(counts, (0, 240))


def scan_histograms(comp_streams: Sequence, components,
                    progressive_scans: Optional[int]):
    """Per-table (dc, ac) histograms on the streams' device, int64 (T, 2,
    257) with T = min(components, 2): ``huffopt.build_histograms`` without
    the reserved-symbol seed, which the host adds once.  Every component's
    AC bands go through K7 together, at most 8 bands per launch."""
    bands = (progressive_bands(progressive_scans)
             if progressive_scans is not None else [(1, 64)])
    # Empty bands ([1, 1)) have no mass; the other bands' raw counts add
    # up before the one fold per component (the fold is linear).
    live = [b for b in bands if b[0] < b[1]]
    n_tables = min(len(components), 2)
    dev = comp_streams[0].device
    out = torch.zeros((n_tables, 2, 257), dtype=torch.int64, device=dev)
    for comp, stream in zip(components, comp_streams):
        if comp.dc_huffman_table < n_tables:
            out[comp.dc_huffman_table, 0] += dc_histogram(stream)
        if comp.ac_huffman_table < n_tables and live:
            stream = stream.contiguous()
            raw = sum(hist_count(stream, live[k:k + 8]).sum(0, dtype=torch.int64)
                      for k in range(0, len(live), 8))
            out[comp.ac_huffman_table, 1] += fold_counts(raw)
    return out
