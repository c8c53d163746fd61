"""AC symbol statistics for the two-pass optimized tables: K7 and K9.

Counterpart of ``tpuenc/entropy/pallas_hist.py``.  The optimized-table
mode (reference ``encoder.rs:1086-1200``) needs a 257-bin AC symbol
histogram per table; both kernels symbolize a coefficient-major (64, B)
int16 stream band by band (run = zeros since the previous nonzero of the
band, which starts at ss - 1; size = magnitude category):

* K7, :func:`hist_count` (``csrc/hist_count.cu``): up to 8 bands of one
  component in one pass, counted in the kernel.  This is the one the
  encode path runs (``entropy.device.scan_histograms``);
  :func:`ac_histograms_multiband` gives its per-band histograms.
* K9, :func:`hist_sym` (``csrc/hist_sym.cu``): one band, written out as
  int8 run and size streams plus per-block ZRL and EOB partials; the count
  after it is plain PyTorch (:func:`ac_histogram_sym`).  No encode path
  runs it, in ``tpuenc`` or here; it keeps its tests' counterpart.

ZRL codes are counted as the sum of ``run >> 4`` over the nonzeros that
end the runs, and EOB once per block whose last nonzero of the band lies
below se - 1.  Each kernel has a plain PyTorch version (``*_ref``) with the
same contract, which the wrappers run for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from .pallas_pack import _bit_length, check_bands

N_BINS = 16 * 17 + 2  # K7's raw counts per band: joint, ZRL total, EOB count
MAX_BANDS = 8
TILE = 512  # K9's column padding, the TPU kernel's tile


def _band_symbols(q, ss: int, se: int):
    """``(nz, run, size, last)`` of band [ss, se) of an int (64, B)
    stream: int64 (64, B) nonzero mask, zero run before each slot, and
    magnitude category (0 outside the band), and each block's last nonzero
    slot of the band (-1 if none)."""
    dev = q.device
    B = q.shape[1]
    slot = torch.arange(64, device=dev)[:, None]
    band = torch.where((slot >= ss) & (slot < se), q.to(torch.int64), 0)
    nz = band != 0
    lastnz = torch.where(nz, slot, -1).cummax(dim=0).values
    prev = torch.cat(
        [torch.full((1, B), -1, dtype=torch.int64, device=dev), lastnz[:-1]]
    ).clamp(min=ss - 1)
    return nz, slot - prev - 1, _bit_length(band.abs()), lastnz[63]


def _count(idx, n: int):
    """Histogram of the int64 indices ``idx`` over ``n`` bins; indices of
    ``n`` are dropped.  A scatter-add, which needs no device sync."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    out.index_add_(0, idx.reshape(-1), torch.ones_like(idx).reshape(-1))
    return out[:n]


# ---------------------------------------------------------------------------
# K7: counts of several bands.
# ---------------------------------------------------------------------------

def hist_count_ref(q, bands):
    """Plain version of K7: ``q`` int16 (64, B); ``bands`` up to 8
    non-empty ``(ss, se)`` that do not overlap, in any order.  Returns
    int32 (n_bands, 274): per band (row i for band i) the 16 x 17 joint
    (run & 15, size) counts row-major, the ZRL total and the EOB count."""
    out = torch.zeros((len(bands), N_BINS), dtype=torch.int64, device=q.device)
    for b, (ss, se) in enumerate(bands):
        nz, run, size, last = _band_symbols(q, ss, se)
        out[b, :272] = _count(torch.where(nz, (run & 15) * 17 + size, 272), 272)
        out[b, 272] = torch.where(nz, run >> 4, 0).sum()
        out[b, 273] = (last < se - 1).sum()
    return out.to(torch.int32)


def hist_count(q, bands):
    """K7 on ``q``'s device: the CUDA kernel for CUDA tensors, the plain
    version (:func:`hist_count_ref`, same contract) for CPU tensors.
    Both raise ValueError for more than 8 bands, an empty one or two that
    overlap (``pallas_pack.check_bands``)."""
    bands = check_bands("hist_count", bands, MAX_BANDS)
    if not cuda_lib.on_cuda(q, "hist_count"):
        return hist_count_ref(q, bands)
    dev = q.device
    B = q.shape[-1]
    cuda_lib.check_tensor("q", q, torch.int16, (64, B), dev)
    out = torch.zeros((len(bands), N_BINS), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_hist_count(
            q.data_ptr(), B, len(bands),
            cuda_lib.int_array([v for band in bands for v in band]),
            out.data_ptr(), cuda_lib.stream_of(q),
        ),
        "tpuenc_hist_count",
    )
    hist_count.launches += 1
    return out


hist_count.launches = 0


def _fold(joint, zrl, eob):
    """257-bin histogram from the (16, 17) joint counts, the ZRL total and
    the EOB count.  ``sym = run << 4 | size``, so the (16, 16) part is the
    histogram row-major; the size-16 column (unreachable for quantized
    coefficients, kept for exactness) aliases into bin ``(run + 1) << 4``
    as the TPU version folds it, and run 15 / size 16 is dropped."""
    joint = joint.to(torch.int64).view(16, 17)
    hist = torch.zeros(257, dtype=torch.int64, device=joint.device)
    hist[:256] = joint[:, :16].reshape(256)
    hist[16:256:16] += joint[:15, 16]
    hist[0xF0] += zrl
    hist[0x00] += eob
    return hist


def fold_counts(raw):
    """257-bin histogram (int64) from one row of K7's raw counts (274,)."""
    raw = raw.to(torch.int64)
    return _fold(raw[:272], raw[272], raw[273])


def ac_histograms_multiband(stream, bands):
    """Per-band 257-bin AC histograms (int64) of several bands of one
    component from one K7 launch; empty bands ([1, 1) for plans of 34 or
    more scans) get zero mass and stay out of the kernel."""
    live = [tuple(b) for b in bands if b[0] < b[1]]
    zero = torch.zeros(257, dtype=torch.int64, device=stream.device)
    if not live:
        return [zero for _ in bands]
    raw = hist_count(stream.contiguous(), live)
    by_band = {b: fold_counts(raw[i]) for i, b in enumerate(live)}
    return [by_band.get(tuple(b), zero) for b in bands]


# ---------------------------------------------------------------------------
# K9: one band's symbol streams.
# ---------------------------------------------------------------------------

def hist_sym_ref(q, ss: int, se: int, Lp: int):
    """Plain version of K9: ``q`` int16 (64, B), band [ss, se) non-empty,
    ``Lp >= B`` output columns.  Returns ``(run4 int8 (64, Lp), size int8
    (64, Lp), parts int32 (2, Lp))``: run & 15 for the band's nonzeros in
    real blocks and 16 elsewhere; the magnitude category (0 outside the
    band); per block the sum of run >> 4 over its nonzeros (row 0) and its
    EOB flag (row 1)."""
    dev = q.device
    B = q.shape[1]
    qq = torch.zeros((64, Lp), dtype=torch.int64, device=dev)
    qq[:, :B] = q
    nz, run, size, last = _band_symbols(qq, ss, se)
    valid = torch.arange(Lp, device=dev) < B
    parts = torch.stack([torch.where(nz, run >> 4, 0).sum(0),
                         (last < se - 1) & valid])
    return (torch.where(nz, run & 15, 16).to(torch.int8), size.to(torch.int8),
            parts.to(torch.int32))


def hist_sym(q, ss: int, se: int, Lp: int):
    """K9 on ``q``'s device: the CUDA kernel for CUDA tensors, the plain
    version (:func:`hist_sym_ref`, same contract) for CPU tensors."""
    B = q.shape[-1]
    if not 0 <= ss < se <= 64 or Lp < B:
        raise ValueError(f"hist_sym: band ({ss}, {se}), Lp {Lp}, B {B}")
    if not cuda_lib.on_cuda(q, "hist_sym"):
        return hist_sym_ref(q, ss, se, Lp)
    dev = q.device
    cuda_lib.check_tensor("q", q, torch.int16, (64, B), dev)
    run4 = torch.empty((64, Lp), dtype=torch.int8, device=dev)
    size = torch.empty((64, Lp), dtype=torch.int8, device=dev)
    parts = torch.empty((2, Lp), dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_hist_sym(
            q.data_ptr(), B, Lp, ss, se, run4.data_ptr(), size.data_ptr(),
            parts.data_ptr(), cuda_lib.stream_of(q),
        ),
        "tpuenc_hist_sym",
    )
    hist_sym.launches += 1
    return run4, size, parts


hist_sym.launches = 0


def ac_histogram_sym(stream, start: int, end: int):
    """257-bin AC histogram (int64) of one band through K9 and a plain
    PyTorch count, ``tpuenc``'s ``ac_histogram_pallas``; an empty band
    has zero mass."""
    if start >= end:
        return torch.zeros(257, dtype=torch.int64, device=stream.device)
    B = stream.shape[1]
    run4, size, parts = hist_sym(stream.contiguous(), start, end,
                                 -(-B // TILE) * TILE)
    r = run4.to(torch.int64)
    joint = _count(torch.where(r < 16, r * 17 + size.to(torch.int64), 272), 272)
    sums = parts.to(torch.int64).sum(1)
    return _fold(joint, sums[0], sums[1])
