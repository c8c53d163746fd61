"""The device finish: segment realignment, 0xFF stuffing and RST markers on
the encode device.

Counterpart of ``tpuenc/entropy/device_stuff.py``.  The packer leaves one
raw bit concatenation of every scan's restart segments (of every image's,
on the single-program batch).  Every whole-image route and the
single-program batch finish it here (:func:`device_stuff`), on the
stream's own device, in plain PyTorch (``tpuenc``'s version is XLA, with
no Pallas kernel); the chunked routes finish each chunk's stream here too
(:func:`stuff_chunk`), carrying the last partial byte of a segment left
open to the next chunk.  The host finishes (``device_encode._finish_scans_v2``,
which copies the stream back and runs the native realigner, and
``testing.host_stuffer``) are the tests' references.  The work is two
passes over windows of the realigned bytes:

1. **Realign** (:func:`realign`): realigned byte j lies in segment k (a
   search of the segments' byte starts), at local byte l, source bit
   ``seg_start_bits[k] + 8 l``; the byte is a funnel of two stream words,
   and each segment's last byte ORs in the 1-padding (reference
   ``writer.rs:138-145``).
2. **Stuff** (:func:`stuff_markers`): realigned byte j goes to output
   position ``F(j) = j + (#0xFF before j) + 2 * (#markers before j's
   segment)``.  The output starts zeroed, so the 0x00 after each 0xFF
   (``writer.rs:156-167``) is already in place; once every window is
   scattered, each segment that is not the last of its scan gets its RST
   marker pair at the end of its bytes (``encoder.rs:748-757``).

Two things differ from ``tpuenc``, which inverts F with a search of every
output position over buffers sized from the stream's capacity.  The passes
are sized from the segments' bit counts, which the caller has already read:
they cover exactly ``n1`` realigned bytes and scatter into ``2 * n1 + 2 *
S`` output bytes, which no stream can overrun (each realigned byte gives at
most two), so there is no overflow case and no host fallback.  And they
take ``_WINDOW`` bytes a step, carrying the running 0xFF count on the
device from one window to the next, so that the finish holds its output
and a fixed set of window temporaries, whatever the stream's size.  The
stream's words are int32 tensors holding uint32 bits, MSB first; the passes
widen them to int64, so no shift is arithmetic or overflows.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import tracing

# Realigned bytes a window: each int64 temporary of a window takes 16 MiB.
_WINDOW = 1 << 21


def marker_plan(seg_structure: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-segment marker layout for a scan plan.

    ``seg_structure``: number of restart segments per scan, in plan
    order.  Returns ``(emit_marker (S,) bool, marker_m (S,) uint8)``:
    segment k is followed by RST(marker_m[k]) iff emit_marker[k] — every
    segment except the last of its scan, with m cycling 0..7 within the
    scan (encoder.rs:748-757)."""
    emit = []
    ms = []
    for nseg in seg_structure:
        for i in range(nseg):
            emit.append(i != nseg - 1)
            ms.append(i % 8)
    return np.asarray(emit, bool), np.asarray(ms, np.uint8)


@lru_cache(maxsize=64)
def _markers(seg_structure: tuple, device: torch.device):
    """:func:`marker_plan` on ``device``: (emit int64 0/1 (S,), 2 x the
    markers before each segment int64 (S,), the segments that emit one
    int64, their RST bytes uint8)."""
    emit, ms = marker_plan(seg_structure)
    before = 2 * (np.cumsum(emit) - emit)
    idx = np.flatnonzero(emit)
    rst = (0xD0 + ms[idx]).astype(np.uint8)
    out = []
    for a in (emit.astype(np.int64), before, idx, rst):
        with tracing.span("upload"):
            out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


def segment_tables(seg_bits: torch.Tensor):
    """Per segment, int64 (S,), from its unpadded bit counts: its realigned
    bytes, and :func:`realign`'s ``byte_start``, ``src_off`` and
    ``end_bit``."""
    seg_bits = seg_bits.to(torch.int64)
    nbytes = (seg_bits + 7) >> 3
    byte_start = torch.cumsum(nbytes, 0) - nbytes
    src_off = torch.cumsum(seg_bits, 0) - seg_bits - 8 * byte_start
    return nbytes, byte_start, src_off, 8 * byte_start + seg_bits


def realign(words: torch.Tensor, byte_start: torch.Tensor,
            src_off: torch.Tensor, end_bit: torch.Tensor, j0: int, j1: int):
    """Pass 1 over the realigned bytes ``[j0, j1)``.

    ``words``: int32 (W,) raw stream, uint32 bits MSB first; per segment,
    int64 (S,): ``byte_start``, its first realigned byte; ``src_off``,
    its first stream bit less ``8 * byte_start``; ``end_bit``, ``8 *
    byte_start`` plus its unpadded bit count.  Returns ``(bytes uint8
    (j1 - j0,), k int64 (j1 - j0,))``, k each byte's segment."""
    j = torch.arange(j0, j1, dtype=torch.int64, device=words.device)
    k = torch.searchsorted(byte_start, j, right=True)
    k -= 1
    j8 = j.mul_(8)
    src_bit = src_off.index_select(0, k).add_(j8)
    w = src_bit >> 5
    sh = src_bit.bitwise_and_(31)
    hi = words.index_select(0, w).to(torch.int64).bitwise_and_(0xFFFFFFFF)
    w.add_(1).clamp_(max=words.numel() - 1)
    lo = words.index_select(0, w).to(torch.int64).bitwise_and_(0xFFFFFFFF)
    # Widened, a byte that starts on a word boundary shifts ``lo`` by 32 to
    # 0: the guard ``tpuenc``'s 32-bit funnel needs there is not needed.
    lo = lo.bitwise_right_shift_(32 - sh)
    b = hi.bitwise_left_shift_(sh).bitwise_or_(lo).bitwise_right_shift_(24)
    # The valid bits of the byte, end_bit - 8 j: 1..8 in the segment's
    # last byte, whose free low bits take the 1-padding, and more before.
    pad = 0xFF >> end_bit.index_select(0, k).sub_(j8).clamp_(max=8)
    return b.bitwise_or_(pad).to(torch.uint8), k


def stuff_markers(out: torch.Tensor, aligned: torch.Tensor, k: torch.Tensor,
                  j0: int, ff_before: torch.Tensor,
                  markers_before: torch.Tensor) -> torch.Tensor:
    """Pass 2 over the window :func:`realign` gave: scatter each byte to
    ``F(j)`` in ``out`` (zeroed, so each 0xFF's stuffed 0x00 is there).

    ``ff_before``: 0-d int64, the 0xFF bytes before ``j0``;
    ``markers_before``: (S,) twice the markers before each segment.
    Returns the running 0xFF count through each byte of the window, int64
    (inclusive, from the start of the stream)."""
    is_ff = (aligned == 0xFF).to(torch.int64)
    ff = torch.cumsum(is_ff, 0).add_(ff_before)
    F = torch.arange(j0, j0 + aligned.numel(), dtype=torch.int64,
                     device=out.device)
    F.add_(ff).sub_(is_ff).add_(markers_before.index_select(0, k))
    out.index_copy_(0, F, aligned)
    return ff


def device_stuff(buf_words: torch.Tensor, seg_bits: torch.Tensor,
                 seg_structure: Sequence[int], host_bits):
    """Run both passes on the words' device.

    ``buf_words``: int32 (W,) raw stream; ``seg_bits``: (S,) per-segment
    UNPADDED bit counts, an integer tensor on the same device;
    ``seg_structure``: per-scan segment counts; ``host_bits``: the same
    counts on the host, which size the passes and their windows.  Raises
    ``ValueError`` when the counts do not fit the plan or ask for more
    bits than the buffer holds.  Returns ``(out uint8 (2 n1 + 2 S,),
    seg_out_bytes int64 (S,), total_out int64 0-d)`` on the device:
    ``out[:total_out]`` is every scan's finished bytes in plan order, and
    ``seg_out_bytes`` each segment's final byte count (aligned bytes,
    stuffed zeros, trailing marker pair), whose prefix sums are the
    segment and scan boundaries in ``out``.  Nothing in it waits for the
    device, except the upload of a plan's marker layout at its first
    call."""
    with tracing.span("finish.device"):
        if buf_words.dtype != torch.int32 or buf_words.dim() != 1:
            raise ValueError(f"buf_words must be 1-D int32, got "
                             f"{tuple(buf_words.shape)} {buf_words.dtype}")
        host_bits = np.asarray(host_bits, np.int64)
        S = int(sum(seg_structure))
        if seg_bits.shape != (S,) or host_bits.shape != (S,) or S == 0:
            raise ValueError(f"{tuple(seg_bits.shape)} segment bit counts "
                             f"for a plan of {S} segments")
        if host_bits.min() < 0 or host_bits.sum() > 32 * buf_words.numel():
            raise ValueError(f"segments of {int(host_bits.sum())} bits in a "
                             f"stream of {buf_words.numel()} words")
        dev = buf_words.device
        emit, markers_before, marker_seg, rst = _markers(
            tuple(seg_structure), dev)
        seg_nbytes, byte_start, src_off, end_bit = segment_tables(seg_bits)
        byte_end = byte_start + seg_nbytes
        host_end = np.cumsum((host_bits + 7) >> 3)
        n1 = int(host_end[-1])

        out = torch.zeros(2 * n1 + 2 * S, dtype=torch.uint8, device=dev)
        # The running 0xFF count at each segment's end: its differences are
        # the segments' stuffed zeros (in place of tpuenc's segment_sum).
        ff_at_end = torch.zeros(S, dtype=torch.int64, device=dev)
        ff_before = torch.zeros((), dtype=torch.int64, device=dev)
        for j0 in range(0, n1, _WINDOW):
            j1 = min(n1, j0 + _WINDOW)
            aligned, k = realign(buf_words, byte_start, src_off, end_bit,
                                 j0, j1)
            ff = stuff_markers(out, aligned, k, j0, ff_before, markers_before)
            s0, s1 = np.searchsorted(host_end, (j0, j1), side="right")
            ff_at_end[s0:s1] = ff.index_select(0, byte_end[s0:s1] - (j0 + 1))
            ff_before = ff[-1]
        stuffed = torch.diff(ff_at_end, prepend=ff_at_end.new_zeros(1))
        seg_out_bytes = seg_nbytes + stuffed + 2 * emit
        marker_at = torch.cumsum(seg_out_bytes, 0).index_select(
            0, marker_seg) - 2
        out.index_fill_(0, marker_at, 0xFF)
        out.index_copy_(0, marker_at + 1, rst)
        return out, seg_out_bytes, seg_out_bytes.sum()


def stuff_chunk(words: torch.Tensor, carry: torch.Tensor, carry_bits: int,
                piece_bits, tail_open: bool, marker_m):
    """Finish one chunk of a scan's stream on its device: the chunked
    routes' finish, one chunk at a time, with the passes of
    :func:`device_stuff`.

    The chunk holds pieces of one or more restart segments: the first
    continues the segment the chunks before left open, each later one
    starts a segment.  ``words``: int32, the chunk's packed stream (at
    least its used words); ``carry``: int32 (1,) on the same device, the
    open segment's last ``carry_bits`` (0..7) bits that the chunks before
    did not finish, at the end of the word; ``piece_bits``, each piece's
    bits in the chunk (host, int64 (P,)); ``tail_open``, whether the last
    piece's segment goes on past the chunk (every other piece ends its
    segment); ``marker_m``, the RST index written after each piece (host,
    (P,)), -1 where none is.

    The passes run over one source, the carry word and then the chunk's
    words, so the first piece starts at source bit ``32 - carry_bits``.  A
    piece that closes gives its bytes with the 1-padded last one, stuffed,
    then its marker.  An open piece gives only its whole bytes, stuffed:
    no byte of it is partial, so none is padded, and its last ``bits & 7``
    bits stay on the device as the next chunk's carry.  Returns ``(out
    uint8, total int64 0-d, next carry int32 (1,), next carry bits)``:
    ``out[:total]`` is the chunk's finished bytes.  Nothing in it waits
    for the device."""
    # Per piece: its bits with the carry, realigned bytes, first source bit.
    bits = np.array(piece_bits, np.int64)
    P = bits.shape[0]
    n_words = (int(bits.sum()) + 31) >> 5
    bits[0] += carry_bits
    nbytes = (bits + 7) >> 3
    if tail_open:
        nbytes[-1] = bits[-1] >> 3
    host_end = np.cumsum(nbytes)
    byte_start = host_end - nbytes
    src_start = 32 - carry_bits + np.cumsum(bits) - bits
    emit = (np.asarray(marker_m) >= 0).astype(np.int64)
    marker_seg = np.flatnonzero(emit)
    # The tables: byte_start, src_off, end_bit (every byte of an open piece
    # is whole, so none is padded), byte_end, the bytes that are not
    # stuffed zeros, twice the markers before; the marker pieces, their RST.
    table = np.concatenate([
        byte_start, src_start - 8 * byte_start, 8 * byte_start + bits,
        host_end, nbytes + 2 * emit, 2 * (np.cumsum(emit) - emit),
        marker_seg, 0xD0 + np.asarray(marker_m, np.int64)[marker_seg]])
    dev = words.device
    tab = torch.from_numpy(table).to(dev, non_blocking=True)
    (byte_start, src_off, end_bit, byte_end, unstuffed,
     markers_before) = tab[:6 * P].view(6, P)
    marker_seg, rst = tab[6 * P:].view(2, -1)
    src = torch.cat([carry, words[:n_words]])
    n1 = int(host_end[-1])

    out = torch.zeros(2 * n1 + 2 * P, dtype=torch.uint8, device=dev)
    ff_at_end = torch.zeros(P, dtype=torch.int64, device=dev)
    ff_before = torch.zeros((), dtype=torch.int64, device=dev)
    for j0 in range(0, n1, _WINDOW):
        j1 = min(n1, j0 + _WINDOW)
        aligned, k = realign(src, byte_start, src_off, end_bit, j0, j1)
        ff = stuff_markers(out, aligned, k, j0, ff_before, markers_before)
        s0, s1 = np.searchsorted(host_end, (j0, j1), side="right")
        ff_at_end[s0:s1] = ff.index_select(0, byte_end[s0:s1] - (j0 + 1))
        ff_before = ff[-1]
    stuffed = torch.diff(ff_at_end, prepend=ff_at_end.new_zeros(1))
    seg_out_bytes = unstuffed + stuffed
    marker_at = torch.cumsum(seg_out_bytes, 0).index_select(
        0, marker_seg) - 2
    out.index_fill_(0, marker_at, 0xFF)
    out.index_copy_(0, marker_at + 1, rst.to(torch.uint8))

    carry_next = int(bits[-1] & 7) if tail_open else 0
    at = int(src_start[-1] + 8 * nbytes[-1])
    return (out, seg_out_bytes.sum(), _carry_word(src, at, carry_next),
            carry_next)


def _carry_word(src: torch.Tensor, at: int, n: int) -> torch.Tensor:
    """int32 (1,): source bits ``[at, at + n)`` of ``src`` (uint32 bits
    MSB first in int32 words), n <= 7, at the end of the word."""
    w, off = at >> 5, at & 31
    if n == 0:
        return src.new_zeros(1)
    hi = src[w:w + 1].to(torch.int64).bitwise_and_(0xFFFFFFFF)
    if off + n <= 32:
        v = hi >> (32 - off - n)
    else:  # the bits run into the next word
        r = off + n - 32
        lo = src[w + 1:w + 2].to(torch.int64).bitwise_and_(0xFFFFFFFF)
        v = (hi << r) | (lo >> (32 - r))
    return v.bitwise_and_((1 << n) - 1).to(torch.int32)
