"""Bounded-memory interleaved encode: MCU-row chunks through the device.

Counterpart of ``tpuenc/entropy/chunked.py``.  The image goes through the
device in chunks of ``chunk_mcu_rows`` MCU rows: each chunk's pixel rows
are read (from the whole array or from a pull source) and uploaded, turned
into its MCU stream (``kernels.pipeline.fn_cm`` at the chunk's height,
which pads the edges itself), packed (P1-P4, ``pallas_pack``) and finished
on the device by a :class:`StreamingStuffer` (realigned, 1-padded,
0xFF-stuffed, RST markers inline: ``device_stuff.stuff_chunk``), and only
the scan bytes that became final come back to the host.  Device memory,
host memory and the transfers are all O(chunk), so a 16K x 16K
4-component image encodes past the whole-image path's limits.  (``tpuenc``
finishes its chunks on the host; that finish is the tests' reference,
``testing.host_stuffer``.)

State across chunks is small and explicit: the DC predictor chain (the
previous chunk's last ``pat`` DC values, taken from the input
coefficients, feed ``dc_diffs_from_dc`` as ``prev_tail``) and the chunk's
first block index in the scan (``global_offset``), which fixes the restart
segments.  A restart segment may span chunks; the stuffer carries the last
partial byte of its bits from one chunk to the next, on the device.

:func:`pack_chunks` runs the chunks with a lookahead of one: chunk i+1 is
queued on the device before chunk i's results are read, so the host's
reads and copies of chunk i overlap the device work of chunk i+1.  On one
CUDA stream a plain ``.cpu()`` of chunk i would wait for chunk i+1's work
as well, so chunk i's reads and its finish go through :class:`HostCopy`: a
side stream behind an event recorded after chunk i's work.
"""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from .. import tracing
from ..core import errors
from ..core.types import ColorType
from ..kernels.pipeline import fn_cm
from .. import upload
from .device_encode import BUDGET_LADDER, EncodeParams, PinnedBuffer
from .device_stuff import stuff_chunk
from .pallas_pack import dc_diffs_from_dc, device_scan_pack


def append_bits(dst: bytearray, dst_bits: int, src: np.ndarray,
                src_bits: int) -> int:
    """Append ``src_bits`` bits of ``src`` (uint8, MSB-first) to ``dst``
    whose current length is ``dst_bits`` bits.  Returns the new bit
    length.  Vectorized byte-granular shift; O(len(src))."""
    if src_bits <= 0:
        return dst_bits
    nbytes = (src_bits + 7) >> 3
    src = src[:nbytes]
    rem_src = src_bits & 7
    if rem_src:  # mask junk past the source's last valid bit
        src = src.copy()
        src[-1] &= (0xFF << (8 - rem_src)) & 0xFF
    sh = dst_bits & 7
    if sh == 0:
        dst += src.tobytes()
    else:
        # First src byte ORs into dst's partial last byte; the rest are
        # pairwise shifted.
        hi = src >> sh
        lo = (src << (8 - sh)) & 0xFF
        dst[-1] |= int(hi[0])
        tail = lo[:-1] | hi[1:]
        dst += tail.tobytes()
        dst.append(int(lo[-1]))
    total = dst_bits + src_bits
    del dst[(total + 7) >> 3:]
    # Clear any stale bits past the new end in the final partial byte.
    rem = total & 7
    if rem:
        dst[-1] &= (0xFF << (8 - rem)) & 0xFF
    return total


class BitAccumulator:
    """Host-side raw bitstream accumulator for chunk streams."""

    def __init__(self):
        self.buf = bytearray()
        self.bits = 0

    def append_words(self, words: np.ndarray, nbits: int) -> None:
        # Big-endian bytes of the packed words: ``byteswap`` is numpy's
        # SIMD path; ``astype('>u4')`` converts element by element.
        w = np.ascontiguousarray(words, dtype=np.uint32)
        data = (w.byteswap() if sys.byteorder == "little" else w).view(np.uint8)
        self.bits = append_bits(self.buf, self.bits, data, int(nbits))


class StreamingStuffer:
    """Turn a scan's packed chunks into its final bytes (stuffed, RST
    markers inline) one chunk at a time, on the chunks' device, with
    O(chunk) memory.

    Segments start byte-aligned in the output (1-padded tails), so every
    whole byte of the open segment is final as soon as its bits exist:
    each chunk's finish (``device_stuff.stuff_chunk``) gives them all,
    closes the segments that end in the chunk, and leaves at most 7 bits
    of the open one on the device for the next chunk, the reference's
    streaming bit writer (writer.rs:138-202) at chunk granularity.  The
    host walks the segments over the blocks' bit counts and copies back
    only the finished bytes: into ``pinned`` (a :class:`PinnedPieces`),
    where given, else into a new host tensor (on the CPU, none: the
    pieces view the finish's output)."""

    def __init__(self, seg_blocks: int, total_blocks: int, pinned=None):
        self.seg = max(int(seg_blocks), 1)
        self.total = int(total_blocks)
        self.n_seg = -(-self.total // self.seg) if self.total else 1
        self.pinned = pinned
        self.blocks_done = 0
        self.seg_idx = 0        # the open segment
        self.carry = None       # its unfinished bits, int32 (1,) on the device
        self.carry_bits = 0

    def add_chunk(self, words: torch.Tensor, nbits: int,
                  lens: np.ndarray) -> memoryview:
        """Finish one chunk (its packed words on the device, their bit
        count, its blocks' bit lengths on the host) on the words' device,
        in the current stream; returns a read-only view of the bytes that
        became final, valid while ``pinned`` is not reset."""
        with tracing.span("finish.stream"):
            piece_bits, tail_open, marker_m = self._pieces(np.asarray(lens),
                                                           int(nbits))
            if self.carry is None:
                self.carry = words.new_zeros(1)
            out, total, self.carry, self.carry_bits = stuff_chunk(
                words, self.carry, self.carry_bits, piece_bits, tail_open,
                marker_m)
            tracing.count("device_finished_chunks")
        with tracing.span("sync.counts"):
            n = int(total)
        if n == 0:
            return memoryview(b"")
        with tracing.span("sync.bytes"):
            if self.pinned is None:
                data = out[:n].cpu().numpy()
            else:
                host = self.pinned.take(n)
                host.copy_(out[:n])
                data = host.numpy()
        return memoryview(data).toreadonly()

    def _pieces(self, lens: np.ndarray, nbits: int):
        """The chunk's pieces of segments, in order: each one's bits,
        whether the last one's segment goes on past the chunk, and the RST
        index written after each (-1 for none: the scan's last segment, or
        a piece left open).  Moves the walk past the chunk."""
        b0 = self.blocks_done
        b1 = b0 + lens.shape[0]
        if b1 > self.total:
            raise ValueError(f"fed {b1} blocks, expected {self.total}")
        # The segment ends in (b0, b1]: multiples of seg, and the scan's end.
        ends = np.arange((b0 // self.seg + 1) * self.seg, b1 + 1, self.seg)
        if b1 == self.total > b0 and (not ends.size or ends[-1] != b1):
            ends = np.append(ends, b1)
        n_close = ends.size
        P = n_close + int(not n_close or ends[-1] < b1)
        if lens.shape[0]:
            starts = np.concatenate([[b0], ends[:P - 1]]) - b0
            bits = np.add.reduceat(lens, starts, dtype=np.int64)
        else:
            bits = np.zeros(1, np.int64)
        if int(bits.sum()) != nbits:
            raise ValueError(f"blocks of {int(bits.sum())} bits in a chunk "
                             f"of {nbits}")
        idx = self.seg_idx + np.arange(P)
        marker_m = np.where((idx < self.seg_idx + n_close)
                            & (idx < self.n_seg - 1), idx % 8, -1)
        self.blocks_done = b1
        self.seg_idx += n_close
        return bits, P > n_close, marker_m

    def finish(self) -> bytes:
        """Check that all blocks were fed; every byte was already given
        by :meth:`add_chunk` (the last segment closes with its last
        block)."""
        with tracing.span("finish.stream"):
            if self.blocks_done != self.total:
                raise ValueError(
                    f"fed {self.blocks_done} blocks, expected {self.total}"
                )
            if self.seg_idx != self.n_seg:
                raise ValueError("segment accounting mismatch")
            tracing.count("restart_segments", self.n_seg)
            return b""


class PinnedPieces:
    """Page-locked host memory that a call's finished chunks are copied
    into end to end, so that each piece stays where its copy left it until
    the file is joined.  It grows to the power of two that holds what was
    taken since the last :meth:`reset` (the pieces before stay in the old
    buffer, which their views keep), and is reused after one: a piece
    holds until the next reset."""

    def __init__(self):
        self._buf = None
        self._used = 0

    def reset(self) -> None:
        self._used = 0

    def take(self, n: int) -> torch.Tensor:
        """The next ``n`` bytes, uint8."""
        end = self._used + n
        if self._buf is None or self._buf.numel() < end:
            self._buf = torch.empty(1 << max(0, end - 1).bit_length(),
                                    dtype=torch.uint8, pin_memory=True)
        piece = self._buf[self._used:end]
        self._used = end
        return piece


def _upload(slab: np.ndarray, device) -> torch.Tensor:
    """One chunk's host rows on ``device`` (``upload.to_device``)."""
    with tracing.span("upload"):
        return upload.to_device(slab, device)


def read_rows(pixels, y0: int, n: int, width: int, color_type: ColorType,
              device) -> torch.Tensor:
    """Pixel rows [y0, y0 + n) as a uint8 (n, width[, C]) tensor on
    ``device``.

    ``pixels`` is the whole (H, W[, C]) array, or a pull source, a
    callable ``(y0, n) -> rows``, the analog of the reference's
    per-scanline ``ImageBuffer::fill_buffers`` (image_buffer.rs:86-98): it
    returns bytes or an array of at least ``n * width`` pixels, or a uint8
    ``torch.Tensor`` already on ``device`` (rows made by another program
    on the card), which is checked and used there with no host round
    trip.  Too few rows or bytes raise ``BadImageData``."""
    bpp = color_type.bytes_per_pixel
    need = n * width * bpp
    if not callable(pixels):
        return _upload(pixels[y0:y0 + n], device)
    slab = pixels(y0, n)
    if isinstance(slab, torch.Tensor):
        if slab.device != torch.device(device) or slab.dtype != torch.uint8:
            raise ValueError(f"row source gave a {slab.dtype} tensor on "
                             f"{slab.device}, want uint8 on {device}")
        if slab.ndim != (2 if bpp == 1 else 3) or (bpp > 1 and slab.shape[2] != bpp):
            raise ValueError(f"row source gave shape {tuple(slab.shape)} for "
                             f"{bpp} channel(s)")
        if slab.shape[0] < n or slab.shape[1] < width:
            raise errors.BadImageData(slab.shape[0] * slab.shape[1] * bpp, need)
        return slab[:n, :width]
    flat = np.frombuffer(slab, np.uint8) if isinstance(
        slab, (bytes, bytearray, memoryview)
    ) else np.asarray(slab, np.uint8).reshape(-1)
    if flat.size < need:
        raise errors.BadImageData(flat.size, need)
    slab = flat[:need].reshape(n, width, bpp)
    return _upload(slab[..., 0] if bpp == 1 else slab, device)


class HostCopy:
    """Host copies of device results, and device work on them, that wait
    only for the work queued before a mark.  On a CUDA device both run on
    a side stream behind the mark's event (the copies into page-locked
    buffers reused by name), so they do not wait for work queued after
    the mark; on the CPU the tensors are already on the host."""

    def __init__(self, device):
        device = torch.device(device)
        self._side = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
        self._buffers: dict = {}

    def mark(self):
        """An event after the work queued so far on the current stream
        (None on the CPU)."""
        if self._side is None:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    @contextlib.contextmanager
    def behind(self, ready):
        """Queue the block's device work on the side stream behind
        ``ready`` (a :meth:`mark`); on the CPU, as it comes."""
        if self._side is None:
            yield
            return
        with torch.cuda.stream(self._side):
            self._side.wait_event(ready)
            yield

    def fetch(self, ready, **tensors):
        """numpy copies of ``tensors`` once ``ready`` (a :meth:`mark`) has
        passed, in keyword order.  The arrays view the buffers named by
        the keywords until the next fetch of the same name."""
        if self._side is None:
            return [t.numpy() for t in tensors.values()]
        hosts = []
        with self.behind(ready):
            for name, t in tensors.items():
                host = self._buffers.setdefault(name, PinnedBuffer()).take(
                    t.numel(), t.dtype).view(t.shape)
                host.copy_(t, non_blocking=True)
                hosts.append(host)
            done = torch.cuda.Event()
            done.record(self._side)
        done.synchronize()
        return [h.numpy() for h in hosts]


def _pack(blocks, dcdiff, valid, spec, params: EncodeParams, budget: int):
    """P1-P4 of one chunk at ``budget``: ``(stream int32, meta int64
    [overflow, bits], lens int16)``, ``lens`` cut to the chunk's
    ``valid`` blocks (all of them where it is None).  A block's bits fit
    int16 (at most 64 items of at most 32 bits), which halves their
    copy."""
    with tracing.span("pack", rung=budget, blocks=blocks.shape[1]):
        stream, bits, lens, ovf = device_scan_pack(
            blocks, spec, params.dc, params.ac, budget, dcdiff=dcdiff,
            valid_blocks=valid)
        n = blocks.shape[1] if valid is None else valid
        return (stream, torch.cat([ovf.to(torch.int64), bits.view(1)]),
                lens[:n].to(torch.int16))


def pack_chunks(chunks, spec, params: EncodeParams,
                stuffer: StreamingStuffer, ladder):
    """Pack each chunk of one scan and yield the stuffer's non-empty
    pieces, with a lookahead of one: chunk i's finish and its copy run on
    the side stream behind chunk i's work, while chunk i+1's is queued.

    ``chunks`` yields ``(blocks, dcdiff, valid)`` per chunk, in scan order
    (:func:`_pack`'s inputs); ``ladder`` is the list of budget rungs still
    to try, climbed in place: a chunk that overflows is packed again at
    the next rung, which later chunks start from, and the bytes already
    yielded stay valid (packed bits do not depend on the budget).  The
    top rung cannot overflow; if it did, RuntimeError."""
    copier = HostCopy(params.dc.device)

    def launch(inputs, budget):
        outs = _pack(*inputs, spec, params, budget)
        return inputs, budget, outs, copier.mark()

    def resolve(entry):
        inputs, budget, outs, ready = entry
        while True:
            with tracing.span("sync.meta"):
                meta, lens = copier.fetch(ready, meta=outs[1], lens=outs[2])
            if not meta[0]:
                break
            if budget >= ladder[-1]:
                raise RuntimeError("chunked pack overflow at the top rung")
            tracing.count("ladder_retries")
            while ladder[0] <= budget:
                ladder.pop(0)
            inputs, budget, outs, ready = launch(inputs, ladder[0])
        # Every tensor the finish reads is alive until it returns, and it
        # returns once the side stream has copied the chunk's bytes back.
        with copier.behind(ready):
            return stuffer.add_chunk(outs[0], int(meta[1]), lens)

    pending = None
    for inputs in chunks:
        entry = launch(inputs, ladder[0])
        if pending is not None:
            piece = resolve(pending)
            if piece:
                yield piece
        pending = entry
    if pending is not None:
        piece = resolve(pending)
        if piece:
            yield piece
    stuffer.finish()


def iter_encode_interleaved_chunked(pixels, plan, params: EncodeParams,
                                    chunk_mcu_rows: int = 64, ladder=None,
                                    pinned=None):
    """Bounded-memory interleaved scan encode, yielding final scan bytes
    (stuffed, RST markers inline) as MCU-row bands complete.

    ``pixels``: the whole array or a pull source (:func:`read_rows`);
    ``plan``: the call's ``plan.Plan``, of the interleaved mode;
    ``params``: the encoder's quantizers and packed tables on its device,
    where the chunks run; ``ladder``: the budget rungs to try, climbed in
    place (default: all of ``BUDGET_LADDER``), so that the caller can read
    the last rung from it; ``pinned``: a :class:`PinnedPieces` for the
    finished bytes, as :class:`StreamingStuffer` takes it.  The pieces are
    read-only views.  Only the last chunk is partial."""
    width, height = plan.width, plan.height
    color_type, config = plan.color_type, plan.config
    if config.mode() != "interleaved":
        raise ValueError(f"the chunked interleaved path takes an interleaved "
                         f"config, got {config.mode()}")
    layout = plan.layout
    ((_, spec, _),) = plan.scans
    pat = len(spec.dc_tab_pattern)
    mcu_h = 8 * layout["max_v"]
    num_rows = -(-height // mcu_h)
    total_blocks = layout["mcu_count"] * pat
    chunk_mcu_rows = min(chunk_mcu_rows, num_rows)
    chunk_blocks = chunk_mcu_rows * (layout["mcu_count"] // num_rows) * pat
    device = params.dc.device

    def chunks():
        prev_tail = torch.zeros(pat, dtype=torch.int32, device=device)
        for ci in range(-(-num_rows // chunk_mcu_rows)):
            y0 = ci * chunk_mcu_rows * mcu_h
            n = min(chunk_mcu_rows * mcu_h, height - y0)
            px = read_rows(pixels, y0, n, width, color_type, device)
            (mcu,) = fn_cm(px, width, n, color_type, config,
                           params.reciprocals, params.corrections)
            dcdiff = dc_diffs_from_dc(mcu[0], spec, prev_tail=prev_tail,
                                      global_offset=ci * chunk_blocks)
            # From the input coefficients, so that a chunk packed again
            # at a higher rung never changes the next chunk's input.
            prev_tail = mcu[0, -pat:]
            yield mcu, dcdiff, None

    stuffer = StreamingStuffer(spec.seg_blocks or total_blocks, total_blocks,
                               pinned)
    yield from pack_chunks(chunks(), spec, params, stuffer,
                           list(BUDGET_LADDER) if ladder is None else ladder)


def encode_interleaved_chunked(pixels, plan, params: EncodeParams,
                               chunk_mcu_rows: int = 64, ladder=None) -> bytes:
    """The single scan's entropy bytes (stuffed, RST markers inline) of
    :func:`iter_encode_interleaved_chunked`, joined."""
    pieces = list(iter_encode_interleaved_chunked(
        pixels, plan, params, chunk_mcu_rows, ladder))
    with tracing.span("assemble"):
        return b"".join(pieces)
