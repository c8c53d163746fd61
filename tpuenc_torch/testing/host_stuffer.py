"""The host finish of the chunked routes, on no route: the tests' reference
for ``entropy.chunked.StreamingStuffer``, which finishes each chunk on the
encode device.

:class:`HostStreamingStuffer` appends each chunk's packed words to a host
bit buffer (``entropy.chunked.BitAccumulator``) and flushes the whole bytes
that became final, 0xFF-stuffed (runs of at least 64 KiB through the
native ``tpuenc_stuff_stream``, shorter ones through :func:`extract_bytes`
and ``bytes.replace``), closing each restart segment with its 1-padded
last byte and RST marker: ``tpuenc``'s ``StreamingStuffer``, which the
tests hold it to.
"""

from __future__ import annotations

import numpy as np

from ..entropy import native
from ..entropy.chunked import BitAccumulator


def extract_bytes(buf: bytearray, rel_bit: int, nbytes: int) -> bytes:
    """Whole output bytes [rel_bit, rel_bit + 8*nbytes) of the raw bit
    buffer, MSB-first (vectorized shift)."""
    if nbytes <= 0:
        return b""
    b0 = rel_bit >> 3
    sh = rel_bit & 7
    a = np.frombuffer(bytes(memoryview(buf)[b0:b0 + nbytes + 1]), np.uint8)
    if sh == 0:
        return a[:nbytes].tobytes()
    if a.shape[0] < nbytes + 1:
        a = np.concatenate([a, np.zeros(nbytes + 1 - a.shape[0], np.uint8)])
    w = (a.astype(np.uint16) << 8)
    out = ((w[:-1] | a[1:]) >> (8 - sh)).astype(np.uint8)
    return out.tobytes()


class HostStreamingStuffer:
    """Incrementally turn the raw device bitstream into the final stuffed,
    RST-marker-interleaved scan bytes with O(pending-chunk) memory, on the
    host: the chunked routes' finish before it moved to the device
    (``entropy.chunked.StreamingStuffer``), kept as the tests' reference.

    Segments start byte-aligned in the output (1-padded tails), so any
    whole output byte of the current segment is final as soon as its bits
    exist: it is 0xFF-stuffed (0xFF -> 0xFF 0x00) and flushed at once,
    the reference's streaming bit writer (writer.rs:138-202) at chunk
    granularity.
    """

    def __init__(self, seg_blocks: int, total_blocks: int):
        self.seg = max(int(seg_blocks), 1)
        self.total = int(total_blocks)
        self.n_seg = -(-self.total // self.seg) if self.total else 1
        self.acc = BitAccumulator()
        self.base_bit = 0       # absolute bit index of acc.buf[0] bit 0
        self.read_bit = 0       # absolute next-unflushed bit
        self.blocks_done = 0
        self.seg_idx = 0
        self.seg_bits = 0       # bits fed into the current segment so far
        self.seg_flushed = 0    # whole bytes of the current segment flushed

    def _seg_len(self, idx: int) -> int:
        if idx == self.n_seg - 1:
            return self.total - idx * self.seg
        return self.seg

    def add_chunk(self, words: np.ndarray, nbits: int,
                  lens: np.ndarray) -> bytes:
        """Feed one device chunk (packed words + per-block bit lengths);
        returns the output bytes that became final."""
        self.acc.append_words(words, nbits)
        out = bytearray()
        lens = np.asarray(lens, dtype=np.int64)
        pos = 0
        n = lens.shape[0]
        while pos < n:
            room = self._seg_len(self.seg_idx) - (
                self.blocks_done - self.seg_idx * self.seg
            )
            take = min(room, n - pos)
            self.seg_bits += int(lens[pos:pos + take].sum())
            self.blocks_done += take
            pos += take
            if take == room:
                self._finish_segment(out)
        # Mid-segment: flush the whole bytes that are already final.  Runs
        # of at least 64 KiB go through the native chunk-parallel stuffer;
        # shorter ones through the numpy extract and bytes.replace.  Both
        # give the same bytes.
        avail = (self.seg_bits - 8 * self.seg_flushed) >> 3
        if avail > 0:
            rel = self.read_bit - self.base_bit
            if avail >= (1 << 16):
                stuffed = native.stuff_stream(self.acc.buf, rel, avail)
            else:
                stuffed = extract_bytes(self.acc.buf, rel, avail).replace(
                    b"\xff", b"\xff\x00")
            out += stuffed
            self.read_bit += 8 * avail
            self.seg_flushed += avail
        self._compact()
        return bytes(out)

    def _finish_segment(self, out: bytearray) -> None:
        nbits = self.seg_bits - 8 * self.seg_flushed
        if nbits > 0:
            whole = nbits >> 3
            raw = extract_bytes(
                self.acc.buf, self.read_bit - self.base_bit, whole
            )
            out += raw.replace(b"\xff", b"\xff\x00")
            rem = nbits & 7
            if rem:
                rel = self.read_bit - self.base_bit + 8 * whole
                b0 = rel >> 3
                window = int.from_bytes(self.acc.buf[b0:b0 + 2], "big") \
                    if b0 + 1 < len(self.acc.buf) else \
                    int.from_bytes(self.acc.buf[b0:b0 + 1] + b"\x00", "big")
                sh = rel & 7
                bits = (window >> (16 - sh - rem)) & ((1 << rem) - 1)
                pad = 8 - rem
                byte = (bits << pad) | ((1 << pad) - 1)
                out.append(byte)
                if byte == 0xFF:
                    out.append(0x00)
            self.read_bit += nbits
        self.seg_idx += 1
        self.seg_bits = 0
        self.seg_flushed = 0
        if self.seg_idx < self.n_seg:
            out += bytes((0xFF, 0xD0 + ((self.seg_idx - 1) & 7)))

    def finish(self) -> bytes:
        """Check that all blocks were fed; every byte was already flushed
        by :meth:`add_chunk` (the last segment closes with its last
        block)."""
        if self.blocks_done != self.total:
            raise ValueError(
                f"fed {self.blocks_done} blocks, expected {self.total}"
            )
        if self.seg_idx != self.n_seg:
            raise ValueError("segment accounting mismatch")
        return b""

    def _compact(self) -> None:
        drop = (self.read_bit - self.base_bit) >> 3
        if drop > 4096:
            del self.acc.buf[:drop]
            self.base_bit += 8 * drop
            self.acc.bits -= 8 * drop
