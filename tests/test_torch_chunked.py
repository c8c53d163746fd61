"""tpuenc_torch's bounded-memory paths (``entropy.chunked``,
``entropy.chunked_multipass``) and ``encode_stream`` against tpuenc, on
the CPU (the kernels' plain versions), byte for byte (integer arithmetic:
tolerance 0).

Chunking is forced with small ``chunk_mcu_rows`` / ``pack_chunk`` or by
lowering ``tpuenc_torch.plan.DEVICE_BLOCK_LIMIT``.  tpuenc's host path
(``TPUENC_DEVICE_ENTROPY=0``), which its own tests hold byte-identical to
its chunked device paths (tests/test_chunked.py), is the quick reference
for whole files and scan payloads.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import tpuenc  # noqa: E402
import tpuenc_torch as tt  # noqa: E402
from tpuenc.entropy import chunked as jchunked  # noqa: E402
from tpuenc.entropy import pallas_pack as jpack  # noqa: E402
from tpuenc_torch import plan as planning  # noqa: E402
from tpuenc_torch.entropy import chunked  # noqa: E402
from tpuenc_torch.entropy import native as tnative  # noqa: E402
from tpuenc_torch.entropy import pallas_pack as tpack  # noqa: E402
from tpuenc_torch.entropy.chunked_multipass import (  # noqa: E402
    encode_multipass_chunked,
)
from tpuenc_torch.entropy.device_encode import _dc_prev_delta  # noqa: E402
from tpuenc_torch.entropy.device_encode import (  # noqa: E402
    BUDGET_LADDER,
    params_from_numpy,
    tables_to_arrays,
)
from tpuenc_torch.entropy.device_pack import ScanSpec  # noqa: E402
from tpuenc_torch.jfif import segments  # noqa: E402
from tpuenc_torch.testing import host_stuffer  # noqa: E402

W, H = 70, 150  # many MCU rows; a partial trailing MCU in both axes


def _pixels(ch, seed, w=W, h=H):
    shape = (h, w) if ch == 1 else (h, w, ch)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _payloads(jpeg: bytes):
    """The entropy payload of every scan: after each SOS header, up to the
    next SOS (the encoders write every DHT before the first) or EOI."""
    out = []
    for part in jpeg.split(b"\xff\xda")[1:]:
        out.append(part[(part[0] << 8) | part[1]:])
    out[-1] = out[-1][:-2]
    return out


def _tpuenc_host(monkeypatch, quality, setup, px, ct, w=W, h=H):
    monkeypatch.setenv("TPUENC_DEVICE_ENTROPY", "0")
    enc = tpuenc.Encoder(quality)
    setup(enc, tpuenc)
    out = enc.encode(px, w, h, tpuenc.ColorType[ct])
    assert enc.last_encode_path == "host"
    return out


def _port(quality, setup):
    enc = tt.Encoder(quality, device="cpu")
    setup(enc, tt)
    return enc


# ---------------------------------------------------------------------------
# StreamingStuffer (each chunk finished by the device passes, here on CPU
# tensors), the host reference it replaced, and the native bulk flush.
# ---------------------------------------------------------------------------

def _chunks(rng, n_chunks, max_blocks, ff_heavy):
    """Random chunks: (words uint32, nbits, lens) with lens summing to
    nbits; 0xFF-heavy chunks are mostly all-ones words."""
    out = []
    for _ in range(n_chunks):
        lens = rng.integers(0, 90, int(rng.integers(1, max_blocks)))
        out.append(_chunk(rng, lens, ff_heavy=ff_heavy))
    return out


def _chunk(rng, lens, junk_words=0, ff_heavy=False):
    """One chunk of blocks of ``lens`` bits, its words random (past the
    used ones, ``junk_words`` more, as a pack's capacity leaves them)."""
    lens = np.asarray(lens, np.int64)
    nbits = int(lens.sum())
    words = rng.integers(0, 2**32, (nbits + 31) // 32 + junk_words,
                         dtype=np.uint64)
    if ff_heavy:
        words[rng.random(words.shape[0]) < 0.9] = 0xFFFFFFFF
    return words.astype(np.uint32), nbits, lens


def _feed(chunks, seg, total, carries=None):
    """Each chunk through the port's stuffer and tpuenc's, piece against
    piece; ``carries``: the bits the port's leaves on the device after
    each chunk."""
    mine = chunked.StreamingStuffer(seg, total)
    ref = jchunked.StreamingStuffer(seg, total)
    for i, (words, nbits, lens) in enumerate(chunks):
        got = mine.add_chunk(torch.from_numpy(words.view(np.int32)), nbits,
                             lens.astype(np.int16))
        assert bytes(got) == ref.add_chunk(words, nbits, lens), i
        if carries is not None:
            assert mine.carry_bits == carries[i], i
    assert mine.finish() == ref.finish() == b""


STUFFER_CASES = [
    (0, 12, 40, False),        # one segment: mid-segment flushes only
    (7, 12, 40, False),        # segments spanning chunks
    (3, 20, 9, True),          # 0xFF-heavy, several segments per chunk
    (0, 3, 40000, True),       # flushes of >= 64 KiB: the native stuffer
    (5000, 4, 30000, False),   # native flushes inside long segments
]


@pytest.mark.parametrize("seg,n_chunks,max_blocks,ff_heavy", STUFFER_CASES)
def test_streaming_stuffer_matches_tpuenc(seg, n_chunks, max_blocks, ff_heavy):
    rng = np.random.default_rng(seg * 31 + n_chunks)
    chunks = _chunks(rng, n_chunks, max_blocks, ff_heavy)
    total = sum(len(lens) for _, _, lens in chunks)
    _feed(chunks, seg or total, total)


@pytest.mark.parametrize("seg,n_chunks,max_blocks,ff_heavy", STUFFER_CASES)
def test_host_stuffer_matches_tpuenc(seg, n_chunks, max_blocks, ff_heavy):
    """The host finish the chunked routes ran before, kept as a
    reference."""
    rng = np.random.default_rng(seg * 31 + n_chunks)
    chunks = _chunks(rng, n_chunks, max_blocks, ff_heavy)
    total = sum(len(lens) for _, _, lens in chunks)
    mine = host_stuffer.HostStreamingStuffer(seg or total, total)
    ref = jchunked.StreamingStuffer(seg or total, total)
    for words, nbits, lens in chunks:
        assert mine.add_chunk(words, nbits, lens) == \
            ref.add_chunk(words, nbits, lens)
    assert mine.finish() == ref.finish() == b""


@pytest.mark.parametrize("carry", range(1, 8))
def test_chunk_finish_carries_each_bit_offset(carry):
    """A segment left open with ``carry`` bits past its last whole byte:
    those bits stay on the device and lead the next chunk, where the
    segment closes mid-chunk and the next opens."""
    rng = np.random.default_rng(carry)
    lens = rng.integers(1, 60, 9)
    lens[-1] += (carry - lens.sum()) % 8
    chunks = [_chunk(rng, lens), _chunk(rng, rng.integers(1, 60, 10)),
              _chunk(rng, rng.integers(1, 60, 5))]
    _feed(chunks, 12, 24, carries=[carry, int(chunks[1][2][3:].sum() & 7), 0])


def _bits_to(rng, n, mod8, low=1, high=60):
    """``n`` block lengths whose sum is ``mod8`` modulo 8."""
    lens = rng.integers(low, high, n)
    lens[-1] += (mod8 - lens.sum()) % 8
    return lens


CHUNK_CASES = {
    # a chunk of 0 bits that closes the segment its carry of 3 bits opened
    # (one padded byte and its marker) and opens the next
    "zero_bits_after_a_carry": (6, lambda r: [
        _chunk(r, _bits_to(r, 5, 3)), _chunk(r, np.zeros(4, np.int64)),
        _chunk(r, r.integers(1, 60, 7))]),
    # a chunk of 0 bits with nothing carried: a segment of 0 bits, its
    # marker alone
    "zero_bits_no_carry": (4, lambda r: [
        _chunk(r, r.integers(1, 60, 4)), _chunk(r, np.zeros(4, np.int64)),
        _chunk(r, r.integers(1, 60, 4))]),
    # every chunk ends on a segment's last bit, one of them on a byte
    # boundary (no padding)
    "closes_on_the_last_bit": (5, lambda r: [
        _chunk(r, _bits_to(r, 5, 0)), _chunk(r, r.integers(1, 60, 10)),
        _chunk(r, r.integers(1, 60, 5))]),
    # 26 segments of one block: RST0-7 wrap three times, across chunks
    "rst_wrap": (1, lambda r: [
        _chunk(r, r.integers(1, 60, 7)), _chunk(r, r.integers(1, 60, 13)),
        _chunk(r, r.integers(1, 60, 6))]),
    # words past each chunk's bits, 0xFF-heavy, as a masked chunk's
    # capacity leaves them
    "words_past_the_bits": (9, lambda r: [
        _chunk(r, r.integers(0, 90, 20), junk_words=7, ff_heavy=True)
        for _ in range(4)]),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_finish_edges_match_tpuenc(case):
    seg, make = CHUNK_CASES[case]
    chunks = make(np.random.default_rng(len(case)))
    _feed(chunks, seg, sum(len(lens) for _, _, lens in chunks))


def test_multipass_masked_last_chunk_matches_tpuenc_stuffer(monkeypatch):
    """The multipass route's chunks as its packer hands them to the
    stuffer, the last masked to the component's blocks: the port's chunk
    finish gives tpuenc's stuffer's pieces on the same chunks."""
    fed = []
    real = chunked.StreamingStuffer.add_chunk

    def recording(self, words, nbits, lens):
        fed.append((self, words.numpy().view(np.uint32).copy(), nbits,
                    lens.copy()))
        return real(self, words, nbits, lens)

    monkeypatch.setattr(chunked.StreamingStuffer, "add_chunk", recording)
    q, ct, ch, setup, rows, _ = MULTIPASS["progressive_restart"]
    enc = _port(q, setup)
    _, huffman, params = enc._default_tables(enc._config())
    got = encode_multipass_chunked(
        _pixels(ch, 7), enc._plan(W, H, tt.ColorType[ct]), huffman, params,
        chunk_mcu_rows=rows, pack_chunk=96)
    assert any(st.total % 96 for st, *_ in fed)
    refs, out = {}, []
    for st, words, nbits, lens in fed:
        ref = refs.setdefault(st, jchunked.StreamingStuffer(st.seg, st.total))
        out.append(ref.add_chunk(words, nbits, lens))
    pieces = [bytes(p) for scan in got for p in scan]
    assert [p for p in out if p] == pieces


@pytest.mark.parametrize("bit_off", [0, 3, 13, 8 * 70001 + 5])
def test_stuff_stream_matches_extract(bit_off):
    """The native flush equals the numpy extract + stuff, on a 0xFF-heavy
    buffer past the 64 KiB threshold."""
    rng = np.random.default_rng(bit_off)
    buf = bytearray(rng.integers(0, 256, 300_000, np.uint8).tobytes())
    for i in range(0, len(buf), 3):
        buf[i] = 0xFF
    nbytes = 200_000
    want = host_stuffer.extract_bytes(buf, bit_off, nbytes).replace(
        b"\xff", b"\xff\x00")
    assert tnative.stuff_stream(buf, bit_off, nbytes) == want


def test_stuff_stream_raises_outside_the_buffer():
    """tpuenc's binding returns None where the port's raises."""
    buf = bytes(100)
    with pytest.raises(ValueError):
        tnative.stuff_stream(buf, 1, 100)
    with pytest.raises(ValueError):
        tnative.stuff_stream(buf, -8, 1)
    assert tnative.stuff_stream(buf, 8, 99) == bytes(99)


def test_append_bits_random():
    rng = np.random.default_rng(0)
    ref_bits = []
    dst = bytearray()
    bits = 0
    for _ in range(40):
        n = int(rng.integers(1, 77))
        chunk = rng.integers(0, 2, n).tolist()
        ref_bits += chunk
        by = np.zeros((n + 7) // 8, np.uint8)
        for j, b in enumerate(chunk):
            by[j >> 3] |= b << (7 - (j & 7))
        bits = chunked.append_bits(dst, bits, by, n)
    assert bits == len(ref_bits)
    assert [(dst[j >> 3] >> (7 - (j & 7))) & 1 for j in range(bits)] == ref_bits


# ---------------------------------------------------------------------------
# Mid-stream DC differences.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pattern,seg_mcus,chunk_mcus", [
    ((0,), 0, 7),                           # one component
    ((0, 1, 2), 5, 4),                      # 4:4:4, restart not dividing
    ((0, 0, 0, 0, 1, 2), 3, 5),             # 4:2:0
    ((0, 0, 0, 0, 1, 2, 3, 3, 3, 3), 0, 6),  # YCCK 4:2:0, F_2_2
    ((0, 0, 1, 2), 7, 3),                   # 4:2:2
])
def test_dc_diffs_midstream_match_tpuenc(pattern, seg_mcus, chunk_mcus):
    """Each chunk's mid-stream differences equal tpuenc's on the same
    chunk, and the chunks together give the whole-stream differences."""
    pat = len(pattern)
    spec = ScanSpec(1, 64, True, True, tuple(min(c, 1) for c in pattern),
                    tuple(min(c, 1) for c in pattern), _dc_prev_delta(pattern),
                    seg_mcus * pat)
    rng = np.random.default_rng(pat + seg_mcus)
    dc = rng.integers(-1024, 1024, 23 * pat).astype(np.int16)
    whole = tpack.dc_diffs_from_dc(torch.from_numpy(dc), spec).numpy()
    got = []
    for b0 in range(0, dc.shape[0], chunk_mcus * pat):
        tail = (dc[b0 - pat:b0] if b0 else np.zeros(pat, np.int16))
        chunk = dc[b0:b0 + chunk_mcus * pat]
        mine = tpack.dc_diffs_from_dc(
            torch.from_numpy(chunk), spec,
            prev_tail=torch.from_numpy(tail.astype(np.int32)),
            global_offset=b0).numpy()
        ref = np.asarray(jpack.dc_diffs_from_dc(
            jnp.asarray(chunk), spec,
            prev_tail=jnp.asarray(tail.astype(np.int32)), global_offset=b0))
        np.testing.assert_array_equal(mine, ref)
        got.append(mine)
    np.testing.assert_array_equal(np.concatenate(got), whole)


@pytest.mark.parametrize("spec,valid", [
    (ScanSpec(1, 64, True, True, (0, 0, 0, 0, 1, 1), (0, 0, 0, 0, 1, 1),
              _dc_prev_delta((0, 0, 0, 0, 1, 2)), 18), 300),
    (ScanSpec(1, 1, True, False, (0,), (0,), (1,), 5), 250),   # DC only
    (ScanSpec(6, 20, False, True, (1,), (1,), (1,), 0), 301),  # AC band
])
def test_device_scan_pack_matches_tpuenc(spec, valid):
    """P1-P4 of a chunk with a mid-stream DC chain and a masked tail, K2's
    plain version (or the DC path) through the merge's, against tpuenc's
    Pallas kernels in interpret mode."""
    from tpuenc.core.tables import default_tables
    from tpuenc_torch.core.tables import quantization_table

    rng = np.random.default_rng(valid)
    B = 312
    q = (rng.laplace(0, 3, (64, B)) * (rng.random((64, B)) < 0.3)).astype(
        np.int16)
    q[0] = rng.integers(-300, 300, B)
    tail = rng.integers(-300, 300, len(spec.dc_tab_pattern)).astype(np.int32)
    go = 7 * len(spec.dc_tab_pattern)
    arrays = tables_to_arrays([list(p) for p in default_tables()])
    params = params_from_numpy([quantization_table("default", 90, True),
                                quantization_table("default", 90, False)],
                               *arrays, "cpu")
    dcdiff = tpack.dc_diffs_from_dc(torch.from_numpy(q[0]), spec,
                                    prev_tail=torch.from_numpy(tail),
                                    global_offset=go)
    stream, bits, lens, ovf = tpack.device_scan_pack(
        torch.from_numpy(q), spec, params.dc, params.ac, 16, dcdiff=dcdiff,
        valid_blocks=valid)
    jdc, jac = jpack.pack_tables(arrays)
    jdcdiff = jpack.dc_diffs_from_dc(jnp.asarray(q[0]), spec,
                                     prev_tail=jnp.asarray(tail),
                                     global_offset=go)
    jstream, jbits, jlens, jovf = jpack.device_scan_pack(
        jnp.asarray(q), spec, jdc, jac, 16, interpret=True, dcdiff=jdcdiff,
        valid_blocks=valid, cm=True, tile=512)
    np.testing.assert_array_equal(dcdiff.numpy(), np.asarray(jdcdiff))
    assert int(bits) == int(jbits) and bool(ovf.item()) == bool(jovf)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    assert not lens[valid:].any()
    used = (int(bits) + 31) // 32
    np.testing.assert_array_equal(stream[:used].numpy(),
                                  np.asarray(jstream)[:used].view(np.int32))


# ---------------------------------------------------------------------------
# The chunked interleaved path.
# ---------------------------------------------------------------------------

INTERLEAVED = {
    "plain": (85, "RGB", 3, lambda e, m: None, 2),
    "restart5": (85, "RGB", 3, lambda e, m: e.set_restart_interval(5), 2),
    "420_restart3": (85, "RGB", 3, lambda e, m: (
        e.set_sampling_factor(m.SamplingFactor.F_2_2),
        e.set_restart_interval(3)), 3),
    "luma": (90, "LUMA", 1, lambda e, m: None, 3),
    "cmyk": (90, "CMYK", 4, lambda e, m: None, 4),
}


@pytest.mark.parametrize("name", sorted(INTERLEAVED))
def test_interleaved_chunked_matches_tpuenc(name, monkeypatch):
    q, ct, ch, setup, rows = INTERLEAVED[name]
    px = _pixels(ch, len(name))
    (want,) = _payloads(_tpuenc_host(monkeypatch, q, setup, px, ct))
    enc = _port(q, setup)
    params = enc._default_tables(enc._config())[2]
    ladder = list(BUDGET_LADDER)
    got = chunked.encode_interleaved_chunked(
        px, enc._plan(W, H, tt.ColorType[ct]), params, chunk_mcu_rows=rows,
        ladder=ladder)
    assert got == want
    assert ladder[-1] == 224 and ladder[0] >= 4


def test_top_rung_overflow_raises(monkeypatch):
    """Overflow at the top rung raises RuntimeError (tpuenc returns None
    to a host fallback the port does not have)."""
    enc = _port(90, lambda e, m: None)
    params = enc._default_tables(enc._config())[2]
    real = chunked._pack

    def overflowing(*args):
        stream, meta, lens = real(*args)
        return stream, meta.clone().fill_(1), lens

    monkeypatch.setattr(chunked, "_pack", overflowing)
    with pytest.raises(RuntimeError, match="top rung"):
        chunked.encode_interleaved_chunked(
            _pixels(3, 1, 16, 16), enc._plan(16, 16, tt.ColorType.RGB), params)


# ---------------------------------------------------------------------------
# The chunked multipass path.
# ---------------------------------------------------------------------------

MULTIPASS = {
    "sequential_f41": (85, "RGB", 3, lambda e, m: e.set_sampling_factor(
        m.SamplingFactor.F_4_1), 2, 1 << 20),
    "progressive_restart": (85, "RGB", 3, lambda e, m: (
        e.set_progressive_scans(4), e.set_restart_interval(5)), 3, 128),
    "optimized": (90, "RGB", 3, lambda e, m:
                  e.set_optimized_huffman_tables(True), 2, 256),
    "optimized_progressive": (88, "RGB", 3, lambda e, m: (
        e.set_optimized_huffman_tables(True), e.set_progressive(True)), 4,
        1 << 20),
    "ycck_optimized_420": (90, "CMYK_AS_YCCK", 4, lambda e, m: (
        e.set_sampling_factor(m.SamplingFactor.F_2_2),
        e.set_optimized_huffman_tables(True)), 2, 128),
}


@pytest.mark.parametrize("name", sorted(MULTIPASS))
def test_multipass_chunked_matches_tpuenc(name, monkeypatch):
    """Every scan payload, with chunk boundaries in the coefficient phase
    (the optimized modes' DC-count correction) and tiny pack chunks
    crossing restart segments; the optimized tables are tpuenc's."""
    q, ct, ch, setup, rows, pack = MULTIPASS[name]
    px = _pixels(ch, len(name))
    want = _tpuenc_host(monkeypatch, q, setup, px, ct)
    enc = _port(q, setup)
    _, huffman, params = enc._default_tables(enc._config())
    got = encode_multipass_chunked(px, enc._plan(W, H, tt.ColorType[ct]),
                                   huffman, params, chunk_mcu_rows=rows,
                                   pack_chunk=pack)
    assert [b"".join(pieces) for pieces in got] == _payloads(want)
    head = want[:want.index(b"\xff\xda")]
    for i, (dc, ac) in enumerate(huffman[:2]):
        assert segments.dht(0, i, dc) in head
        assert segments.dht(1, i, ac) in head


# ---------------------------------------------------------------------------
# Routing: encode and encode_batch over the forced limit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,path", [
    ("restart5", "device-chunked"),
    ("420_restart3", "device-chunked"),
    ("progressive_restart", "device-chunked-multipass"),
    ("optimized", "device-chunked-multipass"),
])
def test_encode_over_the_limit(name, path, monkeypatch):
    q, ct, ch, setup = (INTERLEAVED.get(name) or MULTIPASS[name])[:4]
    px = _pixels(ch, 99)
    want = _tpuenc_host(monkeypatch, q, setup, px, ct)
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 10)
    enc = _port(q, setup)
    assert enc.encode(px, W, H, tt.ColorType[ct]) == want
    assert enc.last_encode_path == path
    assert enc.last_budget in BUDGET_LADDER
    files = enc.encode_batch([px, px[::-1].copy()], W, H, tt.ColorType[ct])
    assert enc.last_encode_path == "device-batch-per-image"
    assert files[0] == want
    assert files[1] == _port(q, setup).encode(px[::-1].copy(), W, H,
                                              tt.ColorType[ct])


def test_fused_over_the_limit_takes_the_split_chunked_path(monkeypatch):
    px = _pixels(3, 7)
    want = tt.Encoder(90, device="cpu").encode(px, W, H, tt.ColorType.RGB)
    monkeypatch.setattr(planning, "DEVICE_BLOCK_LIMIT", 10)
    enc = tt.Encoder(90, device="cpu", fused_p1=True)
    assert enc.encode(px, W, H, tt.ColorType.RGB) == want
    assert enc.last_encode_path == "device-chunked"


# ---------------------------------------------------------------------------
# encode_stream.
# ---------------------------------------------------------------------------

def _rows_of(px):
    return lambda y0, n: px[y0:y0 + n]


@pytest.mark.parametrize("kind", ["array", "bytes", "callable", "get_rows",
                                  "tensor"])
def test_encode_stream_interleaved(kind, monkeypatch):
    """Pieces join to encode's bytes; rows are pulled one band at a time;
    several pieces come before the end."""
    setup = INTERLEAVED["420_restart3"][3]
    px = _pixels(3, 21)
    want = _tpuenc_host(monkeypatch, 85, setup, px, "RGB")
    pulls = []

    def rows(y0, n):
        pulls.append(n)
        return px[y0:y0 + n]

    class Source:
        def get_rows(self, y0, n):
            return rows(y0, n).tobytes()

    data = {"array": px, "bytes": px.tobytes(), "callable": rows,
            "get_rows": Source(),
            "tensor": lambda y0, n: torch.from_numpy(rows(y0, n))}[kind]
    enc = _port(85, setup)
    pieces = list(enc.encode_stream(data, W, H, tt.ColorType.RGB,
                                    chunk_mcu_rows=2))
    assert b"".join(pieces) == want
    assert enc.last_encode_path == "device-chunked-stream"
    assert len(pieces) >= 5 and pieces[-1] == b"\xff\xd9"
    if kind not in ("array", "bytes"):
        assert max(pulls) <= 32 and sum(pulls) == H


@pytest.mark.parametrize("kind", ["bytes", "tensor"])
def test_encode_stream_short_rows_raise(kind):
    enc = tt.Encoder(90, device="cpu")
    px = _pixels(3, 3)

    def short(y0, n):
        rows = px[y0:y0 + n - 1]
        return rows.tobytes() if kind == "bytes" else torch.from_numpy(rows)

    with pytest.raises(tt.BadImageData):
        b"".join(enc.encode_stream(short, W, H, tt.ColorType.RGB))


@pytest.mark.parametrize("name,n_pieces", [
    ("progressive_restart", 13),   # 3 DC + 9 AC band scans + EOI
    ("optimized", 4),              # 3 sequential scans + EOI
])
def test_encode_stream_multiscan_per_scan(name, n_pieces, monkeypatch):
    """Multi-pass modes drain a pull source once and give one piece per
    scan, each after the first starting with its SOS."""
    q, ct, ch, setup = MULTIPASS[name][:4]
    px = _pixels(ch, 5)
    want = _tpuenc_host(monkeypatch, q, setup, px, ct)
    pulls = []

    def rows(y0, n):
        pulls.append((y0, n))
        return px[y0:y0 + n]

    for data in (px, rows):
        pieces = list(_port(q, setup).encode_stream(data, W, H,
                                                    tt.ColorType[ct]))
        assert b"".join(pieces) == want
        assert len(pieces) == n_pieces and pieces[-1] == b"\xff\xd9"
        assert all(p[:2] == b"\xff\xda" for p in pieces[1:-1])
    assert pulls == [(0, H)]


def test_encode_stream_many_scans_one_body_piece(monkeypatch):
    """A plan of more than 48 scans streams as one body piece, as in
    tpuenc."""
    setup = lambda e, m: e.set_progressive_scans(20)  # noqa: E731
    px = _pixels(3, 8, 32, 24)
    want = _tpuenc_host(monkeypatch, 90, setup, px, "RGB", 32, 24)
    pieces = list(_port(90, setup).encode_stream(px, 32, 24,
                                                 tt.ColorType.RGB))
    assert pieces == [want]
