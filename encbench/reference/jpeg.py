"""A plain JPEG encoder: the semantics of vstroebel/jpeg-encoder v0.7.0.

The benchmark holds every file that the timed path produced against this
encoder's bytes.  It is written from the published algorithms, in plain
PyTorch tensor operations on whatever device it is given, and shares no
code with the program under test:

* colour conversion by the reference's 2^16 fixed-point transform with its
  ``+0x7FFF`` round (image_buffer.rs:9-38); CMYK as YCCK inverts K;
* edge replication out to the MCU grid and chroma subsampling by taking
  the top-left sample of each cell (encoder.rs:738-744, 1222-1242);
* the level shift, libjpeg's ``jpeg_fdct_islow`` (LL&M with 13 fractional
  bits, outputs scaled by 8) and division by the x8 table through the
  reference's reciprocal (quantization.rs:185-307);
* interleaved, sequential and spectral-selection progressive scans with
  default or two-pass Annex K.2 tables (encoder.rs:556-975);
* Huffman coding one bit at a time: every symbol is expanded into its bits
  in scan order, the bits are packed into bytes, the last byte is padded
  with ones and every 0xFF is followed by 0x00;
* restart intervals: DRI, the DC predictions reset, each segment padded
  with ones to a byte and RST0-RST7 in turn between segments;
* the JFIF segments (writer.rs:204-452).

``const_bits`` below 13 computes the transform with fewer fractional bits:
the benchmark's control, a lower-precision transform that a correct
encoder must not give.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import tables

# Blocks coded per step of the bit expansion (bounds its memory).
BAND_BLOCKS = 1 << 18


def _components(color_type: str, sampling):
    """(id, quantization/Huffman table, h, v) per component
    (encoder.rs:569-619)."""
    h, v = sampling
    if color_type == "rgb":
        return [(0, 0, h, v), (1, 1, 1, 1), (2, 1, 1, 1)]
    if color_type == "cmyk_as_ycck":
        return [(0, 0, h, v), (1, 1, 1, 1), (2, 1, 1, 1), (3, 0, h, v)]
    raise ValueError(f"unsupported colour type {color_type!r}")


def _planes(px, color_type: str):
    """int64 (H, W) planes in JPEG colour space from (H, W, C) uint8."""
    x = px.to(torch.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = (19595 * r + 38470 * g + 7471 * b + 0x7FFF) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 0x7FFF) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 0x7FFF) >> 16
    if color_type == "rgb":
        return [y, cb, cr]
    return [y, cb, cr, 255 - x[..., 3]]


def _fdct_constants(const_bits: int):
    c = {k: round(v * (1 << const_bits)) for k, v in {
        "0.298631336": 0.298631336, "0.390180644": 0.390180644,
        "0.541196100": 0.541196100, "0.765366865": 0.765366865,
        "0.899976223": 0.899976223, "1.175875602": 1.175875602,
        "1.501321110": 1.501321110, "1.847759065": 1.847759065,
        "1.961570560": 1.961570560, "2.053119869": 2.053119869,
        "2.562915447": 2.562915447, "3.072711026": 3.072711026}.items()}
    return c


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _dct_pass(v, c, const_bits: int, first: bool):
    """One 1-D pass of jpeg_fdct_islow over the 8 tensors of ``v``."""
    pass1 = 2
    t0, t7 = v[0] + v[7], v[0] - v[7]
    t1, t6 = v[1] + v[6], v[1] - v[6]
    t2, t5 = v[2] + v[5], v[2] - v[5]
    t3, t4 = v[3] + v[4], v[3] - v[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << pass1, (t10 - t11) << pass1
        n = const_bits - pass1
    else:
        out[0], out[4] = _descale(t10 + t11, pass1), _descale(t10 - t11, pass1)
        n = const_bits + pass1
    z1 = (t12 + t13) * c["0.541196100"]
    out[2] = _descale(z1 + t13 * c["0.765366865"], n)
    out[6] = _descale(z1 - t12 * c["1.847759065"], n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * c["1.175875602"]
    t4, t5 = t4 * c["0.298631336"], t5 * c["2.053119869"]
    t6, t7 = t6 * c["3.072711026"], t7 * c["1.501321110"]
    z1, z2 = -z1 * c["0.899976223"], -z2 * c["2.562915447"]
    z3 = -z3 * c["1.961570560"] + z5
    z4 = -z4 * c["0.390180644"] + z5
    out[7] = _descale(t4 + z1 + z3, n)
    out[5] = _descale(t5 + z2 + z4, n)
    out[3] = _descale(t6 + z2 + z3, n)
    out[1] = _descale(t7 + z1 + z4, n)
    return out


def _quantized(blocks, divisors, const_bits: int):
    """(N, 8, 8) int64 samples minus 128 -> (N, 64) quantized
    coefficients in zigzag order."""
    c = _fdct_constants(const_bits)
    rows = torch.stack(_dct_pass([blocks[..., i] for i in range(8)], c,
                                 const_bits, True), -1)
    coef = torch.stack(_dct_pass([rows[..., i, :] for i in range(8)], c,
                                 const_bits, False), -2)
    dev = blocks.device
    zz = coef.reshape(-1, 64)[:, torch.from_numpy(tables.ZIGZAG).to(dev)]
    pairs = [tables.reciprocal(int(d) * 8) for d in divisors[tables.ZIGZAG]]
    rec = torch.tensor([p[0] for p in pairs], dtype=torch.int64, device=dev)
    corr = torch.tensor([p[1] for p in pairs], dtype=torch.int64, device=dev)
    q = ((zz.abs() + corr) * rec) >> 15
    return torch.where(zz < 0, -q, q)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _component_blocks(planes, comps, rows, width, height, const_bits,
                      divisors):
    """Each component's quantized blocks of the MCU rows [r0, r1), as
    (block rows, block cols, 64) over its MCU-padded grid."""
    r0, r1 = rows
    max_h = max(c[2] for c in comps)
    max_v = max(c[3] for c in comps)
    mcu_w, mcu_h = 8 * max_h, 8 * max_v
    pad_w = _cdiv(width, mcu_w) * mcu_w
    dev = planes[0].device
    ys = torch.arange(r0 * mcu_h, r1 * mcu_h, device=dev).clamp(max=height - 1)
    xs = torch.arange(pad_w, device=dev).clamp(max=width - 1)
    out = []
    for (cid, tab, ch, cv), plane in zip(comps, planes):
        sv, sh = max_v // cv, max_h // ch
        p = plane.index_select(0, ys[::sv]).index_select(1, xs[::sh]) - 128
        R, C = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.reshape(R, 8, C, 8).permute(0, 2, 1, 3).reshape(-1, 8, 8)
        out.append(_quantized(blocks, divisors[tab], const_bits)
                   .reshape(R, C, 64))
    return out


def _bitlen(v):
    a = v.abs()
    n = torch.zeros_like(a)
    while bool((a > 0).any()):
        n += (a > 0).to(n.dtype)
        a = a >> 1
    return n


def _magnitude(v, size):
    """The extra bits of value ``v`` in category ``size``."""
    return torch.where(v < 0, v - 1, v) & ((1 << size) - 1)


class _Writer:
    """Scan bits: symbols are expanded into single bits in order, packed
    MSB first into bytes, and 0xFF-stuffed.  Where items carry restart
    segments, each segment's bits are padded with ones to a whole byte and
    RSTn (n counting 0 to 7) goes before every segment but the first
    (encoder.rs's ``finalize_bit_buffer`` and ``Marker::RST``)."""

    def __init__(self, device):
        self.dev = device
        self.carry = torch.zeros(0, dtype=torch.uint8, device=device)
        self.seg = 0  # the segment that the carried bits belong to
        self.out = []
        self.n_bytes = 0
        self.marker_at, self.marker_seg = [], []
        self.weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1],
                                    dtype=torch.int64, device=device)

    def put(self, values, lengths, segments=None):
        """Append items: ``values`` int64 holding ``lengths`` bits each;
        ``segments``: each item's restart segment, non-decreasing."""
        keep = lengths > 0
        values, lengths = values[keep], lengths[keep]
        if values.numel() == 0:
            return
        item = torch.repeat_interleave(
            torch.arange(values.numel(), device=self.dev), lengths)
        start = torch.cumsum(lengths, 0) - lengths
        pos = torch.arange(item.numel(), device=self.dev) - start[item]
        shift = lengths[item] - 1 - pos
        bits = torch.cat([self.carry,
                          ((values[item] >> shift) & 1).to(torch.uint8)])
        if segments is None:
            self._bytes(bits)
            return
        seg = torch.cat([torch.full_like(self.carry, 0, dtype=torch.int64)
                         + self.seg, segments[keep][item]])
        ids, counts = torch.unique_consecutive(seg, return_counts=True)
        size = counts + (-counts) % 8
        size[-1] = counts[-1]  # the last segment stays open
        old = torch.cumsum(counts, 0) - counts
        new = torch.cumsum(size, 0) - size
        k = torch.repeat_interleave(torch.arange(ids.numel(), device=self.dev),
                                    counts)
        padded = torch.ones(int(size.sum()), dtype=torch.uint8,
                            device=self.dev)
        padded[torch.arange(bits.numel(), device=self.dev) - old[k]
               + new[k]] = bits
        opened = (ids != self.seg) & (ids > 0)
        self.marker_at.append(self.n_bytes + new[opened] // 8)
        self.marker_seg.append(ids[opened])
        self.seg = int(ids[-1])
        self._bytes(padded)

    def _bytes(self, bits):
        whole = bits.numel() // 8 * 8
        self.carry = bits[whole:]
        if whole:
            b = (bits[:whole].reshape(-1, 8).to(torch.int64)
                 * self.weights).sum(1)
            self.out.append(b.to(torch.uint8))
            self.n_bytes += whole // 8

    def finish(self) -> bytes:
        if self.carry.numel():
            pad = torch.ones(8 - self.carry.numel(), dtype=torch.uint8,
                             device=self.dev)
            self._bytes(torch.cat([self.carry, pad]))
        if not self.out:
            return b""
        raw = torch.cat(self.out)
        ff = (raw == 0xFF).to(torch.int64)
        extra = torch.zeros_like(ff)
        at = torch.cat([torch.zeros(0, dtype=torch.int64, device=self.dev)]
                       + self.marker_at)
        seg = torch.cat([torch.zeros(0, dtype=torch.int64, device=self.dev)]
                        + self.marker_seg)
        extra[at] = 2
        total = extra + 1 + ff
        first = torch.cumsum(total, 0) - total
        stuffed = torch.zeros(int(total.sum()), dtype=torch.uint8,
                              device=self.dev)
        stuffed[first + extra] = raw
        stuffed[first[at]] = 0xFF
        stuffed[first[at] + 1] = (0xD0 + (seg - 1) % 8).to(torch.uint8)
        return stuffed.cpu().numpy().tobytes()


def _items(q, prev_dc, dc_tab, ac_tab, ss, se, huff, segments=None):
    """The (values, lengths) of the blocks ``q`` (N, 64), in coding order,
    for the band [ss, se]: the DC difference from ``prev_dc`` (N,) where
    ss is 0, then per coefficient of the AC band its ZRLs and its symbol,
    then an EOB where the band ends in zeros.  ``dc_tab``/``ac_tab``: (N,)
    table ids; ``huff``: (sizes, codes) tensors indexed [kind, table,
    symbol]; ``segments``: (N,) each block's restart segment, passed on
    as each item's."""
    sizes, codes = huff
    N = q.shape[0]
    vals, lens = [], []
    if ss == 0:
        diff = q[:, 0] - prev_dc
        s = _bitlen(diff)
        n = sizes[0, dc_tab, s]
        vals.append((codes[0, dc_tab, s] << s) | _magnitude(diff, s))
        lens.append(n + s)
    a0 = max(ss, 1)
    if se >= a0:
        band = q[:, a0:se + 1]
        L = band.shape[1]
        nz = band != 0
        idx = torch.arange(L, device=q.device).expand(N, L)
        last = torch.cummax(torch.where(nz, idx, torch.full_like(idx, -1)),
                            1).values
        prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
        run = torch.where(nz, idx - prev - 1, torch.zeros_like(idx))
        t = ac_tab[:, None].expand(N, L)
        zlen = sizes[1, t, 0xF0]
        zrl = torch.zeros_like(run)
        for k in range(3):
            zrl = torch.where(run >> 4 > k, (zrl << zlen) | codes[1, t, 0xF0],
                              zrl)
        s = _bitlen(band)
        sym = ((run & 15) << 4) | s
        sym_val = (codes[1, t, sym] << s) | _magnitude(band, s)
        sym_len = torch.where(nz, sizes[1, t, sym] + s, torch.zeros_like(s))
        pair_v = torch.stack([zrl, sym_val], -1).reshape(N, 2 * L)
        pair_l = torch.stack([(run >> 4) * zlen, sym_len], -1).reshape(N, 2 * L)
        vals.append(pair_v)
        lens.append(pair_l)
        eob = last[:, -1] < L - 1
        vals.append(codes[1, ac_tab, 0])
        lens.append(torch.where(eob, sizes[1, ac_tab, 0], 0))
    v = torch.cat([x.reshape(N, -1) for x in vals], 1).reshape(-1)
    n = torch.cat([x.reshape(N, -1) for x in lens], 1).reshape(-1)
    if segments is not None:
        segments = segments.repeat_interleave(v.numel() // N)
    return v, n, segments


def _huff_tensors(pairs, device):
    """[kind (DC, AC), table, symbol] size and code tensors from
    ((dc BITS, HUFFVAL), (ac BITS, HUFFVAL)) per table id."""
    sizes = np.zeros((2, len(pairs), 256), np.int64)
    codes = np.zeros((2, len(pairs), 256), np.int64)
    for t, pair in enumerate(pairs):
        for kind, (bits, values) in enumerate(pair):
            sizes[kind, t], codes[kind, t] = tables.code_table(bits, values)
    return (torch.from_numpy(sizes).to(device),
            torch.from_numpy(codes).to(device))


def _segment(marker: int, data: bytes) -> bytes:
    return bytes((0xFF, marker)) + struct.pack(">H", len(data) + 2) + data


def _headers(width, height, comps, divisors, huff_pairs, progressive,
             color_type, restart):
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\0\x01\x02\x00"
                                 + struct.pack(">HH", 1, 1) + b"\0\0")
    if color_type == "cmyk_as_ycck":
        out += _segment(0xEE, b"Adobe\0\0\0\0\0\0\x02")
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for cid, tab, h, v in comps:
        sof += bytes((cid, (h << 4) | v, tab))
    out += _segment(0xC2 if progressive else 0xC0, sof)
    for t in range(2):
        out += _segment(0xDB, bytes((t,)) + bytes(
            int(x) for x in divisors[t][tables.ZIGZAG]))
    for t, (dc, ac) in enumerate(huff_pairs):
        out += _segment(0xC4, bytes((t,)) + bytes(dc[0]) + bytes(dc[1]))
        out += _segment(0xC4, bytes((0x10 | t,)) + bytes(ac[0]) + bytes(ac[1]))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    return out


def _sos(scan_comps, ss, se) -> bytes:
    data = bytes((len(scan_comps),))
    for cid, tab, _, _ in scan_comps:
        data += bytes((cid, (tab << 4) | tab))
    return _segment(0xDA, data + bytes((ss, se, 0)))


def _progressive_bands(scans: int):
    n = scans - 1
    vps = 64 // n
    return [(max(k * vps, 1), 64 if k == n - 1 else (k + 1) * vps)
            for k in range(n)]


def _dc_prev(d, restart):
    """Each block's DC prediction in a one-component scan: the block
    before's DC, 0 at the scan's start and at each restart."""
    prev = torch.cat([d.new_zeros(1), d[:-1]])
    if restart:
        prev[::restart] = 0
    return prev


def _histograms(comp_q, comps, bands):
    """Annex K.2 input: per table id the DC and AC symbol counts over
    every scan that codes with it, bin 256 the reserved symbol.  The DC
    differences are counted along each component's blocks with no reset
    at restarts, as the reference's ``optimize_huffman_table`` counts
    them."""
    out = []
    for t in range(min(len(comps), 2)):
        dc = torch.zeros(257, dtype=torch.int64)
        ac = torch.zeros(257, dtype=torch.int64)
        dc[256] = ac[256] = 1
        for (cid, tab, _, _), q in zip(comps, comp_q):
            if tab != t:
                continue
            d = q[:, 0]
            diff = d - _dc_prev(d, 0)
            dc += torch.bincount(_bitlen(diff), minlength=257).cpu()[:257]
            for a, b in bands:
                band = q[:, a:b]
                L = band.shape[1]
                if L == 0:
                    continue
                nz = band != 0
                idx = torch.arange(L, device=q.device).expand_as(band)
                last = torch.cummax(torch.where(nz, idx, -1), 1).values
                prev = torch.cat([torch.full_like(last[:, :1], -1),
                                  last[:, :-1]], 1)
                run = idx - prev - 1
                sym = ((run & 15) << 4) | _bitlen(band)
                ac += torch.bincount(sym[nz], minlength=257).cpu()[:257]
                ac[0xF0] += int((run[nz] >> 4).sum())
                ac[0x00] += int((last[:, -1] < L - 1).sum())
        out.append((dc, ac))
    return out


def encode(pixels: np.ndarray, *, color_type: str, quality: int,
           sampling=(1, 1), progressive_scans=None, optimize_tables=False,
           restart_interval=None, device="cpu",
           const_bits: int = 13) -> bytes:
    """The JPEG file of ``pixels`` ((H, W, C) uint8) as the reference
    encoder writes it, with default quantization tables and the default
    density.  ``sampling``: (h, v) of the luma and K components.
    Interleaved where the mode allows (encoder.rs:556-562): no
    progressive scans, default tables, factors of 1 or 2.
    ``restart_interval``: MCUs of each scan between restart markers (a
    block is an MCU of a one-component scan), None or 0 for none."""
    height, width = pixels.shape[:2]
    comps = _components(color_type, sampling)
    divisors = [tables.quant_table(tables.LUMA_QUANT, quality),
                tables.quant_table(tables.CHROMA_QUANT, quality)]
    px = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
    planes = _planes(px, color_type)
    del px
    max_h = max(c[2] for c in comps)
    max_v = max(c[3] for c in comps)
    mcu_rows = _cdiv(height, 8 * max_v)
    mcu_cols = _cdiv(width, 8 * max_h)
    restart = int(restart_interval or 0)
    progressive = progressive_scans is not None
    interleaved = not progressive and not optimize_tables

    if interleaved:
        huff_pairs = [(tables.LUMA_DC, tables.LUMA_AC),
                      (tables.CHROMA_DC, tables.CHROMA_AC)][:min(len(comps), 2)]
        huff = _huff_tensors(huff_pairs, device)
        writer = _Writer(device)
        last_dc = torch.zeros(len(comps), dtype=torch.int64, device=device)
        comp_of = torch.tensor([i for i, c in enumerate(comps)
                                for _ in range(c[2] * c[3])], device=device)
        tab_of = torch.tensor([comps[i][1] for i in comp_of.tolist()],
                              device=device)
        bpm = comp_of.numel()  # blocks an MCU
        first_of_comp = torch.tensor(
            [comp_of[:j].tolist().count(int(comp_of[j])) == 0
             for j in range(bpm)], device=device)
        band_rows = max(1, BAND_BLOCKS // (mcu_cols * len(comp_of)))
        for r0 in range(0, mcu_rows, band_rows):
            r1 = min(r0 + band_rows, mcu_rows)
            blocks = _component_blocks(planes, comps, (r0, r1), width, height,
                                       const_bits, divisors)
            mcu = []  # (MCUs, blocks per MCU, 64) in encoder.rs:759-769's order
            for (cid, tab, ch, cv), b in zip(comps, blocks):
                R, C = b.shape[0] // cv, b.shape[1] // ch
                mcu.append(b.reshape(R, cv, C, ch, 64).permute(0, 2, 1, 3, 4)
                           .reshape(R * C, cv * ch, 64))
            q = torch.cat(mcu, 1)
            n_mcu = q.shape[0]
            q = q.reshape(-1, 64)
            comp = comp_of.repeat(n_mcu)
            prev = torch.empty_like(q[:, 0])
            for i in range(len(comps)):
                mask = comp == i
                d = q[mask, 0]
                prev[mask] = torch.cat([last_dc[i:i + 1], d[:-1]])
                last_dc[i] = d[-1]
            mcu = (r0 * mcu_cols + torch.arange(n_mcu, device=device)
                   ).repeat_interleave(bpm)
            segments = None
            if restart:
                prev[(mcu % restart == 0) & first_of_comp.repeat(n_mcu)] = 0
                segments = mcu // restart
            tab = tab_of.repeat(n_mcu)
            writer.put(*_items(q, prev, tab, tab, 0, 63, huff, segments))
        body = _sos(comps, 0, 63) + writer.finish()
        return (_headers(width, height, comps, divisors, huff_pairs, False,
                         color_type, restart) + body + b"\xff\xd9")

    # Sequential and progressive: one stream per component over its own
    # grid, ceil(ceil(dim / 8) / scale) blocks each way (encoder.rs:1012-1025).
    blocks = _component_blocks(planes, comps, (0, mcu_rows), width, height,
                               const_bits, divisors)
    comp_q = []
    for (cid, tab, ch, cv), b in zip(comps, blocks):
        rows = _cdiv(_cdiv(height, 8), max_v // cv)
        cols = _cdiv(_cdiv(width, 8), max_h // ch)
        comp_q.append(b[:rows, :cols].reshape(-1, 64))
    if progressive:
        scans = [(i, 0, 0) for i in range(len(comps))]
        scans += [(i, a, b - 1) for a, b in _progressive_bands(progressive_scans)
                  for i in range(len(comps))]
        bands = _progressive_bands(progressive_scans)
    else:
        scans = [(i, 0, 63) for i in range(len(comps))]
        bands = [(1, 64)]
    if optimize_tables:
        huff_pairs = [(tables.optimized_table(dc.tolist()),
                       tables.optimized_table(ac.tolist()))
                      for dc, ac in _histograms(comp_q, comps, bands)]
    else:
        huff_pairs = [(tables.LUMA_DC, tables.LUMA_AC),
                      (tables.CHROMA_DC, tables.CHROMA_AC)][:min(len(comps), 2)]
    huff = _huff_tensors(huff_pairs, device)
    body = b""
    for i, ss, se in scans:
        q = comp_q[i]
        tab = torch.full((q.shape[0],), comps[i][1], device=device)
        prev = _dc_prev(q[:, 0], restart)
        block = torch.arange(q.shape[0], device=device)
        writer = _Writer(device)
        for a in range(0, q.shape[0], BAND_BLOCKS):
            b = slice(a, a + BAND_BLOCKS)
            if ss > 0 and se < ss:
                continue
            writer.put(*_items(q[b], prev[b], tab[b], tab[b], ss, se, huff,
                               block[b] // restart if restart else None))
        body += _sos([comps[i]], ss, se) + writer.finish()
    return (_headers(width, height, comps, divisors, huff_pairs, progressive,
                     color_type, restart) + body + b"\xff\xd9")


