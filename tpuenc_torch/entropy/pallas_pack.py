"""Entropy bit packing on the device: P1 (K2, K6, K8), P2 (K3), P3 (K4), P4 (K5).

Counterpart of ``tpuenc/entropy/pallas_pack.py``.  The four stages turn a
coefficient-major (64, B) int16 block stream into one raw bit
concatenation of the blocks' Huffman codes (no byte alignment: the host
realigns, pads and stuffs each restart segment):

* P1, :func:`pack_blocks` (K2): one MSB-aligned bit string per block, for
  an interleaved or sequential scan or one band; :func:`fused_sample_pack`
  (K8): the same strings of an interleaved scan straight from its samples,
  with the fDCT, quantize and DC differences of K1 in the same pass;
  :func:`pack_acbands`
  (K6): the strings of up to 7 progressive AC bands of one component in
  one pass; :func:`dc_only_pack_blocks`: the one-word strings of a DC-only
  scan (plain PyTorch, as it is XLA in ``tpuenc``).
* P2, :func:`merge_chunks` (K3): 128 substreams of consecutive blocks,
  each cut into chunks merged into one row.
* P3, :func:`fold_rows` (K4): each substream's chunk rows folded into one
  row (skipped when :func:`fold_plan` says so, as on the TPU).
* P4, :func:`concat_rows` (K5): the rows placed at their bit offsets in
  one stream.

Every stage keeps the TPU version's capacities (:func:`block_caps`,
:func:`chunk_caps`, :func:`fold_caps`) and sets its overflow flag exactly
where the TPU kernel sets its own, so the budget ladder learns the same
rung.  The kernels are CUDA C++ (``csrc/``); each has a plain PyTorch
version here (``*_ref``) with the same contract, which the wrappers run
for CPU tensors.  Bit words travel as int32 tensors holding the uint32 bit
pattern (PyTorch has no CPU shifts for uint32); the plain versions compute
in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from ..kernels.pallas_fdct import fdct_quantize_ref
from .device_pack import ScanSpec

MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Capacity schedules and plans (pure Python, identical to the TPU version).
# ---------------------------------------------------------------------------

def block_caps(budget_words: int):
    """Chunk word capacities for the six in-block merge levels (windows of
    2, 4, ..., 64 slot items).  Items are single words, so level k holds at
    most 2^k words and the early caps never overflow."""
    caps = []
    c = 1
    for k in range(1, 7):
        n_slots = 1 << k
        limit = max(5, (budget_words * n_slots + 63) // 64 + 2)
        c = min(2 * c, limit)
        caps.append(c)
    return caps


def final_block_cap(budget: int) -> int:
    return block_caps(budget)[-1] + 1


def chunk_caps(cap_in: int, n_chunks: int, budget: int):
    """Capacity schedule for merging ``n_chunks`` single-block chunks of
    ``cap_in`` words (P2)."""
    caps = []
    c = cap_in
    blocks = 1
    n = n_chunks
    while n > 1:
        blocks *= 2
        # Absolute burst slack, saturating at 256 words.
        c = min(2 * c, budget * blocks + 16 * min(blocks, 16))
        caps.append(c)
        n //= 2
    return caps


def fold_caps(cap_in: int, n_chunks: int, budget_eff: int):
    """Capacity schedule for the P3 row fold: like :func:`chunk_caps` but
    every cap is rounded up to a multiple of 128 words."""
    caps = []
    c = cap_in
    blocks = 1
    n = n_chunks
    while n > 1:
        blocks *= 2
        c = min(2 * c, budget_eff * blocks + 256)
        c = -(-c // 128) * 128
        caps.append(c)
        n //= 2
    return caps


def fold_plan(n2p: int, capP: int, n_sub: int, budget_eff: int):
    """The TPU's P3 plan: ``(s_tile, caps)``, or None when even one
    substream per step would not fit its 6 MiB VMEM budget, in which case
    P3 is skipped and P4 takes every chunk row.  The port follows the same
    decision so that it runs, and flags, the same stages; it does not use
    ``s_tile``."""
    caps = fold_caps(capP, n2p, budget_eff)

    def est(s):
        b = 4 * s * n2p * capP + 4 * s * caps[-1]
        rows = n2p
        for c in caps:
            rows //= 2
            b += 16 * s * rows * c
        return b

    s = min(16, n_sub)
    while s >= 1:
        if n_sub % s == 0 and est(s) <= 6 << 20:
            return s, caps
        s //= 2
    return None


# ---------------------------------------------------------------------------
# Helpers of the plain versions: int64 arithmetic on 32-bit words.
# ---------------------------------------------------------------------------

def _to_i32(x):
    """int64 values in [0, 2^32) -> int32 tensor with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _u32(x):
    """int32 bit pattern -> int64 value in [0, 2^32)."""
    return x.to(torch.int64) & MASK32


def _shl(x, n):
    """``x << n`` on 32-bit words with pallas_pack._shl's guards."""
    return torch.where(n >= 32, 0, (x << n.clamp(0, 31)) & MASK32)


def _mask(n):
    return torch.where(n >= 32, MASK32, (torch.ones_like(n) << n.clamp(0, 31)) - 1)


def _bit_length(av):
    """Magnitude category of a non-negative int64 tensor (< 2^53): 0 for
    0, else its bit length, which is frexp's exponent (exact in
    float64)."""
    exp = torch.frexp(av.to(torch.float64)).exponent.to(torch.int64)
    return torch.where(av == 0, 0, exp)


def _scatter_words(n_rows: int, cap: int, row_idx, off, words, active):
    """OR MSB-aligned 32-bit ``words`` (int64) starting at bit ``off`` of
    row ``row_idx`` into a zeroed (n_rows, cap) int32 array; bits past
    ``cap`` words are dropped.  Sources never share bits, so a sum is an
    OR."""
    d = off >> 5
    ph = off & 31
    hi = torch.where(active, words >> ph, 0)
    lo = torch.where(active & (ph != 0), (words << (32 - ph)) & MASK32, 0)
    width = cap + 1  # column ``cap`` collects what is dropped
    out = torch.zeros(n_rows * width, dtype=torch.int64, device=words.device)
    base = row_idx * width
    out.index_add_(0, (base + d.clamp(max=cap)).reshape(-1), hi.reshape(-1))
    out.index_add_(0, (base + (d + 1).clamp(max=cap)).reshape(-1),
                   lo.reshape(-1))
    return _to_i32(out.view(n_rows, width)[:, :cap] & MASK32)


# ---------------------------------------------------------------------------
# P1 (K2): per-block bit strings.
# ---------------------------------------------------------------------------

def _p1_caps(budget: int):
    caps = block_caps(budget)
    return caps[2], caps[3], caps[4], caps[5], caps[5] + 1


def _check_spec(spec: ScanSpec):
    if len(spec.dc_tab_pattern) > 16:
        raise ValueError("table pattern longer than 16 blocks")


def _check_tables(spec: ScanSpec, dc_tab, ac_tab, B: int, Bp: int, device):
    """What K2 and K8 need of the packed tables and the output rows."""
    n_tabs = ac_tab.shape[0]
    cuda_lib.check_tensor("dc_tab", dc_tab, torch.int32, (1, 128), device)
    cuda_lib.check_tensor("ac_tab", ac_tab, torch.int32, (n_tabs, 256), device)
    if Bp < B:
        raise ValueError(f"Bp {Bp} < B {B}")
    if max(spec.dc_tab_pattern + spec.ac_tab_pattern) >= min(n_tabs, 8):
        raise ValueError("table pattern names a missing table")


def _k2_band(spec: ScanSpec):
    """The band K2 codes: the scan's own, or for a DC-only scan the empty
    band [0, 0), which gives no AC item and no EOB."""
    if spec.emit_ac:
        return spec.spectral_start, spec.spectral_end
    return 0, 0


def _ac_items(qq, ss: int, se: int, acl, act, valid):
    """The AC items of band [ss, se) (P1's slot items, as the TPU kernels
    place them): ``qq`` int64 (64, Bp) coefficients; ``acl`` int64 (T,
    256) AC tables; ``act`` the table id of every block ((Bp,) or a
    scalar); ``valid`` (Bp,) bool.  Returns ``(lens, words, last)``:
    int64 (64, Bp) item lengths and MSB-aligned words, zero outside the
    band (a ZRL sits in the zero slot with ``run % 16 == 15`` before the
    band's last nonzero), and each block's last nonzero slot of the band,
    -1 if none."""
    dev = qq.device
    Bp = qq.shape[1]
    slot = torch.arange(64, device=dev)[:, None]
    in_band = (slot >= ss) & (slot < se)
    band = torch.where(in_band, qq, 0)
    nz = band != 0
    lastnz = torch.where(nz, slot, -1).cummax(dim=0).values
    prevnz = torch.cat(
        [torch.full((1, Bp), -1, dtype=torch.int64, device=dev), lastnz[:-1]]
    ).clamp(min=ss - 1)
    run = slot - prevnz - 1
    size = _bit_length(band.abs())
    extra = (band - (band < 0).long()) & _mask(size)
    sym = ((run & 15) << 4) | size
    # The TPU kernels look symbols up in two 128-entry halves: sym 256
    # (size 16) reads entry 128.
    sym = torch.where(sym < 256, sym, 128 + (sym & 127))
    lut = acl[act, sym]
    sym_len = (lut >> 16) + size
    sym_w = _shl(_shl(lut & 0xFFFF, size) | extra, 32 - sym_len)
    zrl = acl[act, 0xF0]
    zrl_len = zrl >> 16
    zrl_w = _shl(zrl & 0xFFFF, 32 - zrl_len)
    last = lastnz[63]
    item = nz & valid
    zrl_here = (~nz) & in_band & ((run & 15) == 15) & (slot < last) & valid
    lens = torch.where(item, sym_len, torch.where(zrl_here, zrl_len, 0))
    words = torch.where(item, sym_w, torch.where(zrl_here, zrl_w, 0))
    return lens, words, last


def _eob_item(acl, act, last, se: int, valid):
    """Each block's EOB item (length, MSB-aligned word), int64 (Bp,): set
    when the band's last nonzero lies below se - 1."""
    eob = acl[act, 0]
    eob_len = torch.where((last < se - 1) & valid, eob >> 16, 0)
    return eob_len, _shl(eob & 0xFFFF, 32 - eob_len.clamp(max=32))


def pack_blocks_ref(q, dcdiff, dc_tab, ac_tab, spec: ScanSpec, Bp: int,
                    budget: int):
    """Plain version of K2.

    ``q``: int16 (64, B) zigzag coefficients; ``dcdiff``: int32 (B,) DC
    differences; ``dc_tab``: int32 (1, 128) [table*16 + size] and
    ``ac_tab``: int32 (T, 256) [symbol], both ``size << 16 | code``;
    ``Bp >= B`` output rows; ``budget``: the block-level budget (callers
    pass ``max(budget, 16)``).  Returns ``(words int32 (Bp, capB), lens
    int32 (Bp,), overflow int32 (1,))``, capB = final_block_cap(budget)."""
    _check_spec(spec)
    dev = q.device
    B = q.shape[1]
    ss, se = _k2_band(spec)
    cap8, cap16, cap32, cap64, capB = _p1_caps(budget)

    qq = torch.zeros((64, Bp), dtype=torch.int64, device=dev)
    qq[:, :B] = q
    diff = torch.zeros(Bp, dtype=torch.int64, device=dev)
    diff[:B] = dcdiff
    bidx = torch.arange(Bp, device=dev)
    valid = bidx < B
    pos = bidx % len(spec.dc_tab_pattern)
    dct = torch.zeros(Bp, dtype=torch.int64, device=dev)
    act = torch.zeros(Bp, dtype=torch.int64, device=dev)
    for p, (d, a) in enumerate(zip(spec.dc_tab_pattern, spec.ac_tab_pattern)):
        dct = torch.where(pos == p, d, dct)
        act = torch.where(pos == p, a, act)
    dcl = _u32(dc_tab.reshape(-1))
    acl = _u32(ac_tab)

    lens, words, last = _ac_items(qq, ss, se, acl, act[None, :], valid)
    if spec.emit_dc:  # slot 0 holds the DC item
        size = _bit_length(diff.abs())
        extra = (diff - (diff < 0).long()) & _mask(size)
        lut = torch.where(size < 16, dcl[dct * 16 + size.clamp(max=15)], 0)
        dc_len = torch.where(valid, (lut >> 16) + size, 0)
        lens[0] = dc_len
        words[0] = _shl(_shl(lut & 0xFFFF, size) | extra, 32 - dc_len)

    eob_len, eob_w = _eob_item(acl, act, last, se, valid)
    total64 = lens.sum(0)
    total = total64 + eob_len
    ovf = (
        (lens.view(8, 8, Bp).sum(1) > 32 * cap8).any()
        | (lens.view(4, 16, Bp).sum(1) > 32 * cap16).any()
        | (lens.view(2, 32, Bp).sum(1) > 32 * cap32).any()
        | (total64 > 32 * cap64).any()
        | (total > 32 * capB).any()
    )

    # Bit concatenation: slot items in order, then EOB.
    all_len = torch.cat([lens, eob_len[None]])             # (65, Bp)
    all_w = torch.cat([words, eob_w[None]])
    off = torch.cumsum(all_len, 0) - all_len
    out = _scatter_words(Bp, capB, bidx[None, :].expand(65, Bp), off, all_w,
                         all_len > 0)
    return out, total.to(torch.int32), ovf.to(torch.int32).reshape(1)


def pack_blocks(q, dcdiff, dc_tab, ac_tab, spec: ScanSpec, Bp: int,
                budget: int):
    """K2 on ``q``'s device: the CUDA kernel for CUDA tensors, the plain
    version (:func:`pack_blocks_ref`, same contract) for CPU tensors."""
    if not cuda_lib.on_cuda(q, "pack_blocks"):
        return pack_blocks_ref(q, dcdiff, dc_tab, ac_tab, spec, Bp, budget)
    _check_spec(spec)
    dev = q.device
    B = q.shape[-1]
    cuda_lib.check_tensor("q", q, torch.int16, (64, B), dev)
    cuda_lib.check_tensor("dcdiff", dcdiff, torch.int32, (B,), dev)
    _check_tables(spec, dc_tab, ac_tab, B, Bp, dev)
    caps = _p1_caps(budget)
    ss, se = _k2_band(spec)
    words = torch.empty((Bp, caps[-1]), dtype=torch.int32, device=dev)
    lens = torch.empty(Bp, dtype=torch.int32, device=dev)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_pack_blocks(
            q.data_ptr(), B, Bp, dcdiff.data_ptr(), dc_tab.data_ptr(),
            ac_tab.data_ptr(),
            cuda_lib.int_array(spec.dc_tab_pattern + spec.ac_tab_pattern),
            len(spec.dc_tab_pattern), ss, se,
            int(spec.emit_dc), cuda_lib.int_array(caps), words.data_ptr(),
            lens.data_ptr(), ovf.data_ptr(), cuda_lib.stream_of(q),
        ),
        "tpuenc_pack_blocks",
    )
    pack_blocks.launches += 1
    return words, lens, ovf


pack_blocks.launches = 0


def dc_diffs_from_dc(dc, spec: ScanSpec):
    """(B,) int32 DC differences from the (B,) DC row: each block minus the
    previous block of the same component, reset to 0 at every restart
    segment start (reference encoder.rs:748-757)."""
    B = dc.shape[0]
    dev = dc.device
    dc = dc.to(torch.int32)
    pat = len(spec.dc_tab_pattern)
    bidx = torch.arange(B, device=dev)
    pos = bidx % pat
    delta = torch.full((B,), int(spec.dc_prev_delta[0]), dtype=torch.int64,
                       device=dev)
    for p in range(1, pat):
        delta = torch.where(pos == p, int(spec.dc_prev_delta[p]), delta)
    prev = torch.zeros_like(dc)
    for d in sorted(set(spec.dc_prev_delta)):
        prev = torch.where(delta == d, torch.roll(dc, d), prev)
    seg = spec.seg_blocks if spec.seg_blocks > 0 else B
    prev = torch.where((bidx % seg) >= delta, prev, 0)
    return dc - prev


def scan_pack_blocks(blocks, spec: ScanSpec, dc_packed, ac_packed,
                     budget: int, *, tile: int = 512):
    """P1 of one scan: int16 (64, B) coefficient-major blocks -> (words
    int32 (Bp, capB), lens int32 (Bp,), overflow int32 (1,)), with Bp = B
    rounded up to ``tile`` and padding blocks of length 0.  Block-level
    caps take ``max(budget, 16)``: they must hold the busiest single
    block however small the aggregate budget is."""
    B = blocks.shape[1]
    Bp = -(-B // tile) * tile
    if spec.emit_ac and not spec.emit_dc and \
            spec.spectral_start >= spec.spectral_end:
        # The empty band [1, 1) of plans with 34 or more scans
        # (encoder.rs:926-936): no symbols and not even an EOB
        # (writer.rs:364-384), so every block is 0 bits.
        return _zero_strings(Bp, blocks.device)
    dcdiff = dc_diffs_from_dc(blocks[0], spec)
    return pack_blocks(blocks.contiguous(), dcdiff, dc_packed, ac_packed, spec,
                       Bp, max(budget, 16))


def _zero_strings(Bp: int, device):
    """P1's output for a scan of empty strings: words (Bp, 1), lens (Bp,)
    and the overflow flag, all zero."""
    return (torch.zeros((Bp, 1), dtype=torch.int32, device=device),
            torch.zeros(Bp, dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device))


def dc_only_pack_blocks(blocks, spec: ScanSpec, dc_packed, tile: int = 512):
    """P1 of a DC-only scan (the progressive DC passes): one item of at
    most 27 bits per block, so one word per block.  Plain PyTorch, as it
    is XLA in ``tpuenc`` (``pallas_pack._dc_only_pack_blocks``).  Returns
    ``(words int32 (Bp, 1), lens int32 (Bp,), overflow int32 (1,))`` with
    Bp = B rounded up to ``tile``; the flag is always 0."""
    dev = blocks.device
    B = blocks.shape[1]
    Bp = -(-B // tile) * tile
    diff = dc_diffs_from_dc(blocks[0], spec).to(torch.int64)
    size = _bit_length(diff.abs())
    pat = spec.dc_tab_pattern
    if len(set(pat)) == 1:
        idx = size + 16 * int(pat[0])
    else:
        pos = torch.arange(B, device=dev) % len(pat)
        tab = torch.full((B,), int(pat[0]), dtype=torch.int64, device=dev)
        for p in range(1, len(pat)):
            tab = torch.where(pos == p, int(pat[p]), tab)
        idx = size + 16 * tab
    lut = _u32(dc_packed.reshape(-1))[idx]
    blen = (lut >> 16) + size
    # size <= 16 and blen <= 32, so no shift here needs _shl's guards, and
    # (code << size | extra) < 2^blen keeps the word below 2^32.
    extra = (diff - (diff < 0).long()) & ((1 << size) - 1)
    word = (((lut & 0xFFFF) << size) | extra) << (32 - blen)
    words, lens, ovf = _zero_strings(Bp, dev)
    words[:B, 0] = _to_i32(word)
    lens[:B] = blen.to(torch.int32)
    return words, lens, ovf


# ---------------------------------------------------------------------------
# Fused sample -> P1 of an interleaved scan (K8).
# ---------------------------------------------------------------------------

def _check_fused(spec: ScanSpec, qtab_pattern):
    _check_spec(spec)
    if not (spec.emit_dc and spec.emit_ac):
        raise ValueError("K8 packs a scan with DC and AC items")
    if len(qtab_pattern) != len(spec.dc_tab_pattern) or \
            not set(qtab_pattern) <= {0, 1}:
        raise ValueError(f"quantizer pattern {qtab_pattern} for "
                         f"{len(spec.dc_tab_pattern)} blocks per MCU")


def fused_sample_pack_ref(x, spec: ScanSpec, qtab_pattern, recip, corr,
                          dc_tab, ac_tab, Bp: int, budget: int):
    """Plain version of K8: K1's plain version with the quantizer of each
    block's MCU position (``qtab_pattern[b % pat]``), the DC differences
    (:func:`dc_diffs_from_dc`) and K2's plain version.

    ``x``: int16 (64, B) MCU-ordered level-shifted samples; ``recip`` /
    ``corr``: int32 (2, 64) zigzag-ordered (luma, chroma); the tables,
    ``Bp`` and ``budget`` as :func:`pack_blocks_ref` takes them.  Returns
    K2's ``(words int32 (Bp, capB), lens int32 (Bp,), overflow int32
    (1,))``."""
    _check_fused(spec, qtab_pattern)
    B = x.shape[1]
    pattern = torch.tensor(qtab_pattern, dtype=torch.int64, device=x.device)
    table = pattern[torch.arange(B, device=x.device) % len(qtab_pattern)]
    q = fdct_quantize_ref(x, recip[table].T, corr[table].T)
    return pack_blocks_ref(q, dc_diffs_from_dc(q[0], spec), dc_tab, ac_tab,
                           spec, Bp, budget)


def fused_sample_pack(x, spec: ScanSpec, qtab_pattern, recip, corr, dc_tab,
                      ac_tab, Bp: int, budget: int):
    """K8 on ``x``'s device: the CUDA kernel for a CUDA tensor, the plain
    version (:func:`fused_sample_pack_ref`, same contract) for a CPU
    tensor."""
    if not cuda_lib.on_cuda(x, "fused_sample_pack"):
        return fused_sample_pack_ref(x, spec, qtab_pattern, recip, corr,
                                     dc_tab, ac_tab, Bp, budget)
    _check_fused(spec, qtab_pattern)
    dev = x.device
    B = x.shape[-1]
    cuda_lib.check_tensor("x", x, torch.int16, (64, B), dev)
    cuda_lib.check_tensor("recip", recip, torch.int32, (2, 64), dev)
    cuda_lib.check_tensor("corr", corr, torch.int32, (2, 64), dev)
    _check_tables(spec, dc_tab, ac_tab, B, Bp, dev)
    caps = _p1_caps(budget)
    words = torch.empty((Bp, caps[-1]), dtype=torch.int32, device=dev)
    lens = torch.empty(Bp, dtype=torch.int32, device=dev)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_fused_sample_pack(
            x.data_ptr(), B, Bp, recip.data_ptr(), corr.data_ptr(),
            dc_tab.data_ptr(), ac_tab.data_ptr(),
            cuda_lib.int_array(spec.dc_tab_pattern + spec.ac_tab_pattern
                               + tuple(qtab_pattern) + spec.dc_prev_delta),
            len(qtab_pattern), spec.spectral_start, spec.spectral_end,
            spec.seg_blocks, cuda_lib.int_array(caps), words.data_ptr(),
            lens.data_ptr(), ovf.data_ptr(), cuda_lib.stream_of(x),
        ),
        "tpuenc_fused_sample_pack",
    )
    fused_sample_pack.launches += 1
    return words, lens, ovf


fused_sample_pack.launches = 0


def fused_sample_pack_blocks(x, spec: ScanSpec, qtab_pattern, params,
                             budget: int, *, tile: int = 512):
    """P1 of one interleaved scan from its samples: ``x`` int16 (64, B)
    (:func:`~tpuenc_torch.kernels.pipeline.fn_cm_samples`), ``params`` the
    encoder's quantizers and packed tables (``EncodeParams``).  Returns
    :func:`scan_pack_blocks`' ``(words int32 (Bp, capB), lens int32 (Bp,),
    overflow int32 (1,))`` for the same budget: Bp = B rounded up to
    ``tile``, padding blocks of length 0, block caps at ``max(budget,
    16)``."""
    B = x.shape[1]
    Bp = -(-B // tile) * tile
    return fused_sample_pack(x.contiguous(), spec, tuple(qtab_pattern),
                             params.reciprocals, params.corrections,
                             params.dc, params.ac, Bp, max(budget, 16))


# ---------------------------------------------------------------------------
# P1 of several AC bands of one component (K6).
# ---------------------------------------------------------------------------

def band_tree_caps(budget: int, ss: int, se: int):
    """Merge-tree plan of one spectral band ``[ss, se)`` packed from 8-slot
    chunks, as the TPU kernel builds it: ``(row0, row1, gen_caps,
    cap_final)`` where rows ``[8*row0, 8*row1)`` cover the band,
    ``gen_caps`` are the pairwise levels' capacities over the band's chunk
    count padded to a power of two, and ``cap_final`` includes the EOB
    word."""
    row0 = ss // 8
    row1 = -(-se // 8)
    nc = row1 - row0
    ncp = 1 << max(0, (nc - 1).bit_length())
    c = block_caps(budget)[2]  # capacity of one 8-slot chunk
    gen_caps = []
    n_slots = 8
    while ncp > 1:
        n_slots *= 2
        limit = max(5, (budget * n_slots + 63) // 64 + 2)
        c = min(2 * c, limit)
        gen_caps.append(c)
        ncp //= 2
    return row0, row1, gen_caps, c + 1


def pack_acbands_ref(q, bands, ac_tab, tab: int, Bp: int, budget: int):
    """Plain version of K6.

    ``q``: int16 (64, B) coefficients of one component; ``bands``: up to
    7 non-empty spectral bands ``(ss, se)`` that do not overlap, in any
    order (band i is row i of the outputs); ``ac_tab``: int32 (T, 256)
    packed AC tables, of which ``tab`` codes every band; ``Bp >= B``
    output rows; ``budget``: the block-level budget (callers pass
    ``max(budget, 16)``).  Returns ``(words int32 (n_bands, Bp, cap_f),
    lens int32 (n_bands, Bp), overflow int32 (1,))``: each band's bit
    string (AC items, then EOB) clipped at its ``cap_band`` words and
    zero-padded to cap_f = max(cap_band), and the flag of the TPU
    kernel's merge tree (:func:`band_tree_caps`)."""
    dev = q.device
    B = q.shape[1]
    qq = torch.zeros((64, Bp), dtype=torch.int64, device=dev)
    qq[:, :B] = q
    bidx = torch.arange(Bp, device=dev)
    valid = bidx < B
    acl = _u32(ac_tab)
    cap8 = block_caps(budget)[2]
    plans = [band_tree_caps(budget, ss, se) for ss, se in bands]
    cap_f = max(p[3] for p in plans)
    words = torch.zeros((len(bands), Bp, cap_f), dtype=torch.int32, device=dev)
    lens = torch.zeros((len(bands), Bp), dtype=torch.int32, device=dev)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for b, ((ss, se), (row0, row1, gen_caps, cap_band)) in enumerate(
            zip(bands, plans)):
        item_len, item_w, last = _ac_items(qq, ss, se, acl, tab, valid)
        chunks = item_len.view(8, 8, Bp).sum(1)
        ovf = ovf | (chunks > 32 * cap8).any()
        ncp = 1 << len(gen_caps)
        level = torch.nn.functional.pad(chunks[row0:row1],
                                        (0, 0, 0, ncp - (row1 - row0)))
        for cap in gen_caps:
            level = level.view(-1, 2, Bp).sum(1)
            ovf = ovf | (level > 32 * cap).any()
        eob_len, eob_w = _eob_item(acl, tab, last, se, valid)
        total = item_len.sum(0) + eob_len
        ovf = ovf | (total > 32 * cap_band).any()
        all_len = torch.cat([item_len, eob_len[None]])
        all_w = torch.cat([item_w, eob_w[None]])
        off = torch.cumsum(all_len, 0) - all_len
        words[b, :, :cap_band] = _scatter_words(
            Bp, cap_band, bidx[None, :].expand(65, Bp), off, all_w,
            all_len > 0)
        lens[b] = total.to(torch.int32)
    return words, lens, ovf.to(torch.int32).reshape(1)


def check_bands(name: str, bands, max_bands: int):
    """``bands`` as a tuple of ``(ss, se)`` int pairs; ValueError unless
    there are 1 to ``max_bands`` of them, each non-empty within [0, 64),
    and no two overlap.  K6 and K7 walk a block's slots once for all its
    bands, so a slot belongs to one band only."""
    bands = tuple((int(ss), int(se)) for ss, se in bands)
    spans = sorted(bands)
    if (not 1 <= len(bands) <= max_bands
            or any(not 0 <= ss < se <= 64 for ss, se in bands)
            or any(a[1] > b[0] for a, b in zip(spans, spans[1:]))):
        raise ValueError(f"{name}: bands {bands}")
    return bands


def pack_acbands(q, bands, ac_tab, tab: int, Bp: int, budget: int):
    """K6 on ``q``'s device: the CUDA kernel for CUDA tensors, the plain
    version (:func:`pack_acbands_ref`, same contract) for CPU tensors.
    Both raise ValueError for more than 7 bands, an empty one or two that
    overlap (:func:`check_bands`)."""
    bands = check_bands("pack_acbands", bands, 7)
    if not cuda_lib.on_cuda(q, "pack_acbands"):
        return pack_acbands_ref(q, bands, ac_tab, tab, Bp, budget)
    dev = q.device
    B = q.shape[-1]
    n_tabs = ac_tab.shape[0]
    cuda_lib.check_tensor("q", q, torch.int16, (64, B), dev)
    cuda_lib.check_tensor("ac_tab", ac_tab, torch.int32, (n_tabs, 256), dev)
    if Bp < B:
        raise ValueError(f"Bp {Bp} < B {B}")
    if not 0 <= tab < n_tabs:
        raise ValueError(f"AC table {tab} of {n_tabs}")
    args = []
    plans = [band_tree_caps(budget, ss, se) for ss, se in bands]
    for (ss, se), (row0, _, gen_caps, cap_band) in zip(bands, plans):
        args += [ss, se, row0, len(gen_caps),
                 *(gen_caps + [0] * (3 - len(gen_caps))), cap_band]
    cap_f = max(p[3] for p in plans)
    words = torch.empty((len(bands), Bp, cap_f), dtype=torch.int32, device=dev)
    lens = torch.empty((len(bands), Bp), dtype=torch.int32, device=dev)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_pack_acbands(
            q.data_ptr(), B, Bp, ac_tab[tab].data_ptr(), len(bands),
            cuda_lib.int_array(args), block_caps(budget)[2], cap_f,
            words.data_ptr(), lens.data_ptr(), ovf.data_ptr(),
            cuda_lib.stream_of(q),
        ),
        "tpuenc_pack_acbands",
    )
    pack_acbands.launches += 1
    return words, lens, ovf


pack_acbands.launches = 0


def scan_pack_blocks_acbands(blocks, specs, ac_packed, budget: int, *,
                             tile: int = 512):
    """P1 of several AC-only band scans of one component in one K6
    launch.  ``specs`` share one AC table; returns ``([(words (Bp,
    cap_f), lens (Bp,)) per spec], overflow int32 (1,))`` with Bp = B
    rounded up to ``tile``.  Empty bands ([1, 1), plans of 34 or more
    scans) stay out of the kernel and get zero strings in their place."""
    if not all(s.emit_ac and not s.emit_dc and len(s.ac_tab_pattern) == 1
               for s in specs):
        raise ValueError("scan_pack_blocks_acbands takes AC-only band scans")
    tabs = {s.ac_tab_pattern[0] for s in specs}
    if len(tabs) != 1:
        raise ValueError(f"band scans of one launch share a table, got {tabs}")
    B = blocks.shape[1]
    Bp = -(-B // tile) * tile
    live = [i for i, s in enumerate(specs)
            if s.spectral_start < s.spectral_end]
    outs = [None] * len(specs)
    if len(live) < len(specs):
        zero_w, zero_l, ovf = _zero_strings(Bp, blocks.device)
        outs = [(zero_w, zero_l)] * len(specs)
        if not live:
            return outs, ovf
    bands = tuple((specs[i].spectral_start, specs[i].spectral_end)
                  for i in live)
    words, lens, ovf = pack_acbands(blocks.contiguous(), bands, ac_packed,
                                    tabs.pop(), Bp, max(budget, 16))
    for k, i in enumerate(live):
        outs[i] = (words[k], lens[k])
    return outs, ovf


# ---------------------------------------------------------------------------
# P2 / P3 (K3 / K4): merge runs of rows.
# ---------------------------------------------------------------------------

def merge_rows_ref(words, lens, run: int, n_runs: int, caps, cap_out: int):
    """Plain version of K3/K4.

    ``words``: int32 (N, C) MSB-aligned rows, zero past their length;
    ``lens``: int32 (N,) bit lengths.  Row ``r*run + i`` is row i of run r;
    rows at or past N are empty.  Returns ``(out int32 (n_runs, cap_out),
    out_len int32 (n_runs,), overflow int32 (1,))``: each run's bit
    concatenation, its length, and whether any aligned window of
    ``2 << l`` rows of a run holds more than ``32 * caps[l]`` bits."""
    dev = words.device
    N, C = words.shape
    M = n_runs * run
    k = min(N, M)
    L = torch.zeros(M, dtype=torch.int64, device=dev)
    L[:k] = lens[:k]
    X = torch.zeros((M, C), dtype=torch.int64, device=dev)
    X[:k] = _u32(words[:k])
    Lr = L.view(n_runs, run)
    incl = torch.cumsum(Lr, 1)
    excl = (incl - Lr).reshape(M, 1)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    for lvl, cap in enumerate(caps):
        size = 2 << lvl
        padded = torch.nn.functional.pad(Lr, (0, -(-run // size) * size - run))
        ovf = ovf | (padded.view(n_runs, -1, size).sum(-1) > 32 * cap).any()
    j = torch.arange(C, device=dev)
    off = excl + 32 * j
    active = 32 * j < L.view(M, 1)
    row_idx = (torch.arange(M, device=dev) // run).view(M, 1).expand(M, C)
    out = _scatter_words(n_runs, cap_out, row_idx, off, X, active)
    return out, incl[:, -1].to(torch.int32), ovf.to(torch.int32).reshape(1)


def _merge_rows(words, lens, run: int, n_runs: int, caps, cap_out: int):
    dev = words.device
    N, C = words.shape
    cuda_lib.check_tensor("words", words, torch.int32, (N, C), dev)
    cuda_lib.check_tensor("lens", lens, torch.int32, (N,), dev)
    if run < 1 or run > 6000 or len(caps) > 24:
        raise ValueError(f"merge_rows: unsupported run {run} / {len(caps)} levels")
    # The kernel writes every output word, the zero tail included.
    out = torch.empty((n_runs, cap_out), dtype=torch.int32, device=dev)
    out_len = torch.empty(n_runs, dtype=torch.int32, device=dev)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_merge_rows(
            words.data_ptr(), lens.data_ptr(), N, C, run, n_runs,
            cuda_lib.int_array(caps), len(caps), out.data_ptr(), cap_out,
            out_len.data_ptr(), ovf.data_ptr(), cuda_lib.stream_of(words),
        ),
        "tpuenc_merge_rows",
    )
    return out, out_len, ovf


def merge_chunks(words, lens, run: int, n_runs: int, caps, cap_out: int):
    """K3 (P2) on ``words``' device; contract of :func:`merge_rows_ref`."""
    if not cuda_lib.on_cuda(words, "merge_chunks"):
        return merge_rows_ref(words, lens, run, n_runs, caps, cap_out)
    res = _merge_rows(words, lens, run, n_runs, caps, cap_out)
    merge_chunks.launches += 1
    return res


def fold_rows(words, lens, run: int, n_runs: int, caps, cap_out: int):
    """K4 (P3) on ``words``' device; contract of :func:`merge_rows_ref`."""
    if not cuda_lib.on_cuda(words, "fold_rows"):
        return merge_rows_ref(words, lens, run, n_runs, caps, cap_out)
    res = _merge_rows(words, lens, run, n_runs, caps, cap_out)
    fold_rows.launches += 1
    return res


merge_chunks.launches = 0
fold_rows.launches = 0


# ---------------------------------------------------------------------------
# P4 (K5): rows into one stream.
# ---------------------------------------------------------------------------

def concat_rows_ref(rows, pos, bits, capW: int):
    """Plain version of K5: ``rows`` int32 (R, W), zero past their
    lengths, ``pos`` int64 (R,) bit offsets (exclusive prefix of
    ``bits``), ``bits`` int32 (R,).  Returns the int32 (capW,) stream with
    row r at bit pos[r]."""
    dev = rows.device
    R, W = rows.shape
    j = torch.arange(W, device=dev)
    nw = ((bits.to(torch.int64) + 31) >> 5).view(R, 1)
    off = pos.view(R, 1) + 32 * j
    zero = torch.zeros((R, W), dtype=torch.int64, device=dev)
    out = _scatter_words(1, capW, zero, off, _u32(rows), j < nw)
    return out.view(capW)


def concat_rows(rows, pos, bits, capW: int):
    """K5 (P4) on ``rows``' device; contract of :func:`concat_rows_ref`."""
    if not cuda_lib.on_cuda(rows, "concat_rows"):
        return concat_rows_ref(rows, pos, bits, capW)
    dev = rows.device
    R, W = rows.shape
    cuda_lib.check_tensor("rows", rows, torch.int32, (R, W), dev)
    cuda_lib.check_tensor("pos", pos, torch.int64, (R,), dev)
    cuda_lib.check_tensor("bits", bits, torch.int32, (R,), dev)
    # The kernel writes every output word, the zero tail included.
    out = torch.empty(capW, dtype=torch.int32, device=dev)
    lib = cuda_lib.library()
    cuda_lib.check(
        lib.tpuenc_concat_rows(
            rows.data_ptr(), pos.data_ptr(), bits.data_ptr(), R, W,
            out.data_ptr(), capW, cuda_lib.stream_of(rows),
        ),
        "tpuenc_concat_rows",
    )
    concat_rows.launches += 1
    return out


concat_rows.launches = 0


def merge_plan(Bp: int, capB: int, budget: int, n_sub: int = 128,
               chunk: int = 256):
    """Shapes of P2 and P3 for ``Bp`` block strings of ``capB`` words:
    ``(chunk, n2, caps, caps_f)``.  P2 merges runs of ``chunk`` blocks
    into ``n_sub * n2`` rows under ``caps``; P3 folds each substream's
    ``n2`` rows into one under ``caps_f``, which is None where P3 is
    skipped (a single row per substream, or no :func:`fold_plan`)."""
    n1 = -(-Bp // n_sub)
    # Small scans: shrink the chunk so the stream is not padded to
    # n_sub * chunk block slots; chunk stays a power of two >= 2.
    chunk = max(2, min(chunk, 1 << max(1, (n1 - 1).bit_length())))
    n2 = -(-n1 // chunk)
    caps = chunk_caps(capB, chunk, budget)
    caps_f = None
    if n2 > 1:
        n2p = 1 << (n2 - 1).bit_length()
        plan = fold_plan(n2p, -(-caps[-1] // 128) * 128, n_sub, budget * chunk)
        if plan is not None:
            caps_f = plan[1]
    return chunk, n2, caps, caps_f


def merge_pack_stream(words, lens, budget: int, *, n_sub: int = 128,
                      chunk: int = 256):
    """P2-P4: per-block bit strings (Bp, capB) + (Bp,) lens -> one raw
    bit-concatenated stream.  Returns ``(stream int32 (capW,), total_bits
    int64 (), overflow int32 (1,))``.

    Substream s holds blocks [s*n2*chunk, (s+1)*n2*chunk); P2 merges each
    run of ``chunk`` consecutive blocks into one row, so rows come out in
    stream order.  P3 folds each substream's rows into one where
    :func:`merge_plan` says so, and P4 places the rows at the prefix sums
    of their lengths."""
    Bp, capB = words.shape
    chunk, n2, caps, caps_f = merge_plan(Bp, capB, budget, n_sub, chunk)
    cap_out = caps[-1]
    rows, row_bits, ovf = merge_chunks(words, lens, chunk, n_sub * n2, caps,
                                       cap_out)
    if caps_f is not None:
        cap_out = caps_f[-1]
        rows, row_bits, ovf3 = fold_rows(rows, row_bits, n2, n_sub, caps_f,
                                         cap_out)
        ovf = ovf | ovf3

    R = rows.shape[0]
    incl = torch.cumsum(row_bits.to(torch.int64), 0)
    pos = incl - row_bits
    capW = -(-(R * cap_out + cap_out + 256) // 128) * 128
    stream = concat_rows(rows, pos, row_bits, capW)
    return stream, incl[-1], ovf
